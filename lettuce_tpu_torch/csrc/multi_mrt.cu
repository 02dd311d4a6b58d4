// The blocked step (K2) of the MRT fragment (collide_mrt.cu's policy,
// unchanged) on a periodic grid, every basis in float32, float64 and a
// bfloat16 or float16 state; from_feq also in bfloat16 deviations (the
// closed-form bases are not shift-invariant in f, as the single-step
// kernels: half_mrt.cu). What it computes, what bounds it and the design:
// multi_sweep.cuh.

#define LT_POLICIES_ONLY
#include "collide_mrt.cu"
#include "multi_sweep.cuh"

extern "C" {

LT_MULTI_ALL_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq, D3Q19)
LT_MULTI_STATE_ENTRIES(mrt_lallemand, d2q9, lt::MrtLallemand, D2Q9)
LT_MULTI_STATE_ENTRIES(mrt_dellar, d2q9, lt::MrtDellar, D2Q9)
LT_MULTI_STATE_ENTRIES(mrt_hermite27, d3q27, lt::MrtHermite, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
