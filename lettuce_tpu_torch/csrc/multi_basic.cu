// The blocked step (K2) of the identity, forced-BGK and TRT fragments
// (collide_basic.cu's policies, unchanged) on a periodic grid, for D2Q9,
// D3Q15, D3Q19 and D3Q27, in every storage (float32, float64, bfloat16 and
// float16 state, bfloat16 deviations). What it computes, what bounds it
// and the design: multi_sweep.cuh.

#define LT_POLICIES_ONLY
#include "collide_basic.cu"
#include "multi_sweep.cuh"

extern "C" {

LT_MULTI_ALL_ENTRIES(none, d2q9, lt::NoCollide, D2Q9)
LT_MULTI_ALL_ENTRIES(none, d3q15, lt::NoCollide, D3Q15)
LT_MULTI_ALL_ENTRIES(none, d3q19, lt::NoCollide, D3Q19)
LT_MULTI_ALL_ENTRIES(none, d3q27, lt::NoCollide, D3Q27)
LT_MULTI_ALL_ENTRIES(bgk_force, d2q9, lt::BgkForce, D2Q9)
LT_MULTI_ALL_ENTRIES(bgk_force, d3q15, lt::BgkForce, D3Q15)
LT_MULTI_ALL_ENTRIES(bgk_force, d3q19, lt::BgkForce, D3Q19)
LT_MULTI_ALL_ENTRIES(bgk_force, d3q27, lt::BgkForce, D3Q27)
LT_MULTI_ALL_ENTRIES(trt, d2q9, lt::Trt, D2Q9)
LT_MULTI_ALL_ENTRIES(trt, d3q15, lt::Trt, D3Q15)
LT_MULTI_ALL_ENTRIES(trt, d3q19, lt::Trt, D3Q19)
LT_MULTI_ALL_ENTRIES(trt, d3q27, lt::Trt, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
