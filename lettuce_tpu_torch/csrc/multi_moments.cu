// The blocked step (K2) of the regularized and Smagorinsky fragments
// (collide_moments.cu's policies, unchanged) on a periodic grid, for D2Q9,
// D3Q15, D3Q19 and D3Q27, in every storage (float32, float64, bfloat16 and
// float16 state, bfloat16 deviations). What it computes, what bounds it
// and the design: multi_sweep.cuh.

#define LT_POLICIES_ONLY
#include "collide_moments.cu"
#include "multi_sweep.cuh"

extern "C" {

LT_MULTI_ALL_ENTRIES(reg, d2q9, lt::Reg, D2Q9)
LT_MULTI_ALL_ENTRIES(reg, d3q15, lt::Reg, D3Q15)
LT_MULTI_ALL_ENTRIES(reg, d3q19, lt::Reg, D3Q19)
LT_MULTI_ALL_ENTRIES(reg, d3q27, lt::Reg, D3Q27)
LT_MULTI_ALL_ENTRIES(smag, d2q9, lt::Smag, D2Q9)
LT_MULTI_ALL_ENTRIES(smag, d3q15, lt::Smag, D3Q15)
LT_MULTI_ALL_ENTRIES(smag, d3q19, lt::Smag, D3Q19)
LT_MULTI_ALL_ENTRIES(smag, d3q27, lt::Smag, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
