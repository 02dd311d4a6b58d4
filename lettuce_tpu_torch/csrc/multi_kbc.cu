// The blocked step (K2) of the KBC fragment (collide_kbc.cu's policy,
// unchanged) on a periodic grid, D2Q9 and D3Q27, in every storage
// (float32, float64, bfloat16 and float16 state, bfloat16 deviations).
// What it computes, what bounds it and the design: multi_sweep.cuh.

#define LT_POLICIES_ONLY
#include "collide_kbc.cu"
#include "multi_sweep.cuh"

extern "C" {

LT_MULTI_ALL_ENTRIES(kbc, d2q9, lt::Kbc, D2Q9)
LT_MULTI_ALL_ENTRIES(kbc, d3q27, lt::Kbc, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
