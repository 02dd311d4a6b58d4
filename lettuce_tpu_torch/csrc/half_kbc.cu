// The 16-bit instances of the KBC fragment (collide_kbc.cu's policy,
// unchanged, in float32): K1f (bfloat16 and float16 state) and K1e
// (bfloat16 deviations), periodic and masked, on D2Q9 and D3Q27. What
// bounds them and how the storage works: half_storage.cuh.

#define LT_POLICIES_ONLY
#include "collide_kbc.cu"
#include "half_storage.cuh"

extern "C" {

LT_HALF_ENTRIES(kbc, d2q9, lt::Kbc, D2Q9)
LT_HALF_ENTRIES(kbc, d3q27, lt::Kbc, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
