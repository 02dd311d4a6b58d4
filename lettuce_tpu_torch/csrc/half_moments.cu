// The 16-bit instances of the regularized and Smagorinsky fragments
// (collide_moments.cu's policies, unchanged, in float32): K1f (bfloat16
// and float16 state) and K1e (bfloat16 deviations), periodic and masked,
// for D2Q9, D3Q15, D3Q19 and D3Q27, and the regularized emit-u entries on
// a 16-bit state (K1d at 16 bits, u in float32). What bounds them and how
// the storage works: half_storage.cuh.

#define LT_POLICIES_ONLY
#include "collide_moments.cu"
#include "half_storage.cuh"

extern "C" {

LT_HALF_ENTRIES(reg, d2q9, lt::Reg, D2Q9)
LT_HALF_ENTRIES(reg, d3q15, lt::Reg, D3Q15)
LT_HALF_ENTRIES(reg, d3q19, lt::Reg, D3Q19)
LT_HALF_ENTRIES(reg, d3q27, lt::Reg, D3Q27)
LT_HALF_ENTRIES(smag, d2q9, lt::Smag, D2Q9)
LT_HALF_ENTRIES(smag, d3q15, lt::Smag, D3Q15)
LT_HALF_ENTRIES(smag, d3q19, lt::Smag, D3Q19)
LT_HALF_ENTRIES(smag, d3q27, lt::Smag, D3Q27)
LT_HALF_EMIT_U_ENTRIES(reg, d2q9, lt::Reg, D2Q9)
LT_HALF_EMIT_U_ENTRIES(reg, d3q15, lt::Reg, D3Q15)
LT_HALF_EMIT_U_ENTRIES(reg, d3q19, lt::Reg, D3Q19)
LT_HALF_EMIT_U_ENTRIES(reg, d3q27, lt::Reg, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
