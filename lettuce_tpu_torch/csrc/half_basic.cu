// The 16-bit instances of the identity, forced-BGK and TRT fragments
// (collide_basic.cu's policies, unchanged, in float32): K1f (bfloat16 and
// float16 state) and K1e (bfloat16 deviations), periodic and masked, for
// D2Q9, D3Q15, D3Q19 and D3Q27, and TRT's emit-u entries on a 16-bit state
// (K1d at 16 bits, u in float32). What bounds them and how the storage
// works: half_storage.cuh.

#define LT_POLICIES_ONLY
#include "collide_basic.cu"
#include "half_storage.cuh"

extern "C" {

LT_HALF_ENTRIES(none, d2q9, lt::NoCollide, D2Q9)
LT_HALF_ENTRIES(none, d3q15, lt::NoCollide, D3Q15)
LT_HALF_ENTRIES(none, d3q19, lt::NoCollide, D3Q19)
LT_HALF_ENTRIES(none, d3q27, lt::NoCollide, D3Q27)
LT_HALF_ENTRIES(bgk_force, d2q9, lt::BgkForce, D2Q9)
LT_HALF_ENTRIES(bgk_force, d3q15, lt::BgkForce, D3Q15)
LT_HALF_ENTRIES(bgk_force, d3q19, lt::BgkForce, D3Q19)
LT_HALF_ENTRIES(bgk_force, d3q27, lt::BgkForce, D3Q27)
LT_HALF_ENTRIES(trt, d2q9, lt::Trt, D2Q9)
LT_HALF_ENTRIES(trt, d3q15, lt::Trt, D3Q15)
LT_HALF_ENTRIES(trt, d3q19, lt::Trt, D3Q19)
LT_HALF_ENTRIES(trt, d3q27, lt::Trt, D3Q27)
LT_HALF_EMIT_U_ENTRIES(trt, d2q9, lt::Trt, D2Q9)
LT_HALF_EMIT_U_ENTRIES(trt, d3q15, lt::Trt, D3Q15)
LT_HALF_EMIT_U_ENTRIES(trt, d3q19, lt::Trt, D3Q19)
LT_HALF_EMIT_U_ENTRIES(trt, d3q27, lt::Trt, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
