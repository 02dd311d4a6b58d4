// The 16-bit instances of the MRT fragment (collide_mrt.cu's policy,
// unchanged, in float32), periodic and masked: K1f (bfloat16 and float16
// state) for every basis, and K1e (bfloat16 deviations) for from_feq
// alone. The closed-form equilibrium moments of the lallemand, dellar and
// hermite27 bases are not shift-invariant in f, so deviation storage
// refuses them, as the TPU gate does
// (lettuce_tpu/ops/pallas/stream_collide.py:1998-2004). from_feq also has
// emit-u entries on a 16-bit state (K1d at 16 bits, u in float32). What
// bounds them and how the storage works: half_storage.cuh.

#define LT_POLICIES_ONLY
#include "collide_mrt.cu"
#include "half_storage.cuh"

extern "C" {

LT_HALF_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq, D3Q19)
LT_HALF_STATE_ENTRIES(mrt_lallemand, d2q9, lt::MrtLallemand, D2Q9)
LT_HALF_STATE_ENTRIES(mrt_dellar, d2q9, lt::MrtDellar, D2Q9)
LT_HALF_STATE_ENTRIES(mrt_hermite27, d3q27, lt::MrtHermite, D3Q27)
LT_HALF_EMIT_U_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq, D3Q19)
LT_ERROR_STRING_ENTRY

}  // extern "C"
