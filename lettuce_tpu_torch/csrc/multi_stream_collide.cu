// The blocked BGK collide-and-stream step (K2) for Hopper (sm_90a): n_sub
// sub-steps per launch on a periodic grid, for D2Q9, D3Q15, D3Q19 and
// D3Q27, in every storage: float32, float64, a bfloat16 or float16 state
// (computed in float32, rounded once per launch) and bfloat16 deviations.
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_multi_sweep (:1270)
// with the "bgk" fragment. What it computes, what bounds it and the
// design: multi_sweep.cuh; the policy is stream_collide.cuh's Bgk.
//
// Plain C interface, loaded with ctypes:
// lt_multi_bgk_<stencil>_<f32|f64|bf16|f16|bf16_dev>, the parameter array
// [tau_inv].

#include "multi_sweep.cuh"

extern "C" {

LT_MULTI_ALL_ENTRIES(bgk, d2q9, lt::Bgk, D2Q9)
LT_MULTI_ALL_ENTRIES(bgk, d3q15, lt::Bgk, D3Q15)
LT_MULTI_ALL_ENTRIES(bgk, d3q19, lt::Bgk, D3Q19)
LT_MULTI_ALL_ENTRIES(bgk, d3q27, lt::Bgk, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
