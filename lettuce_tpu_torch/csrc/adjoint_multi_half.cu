// The blocked adjoint (K4) at 16-bit storage for Hopper (sm_90a): the
// exact VJP of one blocked launch (n_sub steps) of a bfloat16 or float16
// state, for the forward fragments of adjoint_multi.cu (bgk, trt, reg,
// mrt_from_feq, none), on D2Q9, D3Q15, D3Q19 and D3Q27.
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_multi_kernel (:984)
// on a 16-bit state. The tile is float32: f and g convert on load, the
// forward replay and the backward sweep run in float32 between levels (as
// the blocked forward, K2, keeps its tile at 16 bits), and the cotangent
// rounds once at the store. The TPU kernel computes in the storage dtype
// (adjoint.py:1007, :1152-1154) and so replays a trajectory its forward,
// which keeps float32 slabs (stream_collide.py:1760-1762), never took:
// ROADMAP F11. What bounds it and the design: adjoint_multi.cuh.
//
// D3Q19 moves 3 * 19 * 2 B per cell per launch, 114 / n_sub B per lattice
// update; the tile is as large as the float32 one (q + n_sub d float32
// values per cell).
//
// Plain C interface, loaded with ctypes:
// lt_adjoint_multi_<fragment>_<stencil>_<bf16|f16>, the arguments of
// adjoint_multi.cu's entries.

#define LT_POLICIES_ONLY
#include "adjoint.cu"
#include "adjoint_fragments.cu"
#include "collide_basic.cu"
#include "collide_moments.cu"
#include "collide_mrt.cu"
#include "adjoint_multi.cuh"
#include "half_storage.cuh"

#define LT_ADJOINT_MULTI_HALF_ENTRIES(FRAG, STENCIL, FWD, ADJ, S)             \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, bf16, lt::Bf16)         \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, f16, lt::F16Storage)

extern "C" {

LT_ADJOINT_MULTI_HALF_ENTRIES(bgk, d2q9, lt::Bgk, lt::BgkAdjoint, D2Q9)
LT_ADJOINT_MULTI_HALF_ENTRIES(bgk, d3q15, lt::Bgk, lt::BgkAdjoint, D3Q15)
LT_ADJOINT_MULTI_HALF_ENTRIES(bgk, d3q19, lt::Bgk, lt::BgkAdjoint, D3Q19)
LT_ADJOINT_MULTI_HALF_ENTRIES(bgk, d3q27, lt::Bgk, lt::BgkAdjoint, D3Q27)
LT_ADJOINT_MULTI_HALF_ENTRIES(trt, d2q9, lt::Trt, lt::TrtAdjoint, D2Q9)
LT_ADJOINT_MULTI_HALF_ENTRIES(trt, d3q15, lt::Trt, lt::TrtAdjoint, D3Q15)
LT_ADJOINT_MULTI_HALF_ENTRIES(trt, d3q19, lt::Trt, lt::TrtAdjoint, D3Q19)
LT_ADJOINT_MULTI_HALF_ENTRIES(trt, d3q27, lt::Trt, lt::TrtAdjoint, D3Q27)
LT_ADJOINT_MULTI_HALF_ENTRIES(reg, d2q9, lt::Reg, lt::MatvecAdjoint, D2Q9)
LT_ADJOINT_MULTI_HALF_ENTRIES(reg, d3q15, lt::Reg, lt::MatvecAdjoint, D3Q15)
LT_ADJOINT_MULTI_HALF_ENTRIES(reg, d3q19, lt::Reg, lt::MatvecAdjoint, D3Q19)
LT_ADJOINT_MULTI_HALF_ENTRIES(reg, d3q27, lt::Reg, lt::MatvecAdjoint, D3Q27)
LT_ADJOINT_MULTI_HALF_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq,
                              lt::MatvecAdjoint, D3Q19)
LT_ADJOINT_MULTI_HALF_ENTRIES(none, d2q9, lt::NoCollide, lt::NoneAdjoint,
                              D2Q9)
LT_ADJOINT_MULTI_HALF_ENTRIES(none, d3q15, lt::NoCollide, lt::NoneAdjoint,
                              D3Q15)
LT_ADJOINT_MULTI_HALF_ENTRIES(none, d3q19, lt::NoCollide, lt::NoneAdjoint,
                              D3Q19)
LT_ADJOINT_MULTI_HALF_ENTRIES(none, d3q27, lt::NoCollide, lt::NoneAdjoint,
                              D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
