// The blocked adjoint (K4) for Hopper (sm_90a): the exact VJP of one launch
// of the blocked forward kernel (multi_*.cu) for the collisions with a
// closed-form, u-residual adjoint, float32 and float64, on D2Q9, D3Q15,
// D3Q19 and D3Q27:
//   * bgk:          Bgk (stream_collide.cuh)   + BgkAdjoint (adjoint.cu);
//   * trt:          Trt (collide_basic.cu)     + TrtAdjoint;
//   * reg:          Reg (collide_moments.cu)   + MatvecAdjoint;
//   * mrt_from_feq: MrtFromFeq (collide_mrt.cu, D3Q19) + MatvecAdjoint;
//   * none:         NoCollide                  + NoneAdjoint
// (adjoint_fragments.cu). The other collisions keep the single-step
// adjoint: Smagorinsky's Jacobian reads the state of every sub-step, and
// KBC, forced BGK and the closed-form MRT bases have no closed-form one,
// as in lettuce_tpu/ops/pallas/stream_collide.py:2360-2371.
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_multi_kernel
// (:984). What it computes, what bounds it and the design:
// adjoint_multi.cuh.
//
// Plain C interface, loaded with ctypes:
// lt_adjoint_multi_<fragment>_<stencil>_<f32|f64>.

#define LT_POLICIES_ONLY
#include "adjoint.cu"
#include "adjoint_fragments.cu"
#include "collide_basic.cu"
#include "collide_moments.cu"
#include "collide_mrt.cu"
#include "adjoint_multi.cuh"

extern "C" {

LT_ADJOINT_MULTI_ENTRIES(bgk, d2q9, lt::Bgk, lt::BgkAdjoint, D2Q9)
LT_ADJOINT_MULTI_ENTRIES(bgk, d3q15, lt::Bgk, lt::BgkAdjoint, D3Q15)
LT_ADJOINT_MULTI_ENTRIES(bgk, d3q19, lt::Bgk, lt::BgkAdjoint, D3Q19)
LT_ADJOINT_MULTI_ENTRIES(bgk, d3q27, lt::Bgk, lt::BgkAdjoint, D3Q27)
LT_ADJOINT_MULTI_ENTRIES(trt, d2q9, lt::Trt, lt::TrtAdjoint, D2Q9)
LT_ADJOINT_MULTI_ENTRIES(trt, d3q15, lt::Trt, lt::TrtAdjoint, D3Q15)
LT_ADJOINT_MULTI_ENTRIES(trt, d3q19, lt::Trt, lt::TrtAdjoint, D3Q19)
LT_ADJOINT_MULTI_ENTRIES(trt, d3q27, lt::Trt, lt::TrtAdjoint, D3Q27)
LT_ADJOINT_MULTI_ENTRIES(reg, d2q9, lt::Reg, lt::MatvecAdjoint, D2Q9)
LT_ADJOINT_MULTI_ENTRIES(reg, d3q15, lt::Reg, lt::MatvecAdjoint, D3Q15)
LT_ADJOINT_MULTI_ENTRIES(reg, d3q19, lt::Reg, lt::MatvecAdjoint, D3Q19)
LT_ADJOINT_MULTI_ENTRIES(reg, d3q27, lt::Reg, lt::MatvecAdjoint, D3Q27)
LT_ADJOINT_MULTI_ENTRIES(mrt_from_feq, d3q19, lt::MrtFromFeq,
                         lt::MatvecAdjoint, D3Q19)
LT_ADJOINT_MULTI_ENTRIES(none, d2q9, lt::NoCollide, lt::NoneAdjoint, D2Q9)
LT_ADJOINT_MULTI_ENTRIES(none, d3q15, lt::NoCollide, lt::NoneAdjoint, D3Q15)
LT_ADJOINT_MULTI_ENTRIES(none, d3q19, lt::NoCollide, lt::NoneAdjoint, D3Q19)
LT_ADJOINT_MULTI_ENTRIES(none, d3q27, lt::NoCollide, lt::NoneAdjoint, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
