// The adjoint kernels at 16-bit storage (K3 at 16 bits) for Hopper
// (sm_90a): the exact VJP of one step of a bfloat16 or float16 state, for
// every adjoint spec (bgk, none, trt, matvec, smag), periodic and masked
// (with a null ncm: split mode's frozen re-route alone), on D2Q9, D3Q15,
// D3Q19 and D3Q27.
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel (:131) on a
// 16-bit cotangent: the TPU kernel keeps g and out in the storage dtype
// and computes in float32 (compute_dtype and read_f, :167-174). The
// policies are those of adjoint.cu and adjoint_fragments.cu, unchanged, in
// float32; the storage policy (half_storage.cuh) converts each loaded
// cotangent (and Smagorinsky's f residual) to float32 and rounds each
// stored value once to nearest even. The u residual is float32, as the
// 16-bit emit-u forward writes it. The TPU kernel rounds twice on a
// collide cell (h - t, then + A' + e.B, :236-240, :536-541); this kernel
// rounds once, so the two can differ by a storage ulp.
//
// What bounds them: device memory, at about half the float32 bytes. D3Q19
// with the u residual reads 19 * 2 B of g and 3 * 4 B of u and writes
// 19 * 2 B: 88 B per lattice update (164 B in float32); with the f
// residual 114 B; none 76 B (the masked entries add the 1-byte code). One
// thread per cell with 2-byte loads and stores, as the 16-bit forward.
//
// Plain C interface, loaded with ctypes:
// lt_adjoint_<spec>[_masked]_<stencil>_<bf16|f16>, the arguments of
// adjoint_fragments.cu's entries (BGK takes [tau_inv] as its float64
// parameters).

#define LT_POLICIES_ONLY
#include "adjoint.cu"
#include "adjoint_fragments.cu"
#include "half_storage.cuh"

#define LT_ADJOINT_HALF_ENTRIES(FRAG, STENCIL, POLICY, S)                     \
  LT_ADJOINT_ENTRY(FRAG, STENCIL, POLICY, S, bf16, lt::Bf16)                  \
  LT_ADJOINT_ENTRY(FRAG, STENCIL, POLICY, S, f16, lt::F16Storage)

#define LT_ADJOINT_HALF_STENCILS(FRAG, POLICY)                                \
  LT_ADJOINT_HALF_ENTRIES(FRAG, d2q9, POLICY, D2Q9)                           \
  LT_ADJOINT_HALF_ENTRIES(FRAG, d3q15, POLICY, D3Q15)                         \
  LT_ADJOINT_HALF_ENTRIES(FRAG, d3q19, POLICY, D3Q19)                         \
  LT_ADJOINT_HALF_ENTRIES(FRAG, d3q27, POLICY, D3Q27)

extern "C" {

LT_ADJOINT_HALF_STENCILS(bgk, lt::BgkAdjoint)
LT_ADJOINT_HALF_STENCILS(none, lt::NoneAdjoint)
LT_ADJOINT_HALF_STENCILS(trt, lt::TrtAdjoint)
LT_ADJOINT_HALF_STENCILS(matvec, lt::MatvecAdjoint)
LT_ADJOINT_HALF_STENCILS(smag, lt::SmagAdjoint)
LT_ERROR_STRING_ENTRY

}  // extern "C"
