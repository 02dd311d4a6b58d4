// Adjoint of the fused BGK collide-and-stream step for Hopper (sm_90a).
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel for the
// ("bgk", tau_inv) spec with the emitted-u residual: it computes the same
// function as
// fused_adjoint(u, g, e, w, opposite, cs, ("bgk", tau_inv),
//               residual_u=True),
// the exact vector-Jacobian product of one step of stream_collide.cu. For
// the cotangent g of the step output and the pre-collision velocity u that
// the forward emitted, per cell x:
//   h_q = g_q((x + e_q) mod N)          the transpose of the forward push;
//   t_q = tau_inv h_q;
//   ct_q(x) = (h_q - t_q) + (A' + e_q . B)   (adjoint.cuh).
// The Masked instances transpose the forward's masked kernel: frozen
// populations re-route the pulled cotangent, and the cell's code selects
// the BGK transpose, bounce back, zero or identity (adjoint.cuh).
//
// What bounds it: device memory. D3Q19 in float32 reads 19 * 4 B of g and
// 3 * 4 B of u and writes 19 * 4 B per cell: 164 B per lattice update (the
// masked instances add the 1-byte code, and read u on collide cells only).
// One thread per cell along the fastest axis, as in the forward.
//
// The kernel templates live in adjoint.cuh, shared with the other adjoint
// specs (adjoint_fragments.cu); this source holds the BGK instances.
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance, periodic and Masked. Each entry launches on the stream it is
// given and returns cudaGetLastError(); it neither allocates nor
// synchronises.

#include "adjoint.cuh"

namespace lt {

template <class S_, class T_>
struct BgkAdjoint {
  using S = S_;
  using T = T_;
  static constexpr Residual kResidual = kResidualU;
  struct Params {
    T tau_inv;
    EquilibriumConsts<T> c;
  };

  static Params make(T tau_inv, double cs) {
    return Params{tau_inv, equilibrium_consts<T>(cs)};
  }

  // params: [tau_inv] (the blocked adjoint's entries, adjoint_multi.cu)
  static Params load(const double* params, double cs) {
    return make(T(params[0]), cs);
  }

  template <class Sink>
  __device__ __forceinline__ static void transpose_u(const Params& p,
                                                     T (&h)[S::Q],
                                                     const T (&u)[S::D],
                                                     const Sink& sink) {
    equilibrium_transpose<S, T, false>(
        h, u, p.c,
        [&](auto K_, T& tp, T& tm) {
          constexpr int q = pair_first<S>(decltype(K_)::value);
          tp = p.tau_inv * h[q];
          tm = p.tau_inv * h[opposite<S>(q)];
        },
        [&] { return p.tau_inv * h[0]; }, NoExtra{}, NoExtra{}, sink);
  }

  template <class St>
  __device__ __forceinline__ static void transpose(
      const Params& p, T (&h)[S::Q], const T* __restrict__ res, int64_t n,
      int64_t cell, typename St::V* __restrict__ out) {
    T u[S::D];
    load_u<S, T>(res, n, cell, u);
    transpose_u(p, h, u, CellSink<St>{out, n, cell});
  }
};

}  // namespace lt

// adjoint_multi.cu includes this source for its policy alone
#ifndef LT_POLICIES_ONLY

#define LT_ENTRY(NAME, S, T)                                                  \
  int NAME(const void* g, const void* u, void* out, int64_t n0, int64_t n1,  \
           int64_t n2, T tau_inv, double cs, int device, void* stream) {      \
    using A = lt::BgkAdjoint<lt::S, T>;                                       \
    return lt::launch_adjoint<A>(g, u, out, n0, n1, n2,                       \
                                 A::make(tau_inv, cs), device, stream);       \
  }

#define LT_ENTRY_MASKED(NAME, S, T)                                           \
  int NAME(const void* g, const void* u, void* out, const void* ncm,         \
           const void* nsm, const int32_t* kinds, int64_t n0, int64_t n1,     \
           int64_t n2, T tau_inv, double cs, int device, void* stream) {      \
    using A = lt::BgkAdjoint<lt::S, T>;                                       \
    return lt::launch_masked_adjoint<A>(g, u, out, ncm, nsm, kinds, n0, n1,  \
                                        n2, A::make(tau_inv, cs), device,    \
                                        stream);                              \
  }

#define LT_ENTRIES(STENCIL, S)                                                \
  LT_ENTRY(lt_stream_collide_adjoint_##STENCIL##_f32, S, float)               \
  LT_ENTRY(lt_stream_collide_adjoint_##STENCIL##_f64, S, double)              \
  LT_ENTRY_MASKED(lt_stream_collide_adjoint_masked_##STENCIL##_f32, S, float) \
  LT_ENTRY_MASKED(lt_stream_collide_adjoint_masked_##STENCIL##_f64, S, double)

extern "C" {

LT_ENTRIES(d2q9, D2Q9)
LT_ENTRIES(d3q15, D3Q15)
LT_ENTRIES(d3q19, D3Q19)
LT_ENTRIES(d3q27, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
