// The adjoint kernels of the fused collide-and-stream step as templates
// over an adjoint policy, shared by adjoint.cu (the BGK instances) and
// adjoint_fragments.cu (the other adjoint specs).
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_kernel: one thread
// per cell pulls the cotangent of the step's output along -e (re-routed
// where the no-streaming mask froze populations), then either transposes
// the collision (the policy) or, on a boundary cell of the masked kernel,
// the code's replacement.
//
// A policy A is a struct with the stencil S, the scalar T, kResidual (what
// the kernel reads beside the cotangent: the emitted pre-collision u
// [d, *grid], the step's input f [q, *grid], or nothing), a Params struct
// (passed by value as a __grid_constant__ kernel parameter), a host-side
// Params load(params, cs) from the C entry's float64 array, and a
// __device__ transpose<St>(p, h, res, n, cell, out) that writes the q
// values of ct = J^T h for one cell in the storage St; the policies with a
// u residual (or none) also
// have transpose_u(p, h, u, sink), the same with u given, handing each
// value to a sink's put<q> (the blocked adjoint, adjoint_multi.cuh, sinks
// into its tile). Every f-linear policy (f' = f - M (f - feq(f)))
// hands t = M^T h, pair by pair, to equilibrium_transpose, which adds the
// transposed equilibrium Jacobian:
//   S0 = sum w t, S1_a = sum w e_a t, S2_ab = sum w e_a e_b t
//     (pair-folded: one weight multiply per opposite pair),
//   A' and B from the moments and u (ops/cuda/adjoint.py's docstring),
//   ct_q = (h_q - t_q) + (A' + e_q . B) [+ X_q],
// with the sums in the order of the TPU kernel (pairs in the order of
// adjoint.py::_pairs_of, the rest direction last).
//
// The masked kernel transposes the forward's masked kernel (the mask
// routing of _adjoint_kernel, adjoint.py:151-159, :218-241, :534-539):
//   * frozen populations re-route the pulled cotangent,
//     h_q(x) = (nsm_q(x + e_q) ? 0 : g_q(x + e_q)) + (nsm_q(x) ? g_q(x) : 0),
//     reading the mask at both places (no pre-shifted copy);
//   * the cell's code selects: the policy on collide cells only, h_opp(q)
//     on bounce-back cells, 0 on equilibrium cells (constant in f), h_q on
//     identity cells (the outlets the replay rewrites);
//   * with no code mask (ncm == nullptr) every cell is a collide cell: the
//     frozen re-route alone, which split mode's streaming transpose needs
//     (build_adjoint_step :763-764, :786-788).
//
// The storage policy St (stream_collide.cuh's Same<T>, half_storage.cuh's
// Bf16 and F16Storage) says how the cotangent is held in device memory. A
// 16-bit cotangent (K3 at 16 bits, adjoint_half.cu) loads as float32
// (exact), every sum runs in float32 in the same order, and each stored
// value rounds once to nearest even (the TPU kernel's compute_dtype,
// adjoint.py:167-174). A u residual is always in the compute type (the
// 16-bit emit-u forward writes it in float32, stream_collide.py:1778-1779);
// an f residual is stored like the state and loads like the cotangent.
// Same<T> converts nothing, so the float32 and float64 instances compile
// to what they were before the storage split.
//
// What bounds it: device memory. The shifted accesses are the loads (a
// warp's g_q loads straddle two 128 B lines for e_q with a component along
// the fastest axis); every store is aligned and coalesced, the mirror image
// of the forward's push. The cotangent stays in registers.

#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "stream_collide.cuh"

namespace lt {

enum Residual : int { kResidualNone = 0, kResidualU = 1, kResidualF = 2 };

// Index of S2_ab (a <= b) in the packed upper triangle.
template <class S>
__host__ __device__ constexpr int sym(int a, int b) {
  return a * S::D - a * (a - 1) / 2 + (b - a);
}

// The residual a policy reads: the pre-collision u in the compute type,
// or the step's input f stored like the state (St::V).
template <class A, class St>
using residual_t = std::conditional_t<A::kResidual == kResidualF,
                                      typename St::V, typename A::T>;

template <class S, class St, int q = 0>
__device__ __forceinline__ void pull(const typename St::V* __restrict__ g,
                                     const Neighbours& nb,
                                     typename St::T (&h)[S::Q]) {
  if constexpr (q < S::Q) {
    h[q] = St::raw(g + shifted_index<S, q, 1>(nb));
    pull<S, St, q + 1>(g, nb, h);
  }
}

// Pull with frozen populations (see the header comment).
template <class S, class St, int q = 0>
__device__ __forceinline__ void pull_frozen(
    const typename St::V* __restrict__ g, const uint8_t* __restrict__ nsm,
    const Neighbours& nb, int64_t cell, typename St::T (&h)[S::Q]) {
  using T = typename St::T;
  if constexpr (q < S::Q) {
    const int64_t src = shifted_index<S, q, 1>(nb);
    const int64_t here = q * nb.n + cell;
    const T streamed = nsm[src] ? T(0) : St::raw(g + src);
    const T kept = nsm[here] ? St::raw(g + here) : T(0);
    h[q] = streamed + kept;
    pull_frozen<S, St, q + 1>(g, nsm, nb, cell, h);
  }
}

template <class S, class T, int q, int a = 0, int b = 0>
__device__ __forceinline__ void add_s2(T ws, T (&s2)[S::D * (S::D + 1) / 2]) {
  if constexpr (a < S::D) {
    if constexpr (b < S::D) {
      constexpr int c = S::e(q, a) * S::e(q, b);
      if constexpr (c == 1) {
        s2[sym<S>(a, b)] = s2[sym<S>(a, b)] + ws;
      } else if constexpr (c == -1) {
        s2[sym<S>(a, b)] = s2[sym<S>(a, b)] - ws;
      }
      add_s2<S, T, q, a, b + 1>(ws, s2);
    } else {
      add_s2<S, T, q, a + 1, a + 1>(ws, s2);
    }
  }
}

// e_q . v along direction q.
template <class S, class T, int q, int a = 0>
__device__ __forceinline__ T e_dot(const T (&v)[S::D], T acc) {
  if constexpr (a < S::D) {
    if constexpr (S::e(q, a) == 1) {
      acc = acc + v[a];
    } else if constexpr (S::e(q, a) == -1) {
      acc = acc - v[a];
    }
    return e_dot<S, T, q, a + 1>(v, acc);
  } else {
    return acc;
  }
}

// The transposed-equilibrium constants of every f-linear policy.
template <class T>
struct EquilibriumConsts {
  T inv_cs2, half_inv_cs2, half_inv_cs4;
};

template <class T>
EquilibriumConsts<T> equilibrium_consts(double cs) {
  const double inv_cs2 = 1.0 / (cs * cs);
  return EquilibriumConsts<T>{T(inv_cs2), T(0.5 * inv_cs2),
                              T(0.5 * inv_cs2 * inv_cs2)};
}

// Where a cell's cotangent goes: out[q, cell], in the storage St.
template <class St>
struct CellSink {
  typename St::V* __restrict__ out;
  int64_t n, cell;

  template <int q>
  __device__ __forceinline__ void put(typename St::T value) const {
    out[q * n + cell] = St::pack(value);
  }
};

// S0 += w (tp + tm), S1 += w e_q (tp - tm), S2 += w e_q e_q (tp + tm): the
// weighted moments of t over the pair (q, opposite(q)), one weight
// multiply for the pair.
template <class S, class T, int q>
__device__ __forceinline__ void add_pair_moments(
    T tp, T tm, T& s0, T (&s1)[S::D], T (&s2)[S::D * (S::D + 1) / 2]) {
  const T wq = T(S::w(q));
  const T ws = wq * (tp + tm);
  const T wd = wq * (tp - tm);
  s0 = s0 + ws;
  add_pair_diff<S, T, q>(wd, s1);
  add_s2<S, T, q>(ws, s2);
}

// A' = A - u . B and B of the transposed equilibrium Jacobian from the
// weighted moments S0, S1, S2 of t and u: sum_p t_p d feq_p / d f_q =
// A' + e_q . B.
template <class S, class T>
__device__ __forceinline__ void equilibrium_ab(
    T s0, const T (&s1)[S::D], const T (&s2)[S::D * (S::D + 1) / 2],
    const T (&u)[S::D], const EquilibriumConsts<T>& c, T& ap,
    T (&bv)[S::D]) {
  constexpr int D = S::D;
  // T_a = sum_b u_b S2_ab, then A, B and A' = A - u . B
  T ta[D];
  T u2 = T(0), us1 = T(0), uus2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    T acc = T(0);
#pragma unroll
    for (int b = 0; b < D; ++b)
      acc = acc + u[b] * s2[a <= b ? sym<S>(a, b) : sym<S>(b, a)];
    ta[a] = acc;
    u2 = u2 + u[a] * u[a];
    us1 = us1 + u[a] * s1[a];
  }
#pragma unroll
  for (int a = 0; a < D; ++a) uus2 = uus2 + u[a] * ta[a];
  const T A = s0 * (T(1) - u2 * c.half_inv_cs2) + us1 * c.inv_cs2 +
              uus2 * c.half_inv_cs4;
  ap = A;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    bv[a] = ((-u[a] * s0 + s1[a]) + ta[a] * c.inv_cs2) * c.inv_cs2;
    ap = ap - u[a] * bv[a];
  }
}

// ct = (h - t) + (A' + e . B) [+ X] for t = M^T h, each value handed to
// sink.put<q>. tpair(K_, tp, tm) gives t on pair K_ (an integral_constant)
// and trest() t on the rest direction; each may read h only on its own
// pair, since h becomes h - t pair by pair. With Extra, xpair(K_, xp, xm)
// and xrest() add the derivative of a relaxation that depends on f
// (Smagorinsky).
template <class S, class T, bool Extra, class TPair, class TRest,
          class XPair, class XRest, class Sink>
__device__ __forceinline__ void equilibrium_transpose(
    T (&h)[S::Q], const T (&u)[S::D], const EquilibriumConsts<T>& c,
    const TPair& tpair, const TRest& trest, const XPair& xpair,
    const XRest& xrest, const Sink& sink) {
  constexpr int D = S::D;
  T s0 = T(0);
  T s1[D];
  T s2[D * (D + 1) / 2];
#pragma unroll
  for (int a = 0; a < D; ++a) s1[a] = T(0);
#pragma unroll
  for (int k = 0; k < D * (D + 1) / 2; ++k) s2[k] = T(0);
  static_for<kPairs<S>>([&](auto K_) {
    constexpr int q = pair_first<S>(decltype(K_)::value);
    constexpr int p = opposite<S>(q);
    T tp, tm;
    tpair(K_, tp, tm);
    add_pair_moments<S, T, q>(tp, tm, s0, s1, s2);
    h[q] = h[q] - tp;
    h[p] = h[p] - tm;
  });
  const T t0 = trest();
  s0 = s0 + T(S::w(0)) * t0;
  h[0] = h[0] - t0;

  T ap, bv[D];
  equilibrium_ab<S, T>(s0, s1, s2, u, c, ap, bv);

  if constexpr (Extra) {
    sink.template put<0>(h[0] + (ap + xrest()));
  } else {
    sink.template put<0>(h[0] + ap);
  }
  static_for<kPairs<S>>([&](auto K_) {
    constexpr int q = pair_first<S>(decltype(K_)::value);
    constexpr int p = opposite<S>(q);
    const T eb = e_dot<S, T, q>(bv, T(0));
    if constexpr (Extra) {
      T xp, xm;
      xpair(K_, xp, xm);
      sink.template put<q>(h[q] + ((ap + eb) + xp));
      sink.template put<p>(h[p] + ((ap - eb) + xm));
    } else {
      sink.template put<q>(h[q] + (ap + eb));
      sink.template put<p>(h[p] + (ap - eb));
    }
  });
}

// the no-op extra of the policies whose relaxation is static
struct NoExtra {
  template <class K, class T>
  __device__ __forceinline__ void operator()(K, T&, T&) const {}
  __device__ __forceinline__ int operator()() const { return 0; }
};

// u from the emitted-u residual
template <class S, class T>
__device__ __forceinline__ void load_u(const T* __restrict__ res, int64_t n,
                                       int64_t cell, T (&u)[S::D]) {
#pragma unroll
  for (int a = 0; a < S::D; ++a) u[a] = __ldg(res + a * n + cell);
}

// The transpose of a boundary cell's replacement.
template <class S, class St, int q = 0>
__device__ __forceinline__ void boundary_adjoint(
    int kind, const typename St::T (&h)[S::Q],
    typename St::V* __restrict__ out, int64_t n, int64_t cell) {
  using T = typename St::T;
  if constexpr (q < S::Q) {
    T v;
    if (kind == kBounceBack) {
      v = h[opposite<S>(q)];
    } else if (kind == kIdentity) {
      v = h[q];
    } else {  // the equilibrium kinds are constant in f
      v = T(0);
    }
    out[q * n + cell] = St::pack(v);
    boundary_adjoint<S, St, q + 1>(kind, h, out, n, cell);
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
template <class A, class St>
__global__ void __launch_bounds__(kBlock)
    adjoint_kernel(const typename St::V* __restrict__ g,
                   const residual_t<A, St>* __restrict__ res,
                   typename St::V* __restrict__ out, int64_t n0, int64_t n1,
                   int64_t n2, const __grid_constant__ typename A::Params p) {
  using S = typename A::S;
  using T = typename A::T;
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T h[S::Q];
  pull<S, St>(g, nb, h);
  A::template transpose<St>(p, h, res, nb.n, cell, out);
}

template <class A, class St>
__global__ void __launch_bounds__(kBlock) masked_adjoint_kernel(
    const typename St::V* __restrict__ g,
    const residual_t<A, St>* __restrict__ res,
    typename St::V* __restrict__ out,
    const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
    const __grid_constant__ CodeKinds kinds, int64_t n0, int64_t n1,
    int64_t n2, const __grid_constant__ typename A::Params p) {
  using S = typename A::S;
  using T = typename A::T;
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T h[S::Q];
  if (nsm == nullptr) {
    pull<S, St>(g, nb, h);
  } else {
    pull_frozen<S, St>(g, nsm, nb, cell, h);
  }
  const int kind =
      ncm == nullptr ? int(kCollide) : kind_of(kinds.kind, ncm[cell]);
  if (kind == kCollide) {
    A::template transpose<St>(p, h, res, nb.n, cell, out);
  } else {
    boundary_adjoint<S, St>(kind, h, out, nb.n, cell);
  }
}

// ---------------------------------------------------------------------------
// host launchers: each returns cudaGetLastError()
// ---------------------------------------------------------------------------
// The storage St computes in the policy's type and holds the state itself
// (the adjoints take no deviations: deviation storage has no gradient).
template <class A, class St>
constexpr bool adjoint_storage_ok() {
  return std::is_same_v<typename A::T, typename St::T> && !St::kDeviation;
}

template <class A, class St = Same<typename A::T>>
int launch_adjoint(const void* g, const void* res, void* out, int64_t n0,
                   int64_t n1, int64_t n2, const typename A::Params& p,
                   int device, void* stream) {
  using S = typename A::S;
  using V = typename St::V;
  using R = residual_t<A, St>;
  static_assert(adjoint_storage_ok<A, St>(),
                "the storage computes in the policy's type, no deviations");
  static_assert(pair_weights_symmetric<S>(),
                "the pair-folded moments need w[q] == w[opposite[q]]");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(sizeof(typename A::Params) + 64 <= kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  const int err = use_device(device);
  if (err != 0) return err;
  adjoint_kernel<A, St><<<launch_grid(n0, n1, n2), kBlock, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(g), static_cast<const R*>(res),
      static_cast<V*>(out), n0, n1, n2, p);
  return static_cast<int>(cudaGetLastError());
}

// ncm may be null (no code routing; kinds is then unread and may be null),
// nsm may be null (nothing frozen).
template <class A, class St = Same<typename A::T>>
int launch_masked_adjoint(const void* g, const void* res, void* out,
                          const void* ncm, const void* nsm,
                          const int32_t* kinds, int64_t n0, int64_t n1,
                          int64_t n2, const typename A::Params& p, int device,
                          void* stream) {
  using S = typename A::S;
  using V = typename St::V;
  using R = residual_t<A, St>;
  static_assert(adjoint_storage_ok<A, St>(),
                "the storage computes in the policy's type, no deviations");
  static_assert(pair_weights_symmetric<S>(),
                "the pair-folded moments need w[q] == w[opposite[q]]");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(sizeof(typename A::Params) + sizeof(CodeKinds) + 96 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  CodeKinds table{};
  if (ncm != nullptr && !fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = use_device(device);
  if (err != 0) return err;
  masked_adjoint_kernel<A, St><<<launch_grid(n0, n1, n2), kBlock, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(g), static_cast<const R*>(res),
      static_cast<V*>(out), static_cast<const uint8_t*>(ncm),
      static_cast<const uint8_t*>(nsm), table, n0, n1, n2, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt

// The C entries of an adjoint policy: periodic and masked, float32 and
// float64, for the policy template POLICY on stencil S. ``params`` is the
// host float64 array the policy's load() reads.
#define LT_ADJOINT_ENTRIES(FRAG, STENCIL, POLICY, S)                          \
  LT_ADJOINT_ENTRY(FRAG, STENCIL, POLICY, S, f32, lt::Same<float>)            \
  LT_ADJOINT_ENTRY(FRAG, STENCIL, POLICY, S, f64, lt::Same<double>)

// The periodic and masked entries of POLICY on S with the storage policy
// STORAGE of the cotangent, whose compute type the policy runs in.
#define LT_ADJOINT_ENTRY(FRAG, STENCIL, POLICY, S, SUFFIX, STORAGE)           \
  int lt_adjoint_##FRAG##_##STENCIL##_##SUFFIX(                               \
      const void* g, const void* res, void* out, int64_t n0, int64_t n1,     \
      int64_t n2, const double* params, double cs, int device,               \
      void* stream) {                                                         \
    using A = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_adjoint<A, STORAGE>(g, res, out, n0, n1, n2,            \
                                          A::load(params, cs), device,       \
                                          stream);                            \
  }                                                                           \
  int lt_adjoint_##FRAG##_masked_##STENCIL##_##SUFFIX(                        \
      const void* g, const void* res, void* out, const void* ncm,            \
      const void* nsm, const int32_t* kinds, int64_t n0, int64_t n1,         \
      int64_t n2, const double* params, double cs, int device,               \
      void* stream) {                                                         \
    using A = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_masked_adjoint<A, STORAGE>(                             \
        g, res, out, ncm, nsm, kinds, n0, n1, n2, A::load(params, cs),       \
        device, stream);                                                      \
  }
