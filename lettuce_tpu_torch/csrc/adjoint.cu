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
//   S0 = sum w t, S1_a = sum w e_a t, S2_ab = sum w e_a e_b t
//     (pair-folded: one weight multiply per opposite pair);
//   A' and B from the moments and u (adjoint.py's module docstring);
//   ct_q(x) = (h_q - t_q) + (A' + e_q . B).
// The sums run in the order of the TPU kernel (pairs in the order of
// adjoint.py::_pairs_of, the rest direction last).
//
// The Masked instances transpose the forward's masked kernel (the mask
// routing of _adjoint_kernel, adjoint.py:151-159, :218-241, :534-539):
//   * frozen populations re-route the pulled cotangent,
//     h_q(x) = (nsm_q(x + e_q) ? 0 : g_q(x + e_q)) + (nsm_q(x) ? g_q(x) : 0),
//     reading the mask at both places (no pre-shifted copy);
//   * the cell's code selects: the BGK transpose above on collide cells
//     only, h_opp(q) on bounce-back cells, 0 on equilibrium cells (constant
//     in f), h_q on identity cells (the outlets the replay rewrites).
//
// What bounds it: device memory. D3Q19 in float32 reads 19 * 4 B of g and
// 3 * 4 B of u and writes 19 * 4 B per cell: 164 B per lattice update (the
// masked instances add the 1-byte code, and read u on collide cells only).
// One thread per cell along the fastest axis, as in the forward; here the
// shifted accesses are the loads (a warp's g_q loads straddle two 128 B
// lines for e_q with a component along the fastest axis) and every store
// is aligned and coalesced, the mirror image of the forward's push. The
// cotangent stays in registers between the moment sums and the writes.
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance, periodic and Masked. Each entry launches on the stream it is
// given and returns cudaGetLastError(); it neither allocates nor
// synchronises.

#include <cstdint>

#include <cuda_runtime.h>

#include "stencils.cuh"

namespace {

using namespace lt;

// Index of S2_ab (a <= b) in the packed upper triangle.
template <class S>
__host__ __device__ constexpr int sym(int a, int b) {
  return a * S::D - a * (a - 1) / 2 + (b - a);
}

template <class S, class T, int q = 0>
__device__ __forceinline__ void pull(const T* __restrict__ g,
                                     const Neighbours& nb, T (&h)[S::Q]) {
  if constexpr (q < S::Q) {
    h[q] = __ldg(g + shifted_index<S, q, 1>(nb));
    pull<S, T, q + 1>(g, nb, h);
  }
}

template <class S, class T, int q, int a = 0>
__device__ __forceinline__ void add_s1(T wd, T (&s1)[S::D]) {
  if constexpr (a < S::D) {
    if constexpr (S::e(q, a) == 1) {
      s1[a] = s1[a] + wd;
    } else if constexpr (S::e(q, a) == -1) {
      s1[a] = s1[a] - wd;
    }
    add_s1<S, T, q, a + 1>(wd, s1);
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

// S0, S1 and S2 over the opposite pairs (q < opposite(q)), in q order.
template <class S, class T, int q = 0>
__device__ __forceinline__ void pair_moments(const T (&h)[S::Q], T tau_inv,
                                             T& s0, T (&s1)[S::D],
                                             T (&s2)[S::D * (S::D + 1) / 2]) {
  if constexpr (q < S::Q) {
    if constexpr (!is_rest<S>(q) && opposite<S>(q) > q) {
      constexpr int p = opposite<S>(q);
      const T wq = T(S::w(q));
      const T tp = tau_inv * h[q];
      const T tm = tau_inv * h[p];
      const T ws = wq * (tp + tm);
      const T wd = wq * (tp - tm);
      s0 = s0 + ws;
      add_s1<S, T, q>(wd, s1);
      add_s2<S, T, q>(ws, s2);
    }
    pair_moments<S, T, q + 1>(h, tau_inv, s0, s1, s2);
  }
}

template <class S, class T, int q = 0>
__device__ __forceinline__ void rest_moment(const T (&h)[S::Q], T tau_inv,
                                            T& s0) {
  if constexpr (q < S::Q) {
    if constexpr (is_rest<S>(q)) s0 = s0 + T(S::w(q)) * (tau_inv * h[q]);
    rest_moment<S, T, q + 1>(h, tau_inv, s0);
  }
}

// e_q . B along the pair's first direction q.
template <class S, class T, int q, int a = 0>
__device__ __forceinline__ T e_dot(const T (&bv)[S::D], T acc) {
  if constexpr (a < S::D) {
    if constexpr (S::e(q, a) == 1) {
      acc = acc + bv[a];
    } else if constexpr (S::e(q, a) == -1) {
      acc = acc - bv[a];
    }
    return e_dot<S, T, q, a + 1>(bv, acc);
  } else {
    return acc;
  }
}

template <class S, class T, int q = 0>
__device__ __forceinline__ void write_ct(const T (&h)[S::Q], T tau_inv, T ap,
                                         const T (&bv)[S::D],
                                         T* __restrict__ out, int64_t n,
                                         int64_t cell) {
  if constexpr (q < S::Q) {
    if constexpr (is_rest<S>(q)) {
      out[q * n + cell] = (h[q] - tau_inv * h[q]) + ap;
    } else if constexpr (opposite<S>(q) > q) {
      constexpr int p = opposite<S>(q);
      const T eb = e_dot<S, T, q>(bv, T(0));
      out[q * n + cell] = (h[q] - tau_inv * h[q]) + (ap + eb);
      out[p * n + cell] = (h[p] - tau_inv * h[p]) + (ap - eb);
    }
    write_ct<S, T, q + 1>(h, tau_inv, ap, bv, out, n, cell);
  }
}

// Pull with frozen populations (see the header comment).
template <class S, class T, int q = 0>
__device__ __forceinline__ void pull_frozen(const T* __restrict__ g,
                                            const uint8_t* __restrict__ nsm,
                                            const Neighbours& nb,
                                            int64_t cell, T (&h)[S::Q]) {
  if constexpr (q < S::Q) {
    const int64_t src = shifted_index<S, q, 1>(nb);
    const int64_t here = q * nb.n + cell;
    const T streamed = nsm[src] ? T(0) : __ldg(g + src);
    const T kept = nsm[here] ? __ldg(g + here) : T(0);
    h[q] = streamed + kept;
    pull_frozen<S, T, q + 1>(g, nsm, nb, cell, h);
  }
}

// The BGK transpose of a collide cell from its pulled cotangent h.
template <class S, class T>
__device__ __forceinline__ void collide_adjoint(const T (&h)[S::Q],
                                                const T* __restrict__ u,
                                                T* __restrict__ out,
                                                int64_t n, int64_t cell,
                                                T tau_inv, T inv_cs2,
                                                T half_inv_cs2,
                                                T half_inv_cs4) {
  constexpr int D = S::D;
  T uv[D];
  T u2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    uv[a] = __ldg(u + a * n + cell);
    u2 = u2 + uv[a] * uv[a];
  }

  T s0 = T(0);
  T s1[D];
  T s2[D * (D + 1) / 2];
#pragma unroll
  for (int a = 0; a < D; ++a) s1[a] = T(0);
#pragma unroll
  for (int c = 0; c < D * (D + 1) / 2; ++c) s2[c] = T(0);
  pair_moments<S, T>(h, tau_inv, s0, s1, s2);
  rest_moment<S, T>(h, tau_inv, s0);

  // T_a = sum_b u_b S2_ab, then A, B and A' = A - u . B
  T ta[D];
  T us1 = T(0);
  T uus2 = T(0);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    T acc = T(0);
#pragma unroll
    for (int b = 0; b < D; ++b)
      acc = acc + uv[b] * s2[a <= b ? sym<S>(a, b) : sym<S>(b, a)];
    ta[a] = acc;
    us1 = us1 + uv[a] * s1[a];
  }
#pragma unroll
  for (int a = 0; a < D; ++a) uus2 = uus2 + uv[a] * ta[a];

  const T A = s0 * (T(1) - u2 * half_inv_cs2) + us1 * inv_cs2 +
              uus2 * half_inv_cs4;
  T bv[D];
  T ap = A;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    bv[a] = ((-uv[a] * s0 + s1[a]) + ta[a] * inv_cs2) * inv_cs2;
    ap = ap - uv[a] * bv[a];
  }

  write_ct<S, T>(h, tau_inv, ap, bv, out, n, cell);
}

// The transpose of a boundary cell's replacement.
template <class S, class T, int q = 0>
__device__ __forceinline__ void boundary_adjoint(int kind,
                                                 const T (&h)[S::Q],
                                                 T* __restrict__ out,
                                                 int64_t n, int64_t cell) {
  if constexpr (q < S::Q) {
    T v;
    if (kind == kBounceBack) {
      v = h[opposite<S>(q)];
    } else if (kind == kIdentity) {
      v = h[q];
    } else {  // the equilibrium kinds are constant in f
      v = T(0);
    }
    out[q * n + cell] = v;
    boundary_adjoint<S, T, q + 1>(kind, h, out, n, cell);
  }
}

template <class S, class T>
__global__ void __launch_bounds__(kBlock)
    adjoint_kernel(const T* __restrict__ g, const T* __restrict__ u,
                   T* __restrict__ out, int64_t n0, int64_t n1, int64_t n2,
                   T tau_inv, T inv_cs2, T half_inv_cs2, T half_inv_cs4) {
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T h[S::Q];
  pull<S, T>(g, nb, h);
  collide_adjoint<S, T>(h, u, out, nb.n, cell, tau_inv, inv_cs2,
                        half_inv_cs2, half_inv_cs4);
}

template <class S, class T>
__global__ void __launch_bounds__(kBlock) masked_adjoint_kernel(
    const T* __restrict__ g, const T* __restrict__ u, T* __restrict__ out,
    const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
    const __grid_constant__ CodeKinds kinds, int64_t n0, int64_t n1,
    int64_t n2, T tau_inv, T inv_cs2, T half_inv_cs2, T half_inv_cs4) {
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T h[S::Q];
  if (nsm == nullptr) {
    pull<S, T>(g, nb, h);
  } else {
    pull_frozen<S, T>(g, nsm, nb, cell, h);
  }
  const int kind = kind_of(kinds.kind, ncm[cell]);
  if (kind == kCollide) {
    collide_adjoint<S, T>(h, u, out, nb.n, cell, tau_inv, inv_cs2,
                          half_inv_cs2, half_inv_cs4);
  } else {
    boundary_adjoint<S, T>(kind, h, out, nb.n, cell);
  }
}

template <class S, class T>
int launch(const void* g, const void* u, void* out, int64_t n0, int64_t n1,
           int64_t n2, T tau_inv, double cs, int device, void* stream) {
  static_assert(pair_weights_symmetric<S>(),
                "the pair-folded moments need w[q] == w[opposite[q]]");
  const int err = use_device(device);
  if (err != 0) return err;
  const double inv_cs2 = 1.0 / (cs * cs);
  adjoint_kernel<S, T><<<launch_grid(n0, n1, n2), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(u),
      static_cast<T*>(out), n0, n1, n2, tau_inv, T(inv_cs2),
      T(0.5 * inv_cs2), T(0.5 * inv_cs2 * inv_cs2));
  return static_cast<int>(cudaGetLastError());
}

template <class S, class T>
int launch_masked(const void* g, const void* u, void* out, const void* ncm,
                  const void* nsm, const int32_t* kinds, int64_t n0,
                  int64_t n1, int64_t n2, T tau_inv, double cs, int device,
                  void* stream) {
  static_assert(pair_weights_symmetric<S>(),
                "the pair-folded moments need w[q] == w[opposite[q]]");
  CodeKinds table;
  if (!fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = use_device(device);
  if (err != 0) return err;
  const double inv_cs2 = 1.0 / (cs * cs);
  masked_adjoint_kernel<S, T><<<launch_grid(n0, n1, n2), kBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const T*>(u),
      static_cast<T*>(out), static_cast<const uint8_t*>(ncm),
      static_cast<const uint8_t*>(nsm), table, n0, n1, n2, tau_inv,
      T(inv_cs2), T(0.5 * inv_cs2), T(0.5 * inv_cs2 * inv_cs2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LT_ENTRY(NAME, S, T)                                                  \
  int NAME(const void* g, const void* u, void* out, int64_t n0, int64_t n1,  \
           int64_t n2, T tau_inv, double cs, int device, void* stream) {      \
    return launch<S, T>(g, u, out, n0, n1, n2, tau_inv, cs, device, stream);  \
  }

#define LT_ENTRY_MASKED(NAME, S, T)                                           \
  int NAME(const void* g, const void* u, void* out, const void* ncm,         \
           const void* nsm, const int32_t* kinds, int64_t n0, int64_t n1,     \
           int64_t n2, T tau_inv, double cs, int device, void* stream) {      \
    return launch_masked<S, T>(g, u, out, ncm, nsm, kinds, n0, n1, n2,       \
                               tau_inv, cs, device, stream);                  \
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

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
