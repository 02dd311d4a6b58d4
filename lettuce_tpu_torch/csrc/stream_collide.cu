// Fused BGK collide-and-stream step for Hopper (sm_90a).
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel
// with the "bgk" collision fragment, no masks and one step per launch
// (n_sub = 1): it computes the same function as
// fused_stream_collide(f, e, w, opposite, cs, tau_inv), and with EmitU the
// same as fused_stream_collide(..., emit_u=True), which also returns the
// pre-collision velocity u = j / rho as the adjoint kernel's residual
// (adjoint.cu).
//
// What bounds it: device memory. The arithmetic is a few flops per
// population; the traffic is the state itself. D3Q19 in float32 reads
// 19 * 4 B and writes 19 * 4 B per cell: 152 B per lattice update (164 B
// with EmitU, which writes 3 * 4 B of u more). The design reads each
// population once and writes it once:
//   * one thread per lattice cell, threads along the last (fastest) axis,
//     so every f[q, .] load of a warp is coalesced;
//   * the cell's q populations stay in registers; rho and j come from the
//     pair-folded add tree of _moments; the collided populations use the
//     opposite-pair (G, H) cache of the BGK fragment;
//   * each collided population is pushed to out[q, (x + e_q) mod N], the
//     same map as the TPU kernel's pull f_out[q, x] = f_post[q, x - e_q].
//     No neighbour is collided twice and no halo is loaded.
// The step is out of place (f -> out): a push into f itself would race.
// EmitU is a separate instance, so the primal entries never pay its writes.
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance, and one more per instance for EmitU. Each entry launches on
// the stream it is given and returns cudaGetLastError(); it neither
// allocates nor synchronises.

#include <cstdint>

#include <cuda_runtime.h>

#include "stencils.cuh"

namespace {

using namespace lt;

// ---------------------------------------------------------------------------
// per-cell pieces, unrolled over q by template recursion
// ---------------------------------------------------------------------------
template <class S, class T, int q, int a = 0>
__device__ __forceinline__ void add_pair_diff(T dif, T (&j)[S::D]) {
  if constexpr (a < S::D) {
    if constexpr (S::e(q, a) == 1) {
      j[a] = j[a] + dif;
    } else if constexpr (S::e(q, a) == -1) {
      j[a] = j[a] - dif;
    }
    add_pair_diff<S, T, q, a + 1>(dif, j);
  }
}

// rho and j as the pair-folded add tree of _moments: the rest population
// adds to rho; each opposite pair adds its sum to rho and its difference
// to the j components it moves along.
template <class S, class T, int q = 0>
__device__ __forceinline__ void moments(const T (&fv)[S::Q], T& rho,
                                        T (&j)[S::D]) {
  if constexpr (q < S::Q) {
    if constexpr (is_rest<S>(q)) {
      rho = rho + fv[q];
    } else if constexpr (opposite<S>(q) > q) {
      constexpr int p = opposite<S>(q);
      const T s = fv[q] + fv[p];
      const T dif = fv[q] - fv[p];
      rho = rho + s;
      add_pair_diff<S, T, q>(dif, j);
    }
    moments<S, T, q + 1>(fv, rho, j);
  }
}

// e.u / cs^2 along the canonical direction of q's pair.
template <class S, class T, int q, int a = 0>
__device__ __forceinline__ T eu_canonical(const T (&up)[S::D], T acc) {
  if constexpr (a < S::D) {
    constexpr int c = is_canonical<S>(q) ? S::e(q, a) : -S::e(q, a);
    if constexpr (c == 1) {
      acc = acc + up[a];
    } else if constexpr (c == -1) {
      acc = acc - up[a];
    }
    return eu_canonical<S, T, q, a + 1>(up, acc);
  } else {
    return acc;
  }
}

template <class S, class T, int q>
__device__ __forceinline__ void push(T* __restrict__ out, const Neighbours& nb,
                                     T value) {
  out[shifted_index<S, q, 1>(nb)] = value;
}

// BGK with the opposite-pair cache: f_post_q = keep f_q + (G +- H) with
//   G = w (base + quad), H = w trho eu_canonical.
template <class S, class T, int q = 0>
__device__ __forceinline__ void collide_push(const T (&fv)[S::Q],
                                             T* __restrict__ out,
                                             const Neighbours& nb, T keep,
                                             T base, T trho,
                                             const T (&up)[S::D]) {
  if constexpr (q < S::Q) {
    if constexpr (is_rest<S>(q)) {
      push<S, T, q>(out, nb, keep * fv[q] + T(S::w(q)) * base);
    } else if constexpr (is_canonical<S>(q)) {
      constexpr int p = opposite<S>(q);
      const T wq = T(S::w(q));
      const T eu = eu_canonical<S, T, q>(up, T(0));
      const T teu = trho * eu;
      const T H = wq * teu;
      const T G = wq * base + T(0.5 * S::w(q)) * (teu * eu);
      push<S, T, q>(out, nb, keep * fv[q] + (G + H));
      push<S, T, p>(out, nb, keep * fv[p] + (G - H));
    }
    collide_push<S, T, q + 1>(fv, out, nb, keep, base, trho, up);
  }
}

template <class S, class T, bool EmitU>
__global__ void __launch_bounds__(kBlock)
    stream_collide_kernel(const T* __restrict__ f, T* __restrict__ out,
                          T* __restrict__ u_out, int64_t n0, int64_t n1,
                          int64_t n2, T tau_inv, T inv_cs2, T half_inv_cs2) {
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);

  const int64_t cell = (i * n1 + j) * n2 + k;
  T fv[S::Q];
#pragma unroll
  for (int q = 0; q < S::Q; ++q) fv[q] = __ldg(f + q * nb.n + cell);

  T rho = T(0);
  T jm[S::D];
#pragma unroll
  for (int a = 0; a < S::D; ++a) jm[a] = T(0);
  moments<S, T>(fv, rho, jm);

  const T inv_rho = T(1) / rho;
  T up[S::D];
  T u2 = T(0);
#pragma unroll
  for (int a = 0; a < S::D; ++a) {
    const T ua = jm[a] * inv_rho;
    if constexpr (EmitU) u_out[a * nb.n + cell] = ua;
    u2 = u2 + ua * ua;
    up[a] = ua * inv_cs2;
  }

  const T keep = T(1) - tau_inv;
  const T base = tau_inv * (rho - rho * (u2 * half_inv_cs2));
  const T trho = tau_inv * rho;
  collide_push<S, T>(fv, out, nb, keep, base, trho, up);
}

template <class S, class T, bool EmitU>
int launch(const void* f, void* out, void* u_out, int64_t n0, int64_t n1,
           int64_t n2, T tau_inv, double cs, int device, void* stream) {
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  const int err = use_device(device);
  if (err != 0) return err;
  const double cs2 = cs * cs;
  stream_collide_kernel<S, T, EmitU>
      <<<launch_grid(n0, n1, n2), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f), static_cast<T*>(out),
          static_cast<T*>(u_out), n0, n1, n2, tau_inv, T(1.0 / cs2),
          T(0.5 / cs2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LT_ENTRY(NAME, S, T)                                                  \
  int NAME(const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,     \
           T tau_inv, double cs, int device, void* stream) {                  \
    return launch<S, T, false>(f, out, nullptr, n0, n1, n2, tau_inv, cs,     \
                               device, stream);                               \
  }

#define LT_ENTRY_EMIT_U(NAME, S, T)                                           \
  int NAME(const void* f, void* out, void* u_out, int64_t n0, int64_t n1,    \
           int64_t n2, T tau_inv, double cs, int device, void* stream) {      \
    return launch<S, T, true>(f, out, u_out, n0, n1, n2, tau_inv, cs,        \
                              device, stream);                                \
  }

extern "C" {

LT_ENTRY(lt_stream_collide_d2q9_f32, D2Q9, float)
LT_ENTRY(lt_stream_collide_d2q9_f64, D2Q9, double)
LT_ENTRY(lt_stream_collide_d3q15_f32, D3Q15, float)
LT_ENTRY(lt_stream_collide_d3q15_f64, D3Q15, double)
LT_ENTRY(lt_stream_collide_d3q19_f32, D3Q19, float)
LT_ENTRY(lt_stream_collide_d3q19_f64, D3Q19, double)
LT_ENTRY(lt_stream_collide_d3q27_f32, D3Q27, float)
LT_ENTRY(lt_stream_collide_d3q27_f64, D3Q27, double)

LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d2q9_f32, D2Q9, float)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d2q9_f64, D2Q9, double)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q15_f32, D3Q15, float)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q15_f64, D3Q15, double)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q19_f32, D3Q19, float)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q19_f64, D3Q19, double)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q27_f32, D3Q27, float)
LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_d3q27_f64, D3Q27, double)

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
