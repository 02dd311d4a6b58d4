// Fused BGK collide-and-stream step for Hopper (sm_90a).
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel
// with the "bgk" collision fragment and one step per launch (n_sub = 1):
//   * the periodic instances compute the same function as
//     fused_stream_collide(f, e, w, opposite, cs, tau_inv) (no masks);
//   * the Masked instances add the kernel's mask pipeline
//     (stream_collide.py:1565-1605): the uint8 no_collision_mask code of
//     each cell selects a kind from a per-code BoundaryTable passed by
//     value (collide, bounce back, constant equilibrium, per-node
//     equilibrium field, identity), and the optional no_streaming_mask
//     freezes populations at their destination;
//   * with EmitU either also writes the pre-collision velocity u = j / rho
//     as the adjoint kernel's residual (adjoint.cu), at every cell.
//
// What bounds it: device memory. The arithmetic is a few flops per
// population; the traffic is the state itself. D3Q19 in float32 reads
// 19 * 4 B and writes 19 * 4 B per cell: 152 B per lattice update (164 B
// with EmitU, which writes 3 * 4 B of u more). The masked instances add the
// 1-byte code (D2Q9 float32: 73 B against 72), the 2 q bytes of the
// no-streaming mask only when a flow has one, and the field only on the
// cells whose code reads it. The design reads each population once and
// writes it once:
//   * one thread per lattice cell, threads along the last (fastest) axis,
//     so every f[q, .] load of a warp is coalesced;
//   * the cell's q populations stay in registers; rho and j come from the
//     pair-folded add tree of _moments; the collided populations use the
//     opposite-pair (G, H) cache of the BGK fragment;
//   * each post-collision population is pushed to out[q, (x + e_q) mod N],
//     the same map as the TPU kernel's pull f_out[q, x] = f_post[q, x - e_q].
//     No neighbour is collided twice and no halo is loaded.
// The no-streaming mask in the push: the TPU kernel pulls
// out[q, x] = nsm[q, x] ? f_post[q, x] : f_post[q, x - e_q]. Here thread x
// writes f_post[q, x] to out[q, x] when nsm[q, x] is set, and pushes it to
// x + e_q only when nsm[q, x + e_q] is clear, so every output element is
// written by exactly one thread (the forward mirror of the adjoint's
// re-routing) and a step is deterministic.
// The step is out of place (f -> out): a push into f itself would race.
// EmitU and Masked are separate instances, so the periodic primal entries
// never pay for the masks or the u writes.
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance, for each of periodic, periodic EmitU, Masked and Masked EmitU.
// Each entry launches on the stream it is given and returns
// cudaGetLastError(); it neither allocates nor synchronises.

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

// Where a post-collision population goes: the periodic push, or the push
// with frozen populations (nsm == nullptr: nothing frozen).
template <class S, class T>
struct PeriodicStore {
  T* out;
  const Neighbours& nb;

  template <int q>
  __device__ __forceinline__ void put(T value) const {
    out[shifted_index<S, q, 1>(nb)] = value;
  }
};

template <class S, class T>
struct MaskedStore {
  T* out;
  const Neighbours& nb;
  int64_t cell;
  const uint8_t* nsm;

  template <int q>
  __device__ __forceinline__ void put(T value) const {
    const int64_t dst = shifted_index<S, q, 1>(nb);
    if (nsm == nullptr) {
      out[dst] = value;
      return;
    }
    const int64_t here = q * nb.n + cell;
    if (nsm[here]) out[here] = value;  // frozen at its own node
    if (!nsm[dst]) out[dst] = value;   // streamed unless frozen there
  }
};

// BGK with the opposite-pair cache: f_post_q = keep f_q + (G +- H) with
//   G = w (base + quad), H = w trho eu_canonical.
template <class S, class T, class Store, int q = 0>
__device__ __forceinline__ void collide_push(const T (&fv)[S::Q],
                                             const Store& store, T keep,
                                             T base, T trho,
                                             const T (&up)[S::D]) {
  if constexpr (q < S::Q) {
    if constexpr (is_rest<S>(q)) {
      store.template put<q>(keep * fv[q] + T(S::w(q)) * base);
    } else if constexpr (is_canonical<S>(q)) {
      constexpr int p = opposite<S>(q);
      const T wq = T(S::w(q));
      const T eu = eu_canonical<S, T, q>(up, T(0));
      const T teu = trho * eu;
      const T H = wq * teu;
      const T G = wq * base + T(0.5 * S::w(q)) * (teu * eu);
      store.template put<q>(keep * fv[q] + (G + H));
      store.template put<p>(keep * fv[p] + (G - H));
    }
    collide_push<S, T, Store, q + 1>(fv, store, keep, base, trho, up);
  }
}

// A boundary cell's replacement, pushed like a collided population.
template <class S, class T, class Store, int q = 0>
__device__ __forceinline__ void replace_push(int kind, const T* values,
                                             const T (&fv)[S::Q],
                                             const T* __restrict__ feq_field,
                                             int64_t n, int64_t cell,
                                             const Store& store) {
  if constexpr (q < S::Q) {
    T v;
    if (kind == kBounceBack) {
      v = fv[opposite<S>(q)];
    } else if (kind == kEquilibrium) {
      v = values[q];
    } else if (kind == kEquilibriumField) {
      v = __ldg(feq_field + q * n + cell);
    } else {
      v = fv[q];
    }
    store.template put<q>(v);
    replace_push<S, T, Store, q + 1>(kind, values, fv, feq_field, n, cell,
                                     store);
  }
}

// The cell's populations, rho, u / cs^2 and u.u, with u written to u_out
// when EmitU.
template <class S, class T, bool EmitU>
__device__ __forceinline__ void load_moments(const T* __restrict__ f,
                                             T* __restrict__ u_out,
                                             const Neighbours& nb,
                                             int64_t cell, T inv_cs2,
                                             T (&fv)[S::Q], T& rho,
                                             T (&up)[S::D], T& u2) {
#pragma unroll
  for (int q = 0; q < S::Q; ++q) fv[q] = __ldg(f + q * nb.n + cell);

  rho = T(0);
  T jm[S::D];
#pragma unroll
  for (int a = 0; a < S::D; ++a) jm[a] = T(0);
  moments<S, T>(fv, rho, jm);

  const T inv_rho = T(1) / rho;
  u2 = T(0);
#pragma unroll
  for (int a = 0; a < S::D; ++a) {
    const T ua = jm[a] * inv_rho;
    if constexpr (EmitU) u_out[a * nb.n + cell] = ua;
    u2 = u2 + ua * ua;
    up[a] = ua * inv_cs2;
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

  T fv[S::Q], up[S::D], rho, u2;
  load_moments<S, T, EmitU>(f, u_out, nb, cell, inv_cs2, fv, rho, up, u2);

  const T keep = T(1) - tau_inv;
  const T base = tau_inv * (rho - rho * (u2 * half_inv_cs2));
  const T trho = tau_inv * rho;
  collide_push<S, T>(fv, PeriodicStore<S, T>{out, nb}, keep, base, trho,
                     up);
}

template <class S, class T, bool EmitU>
__global__ void __launch_bounds__(kBlock) masked_stream_collide_kernel(
    const T* __restrict__ f, T* __restrict__ out, T* __restrict__ u_out,
    const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
    const T* __restrict__ feq_field,
    const __grid_constant__ BoundaryTable<T> table, int64_t n0, int64_t n1,
    int64_t n2, T tau_inv, T inv_cs2, T half_inv_cs2) {
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T fv[S::Q], up[S::D], rho, u2;
  load_moments<S, T, EmitU>(f, u_out, nb, cell, inv_cs2, fv, rho, up, u2);

  const int code = ncm[cell];
  const int kind = kind_of(table.kind, code);
  const MaskedStore<S, T> store{out, nb, cell, nsm};
  if (kind == kCollide) {
    const T keep = T(1) - tau_inv;
    const T base = tau_inv * (rho - rho * (u2 * half_inv_cs2));
    const T trho = tau_inv * rho;
    collide_push<S, T>(fv, store, keep, base, trho, up);
  } else {
    const T* values = table.value[code < kMaxCodes ? code : 0];
    replace_push<S, T>(kind, values, fv, feq_field, nb.n, cell, store);
  }
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

template <class S, class T, bool EmitU>
int launch_masked(const void* f, void* out, void* u_out, const void* ncm,
                  const void* nsm, const void* feq_field,
                  const int32_t* kinds, const double* values, int64_t n0,
                  int64_t n1, int64_t n2, T tau_inv, double cs, int device,
                  void* stream) {
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  static_assert(S::Q <= kMaxQ, "the table holds kMaxQ values per code");
  BoundaryTable<T> table;
  if (!fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kMaxCodes; ++c)
    for (int q = 0; q < kMaxQ; ++q)
      table.value[c][q] = T(values[c * kMaxQ + q]);
  const int err = use_device(device);
  if (err != 0) return err;
  const double cs2 = cs * cs;
  masked_stream_collide_kernel<S, T, EmitU>
      <<<launch_grid(n0, n1, n2), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f), static_cast<T*>(out),
          static_cast<T*>(u_out), static_cast<const uint8_t*>(ncm),
          static_cast<const uint8_t*>(nsm), static_cast<const T*>(feq_field),
          table, n0, n1, n2, tau_inv, T(1.0 / cs2), T(0.5 / cs2));
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

#define LT_ENTRY_MASKED(NAME, S, T)                                           \
  int NAME(const void* f, void* out, const void* ncm, const void* nsm,       \
           const void* feq_field, const int32_t* kinds,                       \
           const double* values, int64_t n0, int64_t n1, int64_t n2,          \
           T tau_inv, double cs, int device, void* stream) {                  \
    return launch_masked<S, T, false>(f, out, nullptr, ncm, nsm, feq_field,  \
                                      kinds, values, n0, n1, n2, tau_inv,    \
                                      cs, device, stream);                    \
  }

#define LT_ENTRY_MASKED_EMIT_U(NAME, S, T)                                    \
  int NAME(const void* f, void* out, void* u_out, const void* ncm,           \
           const void* nsm, const void* feq_field, const int32_t* kinds,      \
           const double* values, int64_t n0, int64_t n1, int64_t n2,          \
           T tau_inv, double cs, int device, void* stream) {                  \
    return launch_masked<S, T, true>(f, out, u_out, ncm, nsm, feq_field,     \
                                     kinds, values, n0, n1, n2, tau_inv, cs, \
                                     device, stream);                         \
  }

#define LT_ENTRIES(STENCIL, S)                                                \
  LT_ENTRY(lt_stream_collide_##STENCIL##_f32, S, float)                       \
  LT_ENTRY(lt_stream_collide_##STENCIL##_f64, S, double)                      \
  LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_##STENCIL##_f32, S, float)         \
  LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_##STENCIL##_f64, S, double)        \
  LT_ENTRY_MASKED(lt_stream_collide_masked_##STENCIL##_f32, S, float)         \
  LT_ENTRY_MASKED(lt_stream_collide_masked_##STENCIL##_f64, S, double)        \
  LT_ENTRY_MASKED_EMIT_U(lt_stream_collide_masked_emit_u_##STENCIL##_f32, S,  \
                         float)                                               \
  LT_ENTRY_MASKED_EMIT_U(lt_stream_collide_masked_emit_u_##STENCIL##_f64, S,  \
                         double)

extern "C" {

LT_ENTRIES(d2q9, D2Q9)
LT_ENTRIES(d3q15, D3Q15)
LT_ENTRIES(d3q19, D3Q19)
LT_ENTRIES(d3q27, D3Q27)

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
