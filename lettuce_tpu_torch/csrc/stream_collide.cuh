// The fused collide-and-stream kernels as templates over a collision
// policy, shared by stream_collide.cu (the BGK instances) and the
// collision-fragment sources collide_*.cu.
//
// A policy C is a struct with the stencil S, the scalar T, a Params struct
// (passed by value as a __grid_constant__ kernel parameter: the relaxation
// times, and for MRT the folded moment matrices, read from the parameter
// bank at compile-time offsets), a host-side Params load(params, cs) from
// the C entry's float64 array, and a __device__ collide(p, fv, rho, u, u2,
// store) that hands the q post-collision values of one cell to the Store.
// Every policy runs in the periodic kernel (PeriodicStore) and in the
// masked kernel's collide branch (LocalStore, then store_masked with
// frozen populations); the replacement branch of the masked kernel is the
// same for all.
//
// The emit-u instances (BGK, and through LT_COLLIDE_EMIT_U_ENTRIES the TRT,
// regularized and folded MRT fragments) also write the pre-collision
// velocity u = j / rho, the residual of their adjoint kernels (adjoint.cu,
// adjoint_fragments.cu). It is the same for every fragment
// (lettuce_tpu/ops/pallas/stream_collide.py:1535-1542).
//
// A storage policy St (the kernels' second template argument) says how the
// state is held in device memory: the stored type V, the compute type T
// the policy runs in, the conversions between them, and whether the state
// holds the deviations g = f - w_q. Same<T> stores the compute type itself
// (float32, float64); half_storage.cuh adds the 16-bit storage of K1e and
// K1f, whose fragments run unchanged in float32.

#pragma once

#include <cstdint>
#include <type_traits>
#include <utility>

#include <cuda_runtime.h>

#include "stencils.cuh"

namespace lt {

// the parameter space of a kernel launch (CUDA 12.1+ on Volta and later)
constexpr int kMaxParamBytes = 32764;

// ---------------------------------------------------------------------------
// compile-time loops
// ---------------------------------------------------------------------------
template <class F, int... Is>
__device__ __forceinline__ void static_for_impl(
    F&& f, std::integer_sequence<int, Is...>) {
  (f(std::integral_constant<int, Is>{}), ...);
}

// f(std::integral_constant<int, i>) for i = 0 .. N-1, unrolled.
template <int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  static_for_impl(f, std::make_integer_sequence<int, N>{});
}

// ---------------------------------------------------------------------------
// opposite pairs: pair k is (pair_first(k), opposite(pair_first(k))), the
// k-th direction (ascending) whose opposite has a larger index. The rest
// direction is q = 0 on every stencil.
// ---------------------------------------------------------------------------
template <class S>
constexpr int kPairs = (S::Q - 1) / 2;

template <class S>
__host__ __device__ constexpr int pair_first(int k) {
  int n = 0;
  for (int q = 0; q < S::Q; ++q) {
    if (q < opposite<S>(q)) {
      if (n == k) return q;
      ++n;
    }
  }
  return -1;
}

// ---------------------------------------------------------------------------
// storage of the state
// ---------------------------------------------------------------------------
// The compute type itself: float32 and float64 state.
template <class T_>
struct Same {
  using T = T_;  // what the policies compute in
  using V = T_;  // what device memory holds
  static constexpr bool kDeviation = false;
  __device__ __forceinline__ static T raw(const V* p) { return __ldg(p); }
  __device__ __forceinline__ static V pack(T x) { return x; }
};

// Population q of a stored value: f itself, or f = g + w_q for deviations.
template <class St, class S, int q>
__device__ __forceinline__ typename St::T decode(const typename St::V* p) {
  using T = typename St::T;
  const T x = St::raw(p);
  if constexpr (St::kDeviation) {
    return x + T(S::w(q));
  } else {
    return x;
  }
}

// The stored value of population q, rounded to the storage type.
template <class St, class S, int q>
__device__ __forceinline__ typename St::V encode(typename St::T x) {
  using T = typename St::T;
  if constexpr (St::kDeviation) {
    return St::pack(x - T(S::w(q)));
  } else {
    return St::pack(x);
  }
}

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

// The quadratic equilibrium (not tau-scaled) in the opposite-pair form of
// the TPU fragments' feq_raw: feq = G +- H per canonical direction, with
//   G = w base0 + (w / 2) rho (e.u)^2 / cs^4,  H = w rho e.u / cs^2,
// base0 = rho - rho u^2 / (2 cs^2) and up = u / cs^2.
template <class S, class T>
__device__ __forceinline__ void feq_pairs(T rho, T base0,
                                          const T (&up)[S::D],
                                          T (&feq)[S::Q]) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    if constexpr (is_rest<S>(q)) {
      feq[q] = T(S::w(q)) * base0;
    } else if constexpr (is_canonical<S>(q)) {
      constexpr int p = opposite<S>(q);
      const T eu = eu_canonical<S, T, q>(up, T(0));
      const T reu = rho * eu;
      const T H = T(S::w(q)) * reu;
      const T G = T(S::w(q)) * base0 + T(0.5 * S::w(q)) * (reu * eu);
      feq[q] = G + H;
      feq[p] = G - H;
    }
  });
}

// Where a post-collision population goes: the periodic push, encoded by
// the storage St.
template <class S, class St>
struct PeriodicStore {
  typename St::V* out;
  const Neighbours& nb;

  template <int q>
  __device__ __forceinline__ void put(typename St::T value) const {
    out[shifted_index<S, q, 1>(nb)] = encode<St, S, q>(value);
  }
};

// The masked kernel's populations are first gathered in registers and
// pushed after the policy has run (store_masked). Pushing each at once
// would put a branch (the frozen test) between the policy's operations;
// nvcc contracts products into FMAs within a branch-free stretch of code,
// so the policy would round differently there than in the periodic and
// blocked kernels.
template <class T>
struct LocalStore {
  T* values;

  template <int q>
  __device__ __forceinline__ void put(T value) const {
    values[q] = value;
  }
};

// The push with frozen populations (nsm == nullptr: nothing frozen), each
// encoded by the storage St.
template <class S, class St>
__device__ __forceinline__ void store_masked(
    const typename St::T (&values)[S::Q], typename St::V* out,
    const Neighbours& nb, int64_t cell, const uint8_t* nsm) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    const typename St::V v = encode<St, S, q>(values[q]);
    const int64_t dst = shifted_index<S, q, 1>(nb);
    if (nsm == nullptr) {
      out[dst] = v;
      return;
    }
    const int64_t here = q * nb.n + cell;
    if (nsm[here]) out[here] = v;  // frozen at its own node
    if (!nsm[dst]) out[dst] = v;   // streamed unless frozen there
  });
}

// A boundary cell's replacement, pushed like a collided population. The
// table's values are in the compute type; the per-node field is stored
// like the state and decoded like a population.
template <class S, class St, class Store, int q = 0>
__device__ __forceinline__ void replace_push(
    int kind, const typename St::T* values,
    const typename St::T (&fv)[S::Q],
    const typename St::V* __restrict__ feq_field, int64_t n, int64_t cell,
    const Store& store) {
  if constexpr (q < S::Q) {
    typename St::T v;
    if (kind == kBounceBack) {
      v = fv[opposite<S>(q)];
    } else if (kind == kEquilibrium) {
      v = values[q];
    } else if (kind == kEquilibriumField) {
      v = decode<St, S, q>(feq_field + q * n + cell);
    } else {
      v = fv[q];
    }
    store.template put<q>(v);
    replace_push<S, St, Store, q + 1>(kind, values, fv, feq_field, n, cell,
                                      store);
  }
}

// rho, u = j / rho and u.u of a cell from its q populations fv. Under
// deviation storage (Dev) fv holds the deviations g = f - w_q, which sum to
// rho - 1 and to j (sum_q w_q = 1, sum_q w_q e_q = 0): rho gains 1 and j
// nothing, as in the TPU kernel's _moments, and fv becomes f = g + w_q, what
// the policies see.
template <class S, bool Dev, class T>
__device__ __forceinline__ void cell_moments(T (&fv)[S::Q], T& rho,
                                             T (&u)[S::D], T& u2) {
  rho = T(0);
  T jm[S::D];
#pragma unroll
  for (int a = 0; a < S::D; ++a) jm[a] = T(0);
  moments<S, T>(fv, rho, jm);
  if constexpr (Dev) {
    rho = rho + T(1);
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      fv[q] = fv[q] + T(S::w(q));
    });
  }

  const T inv_rho = T(1) / rho;
  u2 = T(0);
#pragma unroll
  for (int a = 0; a < S::D; ++a) {
    u[a] = jm[a] * inv_rho;
    u2 = u2 + u[a] * u[a];
  }
}

// The cell's populations, rho, u = j / rho and u.u (cell_moments), with u
// written to u_out when EmitU.
template <class S, class St, bool EmitU, class T = typename St::T>
__device__ __forceinline__ void load_moments(
    const typename St::V* __restrict__ f, T* __restrict__ u_out,
    const Neighbours& nb, int64_t cell, T (&fv)[S::Q], T& rho, T (&u)[S::D],
    T& u2) {
#pragma unroll
  for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(f + q * nb.n + cell);
  cell_moments<S, St::kDeviation>(fv, rho, u, u2);
  if constexpr (EmitU) {
#pragma unroll
    for (int a = 0; a < S::D; ++a) u_out[a * nb.n + cell] = u[a];
  }
}

// ---------------------------------------------------------------------------
// the BGK policy (the "bgk" fragment)
// ---------------------------------------------------------------------------
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

template <class S_, class T_>
struct Bgk {
  using S = S_;
  using T = T_;
  struct Params {
    T tau_inv, inv_cs2, half_inv_cs2;
  };

  static Params make(T tau_inv, double cs) {
    const double cs2 = cs * cs;
    return Params{tau_inv, T(1.0 / cs2), T(0.5 / cs2)};
  }

  // params: [tau_inv] (the entries of the blocked kernels, multi_sweep.cuh)
  static Params load(const double* params, double cs) {
    return make(T(params[0]), cs);
  }

  template <class Store>
  __device__ __forceinline__ static void collide(const Params& p,
                                                 const T (&fv)[S::Q], T rho,
                                                 const T (&u)[S::D], T u2,
                                                 const Store& store) {
    T up[S::D];
#pragma unroll
    for (int a = 0; a < S::D; ++a) up[a] = u[a] * p.inv_cs2;
    const T keep = T(1) - p.tau_inv;
    const T base = p.tau_inv * (rho - rho * (u2 * p.half_inv_cs2));
    const T trho = p.tau_inv * rho;
    collide_push<S, T>(fv, store, keep, base, trho, up);
  }
};

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
template <class C, class St, bool EmitU>
__global__ void __launch_bounds__(kBlock) stream_collide_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    typename C::T* __restrict__ u_out, int64_t n0, int64_t n1, int64_t n2,
    const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T fv[S::Q], u[S::D], rho, u2;
  load_moments<S, St, EmitU>(f, u_out, nb, cell, fv, rho, u, u2);
  C::collide(p, fv, rho, u, u2, PeriodicStore<S, St>{out, nb});
}

template <class C, class St, bool EmitU>
__global__ void __launch_bounds__(kBlock) masked_stream_collide_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    typename C::T* __restrict__ u_out, const uint8_t* __restrict__ ncm,
    const uint8_t* __restrict__ nsm,
    const typename St::V* __restrict__ feq_field,
    const __grid_constant__ BoundaryTable<typename C::T> table, int64_t n0,
    int64_t n1, int64_t n2, const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;
  const Neighbours nb = neighbours(i, j, k, n0, n1, n2);
  const int64_t cell = (i * n1 + j) * n2 + k;

  T fv[S::Q], u[S::D], rho, u2;
  load_moments<S, St, EmitU>(f, u_out, nb, cell, fv, rho, u, u2);

  const int code = ncm[cell];
  const int kind = kind_of(table.kind, code);
  T post[S::Q];
  const LocalStore<T> store{post};
  if (kind == kCollide) {
    C::collide(p, fv, rho, u, u2, store);
  } else {
    const T* values = table.value[code < kMaxCodes ? code : 0];
    replace_push<S, St>(kind, values, fv, feq_field, nb.n, cell, store);
  }
  store_masked<S, St>(post, out, nb, cell, nsm);
}

// ---------------------------------------------------------------------------
// host launchers: each returns cudaGetLastError()
// ---------------------------------------------------------------------------
template <class C, bool EmitU, class St = Same<typename C::T>>
int launch(const void* f, void* out, void* u_out, int64_t n0, int64_t n1,
           int64_t n2, const typename C::Params& p, int device,
           void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(sizeof(typename C::Params) + 64 <= kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  const int err = use_device(device);
  if (err != 0) return err;
  stream_collide_kernel<C, St, EmitU>
      <<<launch_grid(n0, n1, n2), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(f), static_cast<V*>(out),
          static_cast<T*>(u_out), n0, n1, n2, p);
  return static_cast<int>(cudaGetLastError());
}

template <class C, bool EmitU, class St = Same<typename C::T>>
int launch_masked(const void* f, void* out, void* u_out, const void* ncm,
                  const void* nsm, const void* feq_field,
                  const int32_t* kinds, const double* values, int64_t n0,
                  int64_t n1, int64_t n2, const typename C::Params& p,
                  int device, void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]] (bounce back "
                "of a deviation, and the pair cache)");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(S::Q <= kMaxQ, "the table holds kMaxQ values per code");
  static_assert(sizeof(typename C::Params) + sizeof(BoundaryTable<T>) + 96 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  BoundaryTable<T> table;
  if (!fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kMaxCodes; ++c)
    for (int q = 0; q < kMaxQ; ++q)
      table.value[c][q] = T(values[c * kMaxQ + q]);
  const int err = use_device(device);
  if (err != 0) return err;
  masked_stream_collide_kernel<C, St, EmitU>
      <<<launch_grid(n0, n1, n2), kBlock, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const V*>(f), static_cast<V*>(out),
          static_cast<T*>(u_out), static_cast<const uint8_t*>(ncm),
          static_cast<const uint8_t*>(nsm), static_cast<const V*>(feq_field),
          table, n0, n1, n2, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt

// The C entries of a collision fragment: periodic and masked, float32 and
// float64, for the policy template POLICY on stencil S. ``params`` is the
// host float64 array the policy's load() reads.
#define LT_COLLIDE_ENTRIES(FRAG, STENCIL, POLICY, S)                          \
  LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, f32, lt::Same<float>)           \
  LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, f64, lt::Same<double>)

// The periodic and masked entries of POLICY on S with the storage policy
// STORAGE, whose compute type the policy runs in.
#define LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, SUFFIX, STORAGE)           \
  int lt_collide_##FRAG##_##STENCIL##_##SUFFIX(                               \
      const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,          \
      const double* params, double cs, int device, void* stream) {           \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch<C, false, STORAGE>(f, out, nullptr, n0, n1, n2,         \
                                         C::load(params, cs), device,        \
                                         stream);                             \
  }                                                                           \
  int lt_collide_##FRAG##_masked_##STENCIL##_##SUFFIX(                        \
      const void* f, void* out, const void* ncm, const void* nsm,            \
      const void* feq_field, const int32_t* kinds, const double* values,     \
      int64_t n0, int64_t n1, int64_t n2, const double* params, double cs,   \
      int device, void* stream) {                                             \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_masked<C, false, STORAGE>(                              \
        f, out, nullptr, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        C::load(params, cs), device, stream);                                 \
  }

// The emit-u entries of a collision fragment: periodic and masked, float32
// and float64, also writing the pre-collision u to u_out [d, *grid].
#define LT_COLLIDE_EMIT_U_ENTRIES(FRAG, STENCIL, POLICY, S)                   \
  LT_COLLIDE_EMIT_U_ENTRY(FRAG, STENCIL, POLICY, S, f32, lt::Same<float>)     \
  LT_COLLIDE_EMIT_U_ENTRY(FRAG, STENCIL, POLICY, S, f64, lt::Same<double>)

// The emit-u entries of POLICY on S with the storage policy STORAGE; u is
// written in its compute type (float32 for a 16-bit state, as the TPU
// kernel's u_dtype, stream_collide.py:1778-1779).
#define LT_COLLIDE_EMIT_U_ENTRY(FRAG, STENCIL, POLICY, S, SUFFIX, STORAGE)    \
  int lt_collide_##FRAG##_emit_u_##STENCIL##_##SUFFIX(                        \
      const void* f, void* out, void* u_out, int64_t n0, int64_t n1,         \
      int64_t n2, const double* params, double cs, int device,               \
      void* stream) {                                                         \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch<C, true, STORAGE>(f, out, u_out, n0, n1, n2,            \
                                        C::load(params, cs), device, stream); \
  }                                                                           \
  int lt_collide_##FRAG##_masked_emit_u_##STENCIL##_##SUFFIX(                 \
      const void* f, void* out, void* u_out, const void* ncm,                \
      const void* nsm, const void* feq_field, const int32_t* kinds,          \
      const double* values, int64_t n0, int64_t n1, int64_t n2,              \
      const double* params, double cs, int device, void* stream) {           \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_masked<C, true, STORAGE>(                               \
        f, out, u_out, ncm, nsm, feq_field, kinds, values, n0, n1, n2,       \
        C::load(params, cs), device, stream);                                 \
  }

#define LT_ERROR_STRING_ENTRY                                                 \
  const char* lt_cuda_error_string(int code) {                                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
