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
  // cells a thread of the masked kernel: one (masked_cells_kernel moves
  // 16-bit values)
  template <class S>
  static constexpr int cells() {
    return 1;
  }
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
// the cell-flat geometry of a single-step launch
// ---------------------------------------------------------------------------
// A single-step launch is one flat line of threads over the grid's rows:
// thread t owns `Cells` consecutive cells of row t / row_threads (row
// i n1 + j), from k0 = Cells (t mod row_threads), with row_threads =
// ceil(n2 / Cells). Only the grid's last warp can hold threads that own no
// cell, whatever the extents (a block per row of n2 cells left 80 of 128
// threads idle at n2 = 48). ops/cuda/build.py's plan_cells plans it on the
// host, divisors included, and the C entry checks the plan and launches it.
enum Division : int {
  kMagic = 0,  // 32-bit multiply by a magic number (n < 2^31)
  kDiv32 = 1,  // 32-bit division (n < 2^31)
  kDiv64 = 2,  // 64-bit division
};

// The geometry array of a C entry, in this order (build.CellPlan.geometry).
enum GeometryField : int {
  kCellsField,       // cells a thread: 1, or 2 and 4 (masked 16-bit)
  kVectorsField,     // 1: every row and pointer aligned for the vectors
  kBlocksField,      // blocks of kBlock threads
  kThreadsField,     // threads a block: kBlock
  kRowThreadsField,  // threads a row: ceil(n2 / cells)
  kDivisionField,    // Division
  kRowMagicField,    // floor(t / row_threads) by (magic, shift)
  kRowShiftField,
  kN1MagicField,     // floor(row / n1) by (magic, shift)
  kN1ShiftField,
  kMinBlocksField,   // the __launch_bounds__ minimum blocks per SM
  kGeometryFields,
};

// Passed by value as a kernel parameter.
struct CellGrid {
  int64_t n0, n1, n2, n;  // the launch grid and its cells
  int64_t threads;        // the threads that own cells: n0 n1 row_threads
  int64_t row_threads;
  uint32_t row_magic, n1_magic;
  int row_shift, n1_shift;
  int division;
  int vectors;  // masked_cells_kernel: whole-vector accesses
};

// floor(x / d) for x < 2^31 by m = ceil(2^s / d), s = 31 + ceil(log2 d):
// m d - 2^s < d <= 2^(s - 31), so the quotient is exact for every x below
// 2^31 (Granlund and Montgomery 1994, theorem 4.2), and m < 2^32.
__host__ __device__ __forceinline__ uint32_t magic_divide(uint32_t x,
                                                          uint32_t m, int s) {
  return static_cast<uint32_t>((static_cast<uint64_t>(x) * m) >> s);
}

inline void magic_of(uint64_t d, uint32_t& m, int& s) {
  int l = 0;
  while ((uint64_t(1) << l) < d) ++l;
  s = 31 + l;
  m = static_cast<uint32_t>(((uint64_t(1) << s) + d - 1) / d);
}

// (i, j) of thread t's row and its first cell k0.
template <int Cells>
__device__ __forceinline__ void thread_cells(const CellGrid& g, int64_t t,
                                             int64_t& i, int64_t& j,
                                             int64_t& k0) {
  if (g.division == kDiv64) {
    const int64_t row = t / g.row_threads;
    k0 = (t - row * g.row_threads) * Cells;
    i = row / g.n1;
    j = row - i * g.n1;
  } else if (g.division == kDiv32) {
    const uint32_t tt = uint32_t(t), rt = uint32_t(g.row_threads),
                   n1 = uint32_t(g.n1);
    const uint32_t row = tt / rt, ii = row / n1;
    k0 = int64_t(tt - row * rt) * Cells;
    i = ii;
    j = row - ii * n1;
  } else {
    const uint32_t tt = uint32_t(t);
    const uint32_t row = magic_divide(tt, g.row_magic, g.row_shift);
    const uint32_t ii = magic_divide(row, g.n1_magic, g.n1_shift);
    k0 = int64_t(tt - row * uint32_t(g.row_threads)) * Cells;
    i = ii;
    j = row - ii * uint32_t(g.n1);
  }
}

// The CellGrid of a C entry's geometry for `cells` cells a thread, after
// checking that it covers the [n0, n1, n2] grid as planned; false if not.
inline bool make_cell_grid(const int64_t* geo, int64_t n0, int64_t n1,
                           int64_t n2, CellGrid& g) {
  const int64_t cells = geo[kCellsField];
  if (n0 < 1 || n1 < 1 || n2 < 1 || cells < 1) return false;
  g.n0 = n0;
  g.n1 = n1;
  g.n2 = n2;
  g.n = n0 * n1 * n2;
  g.row_threads = (n2 + cells - 1) / cells;
  g.threads = n0 * n1 * g.row_threads;
  const int64_t blocks = geo[kBlocksField];
  if (geo[kThreadsField] != kBlock || geo[kRowThreadsField] != g.row_threads ||
      blocks < 1 || blocks > 0x7fffffff || blocks * kBlock < g.threads ||
      (blocks - 1) * kBlock >= g.threads)
    return false;
  g.vectors = static_cast<int>(geo[kVectorsField]);
  if ((g.vectors != 0 && g.vectors != 1) || (g.vectors && n2 % cells != 0))
    return false;
  g.division = static_cast<int>(geo[kDivisionField]);
  if (g.division == kDiv64) return true;
  if ((g.division != kMagic && g.division != kDiv32) || g.n >= (int64_t(1) << 31))
    return false;
  magic_of(uint64_t(g.row_threads), g.row_magic, g.row_shift);
  magic_of(uint64_t(n1), g.n1_magic, g.n1_shift);
  return g.division == kDiv32 ||
         (geo[kRowMagicField] == g.row_magic &&
          geo[kRowShiftField] == g.row_shift &&
          geo[kN1MagicField] == g.n1_magic && geo[kN1ShiftField] == g.n1_shift);
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------
template <class C, class St, bool EmitU, int MinBlocks>
__global__ void __launch_bounds__(kBlock, MinBlocks) stream_collide_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    typename C::T* __restrict__ u_out, const __grid_constant__ CellGrid g,
    const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const int64_t cell = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (cell >= g.threads) return;
  int64_t i, j, k;
  thread_cells<1>(g, cell, i, j, k);
  const Neighbours nb = neighbours(i, j, k, g.n0, g.n1, g.n2);

  T fv[S::Q], u[S::D], rho, u2;
  load_moments<S, St, EmitU>(f, u_out, nb, cell, fv, rho, u, u2);
  C::collide(p, fv, rho, u, u2, PeriodicStore<S, St>{out, nb});
}

template <class C, class St, bool EmitU, int MinBlocks>
__global__ void __launch_bounds__(kBlock, MinBlocks)
    masked_stream_collide_kernel(
        const typename St::V* __restrict__ f,
        typename St::V* __restrict__ out, typename C::T* __restrict__ u_out,
        const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
        const typename St::V* __restrict__ feq_field,
        const __grid_constant__ BoundaryTable<typename C::T> table,
        const __grid_constant__ CellGrid g,
        const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const int64_t cell = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (cell >= g.threads) return;
  int64_t i, j, k;
  thread_cells<1>(g, cell, i, j, k);
  const Neighbours nb = neighbours(i, j, k, g.n0, g.n1, g.n2);

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
// the masked kernel of a 16-bit state with several cells a thread
// ---------------------------------------------------------------------------
// A 2-byte value per lane moves 64 B per warp instruction, and a pushed
// row lands one element off the 32-byte sectors. Here a thread owns Cells
// (2 or 4) consecutive cells of a row and moves each population's Cells
// values as one aligned 2 Cells-byte access: the loads, the codes, u as
// float2 or float4 under EmitU, and the push. A population moving along
// the row (e_k = +-1) is stored as the vector of the cells it lands on:
// the thread's own values shifted by one and the value that crosses from
// the neighbouring lane (a warp shuffle). What crosses a warp's edge or
// wraps around the row's periodic end has no lane to come from: the
// thread that holds it stores it alone as 2 bytes, and the thread it would
// land in stores the rest of its vector element by element. Each cell's
// arithmetic is the one-cell kernel's, in float32, rounded once.
// With frozen populations (nsm), a row that Cells does not divide (its
// rows would start off the vectors' alignment, and its last thread owns
// the row's n2 mod Cells last cells) or a tensor off that alignment, every
// access is element-wise, and the push is store_masked's, inside the same
// kernel: the host plans which (CellGrid::vectors).
// The packed 16-bit values of one population over a thread's cells.
template <int Cells>
__device__ __forceinline__ unsigned bits_at(const uint32_t (&w)[Cells / 2],
                                            int e) {
  return (w[e >> 1] >> (16 * (e & 1))) & 0xffffu;
}

template <int Cells>
__device__ __forceinline__ void load_words(const void* p,
                                           uint32_t (&w)[Cells / 2]) {
  if constexpr (Cells == 2) {
    w[0] = __ldg(static_cast<const unsigned*>(p));
  } else {
    const uint2 v = __ldg(static_cast<const uint2*>(p));
    w[0] = v.x;
    w[1] = v.y;
  }
}

template <int Cells>
__device__ __forceinline__ void store_words(void* p,
                                            const uint32_t (&w)[Cells / 2]) {
  if constexpr (Cells == 2) {
    *static_cast<unsigned*>(p) = w[0];
  } else {
    *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  }
}

// The values of cells k0 - 1 .. k0 + Cells - 2: `below` (cell k0 - 1) and
// the thread's own but the last.
template <int Cells>
__device__ __forceinline__ void shift_up(const uint32_t (&w)[Cells / 2],
                                         unsigned below,
                                         uint32_t (&out)[Cells / 2]) {
  out[0] = below | (w[0] << 16);
#pragma unroll
  for (int x = 1; x < Cells / 2; ++x) out[x] = (w[x - 1] >> 16) | (w[x] << 16);
}

// The values of cells k0 + 1 .. k0 + Cells: the thread's own but the first
// and `above` (cell k0 + Cells).
template <int Cells>
__device__ __forceinline__ void shift_down(const uint32_t (&w)[Cells / 2],
                                           unsigned above,
                                           uint32_t (&out)[Cells / 2]) {
#pragma unroll
  for (int x = 0; x + 1 < Cells / 2; ++x)
    out[x] = (w[x] >> 16) | (w[x + 1] << 16);
  out[Cells / 2 - 1] = (w[Cells / 2 - 1] >> 16) | (above << 16);
}

template <class T, int Cells>
__device__ __forceinline__ void store_cells(T* p, const T (&v)[Cells]) {
  if constexpr (Cells == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

constexpr unsigned kFullWarp = 0xffffffffu;

template <class C, class St, bool EmitU, int Cells>
__global__ void __launch_bounds__(kBlock) masked_cells_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    float* __restrict__ u_out, const uint8_t* __restrict__ ncm,
    const uint8_t* __restrict__ nsm,
    const typename St::V* __restrict__ feq_field,
    const __grid_constant__ BoundaryTable<float> table,
    const __grid_constant__ CellGrid g,
    const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = float;
  static_assert(std::is_same_v<typename C::T, float> &&
                    std::is_same_v<typename St::T, float> &&
                    sizeof(typename St::V) == 2,
                "several cells a thread: a 16-bit state computed in float32");
  static_assert(Cells == 2 || Cells == 4, "2 or 4 cells a thread");
  // every lane of a warp that owns cells takes part in the shuffles: a
  // thread past the last one that owns cells computes the last one's and
  // stores nothing; a warp past it ends at once
  const int64_t t = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (t - lane >= g.threads) return;
  const bool active = t < g.threads;
  int64_t i, j, k0;
  thread_cells<Cells>(g, active ? t : g.threads - 1, i, j, k0);
  const Neighbours nb = neighbours(i, j, k0, g.n0, g.n1, g.n2);
  const int64_t n = g.n, n2 = g.n2;
  const int64_t row = (i * g.n1 + j) * n2;
  // the vectors (planned on the host): every row starts on their
  // alignment, and nothing is frozen
  const bool vec = g.vectors;
  // the cells the thread owns, and each one's index (the last of the row
  // for a cell past its end, which computes and stores nothing)
  const int owned = static_cast<int>(n2 - k0 < Cells ? n2 - k0 : Cells);
  int64_t cell[Cells];
#pragma unroll
  for (int e = 0; e < Cells; ++e) cell[e] = row + (e < owned ? k0 + e : n2 - 1);

  uint32_t in[S::Q][Cells / 2];
  uint32_t codes;
  if (vec) {
#pragma unroll
    for (int q = 0; q < S::Q; ++q) load_words<Cells>(f + q * n + cell[0], in[q]);
    if constexpr (Cells == 2) {
      codes = __ldg(reinterpret_cast<const unsigned short*>(ncm + cell[0]));
    } else {
      codes = __ldg(reinterpret_cast<const unsigned*>(ncm + cell[0]));
    }
  } else {
    const auto* fb = reinterpret_cast<const unsigned short*>(f);
    codes = 0;
#pragma unroll
    for (int e = 0; e < Cells; ++e) codes |= unsigned(ncm[cell[e]]) << (8 * e);
#pragma unroll
    for (int q = 0; q < S::Q; ++q) {
#pragma unroll
      for (int x = 0; x < Cells / 2; ++x)
        in[q][x] = unsigned(__ldg(fb + q * n + cell[2 * x])) |
                   (unsigned(__ldg(fb + q * n + cell[2 * x + 1])) << 16);
    }
  }

  uint32_t post_bits[S::Q][Cells / 2];
#pragma unroll
  for (int q = 0; q < S::Q; ++q)
#pragma unroll
    for (int x = 0; x < Cells / 2; ++x) post_bits[q][x] = 0;
  T us[S::D][Cells];
  static_for<Cells>([&](auto E_) {
    constexpr int e = decltype(E_)::value;
    T fv[S::Q], u[S::D], rho, u2;
#pragma unroll
    for (int q = 0; q < S::Q; ++q)
      fv[q] = St::from_bits(static_cast<unsigned short>(bits_at<Cells>(in[q], e)));
    cell_moments<S, St::kDeviation>(fv, rho, u, u2);
#pragma unroll
    for (int a = 0; a < S::D; ++a) us[a][e] = u[a];
    const int code = (codes >> (8 * e)) & 0xff;
    const int kind = kind_of(table.kind, code);
    T post[S::Q];
    const LocalStore<T> store{post};
    if (kind == kCollide) {
      C::collide(p, fv, rho, u, u2, store);
    } else {
      const T* values = table.value[code < kMaxCodes ? code : 0];
      replace_push<S, St>(kind, values, fv, feq_field, n, cell[e], store);
    }
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      post_bits[q][e >> 1] |= unsigned(St::bits(encode<St, S, q>(post[q])))
                              << (16 * (e & 1));
    });
  });

  auto* ob = reinterpret_cast<unsigned short*>(out);
  if (vec) {
    // lane - 1 holds cells k0 - Cells .. k0 - 1 of the same row unless the
    // thread heads its warp or its row; lane + 1 the cells after k0 + Cells
    // - 1 unless it ends them
    const bool head = lane == 0 || k0 == 0;
    const bool tail = lane == 31 || k0 + Cells == n2;
    if constexpr (EmitU) {
      if (active) {
#pragma unroll
        for (int a = 0; a < S::D; ++a) store_cells<T, Cells>(u_out + a * n + cell[0], us[a]);
      }
    }
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      constexpr int ex = comp3<S>(q, 0), ey = comp3<S>(q, 1),
                    ez = comp3<S>(q, 2);
      const int64_t base = q * n + (nb.x[ex + 1] * g.n1 + nb.y[ey + 1]) * n2;
      const uint32_t(&w)[Cells / 2] = post_bits[q];
      if constexpr (ez == 0) {
        if (active) store_words<Cells>(out + base + k0, w);
      } else if constexpr (ez == 1) {
        const unsigned below =
            __shfl_up_sync(kFullWarp, w[Cells / 2 - 1] >> 16, 1);
        if (active) {
          if (!head) {
            uint32_t s[Cells / 2];
            shift_up<Cells>(w, below, s);
            store_words<Cells>(out + base + k0, s);
          } else {
#pragma unroll
            for (int e = 0; e + 1 < Cells; ++e)
              ob[base + k0 + 1 + e] = static_cast<unsigned short>(bits_at<Cells>(w, e));
          }
          if (tail)
            ob[base + (k0 + Cells == n2 ? 0 : k0 + Cells)] =
                static_cast<unsigned short>(bits_at<Cells>(w, Cells - 1));
        }
      } else {
        const unsigned above = __shfl_down_sync(kFullWarp, w[0] & 0xffffu, 1);
        if (active) {
          if (!tail) {
            uint32_t s[Cells / 2];
            shift_down<Cells>(w, above, s);
            store_words<Cells>(out + base + k0, s);
          } else {
#pragma unroll
            for (int e = 1; e < Cells; ++e)
              ob[base + k0 + e - 1] = static_cast<unsigned short>(bits_at<Cells>(w, e));
          }
          if (head)
            ob[base + (k0 == 0 ? n2 - 1 : k0 - 1)] =
                static_cast<unsigned short>(bits_at<Cells>(w, 0));
        }
      }
    });
    return;
  }
  if (!active) return;
  static_for<Cells>([&](auto E_) {
    constexpr int e = decltype(E_)::value;
    if (e >= owned) return;
    if constexpr (EmitU) {
#pragma unroll
      for (int a = 0; a < S::D; ++a) u_out[a * n + cell[e]] = us[a][e];
    }
    const int64_t k = k0 + e;
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      constexpr int ex = comp3<S>(q, 0), ey = comp3<S>(q, 1),
                    ez = comp3<S>(q, 2);
      const int64_t kz = ez == 0 ? k : ez == 1 ? (k == n2 - 1 ? 0 : k + 1)
                                              : (k == 0 ? n2 - 1 : k - 1);
      const int64_t dst =
          q * n + (nb.x[ex + 1] * g.n1 + nb.y[ey + 1]) * n2 + kz;
      const auto v =
          static_cast<unsigned short>(bits_at<Cells>(post_bits[q], e));
      if (nsm == nullptr) {
        ob[dst] = v;
        return;
      }
      const int64_t here = q * n + cell[e];
      if (nsm[here]) ob[here] = v;  // frozen at its own node
      if (!nsm[dst]) ob[dst] = v;   // streamed unless frozen there
    });
  });
}

// ---------------------------------------------------------------------------
// host launchers: each returns cudaGetLastError()
// ---------------------------------------------------------------------------
// The compiled values of a launch parameter (cells a thread, minimum blocks
// per SM), and a call of f(std::integral_constant<int, v>) with the one
// equal to `value`; false when none is.
template <int... Vs>
struct Ints {};

template <int... Vs, class F>
bool dispatch(Ints<Vs...>, int64_t value, F&& f) {
  return ((value == Vs && (f(std::integral_constant<int, Vs>{}), true)) ||
          ...);
}

// The minimum blocks per SM (__launch_bounds__) an instance is compiled
// for: none (1), and every candidate where chip_smoke.py phase 36 times
// them (a specialization beside the policy).
template <class C, class St>
struct BlockChoices {
  using type = Ints<1>;
};

// Whether the masked 16-bit instances of a policy compile every cell count
// (1, 2, 4) that chip_smoke.py phase 36 times; the others compile the one
// their stencil and storage ship (St::cells<S>()).
template <class C>
struct TimedCells : std::false_type {};

template <class S, class T>
struct TimedCells<Bgk<S, T>> : std::true_type {};

template <class C, class St>
using cell_choices = std::conditional_t<
    sizeof(typename St::V) != 2, Ints<1>,
    std::conditional_t<TimedCells<C>::value, Ints<1, 2, 4>,
                       Ints<St::template cells<typename C::S>()>>>;

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <class C, bool EmitU, class St = Same<typename C::T>>
int launch(const void* f, void* out, void* u_out, int64_t n0, int64_t n1,
           int64_t n2, const int64_t* geometry, const typename C::Params& p,
           int device, void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(sizeof(typename C::Params) + sizeof(CellGrid) + 32 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  CellGrid g;
  if (geometry[kCellsField] != 1 || geometry[kVectorsField] != 0 ||
      !make_cell_grid(geometry, n0, n1, n2, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = use_device(device);
  if (err != 0) return err;
  const bool known = dispatch(
      typename BlockChoices<C, St>::type{}, geometry[kMinBlocksField],
      [&](auto M) {
        stream_collide_kernel<C, St, EmitU, decltype(M)::value>
            <<<static_cast<unsigned>(geometry[kBlocksField]), kBlock, 0,
               static_cast<cudaStream_t>(stream)>>>(
                static_cast<const V*>(f), static_cast<V*>(out),
                static_cast<T*>(u_out), g, p);
      });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <class C, bool EmitU, class St = Same<typename C::T>>
int launch_masked(const void* f, void* out, void* u_out, const void* ncm,
                  const void* nsm, const void* feq_field,
                  const int32_t* kinds, const double* values, int64_t n0,
                  int64_t n1, int64_t n2, const int64_t* geometry,
                  const typename C::Params& p, int device, void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]] (bounce back "
                "of a deviation, and the pair cache)");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(S::Q <= kMaxQ, "the table holds kMaxQ values per code");
  static_assert(sizeof(typename C::Params) + sizeof(BoundaryTable<T>) +
                        sizeof(CellGrid) + 64 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  BoundaryTable<T> table;
  CellGrid g;
  if (!fill_kinds(kinds, table.kind) ||
      !make_cell_grid(geometry, n0, n1, n2, g))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kMaxCodes; ++c)
    for (int q = 0; q < kMaxQ; ++q)
      table.value[c][q] = T(values[c * kMaxQ + q]);
  const int err = use_device(device);
  if (err != 0) return err;
  const auto grid = static_cast<unsigned>(geometry[kBlocksField]);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fv = static_cast<const V*>(f);
  auto* ov = static_cast<V*>(out);
  auto* uv = static_cast<T*>(u_out);
  const auto* codes = static_cast<const uint8_t*>(ncm);
  const auto* frozen = static_cast<const uint8_t*>(nsm);
  const auto* field = static_cast<const V*>(feq_field);
  bool known = false;
  dispatch(cell_choices<C, St>{}, geometry[kCellsField], [&](auto Cc) {
    constexpr int cells = decltype(Cc)::value;
    if constexpr (cells == 1) {
      known = !g.vectors && dispatch(
          typename BlockChoices<C, St>::type{}, geometry[kMinBlocksField],
          [&](auto M) {
            masked_stream_collide_kernel<C, St, EmitU, decltype(M)::value>
                <<<grid, kBlock, 0, s>>>(fv, ov, uv, codes, frozen, field,
                                         table, g, p);
          });
    } else {
      // the vectors' alignment: 2 cells bytes of state, cells of codes,
      // 4 cells of u; nothing frozen
      known = geometry[kMinBlocksField] == 1 &&
              (!g.vectors ||
               (nsm == nullptr && aligned(f, 2 * cells) &&
                aligned(out, 2 * cells) && aligned(ncm, cells) &&
                aligned(u_out, 4 * cells)));
      if (known)
        masked_cells_kernel<C, St, EmitU, cells><<<grid, kBlock, 0, s>>>(
            fv, ov, uv, codes, frozen, field, table, g, p);
    }
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
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
      const int64_t* geometry, const double* params, double cs, int device,  \
      void* stream) {                                                         \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch<C, false, STORAGE>(f, out, nullptr, n0, n1, n2,         \
                                         geometry, C::load(params, cs),      \
                                         device, stream);                     \
  }                                                                           \
  int lt_collide_##FRAG##_masked_##STENCIL##_##SUFFIX(                        \
      const void* f, void* out, const void* ncm, const void* nsm,            \
      const void* feq_field, const int32_t* kinds, const double* values,     \
      int64_t n0, int64_t n1, int64_t n2, const int64_t* geometry,           \
      const double* params, double cs, int device, void* stream) {           \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_masked<C, false, STORAGE>(                              \
        f, out, nullptr, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        geometry, C::load(params, cs), device, stream);                       \
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
      int64_t n2, const int64_t* geometry, const double* params, double cs,  \
      int device, void* stream) {                                             \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch<C, true, STORAGE>(f, out, u_out, n0, n1, n2, geometry,  \
                                        C::load(params, cs), device, stream); \
  }                                                                           \
  int lt_collide_##FRAG##_masked_emit_u_##STENCIL##_##SUFFIX(                 \
      const void* f, void* out, void* u_out, const void* ncm,                \
      const void* nsm, const void* feq_field, const int32_t* kinds,          \
      const double* values, int64_t n0, int64_t n1, int64_t n2,              \
      const int64_t* geometry, const double* params, double cs, int device,  \
      void* stream) {                                                         \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_masked<C, true, STORAGE>(                               \
        f, out, u_out, ncm, nsm, feq_field, kinds, values, n0, n1, n2,       \
        geometry, C::load(params, cs), device, stream);                       \
  }

#define LT_ERROR_STRING_ENTRY                                                 \
  const char* lt_cuda_error_string(int code) {                                \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
