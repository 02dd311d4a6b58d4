// The blocked adjoint kernel (K4): the exact vector-Jacobian product of
// n_sub collide-and-stream sub-steps (one launch of multi_sweep.cuh's
// kernel) in one launch, as a template over the forward collision policy C
// (stream_collide.cuh, collide_*.cu) and its adjoint policy A
// (adjoint.cuh, adjoint.cu, adjoint_fragments.cu).
//
// Replaces lettuce_tpu/ops/pallas/adjoint.py::_adjoint_multi_kernel (:984,
// fused_adjoint_multi :1097): periodic grids, the f-linear collisions whose
// adjoint reads the pre-collision u (BGK, TRT, the regularized and the
// folded MRT through matvec) and the identity, float32 and float64, and a
// bfloat16 or float16 state and cotangent (the storage policy St of
// half_storage.cuh, adjoint_multi_half.cu). The forward's only residual is
// the launch input f.
//
// At 16 bits the rings stay float32 throughout: f and g convert on load
// (exact), the replay and the backward sweep compute in float32 between
// levels, as K2 keeps its rings (multi_sweep.cuh), and the cotangent
// rounds once, at the store. The TPU kernel keeps its slabs and computes
// in the storage dtype (adjoint.py:1007, :1152-1154) while its forward
// keeps a float32 slab (stream_collide.py:1760-1762): it replays a
// trajectory its forward never took. This kernel replays the forward's own
// (ROADMAP F11).
//
// What it computes: the forward f^{k+1}_q(x + e_q) = C(f^k(x))_q replayed
// from f, and the cotangent pulled back through its levels,
// G^k(x) = J_k(x)^T [G^{k+1}_q(x + e_q)]_q from G^n_sub = g, J_k read
// from the pre-collision u of level k (the adjoint policy's transpose_u);
// out = G^0 on the interior.
//
// What bounds it: device memory, ideally. A launch reads f and g and
// writes the cotangent once: 228 / n_sub B per D3Q19 float32 lattice
// update. The halo is deeper than K2's, max(n_sub, 2 (n_sub - 1)) cells
// (adjoint.py:954-981): the cotangent's cone (n_sub) and the forward
// replay's cone for the deepest level's u (2 (n_sub - 1)).
//
// The design: multi_sweep.cuh's march. A block owns a column (a
// cross-section with that halo on the cross axes, a segment of the march
// axis) and walks it with one wavefront of phases per march step s, a
// barrier after each, on local planes (plane 0 is the segment's first
// less 2 (n_sub - 1)):
//   * replay level k = 0 .. n_sub - 2 on plane s - k, the cross cells at
//     least k from the border: level 0 reads f, level k pulls from level
//     k - 1's ring; it keeps u in a ring of 2 (n_sub - 1 - k) + 1 planes
//     (d values per cell, read by backward level k 2 (n_sub - 1 - k) steps
//     later) and collides into its own ring as K2 does;
//   * the top level n_sub - 1 on plane s - (n_sub - 1), the cells at least
//     halo - (n_sub - 1) from the border: the forward's last u (no ring:
//     read at once) and the first pull of g, read from device memory at
//     x + e_q, transposed into the ring of G^{n_sub - 1};
//   * backward level kk = n_sub - 2 .. 1 on plane s - 2 (n_sub - 1) + kk,
//     the cells at least halo - kk from the border: G^{kk + 1} pulled from
//     the ring above at plane x + e_m and cell c + e (a value with
//     e_m = +1, 0, -1 is read 0, 1 or 2 steps after it is written: its
//     ring holds 1, 2 or 3 planes, 2 q per cross cell), with u from level
//     kk's ring, transposed into its own ring;
//   * level 0 on plane s - 2 (n_sub - 1): the interior into out, rounded
//     once (at n_sub = 1 the top level writes out).
// Every level's plane and ring slot is ops/cuda/build.py's march_steps
// (adjoint=True), walked by the tests. Per cross cell a block keeps
// 2 (n_sub - 1) rings of 2 q values (K2's class layout) and
// (n_sub^2 - 1) d values of u, and its grid offset: 348 B for D3Q19
// float32 at n_sub 2. A column that does not fit the 227 KB of shared
// memory runs in a per-block slice of a global scratch (the body is
// instantiated for each: with_buffer). Every phase is a loop over cross
// cells strided by blockDim.x, as in K2.

#pragma once

#include "adjoint.cuh"
#include "multi_sweep.cuh"

namespace lt {

// The values per cross cell of a K4 block: 2 (n_sub - 1) rings of 2 q
// values (the replay's post-collision values and the cotangents) and the
// u rings of levels 0 .. n_sub - 2, 2 (n_sub - 1 - k) + 1 planes of d.
template <class S>
__host__ __device__ __forceinline__ size_t adjoint_march_values(int n_sub) {
  return size_t(2 * (n_sub - 1)) * kRing<S> +
         size_t(n_sub * n_sub - 1) * S::D;
}

// The planes of level k's u ring, and the offset of that ring (in cross
// cells times values) after the u rings of the levels below.
__host__ __device__ __forceinline__ int u_depth(int n_sub, int k) {
  return 2 * (n_sub - 1 - k) + 1;
}

template <class S>
__device__ __forceinline__ size_t u_ring_offset(int n_sub, int k) {
  return size_t(k) * (2 * n_sub - k) * S::D;
}

// Where a cotangent value of a backward level goes: its ring's block of
// the written plane.
template <class S, class T>
struct RingSink {
  const RingPlanes<S, -1, T>& r;
  int cell;

  template <int q>
  __device__ __forceinline__ void put(T value) const {
    constexpr int k = march_comp<S>(q) + 1;
    r.at[k][cell * class_size<S>(k) + class_index<S>(q)] = value;
  }
};

// One block's rings: the replay's post-collision rings of levels
// 0 .. n_sub - 2, the cotangent rings of levels 1 .. n_sub - 1 and the u
// rings of levels 0 .. n_sub - 2; and the cross cells' grid offsets.
template <class S, class T>
struct AdjointRings {
  T* base;
  const int64_t* table;
  int cells, n_sub;

  __device__ __forceinline__ T* forward(int k) const {
    return base + size_t(k) * kRing<S> * cells;
  }
  __device__ __forceinline__ T* cotangent(int kk) const {
    return base + size_t(n_sub - 2 + kk) * kRing<S> * cells;
  }
  __device__ __forceinline__ T* u(int k) const {
    return base + size_t(2 * (n_sub - 1)) * kRing<S> * cells +
           u_ring_offset<S>(n_sub, k) * cells;
  }
};

// Phase: replay level k on local plane ``plane`` (level 0: the grid's
// plane at offset plane_at), on the cross cells at least k from the
// border: keeps u, collides into level k's ring.
template <class C, class St, bool First>
__device__ __forceinline__ void replay_level(
    const typename C::Params& p, const typename St::V* __restrict__ f,
    const AdjointRings<typename C::S, typename C::T>& r, const MarchGeom& t,
    int k, int plane, int64_t plane_at) {
  using S = typename C::S;
  using T = typename C::T;
  T* mine = r.forward(k);
  T* u_slot =
      r.u(k) + size_t(plane % u_depth(r.n_sub, k)) * S::D * t.cells;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const RingPlanes<S, 1, T> out = ring_planes<S, 1>(mine, t, plane, false);
  // level k - 1's ring (unused by level 0)
  const RingPlanes<S, 1, T> below = ring_planes<S, 1>(
      First ? mine : r.forward(k - 1), t, First ? 1 : plane, true);
  const CrossBox box = cross_box(t, k);
  for (BoxWalk w(box.ext[0], box.ext[1]); w.more(); w.next()) {
    const int c = cross_cell(t, box, w);
    T fv[S::Q], u[S::D], rho, u2;
    if constexpr (First) {
      const int64_t gi = plane_at + r.table[c];
#pragma unroll
      for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(f + q * n + gi);
    } else {
      ring_pull<S, 1>(below, c, fv);
    }
    cell_moments<S, false>(fv, rho, u, u2);
#pragma unroll
    for (int a = 0; a < S::D; ++a) u_slot[a * t.cells + c] = u[a];
    C::collide(p, fv, rho, u, u2, RingStore<S, Same<T>>{out, c});
  }
}

// The first pull of the launch output's cotangent g at cross cell c of
// the grid's plane x: h_q = g_q(x + e_q), the three planes' offsets in
// at[e_m + 1], the cross cell's neighbour from the table.
template <class S, class St>
__device__ __forceinline__ void pull_g(const typename St::V* __restrict__ g,
                                       int64_t n, const int64_t (&at)[3],
                                       const int64_t* table,
                                       const MarchGeom& t, int c,
                                       typename St::T (&h)[S::Q]) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    constexpr int em = comp3<S>(q, march_axis<S>());
    h[q] = St::raw(g + q * n + at[em + 1] + table[c + cross_offset<S, q>(t)]);
  });
}

// Phase: the top level n_sub - 1 on local plane ``plane`` (the grid's
// plane x, wrapped): the forward's last pre-collision u and the pull of g
// at x + e_q, transposed. With Single (n_sub = 1) it reads f and writes
// the interior to out; else it pulls from the replay's last ring and
// writes the cotangent ring of level n_sub - 1 on the cells at least
// halo - (n_sub - 1) from the border.
template <class C, class A, class St, bool Single>
__device__ __forceinline__ void top_level(
    const typename C::Params& pf, const typename A::Params& pa,
    const typename St::V* __restrict__ f,
    const typename St::V* __restrict__ g, typename St::V* __restrict__ out,
    const AdjointRings<typename C::S, typename C::T>& r, const MarchGeom& t,
    const int64_t (&o)[3], int halo, int plane, int64_t x) {
  using S = typename C::S;
  using T = typename C::T;
  constexpr int M = march_axis<S>();
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int64_t stride = grid_stride(t, M);
  const int64_t at[3] = {wrap_near(x - 1, t.n[M]) * stride, x * stride,
                         wrap_near(x + 1, t.n[M]) * stride};
  const CrossBox box = cross_box(t, halo - (r.n_sub - 1));
  // the replay's last ring and the cotangent ring of level n_sub - 1
  // (neither used at n_sub 1)
  const RingPlanes<S, 1, T> in = ring_planes<S, 1>(
      r.forward(Single ? 0 : r.n_sub - 2), t, Single ? 1 : plane, true);
  const RingPlanes<S, -1, T> cot = ring_planes<S, -1>(
      r.cotangent(Single ? 1 : r.n_sub - 1), t, plane, false);
  for (BoxWalk w = Single ? interior_walk<S>(t)
                          : BoxWalk(box.ext[0], box.ext[1]);
       w.more(); w.next()) {
    int c;
    if constexpr (Single) {
      if (!march_interior<S>(t, o, w, c)) continue;
    } else {
      c = cross_cell(t, box, w);
    }
    T fv[S::Q], u[S::D], rho, u2, h[S::Q];
    if constexpr (Single) {
#pragma unroll
      for (int q = 0; q < S::Q; ++q)
        fv[q] = St::raw(f + q * n + at[1] + r.table[c]);
    } else {
      ring_pull<S, 1>(in, c, fv);
    }
    cell_moments<S, false>(fv, rho, u, u2);
    pull_g<S, St>(g, n, at, r.table, t, c, h);
    if constexpr (Single) {
      A::transpose_u(pa, h, u, CellSink<St>{out, n, at[1] + r.table[c]});
    } else {
      A::transpose_u(pa, h, u, RingSink<S, T>{cot, c});
    }
  }
}

// Phase: backward level kk (0 < kk < n_sub - 1) on local plane ``plane``,
// on the cross cells at least halo - kk from the border: the cotangent
// pulled from level kk + 1's ring, transposed with level kk's u into its
// own ring.
template <class A>
__device__ __forceinline__ void adjoint_level(
    const typename A::Params& p,
    const AdjointRings<typename A::S, typename A::T>& r, const MarchGeom& t,
    int halo, int kk, int plane) {
  using S = typename A::S;
  using T = typename A::T;
  const T* u_slot =
      r.u(kk) + size_t(plane % u_depth(r.n_sub, kk)) * S::D * t.cells;
  const CrossBox box = cross_box(t, halo - kk);
  const RingPlanes<S, -1, T> above =
      ring_planes<S, -1>(r.cotangent(kk + 1), t, plane, true);
  const RingPlanes<S, -1, T> out =
      ring_planes<S, -1>(r.cotangent(kk), t, plane, false);
  for (BoxWalk w(box.ext[0], box.ext[1]); w.more(); w.next()) {
    const int c = cross_cell(t, box, w);
    T h[S::Q], u[S::D];
    ring_pull<S, -1>(above, c, h);
#pragma unroll
    for (int a = 0; a < S::D; ++a) u[a] = u_slot[a * t.cells + c];
    A::transpose_u(p, h, u, RingSink<S, T>{out, c});
  }
}

// Phase: level 0 on local plane ``plane`` (the grid's plane x): the
// interior's cotangent into out, rounded to St.
template <class A, class St>
__device__ __forceinline__ void adjoint_store(
    const typename A::Params& p, typename St::V* __restrict__ out,
    const AdjointRings<typename A::S, typename A::T>& r, const MarchGeom& t,
    const int64_t (&o)[3], int plane, int64_t x) {
  using S = typename A::S;
  using T = typename A::T;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int64_t plane_at = x * grid_stride(t, march_axis<S>());
  const T* u_slot = r.u(0) + size_t(plane % u_depth(r.n_sub, 0)) * S::D *
                                 t.cells;
  const RingPlanes<S, -1, T> above =
      ring_planes<S, -1>(r.cotangent(1), t, plane, true);
  for (BoxWalk w = interior_walk<S>(t); w.more(); w.next()) {
    int c;
    if (!march_interior<S>(t, o, w, c)) continue;
    T h[S::Q], u[S::D];
    ring_pull<S, -1>(above, c, h);
#pragma unroll
    for (int a = 0; a < S::D; ++a) u[a] = u_slot[a * t.cells + c];
    A::transpose_u(p, h, u, CellSink<St>{out, n, plane_at + r.table[c]});
  }
}

// The units of one block, in the buffer at base: every unit's segment
// marched with the phases of march_steps(adjoint=True) in
// ops/cuda/build.py, a barrier after each.
template <class C, class A, class St>
__device__ __forceinline__ void adjoint_units(
    unsigned char* base, const typename St::V* __restrict__ f,
    const typename St::V* __restrict__ g, typename St::V* __restrict__ out,
    const MarchGeom& t, int n_sub, int halo, const typename C::Params& pf,
    const typename A::Params& pa) {
  using S = typename C::S;
  using T = typename C::T;
  constexpr int M = march_axis<S>();
  int64_t* table = reinterpret_cast<int64_t*>(
      base + march_table_at(t.cells, adjoint_march_values<S>(n_sub),
                            sizeof(T)));
  const AdjointRings<S, T> r{reinterpret_cast<T*>(base), table, t.cells,
                             n_sub};
  const int64_t stride = grid_stride(t, M);
  const int lead = t.halo;  // 2 (n_sub - 1) planes before the segment
  for (int64_t unit = blockIdx.x; unit < t.nunits; unit += gridDim.x) {
    int64_t o[3];
    march_origin<S>(t, unit, o);
    cross_table<S>(t, o, table);
    __syncthreads();
    const int planes = segment_planes<S>(t, o);
    const int last = planes + 2 * lead - 1;  // the last local plane
    for (int s = 0; s <= last; ++s) {
      if (n_sub == 1) {
        top_level<C, A, St, true>(pf, pa, f, g, out, r, t, o, halo, s,
                                  o[M] + s);
        continue;
      }
      replay_level<C, St, true>(pf, f, r, t, 0, s,
                                wrap_near(o[M] - lead + s, t.n[M]) * stride);
      __syncthreads();
      for (int k = 1; k < n_sub - 1; ++k) {
        const int plane = s - k;
        if (plane >= k && plane <= last - k)
          replay_level<C, St, false>(pf, f, r, t, k, plane, 0);
        __syncthreads();
      }
      int plane = s - (n_sub - 1);
      if (plane >= n_sub - 1 && plane <= last - (n_sub - 1))
        top_level<C, A, St, false>(pf, pa, f, g, out, r, t, o, halo, plane,
                                   wrap_near(o[M] - lead + plane, t.n[M]));
      __syncthreads();
      for (int kk = n_sub - 2; kk > 0; --kk) {
        plane = s - lead + kk;
        if (plane >= lead - kk && plane <= lead + planes - 1 + kk)
          adjoint_level<A>(pa, r, t, halo, kk, plane);
        __syncthreads();
      }
      plane = s - lead;
      if (plane >= lead && plane < lead + planes)
        adjoint_store<A, St>(pa, out, r, t, o, plane, o[M] + plane - lead);
      __syncthreads();
    }
    __syncthreads();
  }
}

// The most threads a K4 block takes (its __launch_bounds__): its replay,
// adjoint policy and pulls of g hold more values than a K2 level, and at
// 512 threads (128 registers) the float32 instances spilled.
constexpr int kAdjointThreads = 256;

template <class C, class A, class St>
__global__ void __launch_bounds__(kAdjointThreads) adjoint_multi_kernel(
    const typename St::V* __restrict__ f,
    const typename St::V* __restrict__ g, typename St::V* __restrict__ out,
    unsigned char* scratch, const __grid_constant__ MarchGeom t, int n_sub,
    int halo, const __grid_constant__ typename C::Params pf,
    const __grid_constant__ typename A::Params pa) {
  using S = typename C::S;
  using T = typename C::T;
  with_buffer(scratch,
              march_bytes(t.cells, adjoint_march_values<S>(n_sub),
                          sizeof(T)),
              [&](unsigned char* base) {
                adjoint_units<C, A, St>(base, f, g, out, t, n_sub, halo, pf,
                                        pa);
              });
}

// Host launcher: as launch_multi's periodic launch, with the halo (at
// least max(n_sub, 2 (n_sub - 1))) on the cross axes, ``threads`` (at most
// kAdjointThreads) per block and adjoint_march_values per cross cell of the
// compute type, whatever the storage St.
template <class C, class A, class St = Same<typename C::T>>
int launch_adjoint_multi(const void* f, const void* g, void* out,
                         void* scratch, int64_t n0, int64_t n1, int64_t n2,
                         int n_sub, int halo, int b0, int b1, int b2,
                         int blocks, int threads,
                         const typename C::Params& pf,
                         const typename A::Params& pa, int device,
                         void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  static_assert(std::is_same_v<S, typename A::S> &&
                    std::is_same_v<T, typename A::T>,
                "the forward and adjoint policies share stencil and type");
  static_assert(adjoint_storage_ok<A, St>(),
                "the storage computes in the policies' type, no deviations");
  static_assert(A::kResidual != kResidualF,
                "the blocked adjoint keeps u per level, not the state");
  static_assert(sizeof(typename C::Params) + sizeof(typename A::Params) +
                        sizeof(MarchGeom) + 64 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  MarchGeom t;
  const int need = n_sub > 2 * (n_sub - 1) ? n_sub : 2 * (n_sub - 1);
  if (n_sub < 1 || halo < need || blocks < 1 || threads < 1 ||
      threads > kAdjointThreads ||
      !make_march<S>(n0, n1, n2, b0, b1, b2, halo, 2 * (n_sub - 1), t))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = use_device(device);
  if (err != 0) return err;
  const auto kernel = adjoint_multi_kernel<C, A, St>;
  const size_t bytes =
      march_bytes(t.cells, adjoint_march_values<S>(n_sub), sizeof(T));
  const int64_t smem =
      tile_smem<TileTag<C, A, St>>(kernel, bytes, scratch, device, err);
  if (smem < 0) return err;
  kernel<<<blocks, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(f), static_cast<const V*>(g),
      static_cast<V*>(out), static_cast<unsigned char*>(scratch), t, n_sub,
      halo, pf, pa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt

// The blocked adjoint entry of the forward policy FWD with the adjoint
// policy ADJ on S in the storage STORAGE (computing in its type T): the
// forward's float64 parameters and the adjoint's (PackedSpec.params,
// .adjoint_params); (b0, b1, b2) is the cross-section's interior on the
// cross axes and the segment's planes on the march axis, ``threads`` per
// block.
#define LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, SUFFIX, STORAGE)   \
  int lt_adjoint_multi_##FRAG##_##STENCIL##_##SUFFIX(                         \
      const void* f, const void* g, void* out, void* scratch, int64_t n0,    \
      int64_t n1, int64_t n2, int n_sub, int halo, int b0, int b1, int b2,   \
      int blocks, int threads, const double* fwd_params,                     \
      const double* adj_params, double cs, int device, void* stream) {       \
    using C = FWD<lt::S, typename STORAGE::T>;                                \
    using A = ADJ<lt::S, typename STORAGE::T>;                                \
    return lt::launch_adjoint_multi<C, A, STORAGE>(                           \
        f, g, out, scratch, n0, n1, n2, n_sub, halo, b0, b1, b2, blocks,     \
        threads, C::load(fwd_params, cs), A::load(adj_params, cs), device,   \
        stream);                                                              \
  }

#define LT_ADJOINT_MULTI_ENTRIES(FRAG, STENCIL, FWD, ADJ, S)                  \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, f32, lt::Same<float>)   \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, f64, lt::Same<double>)
