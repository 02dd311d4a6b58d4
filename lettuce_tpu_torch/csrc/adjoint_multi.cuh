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
// At 16 bits the tile stays float32 throughout: f and g convert on load
// (exact), the replay and the backward sweep compute in float32 between
// levels, as K2 keeps its tile (multi_sweep.cuh), and the cotangent rounds
// once, at the store. The TPU kernel keeps its slabs and computes in the
// storage dtype (adjoint.py:1007, :1152-1154) while its forward keeps a
// float32 slab (stream_collide.py:1760-1762): it replays a trajectory its
// forward never took. This kernel replays the forward's own (ROADMAP F11).
//
// What it computes, per tile (multi_sweep.cuh's tiles, with a halo of
// max(n_sub, 2 (n_sub - 1)) cells, adjoint.py:954-981):
//   1. replay the forward from f: at level k = 0 .. n_sub - 1 the
//      pre-collision u of every cell at least k from the border is kept in
//      the tile (n_sub d values per cell), and levels below n_sub - 1
//      collide and stream as K2 does (same slots, same policy code);
//   2. load the cotangent g of the launch output over the same tile, and
//      pull it back through the levels kk = n_sub - 1 .. 0: the adjoint
//      stream h_q(x) = h'_q(x + e_q) moves no data either (the cotangent of
//      cell x after m pulls lives in slot x + m off_q), then the adjoint
//      policy's transpose_u writes ct = J_kk^T h back to the same slots,
//      with level kk's u, on the cells within kk of the interior (the
//      forward replay needs 2 (n_sub - 1) cells of halo for the deepest
//      level's u, the cotangent n_sub);
//   3. level 0 writes the interior's cotangent to out.
//
// What bounds it: device memory, ideally. A launch reads f and g and
// writes the cotangent once: 228 / n_sub B per D3Q19 float32 lattice
// update. The deeper halo makes the recompute larger than K2's: at n_sub 2
// a tile's halo is 2, at n_sub 4 it is 6.
//
// Tile memory per cell: q values of f, then of the cotangent (one buffer),
// plus n_sub d values of u. A tile that does not fit the 227 KB of shared
// memory runs in a per-block slice of a global scratch (multi_sweep.cuh).
// Every phase is a loop over cells strided by blockDim.x, as in K2.

#pragma once

#include "adjoint.cuh"
#include "multi_sweep.cuh"

namespace lt {

// Where a cotangent value goes at level kk > 0: back to the slot it was
// pulled from, m = n_sub - kk pulls after the load.
template <class S, class T>
struct PullSink {
  T* buf;
  const TileGeom& t;
  int cell, m;

  template <int q>
  __device__ __forceinline__ void put(T value) const {
    buf[q * t.cells + cell + m * tile_offset<S, q>(t)] = value;
  }
};

// Phase: level k of the forward replay. Keeps u on the cells at least k
// from the border; below the last level, collides in place.
template <class C>
__device__ __forceinline__ void replay_level(const typename C::Params& p,
                                             typename C::T* buf,
                                             typename C::T* ubuf,
                                             const TileGeom& t, int k,
                                             bool last) {
  using S = typename C::S;
  using T = typename C::T;
  const TileBox box = tile_box(t, k);
  for (int i = threadIdx.x; i < box.count; i += blockDim.x) {
    const int c = box_cell(t, box, i);
    T fv[S::Q], u[S::D], rho, u2;
    tile_populations<S, T>(buf, t, c, k, fv);
    cell_moments<S, false>(fv, rho, u, u2);
#pragma unroll
    for (int a = 0; a < S::D; ++a) ubuf[(k * S::D + a) * t.cells + c] = u[a];
    if (!last) C::collide(p, fv, rho, u, u2, TileStore<S, Same<T>>{buf, t, c, k});
  }
}

// The cotangent of cell c after m pulls, and its level-kk u.
template <class S, class T>
__device__ __forceinline__ void pulled(const T* buf, const T* ubuf,
                                       const TileGeom& t, int c, int m,
                                       int kk, T (&h)[S::Q], T (&u)[S::D]) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    h[q] = buf[q * t.cells + c + m * tile_offset<S, q>(t)];
  });
#pragma unroll
  for (int a = 0; a < S::D; ++a) u[a] = ubuf[(kk * S::D + a) * t.cells + c];
}

// Phase: level kk > 0 of the backward sweep, on the cells within kk of
// the interior, in place.
template <class A>
__device__ __forceinline__ void adjoint_level(const typename A::Params& p,
                                              typename A::T* buf,
                                              const typename A::T* ubuf,
                                              const TileGeom& t, int kk,
                                              int n_sub, int halo) {
  using S = typename A::S;
  using T = typename A::T;
  const int m = n_sub - kk;
  const TileBox box = tile_box(t, halo - kk);
  for (int i = threadIdx.x; i < box.count; i += blockDim.x) {
    const int c = box_cell(t, box, i);
    T h[S::Q], u[S::D];
    pulled<S, T>(buf, ubuf, t, c, m, kk, h, u);
    A::transpose_u(p, h, u, PullSink<S, T>{buf, t, c, m});
  }
}

// Phase: level 0 on the interior, into out.
template <class A, class St>
__device__ __forceinline__ void adjoint_store(const typename A::Params& p,
                                              typename St::V* __restrict__ out,
                                              const typename A::T* buf,
                                              const typename A::T* ubuf,
                                              const TileGeom& t,
                                              const int64_t (&o)[3],
                                              int n_sub) {
  using S = typename A::S;
  using T = typename A::T;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int interior = t.b[0] * t.b[1] * t.b[2];
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    int c;
    int64_t gi;
    if (!interior_cell(t, o, i, c, gi)) continue;
    T h[S::Q], u[S::D];
    pulled<S, T>(buf, ubuf, t, c, n_sub, 0, h, u);
    A::transpose_u(p, h, u, CellSink<St>{out, n, gi});
  }
}

template <class C, class A, class St>
__global__ void __launch_bounds__(kMultiBlock) adjoint_multi_kernel(
    const typename St::V* __restrict__ f,
    const typename St::V* __restrict__ g, typename St::V* __restrict__ out,
    typename C::T* scratch,
    const __grid_constant__ TileGeom t, int n_sub, int halo,
    const __grid_constant__ typename C::Params pf,
    const __grid_constant__ typename A::Params pa) {
  using S = typename C::S;
  using T = typename C::T;
  T* buf = tile_buffer(scratch, size_t(t.cells) * (S::Q + n_sub * S::D));
  T* ubuf = buf + size_t(t.cells) * S::Q;
  for (int64_t tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    int64_t o[3];
    tile_origin(t, tile, o);
    load_tile<S, St>(f, buf, t, o);
    __syncthreads();
    for (int k = 0; k < n_sub; ++k) {
      replay_level<C>(pf, buf, ubuf, t, k, k == n_sub - 1);
      __syncthreads();
    }
    load_tile<S, St>(g, buf, t, o);
    __syncthreads();
    for (int kk = n_sub - 1; kk > 0; --kk) {
      adjoint_level<A>(pa, buf, ubuf, t, kk, n_sub, halo);
      __syncthreads();
    }
    adjoint_store<A, St>(pa, out, buf, ubuf, t, o, n_sub);
    __syncthreads();
  }
}

// Host launcher: as launch_multi, with the halo (at least
// max(n_sub, 2 (n_sub - 1))) and a tile of q + n_sub d values of the
// compute type per cell, whatever the storage St.
template <class C, class A, class St = Same<typename C::T>>
int launch_adjoint_multi(const void* f, const void* g, void* out,
                         void* scratch, int64_t n0, int64_t n1, int64_t n2,
                         int n_sub, int halo, int b0, int b1, int b2,
                         int blocks, const typename C::Params& pf,
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
                        sizeof(TileGeom) + 64 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  TileGeom t;
  const int need = n_sub > 2 * (n_sub - 1) ? n_sub : 2 * (n_sub - 1);
  if (n_sub < 1 || halo < need || blocks < 1 ||
      !make_geom<S>(n0, n1, n2, b0, b1, b2, halo, t))
    return static_cast<int>(cudaErrorInvalidValue);
  int err = use_device(device);
  if (err != 0) return err;
  const auto kernel = adjoint_multi_kernel<C, A, St>;
  const size_t bytes = size_t(t.cells) * (S::Q + n_sub * S::D) * sizeof(T);
  const int64_t smem =
      tile_smem<TileTag<C, A, St>>(kernel, bytes, scratch, device, err);
  if (smem < 0) return err;
  kernel<<<blocks, kMultiBlock, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(f), static_cast<const V*>(g),
      static_cast<V*>(out), static_cast<T*>(scratch), t, n_sub, halo, pf, pa);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lt

// The blocked adjoint entry of the forward policy FWD with the adjoint
// policy ADJ on S in the storage STORAGE (computing in its type T): the
// forward's float64 parameters and the adjoint's (PackedSpec.params,
// .adjoint_params).
#define LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, SUFFIX, STORAGE)   \
  int lt_adjoint_multi_##FRAG##_##STENCIL##_##SUFFIX(                         \
      const void* f, const void* g, void* out, void* scratch, int64_t n0,    \
      int64_t n1, int64_t n2, int n_sub, int halo, int b0, int b1, int b2,   \
      int blocks, const double* fwd_params, const double* adj_params,        \
      double cs, int device, void* stream) {                                  \
    using C = FWD<lt::S, typename STORAGE::T>;                                \
    using A = ADJ<lt::S, typename STORAGE::T>;                                \
    return lt::launch_adjoint_multi<C, A, STORAGE>(                           \
        f, g, out, scratch, n0, n1, n2, n_sub, halo, b0, b1, b2, blocks,     \
        C::load(fwd_params, cs), A::load(adj_params, cs), device, stream);   \
  }

#define LT_ADJOINT_MULTI_ENTRIES(FRAG, STENCIL, FWD, ADJ, S)                  \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, f32, lt::Same<float>)   \
  LT_ADJOINT_MULTI_ENTRY(FRAG, STENCIL, FWD, ADJ, S, f64, lt::Same<double>)
