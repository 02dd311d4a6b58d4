// The temporally blocked collide-and-stream kernel (K2): n_sub sub-steps of
// any collision policy per launch, periodic or masked, as a template over
// the collision policy C and the storage policy St of stream_collide.cuh.
// The multi_*.cu sources hold its instances for every fragment and
// storage; adjoint_multi.cuh reuses its tile pieces.
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_multi_sweep (:1270),
// run by _stream_collide_kernel with n_sub > 1 (fused_stream_collide(n_sub=),
// build_fused_multi_step :2195): its periodic form, and its masked form
// (boundary codes, the per-node equilibrium field and frozen populations
// on every sub-step, :1299-1367). No emit-u (the TPU kernel refuses it
// there, :1717).
//
// What it computes: n_sub collide-and-stream steps from one launch input,
// each sub-step the fragment's policy code on the same pair-folded moments
// (cell_moments) as the single-step kernel, so a float32 or float64 launch
// equals n_sub single-step launches up to roundoff (bitwise on the card
// wherever the single-step kernel's build rounds the policy alike, PERF.md
// §6). A 16-bit state is held in float32 between sub-steps and
// rounded only at the store of the last one (the TPU kernel's wide slabs,
// :1754-1762); deviation storage keeps the float32 deviations g = f - w_q
// in the tile, so rho = 1 + sum g at every sub-step.
//
// The masked form is the single-step masked kernel's mask pipeline on
// every sub-step: a cell's uint8 code selects its kind from the per-code
// table (collide, bounce back, a constant equilibrium, the per-node
// equilibrium field, identity), the replacement pushed like a collided
// population (replace_push); the bool no-streaming mask freezes a
// population at its destination, which keeps its own post-collision value
// (store_masked). Codes, frozen populations and the field are read at the
// same periodically wrapped grid index as f, so a tile's halo and a
// partial tile at the grid's end are exact. One C entry serves both forms
// (a periodic launch passes null mask pointers) and launches one of two
// kernels, so the periodic kernel carries none of the masked one's code.
//
// What bounds it: device memory, ideally. A launch reads q populations and
// writes q per cell for n_sub steps: 152 / n_sub B per D3Q19 float32
// lattice update, 76 / n_sub in 16 bits; the masked form adds a 1-byte code
// per cell (73 / n_sub B per D2Q9 float32 update), q bytes of the
// no-streaming mask when populations are frozen and the field's q values
// where a code reads it. The price is the halo: a tile's interior is
// surrounded by n_sub cells per side that are loaded and collided again by
// the neighbouring tiles.
//
// The design (simple and exact first; its speed is later work):
//   * one block per tile of the grid, threads along the fastest axis z;
//     the tile is the interior plus an n_sub-deep halo on every axis the
//     stencil moves along (a 2D grid [1, X, Y] has none on axis 0), loaded
//     with periodic wrap, so a partial tile at the grid's end is exact;
//   * the tile lives in ONE buffer of q values per cell (dynamic shared
//     memory, up to 227 KB; or, when even the smallest tile does not fit,
//     a per-block slice of a global scratch the wrapper allocates, the
//     blocks then looping over the tiles), followed in a masked launch by
//     the cells' codes (1 B each) and, when populations are frozen, their
//     frozen bits (4 B) and a second buffer of q values (TileLayout);
//   * streaming moves no data: population q of the tile cell c at sub-step
//     k lives in slot c - k off_q (off_q the flat offset of e_q), so a
//     collision reads its q values from their slots and writes the
//     post-collision values back to the same slots, and the next sub-step
//     finds each streamed value where its source left it. No two threads
//     touch one slot in a sub-step; a barrier separates sub-steps;
//   * a frozen population q of cell c must find its own post-collision
//     value in slot c - (k+1) off_q at sub-step k + 1; that slot is the one
//     cell c - off_q read and wrote in sub-step k. Moving the value there in
//     the collision phase would race with c - off_q, and along a chain of
//     frozen cells every move overwrites a value the next move still has
//     to read. So after the collision phase (a barrier) each frozen value
//     is copied from its slot c - k off_q to the second buffer, and after a
//     second barrier from there to slot c - (k+1) off_q: every read of a
//     phase precedes every write of the next, so the copy is exact; the
//     value it overwrites streamed to c alone, and c discards it;
//   * sub-step k runs on the cells at least k from the tile's border (the
//     valid region shrinks one cell per side per sub-step), so after n_sub
//     sub-steps the interior is exact, and only it is stored.
// The tile geometry is chosen on the host (ops/cuda/build.py's plan_tile,
// which counts the masks' bytes per cell).
//
// Each phase (load, sub-step, the two copies, store) is a loop over the
// tile's cells strided by blockDim.x, so a one-thread launch runs the
// phases in order with the barriers as no-ops.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "half_storage.cuh"
#include "stream_collide.cuh"

// the tile buffer: dynamic shared memory
extern __shared__ __align__(16) unsigned char lt_tile_smem[];

namespace lt {

constexpr int kMultiBlock = 256;
// the dynamic shared memory a block may opt into on sm_90 (227 KB)
constexpr size_t kMaxTileSmem = 232448;
constexpr int kMaxDevices = 64;

// One launch's tiles: the grid [n0, n1, n2], the interior b and halo h per
// axis, the tile extents dim = b + 2h and the flat strides of a tile.
struct TileGeom {
  int64_t n[3];
  int b[3], h[3], dim[3];
  int cells, stride0, stride1;
  int tiles[3];
  int64_t ntiles;
};

// Whether the stencil moves along axis a of the 3D launch grid.
template <class S>
constexpr bool moves_along(int a) {
  for (int q = 0; q < S::Q; ++q)
    if (comp3<S>(q, a) != 0) return true;
  return false;
}

// The geometry of interior (b0, b1, b2) with a halo of ``halo`` cells on
// every axis the stencil moves along; false if a size is out of range.
template <class S>
bool make_geom(int64_t n0, int64_t n1, int64_t n2, int b0, int b1, int b2,
               int halo, TileGeom& t) {
  const int64_t n[3] = {n0, n1, n2};
  const int b[3] = {b0, b1, b2};
  int64_t cells = 1;
  t.ntiles = 1;
  for (int a = 0; a < 3; ++a) {
    if (n[a] < 1 || b[a] < 1 || halo < 0) return false;
    t.n[a] = n[a];
    t.b[a] = b[a];
    t.h[a] = moves_along<S>(a) ? halo : 0;
    t.dim[a] = b[a] + 2 * t.h[a];
    t.tiles[a] = static_cast<int>((n[a] + b[a] - 1) / b[a]);
    cells *= t.dim[a];
    t.ntiles *= t.tiles[a];
  }
  if (cells > (int64_t(1) << 30)) return false;
  t.cells = static_cast<int>(cells);
  t.stride1 = t.dim[2];
  t.stride0 = t.dim[1] * t.dim[2];
  return true;
}

// The flat tile offset of e_q.
template <class S, int q>
__device__ __forceinline__ int tile_offset(const TileGeom& t) {
  return comp3<S>(q, 0) * t.stride0 + comp3<S>(q, 1) * t.stride1 +
         comp3<S>(q, 2);
}

__device__ __forceinline__ int64_t wrap(int64_t x, int64_t n) {
  x %= n;
  return x < 0 ? x + n : x;
}

// The tile's origin in the grid (its first interior cell).
__device__ __forceinline__ void tile_origin(const TileGeom& t, int64_t tile,
                                            int64_t (&o)[3]) {
  o[2] = (tile % t.tiles[2]) * t.b[2];
  tile /= t.tiles[2];
  o[1] = (tile % t.tiles[1]) * t.b[1];
  o[0] = (tile / t.tiles[1]) * t.b[0];
}

// The box of tile cells at least r from the border on every axis with a
// halo (all cells on an axis without one).
struct TileBox {
  int lo[3], ext[3], count;
};

__device__ __forceinline__ TileBox tile_box(const TileGeom& t, int r) {
  TileBox box;
  box.count = 1;
  for (int a = 0; a < 3; ++a) {
    box.lo[a] = t.h[a] > 0 ? r : 0;
    box.ext[a] = t.dim[a] - 2 * box.lo[a];
    box.count *= box.ext[a];
  }
  return box;
}

// The tile cell of the i-th cell of a box, z fastest.
__device__ __forceinline__ int box_cell(const TileGeom& t, const TileBox& box,
                                        int i) {
  const int z = i % box.ext[2];
  i /= box.ext[2];
  const int y = i % box.ext[1];
  const int x = i / box.ext[1];
  return (x + box.lo[0]) * t.stride0 + (y + box.lo[1]) * t.stride1 + z +
         box.lo[2];
}

// The tile form of a storage St (what encode() writes back to the tile):
// its compute type, unrounded; deviations stay deviations.
template <class St>
struct TileStorage {
  using T = typename St::T;
  using V = T;
  static constexpr bool kDeviation = St::kDeviation;
  __device__ __forceinline__ static V pack(T x) { return x; }
};

// Where a post-collision population goes at sub-step k: back to the slot
// it was read from, encoded in the tile form of St.
template <class S, class St>
struct TileStore {
  typename St::T* buf;
  const TileGeom& t;
  int cell, k;

  template <int q>
  __device__ __forceinline__ void put(typename St::T value) const {
    buf[q * t.cells + cell - k * tile_offset<S, q>(t)] =
        encode<TileStorage<St>, S, q>(value);
  }
};

// The flat grid index of tile cell c of the tile of origin o, with
// periodic wrap.
__device__ __forceinline__ int64_t tile_global(const TileGeom& t,
                                               const int64_t (&o)[3], int c) {
  const int z = c % t.dim[2];
  const int y = (c / t.dim[2]) % t.dim[1];
  const int x = c / t.stride0;
  const int64_t gx = wrap(o[0] - t.h[0] + x, t.n[0]);
  const int64_t gy = wrap(o[1] - t.h[1] + y, t.n[1]);
  const int64_t gz = wrap(o[2] - t.h[2] + z, t.n[2]);
  return (gx * t.n[1] + gy) * t.n[2] + gz;
}

// Phase: the tile of origin o from the state f (stored as St) into buf, in
// St's tile form, with periodic wrap.
template <class S, class St>
__device__ __forceinline__ void load_tile(
    const typename St::V* __restrict__ f, typename St::T* buf,
    const TileGeom& t, const int64_t (&o)[3]) {
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  for (int c = threadIdx.x; c < t.cells; c += blockDim.x) {
    const int64_t gi = tile_global(t, o, c);
#pragma unroll
    for (int q = 0; q < S::Q; ++q) buf[q * t.cells + c] = St::raw(f + q * n + gi);
  }
}

// The parts of a K2 tile after its q values per cell, as byte offsets
// into the tile buffer: in a masked launch the cells' codes, and when
// populations are frozen a second buffer of q values and the cells'
// frozen bits (bit q: population q is frozen there).
struct TileLayout {
  size_t keep, bits, codes, bytes;
};

template <class S, class T>
__host__ __device__ __forceinline__ TileLayout tile_layout(int cells,
                                                           bool masked,
                                                           bool frozen) {
  TileLayout l;
  size_t at = size_t(cells) * S::Q * sizeof(T);
  l.keep = at;
  if (frozen) at += size_t(cells) * S::Q * sizeof(T);
  l.bits = at;
  if (frozen) at += size_t(cells) * sizeof(uint32_t);
  l.codes = at;
  if (masked) at += size_t(cells);
  l.bytes = at;
  return l;
}

// A block's share of the global scratch: its tile's bytes rounded up to
// 16 (ops/cuda/stream_collide.py allocates blocks times this).
__host__ __device__ __forceinline__ size_t tile_stride(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// The masks of a K2 launch: the grid's (codes, no-streaming mask, per-node
// field; null when absent) and their tile copies (codes, frozen bits) with
// the second buffer for frozen values.
template <class St>
struct TileMasks {
  const uint8_t* __restrict__ ncm;
  const uint8_t* __restrict__ nsm;
  const typename St::V* __restrict__ feq_field;
  uint8_t* codes;
  uint32_t* bits;
  typename St::T* keep;
};

// Phase: the codes and frozen bits of the tile of origin o, read at the
// wrapped grid index of each tile cell.
template <class S, class St>
__device__ __forceinline__ void load_masks(const TileMasks<St>& m,
                                           const TileGeom& t,
                                           const int64_t (&o)[3]) {
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  for (int c = threadIdx.x; c < t.cells; c += blockDim.x) {
    const int64_t gi = tile_global(t, o, c);
    if (m.codes != nullptr) m.codes[c] = __ldg(m.ncm + gi);
    if (m.bits != nullptr) {
      uint32_t b = 0;
#pragma unroll
      for (int q = 0; q < S::Q; ++q)
        b |= uint32_t(__ldg(m.nsm + q * n + gi) != 0) << q;
      m.bits[c] = b;
    }
  }
}

// The q populations of tile cell c at sub-step k.
template <class S, class T>
__device__ __forceinline__ void tile_populations(const T* buf,
                                                 const TileGeom& t, int c,
                                                 int k, T (&fv)[S::Q]) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    fv[q] = buf[q * t.cells + c - k * tile_offset<S, q>(t)];
  });
}

// Phase: sub-step k of the collision C on the cells at least k from the
// tile's border; in a Masked launch a cell whose code is not "collide"
// pushes its replacement instead (the single-step masked kernel's
// branch), the per-node field read at the cell's wrapped grid index.
template <class C, class St, bool Masked>
__device__ __forceinline__ void sub_step(
    const typename C::Params& p, typename St::T* buf, const TileGeom& t,
    int k, const TileMasks<St>& m,
    const BoundaryTable<typename C::T>& table, const int64_t (&o)[3]) {
  using S = typename C::S;
  using T = typename C::T;
  const TileBox box = tile_box(t, k);
  for (int i = threadIdx.x; i < box.count; i += blockDim.x) {
    const int c = box_cell(t, box, i);
    T fv[S::Q], u[S::D], rho, u2;
    tile_populations<S, T>(buf, t, c, k, fv);
    cell_moments<S, St::kDeviation>(fv, rho, u, u2);
    const TileStore<S, St> store{buf, t, c, k};
    if constexpr (Masked) {
      const int code = m.codes[c];
      const int kind = kind_of(table.kind, code);
      if (kind != kCollide) {
        const int64_t gi =
            kind == kEquilibriumField ? tile_global(t, o, c) : 0;
        replace_push<S, St>(kind, table.value[code < kMaxCodes ? code : 0],
                            fv, m.feq_field, t.n[0] * t.n[1] * t.n[2], gi,
                            store);
        continue;
      }
    }
    C::collide(p, fv, rho, u, u2, store);
  }
}

// Phases after sub-step k when populations are frozen, on the cells that
// collide at sub-step k + 1: copy each frozen population's post-collision
// value from its slot c - k off_q to the second buffer (to_keep), then
// from there to slot c - (k+1) off_q, where sub-step k + 1 (or the store)
// reads population q of cell c. A barrier separates the two.
template <class S, class T>
__device__ __forceinline__ void move_frozen(T* buf, T* keep,
                                            const uint32_t* bits,
                                            const TileGeom& t, int k,
                                            bool to_keep) {
  const TileBox box = tile_box(t, k + 1);
  for (int i = threadIdx.x; i < box.count; i += blockDim.x) {
    const int c = box_cell(t, box, i);
    const uint32_t b = bits[c];
    if (b == 0) continue;
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      if ((b >> q) & 1u) {
        T* slot = buf + q * t.cells + c - (k + 1) * tile_offset<S, q>(t);
        if (to_keep) {
          keep[q * t.cells + c] = slot[tile_offset<S, q>(t)];
        } else {
          *slot = keep[q * t.cells + c];
        }
      }
    });
  }
}

// The i-th interior cell of a tile: false when it lies past the grid's
// end (a partial tile); else its tile cell and its flat grid index.
__device__ __forceinline__ bool interior_cell(const TileGeom& t,
                                              const int64_t (&o)[3], int i,
                                              int& c, int64_t& gi) {
  const int z = i % t.b[2];
  const int y = (i / t.b[2]) % t.b[1];
  const int x = i / (t.b[1] * t.b[2]);
  const int64_t gx = o[0] + x, gy = o[1] + y, gz = o[2] + z;
  if (gx >= t.n[0] || gy >= t.n[1] || gz >= t.n[2]) return false;
  c = (x + t.h[0]) * t.stride0 + (y + t.h[1]) * t.stride1 + z + t.h[2];
  gi = (gx * t.n[1] + gy) * t.n[2] + gz;
  return true;
}

// Phase: the interior after n_sub sub-steps into out, rounded to St.
template <class S, class St>
__device__ __forceinline__ void store_tile(typename St::V* __restrict__ out,
                                           const typename St::T* buf,
                                           const TileGeom& t,
                                           const int64_t (&o)[3], int n_sub) {
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int interior = t.b[0] * t.b[1] * t.b[2];
  for (int i = threadIdx.x; i < interior; i += blockDim.x) {
    int c;
    int64_t gi;
    if (!interior_cell(t, o, i, c, gi)) continue;
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      out[q * n + gi] =
          St::pack(buf[q * t.cells + c - n_sub * tile_offset<S, q>(t)]);
    });
  }
}

// The tile buffer of this block: its slice of the global scratch, or the
// dynamic shared memory.
template <class T>
__device__ __forceinline__ T* tile_buffer(T* scratch, size_t per_block) {
  return scratch != nullptr ? scratch + blockIdx.x * per_block
                            : reinterpret_cast<T*>(lt_tile_smem);
}

// ncm, nsm and feq_field (null when absent) are the grid's masks, read
// only when Masked (ncm then given); scratch (null: shared memory) holds
// tile_stride bytes per block. The periodic form is an instance of its
// own, so it carries none of the masked form's code.
template <class C, class St, bool Masked>
__global__ void __launch_bounds__(kMultiBlock) multi_sweep_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    unsigned char* scratch, const __grid_constant__ TileGeom t, int n_sub,
    const __grid_constant__ typename C::Params p,
    const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
    const typename St::V* __restrict__ feq_field,
    const __grid_constant__ BoundaryTable<typename C::T> table) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const TileLayout l = tile_layout<S, T>(t.cells, Masked, nsm != nullptr);
  unsigned char* base = tile_buffer(scratch, tile_stride(l.bytes));
  T* buf = reinterpret_cast<T*>(base);
  const TileMasks<St> m{
      ncm, nsm, feq_field, Masked ? base + l.codes : nullptr,
      nsm != nullptr ? reinterpret_cast<uint32_t*>(base + l.bits) : nullptr,
      nsm != nullptr ? reinterpret_cast<T*>(base + l.keep) : nullptr};
  for (int64_t tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    int64_t o[3];
    tile_origin(t, tile, o);
    load_tile<S, St>(f, buf, t, o);
    if constexpr (Masked) load_masks<S, St>(m, t, o);
    __syncthreads();
    for (int k = 0; k < n_sub; ++k) {
      sub_step<C, St, Masked>(p, buf, t, k, m, table, o);
      __syncthreads();
      if (Masked && m.bits != nullptr) {
        move_frozen<S, T>(buf, m.keep, m.bits, t, k, true);
        __syncthreads();
        move_frozen<S, T>(buf, m.keep, m.bits, t, k, false);
        __syncthreads();
      }
    }
    store_tile<S, St>(out, buf, t, o, n_sub);
    __syncthreads();
  }
}

// A type per kernel instance: instances whose pointers share a type (the
// bfloat16 state and bfloat16 deviation instances of one policy) must not
// share allow_tile_smem's record.
template <class... Instance>
struct TileTag {};

// Opt the kernel of instance Tag into up to kMaxTileSmem of dynamic shared
// memory, once per device; returns a cudaError_t.
template <class Tag, class Kernel>
int allow_tile_smem(Kernel kernel, int device) {
  static bool done[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[device]) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxTileSmem));
  if (err == cudaSuccess) done[device] = true;
  return static_cast<int>(err);
}

// The dynamic shared memory of a launch whose tile takes ``bytes``: 0 with
// a scratch, else bytes (and the kernel of instance Tag opted in); -1 if it
// cannot run.
template <class Tag, class Kernel>
int64_t tile_smem(Kernel kernel, size_t bytes, const void* scratch,
                  int device, int& err) {
  err = 0;
  if (scratch != nullptr) return 0;
  if (bytes > kMaxTileSmem) {
    err = cudaErrorInvalidValue;
    return -1;
  }
  if (bytes > 48 * 1024) err = allow_tile_smem<Tag>(kernel, device);
  return err == 0 ? int64_t(bytes) : -1;
}

// One launch of the periodic or the Masked instance over the tiles of t;
// returns cudaGetLastError().
template <class C, class St, bool Masked>
int start_multi(const void* f, void* out, void* scratch, const void* ncm,
                const void* nsm, const void* feq_field, const TileGeom& t,
                int n_sub, int blocks, const typename C::Params& p,
                const BoundaryTable<typename C::T>& table, int device,
                void* stream) {
  using V = typename St::V;
  const auto kernel = multi_sweep_kernel<C, St, Masked>;
  const TileLayout l = tile_layout<typename C::S, typename C::T>(
      t.cells, Masked, nsm != nullptr);
  int err = 0;
  const int64_t smem =
      tile_smem<TileTag<C, St, std::bool_constant<Masked>>>(
          kernel, l.bytes, scratch, device, err);
  if (smem < 0) return err;
  kernel<<<blocks, kMultiBlock, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(f), static_cast<V*>(out),
      static_cast<unsigned char*>(scratch), t, n_sub, p,
      static_cast<const uint8_t*>(ncm), static_cast<const uint8_t*>(nsm),
      static_cast<const V*>(feq_field), table);
  return static_cast<int>(cudaGetLastError());
}

// Host launcher: blocks over the tiles of interior (b0, b1, b2); scratch
// (null for shared memory) holds blocks * tile_stride(tile bytes) bytes.
// ncm null is a periodic launch; else nsm and feq_field may be null, and
// kinds and values are the host table (the single-step masked entries').
// Returns cudaGetLastError().
template <class C, class St>
int launch_multi(const void* f, void* out, void* scratch, const void* ncm,
                 const void* nsm, const void* feq_field, const int32_t* kinds,
                 const double* values, int64_t n0, int64_t n1, int64_t n2,
                 int n_sub, int b0, int b1, int b2, int blocks,
                 const typename C::Params& p, int device, void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  static_assert(is_rest<S>(0), "the rest direction is q = 0");
  static_assert(S::Q <= kMaxQ && S::Q <= 32,
                "the table holds kMaxQ values per code, the frozen bits 32");
  static_assert(sizeof(typename C::Params) + sizeof(TileGeom) +
                        sizeof(BoundaryTable<T>) + 96 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  TileGeom t;
  if (n_sub < 1 || blocks < 1 || (ncm == nullptr && nsm != nullptr) ||
      !make_geom<S>(n0, n1, n2, b0, b1, b2, n_sub, t))
    return static_cast<int>(cudaErrorInvalidValue);
  BoundaryTable<T> table{};
  if (ncm != nullptr) {
    if (!fill_kinds(kinds, table.kind))
      return static_cast<int>(cudaErrorInvalidValue);
    for (int c = 0; c < kMaxCodes; ++c)
      for (int q = 0; q < kMaxQ; ++q)
        table.value[c][q] = T(values[c * kMaxQ + q]);
  }
  const int err = use_device(device);
  if (err != 0) return err;
  return ncm != nullptr
             ? start_multi<C, St, true>(f, out, scratch, ncm, nsm, feq_field,
                                        t, n_sub, blocks, p, table, device,
                                        stream)
             : start_multi<C, St, false>(f, out, scratch, ncm, nsm,
                                         feq_field, t, n_sub, blocks, p,
                                         table, device, stream);
}

}  // namespace lt

// The blocked entry of POLICY on S with the storage STORAGE (whose compute
// type the policy runs in): n_sub sub-steps over tiles of interior
// (b0, b1, b2), ``blocks`` blocks, the global ``scratch`` or null; with
// ``ncm`` null a periodic launch, else masked (``nsm`` and ``feq_field``
// null when absent; ``kinds`` and ``values`` the host table).
#define LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, SUFFIX, STORAGE)             \
  int lt_multi_##FRAG##_##STENCIL##_##SUFFIX(                                 \
      const void* f, void* out, void* scratch, const void* ncm,              \
      const void* nsm, const void* feq_field, const int32_t* kinds,          \
      const double* values, int64_t n0, int64_t n1, int64_t n2, int n_sub,   \
      int b0, int b1, int b2, int blocks, const double* params, double cs,   \
      int device, void* stream) {                                             \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_multi<C, STORAGE>(                                      \
        f, out, scratch, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        n_sub, b0, b1, b2, blocks, C::load(params, cs), device, stream);     \
  }

// The blocked entries of a fragment in float32 and float64.
#define LT_MULTI_ENTRIES(FRAG, STENCIL, POLICY, S)                            \
  LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, f32, lt::Same<float>)             \
  LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, f64, lt::Same<double>)

// The blocked entries of a fragment in every storage: float32, float64,
// bfloat16 and float16 state, bfloat16 deviations.
#define LT_MULTI_ALL_ENTRIES(FRAG, STENCIL, POLICY, S)                        \
  LT_MULTI_STATE_ENTRIES(FRAG, STENCIL, POLICY, S)                            \
  LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, bf16_dev, lt::Bf16Dev)

// Every storage but deviations: a fragment that deviation storage refuses.
#define LT_MULTI_STATE_ENTRIES(FRAG, STENCIL, POLICY, S)                      \
  LT_MULTI_ENTRIES(FRAG, STENCIL, POLICY, S)                                  \
  LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, bf16, lt::Bf16)                    \
  LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, f16, lt::F16Storage)
