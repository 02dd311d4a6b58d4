// The temporally blocked collide-and-stream kernel (K2): n_sub sub-steps of
// any collision policy per launch, periodic or masked, as a template over
// the collision policy C and the storage policy St of stream_collide.cuh.
// The multi_*.cu sources hold its instances for every fragment and
// storage; adjoint_multi.cuh reuses its march pieces.
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
// between sub-steps, so rho = 1 + sum g at every sub-step.
//
// What bounds it: device memory, ideally. A launch reads q populations and
// writes q per cell for n_sub steps: 152 / n_sub B per D3Q19 float32
// lattice update, 76 / n_sub in 16 bits; the masked form adds a 1-byte code
// per cell (73 / n_sub B per D2Q9 float32 update), q bytes of the
// no-streaming mask when populations are frozen and the field's q values
// where a code reads it. The price is the halo (cells next to a block's
// region are loaded and collided again by its neighbours) and, on this
// card, the issue rate: one block fills an SM's shared memory, its levels
// are separated by barriers, and a step's collisions, ring traffic and
// index arithmetic keep its warps busy while device memory idles (the
// marched launch moves its bytes at about a third of the card's rate;
// PERF.md §6, PR 10).
//
// The periodic kernel (march_kernel) marches a tile along the slowest axis
// the stencil moves along (axis 0 of a 3D grid, axis 1 of a 2D grid
// [1, X, Y]):
//   * a block owns a column: a cross-section of the other two axes, its
//     interior plus an n_sub-deep halo on the cross axes the stencil moves
//     along (loaded with periodic wrap, so a partial column at the grid's
//     end is exact), and a segment of the march axis; ops/cuda/build.py's
//     plan_march picks the cross-section, the segment length (the C
//     entry's interior extents: the segment's planes on the march axis)
//     and the block's threads (up to kMarchThreads);
//   * a wavefront of levels walks the segment with lag 1: at march step s
//     level 0 collides plane s (the launch input, wrapped; the segment's
//     planes less n_sub up to its planes plus n_sub), level k collides
//     plane s - k on the cross cells at least k from the border, pulling
//     each population from level k - 1's post-collision plane
//     x - e_m (e_m its march component) and cross cell c - e; at step s the
//     store pulls plane s - n_sub from level n_sub - 1 and writes the
//     interior to out, rounded to the storage once (build.py's
//     march_steps is this order, walked by the tests);
//   * each level keeps its post-collision values in a ring of planes in
//     shared memory (the compute type; 16 bits as float32, deviations as
//     deviations): a value with e_m = -1, 0, +1 is read in the step it is
//     written, one or two steps later, so the ring keeps 1, 2 or 3 planes
//     of it (2 + e_m; the compact ring, 2 q values per cross cell and
//     level, 38 for D3Q19 where three planes of every population would
//     take 57). The populations of one e_m form a class, stored per plane
//     as [cross cell][population of the class]: a phase fixes each class's
//     plane once (ring_planes), and a population's offset within a cell is
//     an immediate (class sizes are odd, so a warp's cells fall in
//     distinct banks); when no cross-section fits the 227 KB of
//     shared memory the rings live in a per-block slice of a global
//     scratch the wrapper allocates, the blocks then looping over the
//     columns (the kernel's body is instantiated for each, so the rings in
//     shared memory take shared-memory instructions: with_buffer);
//   * ring hazards: a barrier follows every level and the store, so a
//     level reads its lower level's plane s - k + 1 after it is written in
//     the same step, and a slot is overwritten (by plane p + depth, at
//     step p + depth + k) only after its last read (step p + 1 + e_m + k);
//   * the cross cells' wrapped grid offsets are tabled once per column
//     (cross_table), and the phases walk their boxes without a division
//     per cell (BoxWalk);
//   * each phase is a loop over the cross cells strided by blockDim.x, so
//     a one-thread launch runs the phases in order with the barriers as
//     no-ops.
// Along the march axis the halo costs a warm-up of 2 n_sub planes per
// segment; across it the interior share is By Bz / ((By + 2 n)(Bz + 2 n)),
// not the cube's cubic one. Level 0 loads its plane itself: a staging
// plane filled by cp.async while the levels above compute cost more than
// it hid (its 4-byte copies took a third of a step, and it shrank the
// cross-section; PERF.md §6, PR 10).
//
// The masked kernel (masked_sweep_kernel) keeps the cube tile:
//   * one block per tile of the grid, threads along the fastest axis z;
//     the tile is the interior plus an n_sub-deep halo on every axis the
//     stencil moves along (a 2D grid [1, X, Y] has none on axis 0), loaded
//     with periodic wrap, so a partial tile at the grid's end is exact;
//   * the tile lives in ONE buffer of q values per cell (dynamic shared
//     memory, up to 227 KB, or a per-block slice of a global scratch),
//     followed by the cells' codes (1 B each) and, when populations are
//     frozen, their frozen bits (4 B) and a second buffer of q values
//     (TileLayout);
//   * streaming moves no data: population q of the tile cell c at sub-step
//     k lives in slot c - k off_q (off_q the flat offset of e_q), so a
//     collision reads its q values from their slots and writes the
//     post-collision values back to the same slots, and the next sub-step
//     finds each streamed value where its source left it. No two threads
//     touch one slot in a sub-step; a barrier separates sub-steps;
//   * a cell's uint8 code selects its kind from the per-code table
//     (collide, bounce back, a constant equilibrium, the per-node
//     equilibrium field, identity), the replacement pushed like a collided
//     population (replace_push); codes, frozen populations and the field
//     are read at the same periodically wrapped grid index as f;
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
// Its tile geometry is chosen on the host (build.py's plan_tile, which
// counts the masks' bytes per cell). One C entry serves both forms (a
// periodic launch passes null mask pointers) and launches one of the two
// kernels, so the periodic kernel carries none of the masked one's code.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "half_storage.cuh"
#include "stream_collide.cuh"

// the tile buffer: dynamic shared memory
extern __shared__ __align__(16) unsigned char lt_tile_smem[];

namespace lt {

// the threads of a masked K2 block
constexpr int kMultiBlock = 256;
// the dynamic shared memory a block may opt into on sm_90 (227 KB)
constexpr size_t kMaxTileSmem = 232448;
constexpr int kMaxDevices = 64;

// Whether the stencil moves along axis a of the 3D launch grid.
template <class S>
__host__ __device__ constexpr bool moves_along(int a) {
  for (int q = 0; q < S::Q; ++q)
    if (comp3<S>(q, a) != 0) return true;
  return false;
}

__host__ __device__ __forceinline__ int64_t wrap(int64_t x, int64_t n) {
  x %= n;
  return x < 0 ? x + n : x;
}

// wrap() for an x within one period of [0, n), without the division.
__device__ __forceinline__ int64_t wrap_near(int64_t x, int64_t n) {
  if (x < 0) {
    x += n;
  } else if (x >= n) {
    x -= n;
  }
  return x < 0 || x >= n ? wrap(x, n) : x;
}

// A block's share of the global scratch: its buffer's bytes rounded up to
// 16 (ops/cuda/stream_collide.py allocates blocks times this).
__host__ __device__ __forceinline__ size_t tile_stride(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

// The buffer of this block: its slice of the global scratch, or the
// dynamic shared memory.
template <class T>
__device__ __forceinline__ T* tile_buffer(T* scratch, size_t per_block) {
  return scratch != nullptr ? scratch + blockIdx.x * per_block
                            : reinterpret_cast<T*>(lt_tile_smem);
}

// The tile form of a storage St (what encode() writes back to a tile or a
// ring): its compute type, unrounded; deviations stay deviations.
template <class St>
struct TileStorage {
  using T = typename St::T;
  using V = T;
  static constexpr bool kDeviation = St::kDeviation;
  __device__ __forceinline__ static V pack(T x) { return x; }
};

// ---------------------------------------------------------------------------
// the march (the periodic K2, and K4 in adjoint_multi.cuh)
// ---------------------------------------------------------------------------
// The march axis: the slowest axis of the 3D launch grid the stencil moves
// along (0 in 3D, 1 for a 2D grid [1, X, Y]).
template <class S>
__host__ __device__ constexpr int march_axis() {
  return moves_along<S>(0) ? 0 : (moves_along<S>(1) ? 1 : 2);
}

// Cross axis i (0 or 1): the other two axes, in order.
template <class S, int i>
__host__ __device__ constexpr int cross_axis() {
  return i == 0 ? (march_axis<S>() == 0 ? 1 : 0)
                : (march_axis<S>() == 2 ? 1 : 2);
}

// One launch's columns: the grid, the cross-section's interior b on the
// cross axes and the segment's planes b on the march axis, the halo h and
// extent dim = b + 2h per cross axis, the planes collided before and after
// a segment (halo), and the units (segments x columns) the blocks take.
struct MarchGeom {
  int64_t n[3];
  int b[3];
  int h[2], dim[2];
  int cells, halo;
  int64_t units[3];  // segments, columns along cross axis 0, along axis 1
  int64_t nunits;
};

// The march of interior (b0, b1, b2) (on the march axis: the segment's
// planes) with ``halo`` cells on the cross axes the stencil moves along and
// ``march_halo`` planes before and after a segment; false if a size is out
// of range.
template <class S>
bool make_march(int64_t n0, int64_t n1, int64_t n2, int b0, int b1, int b2,
                int halo, int march_halo, MarchGeom& t) {
  constexpr int M = march_axis<S>();
  const int64_t n[3] = {n0, n1, n2};
  const int b[3] = {b0, b1, b2};
  const int cross[2] = {cross_axis<S, 0>(), cross_axis<S, 1>()};
  if (halo < 0 || march_halo < 0) return false;
  for (int a = 0; a < 3; ++a) {
    if (n[a] < 1 || b[a] < 1) return false;
    t.n[a] = n[a];
    t.b[a] = b[a];
  }
  int64_t cells = 1;
  t.units[0] = (n[M] + b[M] - 1) / b[M];
  t.nunits = t.units[0];
  for (int i = 0; i < 2; ++i) {
    const int a = cross[i];
    t.h[i] = moves_along<S>(a) ? halo : 0;
    t.dim[i] = b[a] + 2 * t.h[i];
    cells *= t.dim[i];
    t.units[i + 1] = (n[a] + b[a] - 1) / b[a];
    t.nunits *= t.units[i + 1];
  }
  if (cells > (int64_t(1) << 30)) return false;
  t.cells = static_cast<int>(cells);
  t.halo = march_halo;
  return true;
}

// The origin in the grid of a unit's column and segment (its first
// interior cell, its first stored plane). Neighbouring blocks take
// neighbouring columns of one segment, so they share halo rows in L2.
template <class S>
__device__ __forceinline__ void march_origin(const MarchGeom& t, int64_t unit,
                                             int64_t (&o)[3]) {
  constexpr int M = march_axis<S>(), A0 = cross_axis<S, 0>(),
                A1 = cross_axis<S, 1>();
  o[A1] = (unit % t.units[2]) * t.b[A1];
  unit /= t.units[2];
  o[A0] = (unit % t.units[1]) * t.b[A0];
  o[M] = (unit / t.units[1]) * t.b[M];
}

// The wrapped grid coordinates of cross cell c of the column of origin o.
template <class S>
__device__ __forceinline__ void cross_coords(const MarchGeom& t,
                                             const int64_t (&o)[3], int c,
                                             int64_t& g0, int64_t& g1) {
  constexpr int A0 = cross_axis<S, 0>(), A1 = cross_axis<S, 1>();
  g0 = wrap_near(o[A0] - t.h[0] + c / t.dim[1], t.n[A0]);
  g1 = wrap_near(o[A1] - t.h[1] + c % t.dim[1], t.n[A1]);
}

// The flat grid stride of axis a.
__device__ __forceinline__ int64_t grid_stride(const MarchGeom& t, int a) {
  return a == 0 ? t.n[1] * t.n[2] : (a == 1 ? t.n[2] : 1);
}

// Phase, once per unit: the flat grid offset of every cross cell of the
// column of origin o (its wrapped cross coordinates; the march plane's
// offset is added per plane), so the levels and the store index the grid
// without a division or a wrap per cell.
template <class S>
__device__ __forceinline__ void cross_table(const MarchGeom& t,
                                            const int64_t (&o)[3],
                                            int64_t* table) {
  const int64_t s0 = grid_stride(t, cross_axis<S, 0>()),
                s1 = grid_stride(t, cross_axis<S, 1>());
  for (int c = threadIdx.x; c < t.cells; c += blockDim.x) {
    int64_t g0, g1;
    cross_coords<S>(t, o, c, g0, g1);
    table[c] = g0 * s0 + g1 * s1;
  }
}

// A thread's walk over the cells of a box ext0 x ext1 (axis 1 fastest),
// strided by blockDim.x: (y, z) advance without a division per cell.
struct BoxWalk {
  int y, z, dy, dz, ext0, ext1;

  __device__ __forceinline__ BoxWalk(int e0, int e1)
      : y(int(threadIdx.x) / e1), z(int(threadIdx.x) % e1),
        dy(int(blockDim.x) / e1), dz(int(blockDim.x) % e1), ext0(e0),
        ext1(e1) {}
  __device__ __forceinline__ bool more() const { return y < ext0; }
  __device__ __forceinline__ void next() {
    y += dy;
    z += dz;
    if (z >= ext1) {
      z -= ext1;
      ++y;
    }
  }
};

// The cross cells at least r from the border on every cross axis with a
// halo (all cells on one without): a box of ext[0] x ext[1] from lo.
struct CrossBox {
  int lo[2], ext[2];
};

__device__ __forceinline__ CrossBox cross_box(const MarchGeom& t, int r) {
  CrossBox box;
  for (int i = 0; i < 2; ++i) {
    box.lo[i] = t.h[i] > 0 ? r : 0;
    box.ext[i] = t.dim[i] - 2 * box.lo[i];
  }
  return box;
}

// The cross cell at (y, z) of a box.
__device__ __forceinline__ int cross_cell(const MarchGeom& t,
                                          const CrossBox& box,
                                          const BoxWalk& w) {
  return (w.y + box.lo[0]) * t.dim[1] + w.z + box.lo[1];
}

// The interior of a column (a box of the cross-section interiors).
template <class S>
__device__ __forceinline__ BoxWalk interior_walk(const MarchGeom& t) {
  return BoxWalk(t.b[cross_axis<S, 0>()], t.b[cross_axis<S, 1>()]);
}

// Interior cell (y, z) of a column: false when it lies past the grid's end
// (a partial column); else its cross cell.
template <class S>
__device__ __forceinline__ bool march_interior(const MarchGeom& t,
                                               const int64_t (&o)[3],
                                               const BoxWalk& w, int& c) {
  if (o[cross_axis<S, 0>()] + w.y >= t.n[cross_axis<S, 0>()] ||
      o[cross_axis<S, 1>()] + w.z >= t.n[cross_axis<S, 1>()])
    return false;
  c = (w.y + t.h[0]) * t.dim[1] + w.z + t.h[1];
  return true;
}

// The flat cross offset of e_q.
template <class S, int q>
__device__ __forceinline__ int cross_offset(const MarchGeom& t) {
  return comp3<S>(q, cross_axis<S, 0>()) * t.dim[1] +
         comp3<S>(q, cross_axis<S, 1>());
}

// The march component e_m of population q.
template <class S>
__host__ __device__ constexpr int march_comp(int q) {
  return comp3<S>(q, march_axis<S>());
}

// A ring groups its populations by class k = e_m + 1: the populations of
// class k, and their index j within it (in the order of q).
template <class S>
__host__ __device__ constexpr int class_size(int k) {
  int n = 0;
  for (int q = 0; q < S::Q; ++q) n += march_comp<S>(q) + 1 == k;
  return n;
}

template <class S>
__host__ __device__ constexpr int class_index(int q) {
  int j = 0;
  for (int p = 0; p < q; ++p) j += march_comp<S>(p) == march_comp<S>(q);
  return j;
}

// The planes a ring keeps of class k: Sign +1 for a forward level's
// post-collision values, read by the level above at plane x + e_m (ages 0
// to 1 + e_m), Sign -1 for a backward level's cotangents, read at x - e_m
// (per population: ops/cuda/build.py's ring_depths).
template <class S, int Sign>
__host__ __device__ constexpr int class_depth(int k) {
  return 2 + Sign * (k - 1);
}

// Where class k starts in a ring, in cross cells times values: the
// classes below it, their planes of their populations.
template <class S, int Sign>
__host__ __device__ constexpr int class_offset(int k) {
  int at = 0;
  for (int i = 0; i < k; ++i) at += class_depth<S, Sign>(i) * class_size<S>(i);
  return at;
}

// The values of one ring per cross cell: 2 q (e_m = +1 and -1 pair up).
template <class S>
constexpr int kRing = 2 * S::Q;

// One ring as a phase sees it: per class k, its plane's block
// ([cross cell][population of the class]) at the slot of the plane the
// phase writes, or (pull) of the plane its populations are pulled from,
// plane - Sign (k - 1); and the block's stride of one cross row.
template <class S, int Sign, class T>
struct RingPlanes {
  T* at[3];
  int row[3];
};

template <class S, int Sign, class T>
__device__ __forceinline__ RingPlanes<S, Sign, T> ring_planes(
    T* ring, const MarchGeom& t, int plane, bool pull) {
  static_assert(class_offset<S, Sign>(3) == kRing<S>,
                "a ring holds 2 q values per cross cell");
  RingPlanes<S, Sign, T> r;
  static_for<3>([&](auto K_) {
    constexpr int k = decltype(K_)::value;
    constexpr int depth = class_depth<S, Sign>(k), size = class_size<S>(k);
    const int at = pull ? plane - Sign * (k - 1) : plane;
    r.at[k] = ring + (size_t(class_offset<S, Sign>(k)) +
                      size_t(at % depth) * size) *
                         t.cells;
    r.row[k] = t.dim[1] * size;
  });
  return r;
}

// The q values a level pulls at cross cell c: forward (Sign +1)
// population q from cell c - e, backward (Sign -1) from c + e, each in its
// class's block (the plane ring_planes chose).
template <class S, int Sign, class T, class V>
__device__ __forceinline__ void ring_pull(const RingPlanes<S, Sign, V>& r,
                                          int c, T (&v)[S::Q]) {
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    constexpr int k = march_comp<S>(q) + 1, n = class_size<S>(k),
                  j = class_index<S>(q);
    constexpr int e0 = comp3<S>(q, cross_axis<S, 0>()),
                  e1 = comp3<S>(q, cross_axis<S, 1>());
    v[q] = r.at[k][c * n - Sign * (e0 * r.row[k] + e1 * n) + j];
  });
}

// Where a forward level's post-collision population goes: its ring's
// block of the written plane, in the tile form of St.
template <class S, class St>
struct RingStore {
  const RingPlanes<S, 1, typename St::T>& r;
  int cell;

  template <int q>
  __device__ __forceinline__ void put(typename St::T value) const {
    constexpr int k = march_comp<S>(q) + 1;
    r.at[k][cell * class_size<S>(k) + class_index<S>(q)] =
        encode<TileStorage<St>, S, q>(value);
  }
};

// Phase: level k of the march on local plane ``plane`` (level 0: the
// grid's plane at offset plane_at): the collision C on the cross cells at
// least k from the border, into level k's ring. Level 0 reads the launch
// input f, a level above it pulls from level k - 1's ring.
template <class C, class St, bool First>
__device__ __forceinline__ void march_level(
    const typename C::Params& p, const typename St::V* __restrict__ f,
    typename St::T* ring, const int64_t* table, const MarchGeom& t, int k,
    int plane, int64_t plane_at) {
  using S = typename C::S;
  using T = typename C::T;
  T* mine = ring + size_t(k) * kRing<S> * t.cells;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const RingPlanes<S, 1, T> out = ring_planes<S, 1>(mine, t, plane, false);
  // level k - 1's ring (unused by level 0)
  const RingPlanes<S, 1, T> below = ring_planes<S, 1>(
      First ? mine : mine - kRing<S> * t.cells, t, First ? 1 : plane, true);
  const CrossBox box = cross_box(t, k);
  for (BoxWalk w(box.ext[0], box.ext[1]); w.more(); w.next()) {
    const int c = cross_cell(t, box, w);
    T fv[S::Q], u[S::D], rho, u2;
    if constexpr (First) {
      const int64_t gi = plane_at + table[c];
#pragma unroll
      for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(f + q * n + gi);
    } else {
      ring_pull<S, 1>(below, c, fv);
    }
    cell_moments<S, St::kDeviation>(fv, rho, u, u2);
    C::collide(p, fv, rho, u, u2, RingStore<S, St>{out, c});
  }
}

// Phase: the store of local plane ``plane`` (the grid's plane x): the
// interior pulled from the top level's ring into out, rounded to St.
template <class S, class St>
__device__ __forceinline__ void march_store(typename St::V* __restrict__ out,
                                            const typename St::T* top,
                                            const int64_t* table,
                                            const MarchGeom& t,
                                            const int64_t (&o)[3], int plane,
                                            int64_t x) {
  using T = typename St::T;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int64_t plane_at = x * grid_stride(t, march_axis<S>());
  const RingPlanes<S, 1, const T> in = ring_planes<S, 1>(top, t, plane, true);
  for (BoxWalk w = interior_walk<S>(t); w.more(); w.next()) {
    int c;
    if (!march_interior<S>(t, o, w, c)) continue;
    const int64_t gi = plane_at + table[c];
    T v[S::Q];
    ring_pull<S, 1>(in, c, v);
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      out[q * n + gi] = St::pack(v[q]);
    });
  }
}

// The planes of a unit's segment (fewer in the last one).
template <class S>
__device__ __forceinline__ int segment_planes(const MarchGeom& t,
                                              const int64_t (&o)[3]) {
  constexpr int M = march_axis<S>();
  const int64_t left = t.n[M] - o[M];
  return static_cast<int>(left < t.b[M] ? left : t.b[M]);
}

// A marched block's buffer: ``values`` ring values of T per cross cell,
// then (8-byte aligned) the cross cells' grid offsets (ops/cuda/build.py's
// march_bytes).
__host__ __device__ __forceinline__ size_t march_table_at(int cells,
                                                          size_t values,
                                                          size_t itemsize) {
  return (values * cells * itemsize + 7) / 8 * 8;
}

__host__ __device__ __forceinline__ size_t march_bytes(int cells,
                                                       size_t values,
                                                       size_t itemsize) {
  return march_table_at(cells, values, itemsize) +
         size_t(cells) * sizeof(int64_t);
}

// The block's buffer: a slice of the global scratch, else the dynamic
// shared memory. The kernels run their body once for each (march_units
// below): from a pointer the compiler sees derive from lt_tile_smem, the
// rings are read and written with shared-memory instructions and 32-bit
// addresses; a pointer that may be either would make every ring access a
// generic one (slower on the H100: PERF.md §6, PR 10).
template <class Body>
__device__ __forceinline__ void with_buffer(unsigned char* scratch,
                                            size_t bytes, Body&& body) {
  if (scratch == nullptr) {
    body(lt_tile_smem);
  } else {
    body(scratch + blockIdx.x * tile_stride(bytes));
  }
}

// The most threads a marched block takes (its __launch_bounds__, which
// caps its registers): 512 where the compute type is 4 bytes and the
// stencil has at most 19 populations (128 registers), else 256.
template <class S, class T>
constexpr int kMarchThreads = sizeof(T) == 4 && S::Q <= 19 ? 512 : 256;

// The units of one block, in the buffer at base: every unit's segment
// marched with n_sub levels and the store, a barrier after each
// (march_steps in ops/cuda/build.py).
template <class C, class St>
__device__ __forceinline__ void march_units(
    unsigned char* base, const typename St::V* __restrict__ f,
    typename St::V* __restrict__ out, const MarchGeom& t, int n_sub,
    const typename C::Params& p) {
  using S = typename C::S;
  using T = typename C::T;
  constexpr int M = march_axis<S>();
  const size_t values = size_t(n_sub) * kRing<S>;
  T* ring = reinterpret_cast<T*>(base);
  int64_t* table = reinterpret_cast<int64_t*>(
      base + march_table_at(t.cells, values, sizeof(T)));
  const T* top = ring + size_t(n_sub - 1) * kRing<S> * t.cells;
  const int64_t stride = grid_stride(t, M);
  for (int64_t unit = blockIdx.x; unit < t.nunits; unit += gridDim.x) {
    int64_t o[3];
    march_origin<S>(t, unit, o);
    cross_table<S>(t, o, table);
    __syncthreads();
    const int planes = segment_planes<S>(t, o);
    const int last = planes + 2 * n_sub - 1;  // the last local plane
    for (int s = 0; s <= last; ++s) {
      march_level<C, St, true>(p, f, ring, table, t, 0, s,
                               wrap_near(o[M] - n_sub + s, t.n[M]) * stride);
      __syncthreads();
      for (int k = 1; k < n_sub; ++k) {
        const int plane = s - k;
        if (plane >= k && plane <= last - k)
          march_level<C, St, false>(p, f, ring, table, t, k, plane, 0);
        __syncthreads();
      }
      const int plane = s - n_sub;
      if (plane >= n_sub && plane < n_sub + planes)
        march_store<S, St>(out, top, table, t, o, plane,
                           o[M] + plane - n_sub);
      __syncthreads();
    }
  }
}

// The periodic kernel; scratch (null: shared memory) holds
// tile_stride(march_bytes) per block.
template <class C, class St>
__global__ void __launch_bounds__(
    kMarchThreads<typename C::S, typename C::T>) march_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    unsigned char* scratch, const __grid_constant__ MarchGeom t, int n_sub,
    const __grid_constant__ typename C::Params p) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  with_buffer(scratch,
              march_bytes(t.cells, size_t(n_sub) * kRing<S>, sizeof(T)),
              [&](unsigned char* base) {
                march_units<C, St>(base, f, out, t, n_sub, p);
              });
}

// ---------------------------------------------------------------------------
// the cube tile (the masked K2)
// ---------------------------------------------------------------------------
// One launch's tiles: the grid [n0, n1, n2], the interior b and halo h per
// axis, the tile extents dim = b + 2h and the flat strides of a tile.
struct TileGeom {
  int64_t n[3];
  int b[3], h[3], dim[3];
  int cells, stride0, stride1;
  int tiles[3];
  int64_t ntiles;
};

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

// The parts of a masked K2 tile after its q values per cell, as byte
// offsets into the tile buffer: the cells' codes, and when populations are
// frozen a second buffer of q values and the cells' frozen bits (bit q:
// population q is frozen there).
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

// The masks of a masked K2 launch: the grid's (codes, no-streaming mask,
// per-node field; null when absent) and their tile copies (codes, frozen
// bits) with the second buffer for frozen values.
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
    m.codes[c] = __ldg(m.ncm + gi);
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
// tile's border; a cell whose code is not "collide" pushes its
// replacement instead (the single-step masked kernel's branch), the
// per-node field read at the cell's wrapped grid index.
template <class C, class St>
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
    const int code = m.codes[c];
    const int kind = kind_of(table.kind, code);
    if (kind != kCollide) {
      const int64_t gi = kind == kEquilibriumField ? tile_global(t, o, c) : 0;
      replace_push<S, St>(kind, table.value[code < kMaxCodes ? code : 0],
                          fv, m.feq_field, t.n[0] * t.n[1] * t.n[2], gi,
                          store);
      continue;
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

// The masked kernel: ncm is the grid's codes, nsm and feq_field (null when
// absent) its no-streaming mask and per-node field; scratch (null: shared
// memory) holds tile_stride bytes per block.
template <class C, class St>
__global__ void __launch_bounds__(kMultiBlock) masked_sweep_kernel(
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
  const TileLayout l = tile_layout<S, T>(t.cells, true, nsm != nullptr);
  unsigned char* base = tile_buffer(scratch, tile_stride(l.bytes));
  T* buf = reinterpret_cast<T*>(base);
  const TileMasks<St> m{
      ncm, nsm, feq_field, base + l.codes,
      nsm != nullptr ? reinterpret_cast<uint32_t*>(base + l.bits) : nullptr,
      nsm != nullptr ? reinterpret_cast<T*>(base + l.keep) : nullptr};
  for (int64_t tile = blockIdx.x; tile < t.ntiles; tile += gridDim.x) {
    int64_t o[3];
    tile_origin(t, tile, o);
    load_tile<S, St>(f, buf, t, o);
    load_masks<S, St>(m, t, o);
    __syncthreads();
    for (int k = 0; k < n_sub; ++k) {
      sub_step<C, St>(p, buf, t, k, m, table, o);
      __syncthreads();
      if (m.bits != nullptr) {
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
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

// The dynamic shared memory of a launch whose buffer takes ``bytes``: 0
// with a scratch, else bytes (and the kernel of instance Tag opted in); -1
// if it cannot run.
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

// One launch of the periodic (marched) kernel over the units of t with
// ``threads`` threads per block; returns cudaGetLastError().
template <class C, class St>
int start_march(const void* f, void* out, void* scratch, const MarchGeom& t,
                int n_sub, int blocks, int threads,
                const typename C::Params& p, int device, void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  const auto kernel = march_kernel<C, St>;
  if (threads < 1 || threads > kMarchThreads<S, T>)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  const int64_t smem = tile_smem<TileTag<C, St, std::false_type>>(
      kernel, march_bytes(t.cells, size_t(n_sub) * kRing<S>, sizeof(T)),
      scratch, device, err);
  if (smem < 0) return err;
  kernel<<<blocks, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(f), static_cast<V*>(out),
      static_cast<unsigned char*>(scratch), t, n_sub, p);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the masked kernel over the tiles of t; returns
// cudaGetLastError().
template <class C, class St>
int start_masked(const void* f, void* out, void* scratch, const void* ncm,
                 const void* nsm, const void* feq_field, const TileGeom& t,
                 int n_sub, int blocks, const typename C::Params& p,
                 const BoundaryTable<typename C::T>& table, int device,
                 void* stream) {
  using V = typename St::V;
  const auto kernel = masked_sweep_kernel<C, St>;
  const TileLayout l = tile_layout<typename C::S, typename C::T>(
      t.cells, true, nsm != nullptr);
  int err = 0;
  const int64_t smem = tile_smem<TileTag<C, St, std::true_type>>(
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

// Host launcher. A periodic launch (ncm null) marches: (b0, b1, b2) is the
// cross-section's interior on the cross axes and the segment's planes on
// the march axis, ``threads`` (at most kMarchThreads) per block, scratch
// (null for shared memory) holds blocks * tile_stride(march_bytes) bytes.
// A masked launch (ncm given; nsm and feq_field may be null, kinds and
// values are the host table, the single-step masked entries') runs the
// cube tiles of interior (b0, b1, b2) with kMultiBlock threads per block,
// scratch holding blocks * tile_stride(tile bytes). Returns
// cudaGetLastError().
template <class C, class St>
int launch_multi(const void* f, void* out, void* scratch, const void* ncm,
                 const void* nsm, const void* feq_field, const int32_t* kinds,
                 const double* values, int64_t n0, int64_t n1, int64_t n2,
                 int n_sub, int b0, int b1, int b2, int blocks, int threads,
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
  if (n_sub < 1 || blocks < 1 || (ncm == nullptr && nsm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncm == nullptr) {
    MarchGeom t;
    if (!make_march<S>(n0, n1, n2, b0, b1, b2, n_sub, n_sub, t))
      return static_cast<int>(cudaErrorInvalidValue);
    const int err = use_device(device);
    if (err != 0) return err;
    return start_march<C, St>(f, out, scratch, t, n_sub, blocks, threads, p,
                              device, stream);
  }
  TileGeom t;
  if (!make_geom<S>(n0, n1, n2, b0, b1, b2, n_sub, t))
    return static_cast<int>(cudaErrorInvalidValue);
  BoundaryTable<T> table{};
  if (!fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kMaxCodes; ++c)
    for (int q = 0; q < kMaxQ; ++q)
      table.value[c][q] = T(values[c * kMaxQ + q]);
  const int err = use_device(device);
  if (err != 0) return err;
  return start_masked<C, St>(f, out, scratch, ncm, nsm, feq_field, t, n_sub,
                             blocks, p, table, device, stream);
}

}  // namespace lt

// The blocked entry of POLICY on S with the storage STORAGE (whose compute
// type the policy runs in): n_sub sub-steps with ``blocks`` blocks and the
// global ``scratch`` or null; with ``ncm`` null a periodic launch marching
// columns of interior (b0, b1, b2) (the segment's planes on the march
// axis) with ``threads`` per block, else masked over cube tiles of
// interior (b0, b1, b2) (``threads`` unused; ``nsm`` and ``feq_field``
// null when absent; ``kinds`` and ``values`` the host table).
#define LT_MULTI_ENTRY(FRAG, STENCIL, POLICY, S, SUFFIX, STORAGE)             \
  int lt_multi_##FRAG##_##STENCIL##_##SUFFIX(                                 \
      const void* f, void* out, void* scratch, const void* ncm,              \
      const void* nsm, const void* feq_field, const int32_t* kinds,          \
      const double* values, int64_t n0, int64_t n1, int64_t n2, int n_sub,   \
      int b0, int b1, int b2, int blocks, int threads, const double* params, \
      double cs, int device, void* stream) {                                  \
    using C = POLICY<lt::S, typename STORAGE::T>;                             \
    return lt::launch_multi<C, STORAGE>(                                      \
        f, out, scratch, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        n_sub, b0, b1, b2, blocks, threads, C::load(params, cs), device,     \
        stream);                                                              \
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
