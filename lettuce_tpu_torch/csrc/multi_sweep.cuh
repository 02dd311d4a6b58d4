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
// The masked kernel (masked_march_kernel) marches the same columns in the
// same order, with the boundary codes, the per-node field and frozen
// populations of every sub-step:
//   * level 0 reads each cell's uint8 code (and, when populations are
//     frozen, its no-streaming bits) at the wrapped grid index, the index
//     it reads f at, into a row of n_sub + 1 code rows (and bit rows, 4 B
//     per cell) in shared memory; level k and the store read the row of
//     their plane (the row of plane p is rewritten at step p + n_sub + 1,
//     after the store read it at step p + n_sub);
//   * a cell whose code is "collide" runs the policy; any other kind
//     writes its replacement into the cell's own ring slots (bounce back
//     from its pulled populations, a constant equilibrium, the per-node
//     field read at the grid index, identity: replace_push), so a pulling
//     level needs no push;
//   * a frozen population q at (plane p, cross cell c) takes level k - 1's
//     post-collision value at (p, c), not the pulled one at
//     (p - e_m, c - e): the destination select of the TPU kernel's
//     freeze. The compact ring keeps a population with e_m = -1 one plane
//     only, and plane p's is overwritten by plane p + 1 in the step that
//     reads it, so a frozen launch keeps that class two planes (ring_keep
//     more values per level and cross cell);
//   * a bounded grid wraps like a periodic one: its walls' codes make the
//     wrap harmless, as on the single-step kernel.
// Where the cross-section is a row (a 2D grid) it is small enough that
// several blocks share an SM, and one block's loads hide behind the
// others' levels (ops/cuda/build.py's row budgets). One C entry serves
// both forms (a periodic launch passes null mask pointers) and launches one
// of the two kernels, so the periodic kernel carries none of the masked
// one's code.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "half_storage.cuh"
#include "stream_collide.cuh"

// the tile buffer: dynamic shared memory
extern __shared__ __align__(16) unsigned char lt_tile_smem[];

namespace lt {

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

// The ring form of a storage St (what encode() writes back to a ring): its compute type, unrounded; deviations stay deviations.
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

// The values a masked launch with frozen populations adds to a forward
// ring per cross cell: a second plane of class 0 (e_m = -1), which a
// frozen population reads on its own plane after the next plane's values
// were written (ops/cuda/build.py's ring_keep).
template <class S>
__host__ __device__ constexpr int ring_keep() {
  return class_size<S>(0);
}

// One ring as a phase sees it: per class k, its plane's block
// ([cross cell][population of the class]) at the slot of the plane the
// phase writes, or (pull) of the plane its populations are pulled from,
// plane - Sign (k - 1); and the block's stride of one cross row. With
// ``keep`` 1 class 0 keeps one plane more (a forward ring of a frozen
// launch; the periodic kernels pass 0).
template <class S, int Sign, class T>
struct RingPlanes {
  T* at[3];
  int row[3];
};

template <class S, int Sign, class T>
__device__ __forceinline__ RingPlanes<S, Sign, T> ring_planes(
    T* ring, const MarchGeom& t, int plane, bool pull, int keep = 0) {
  static_assert(class_offset<S, Sign>(3) == kRing<S>,
                "a ring holds 2 q values per cross cell");
  RingPlanes<S, Sign, T> r;
  static_for<3>([&](auto K_) {
    constexpr int k = decltype(K_)::value;
    constexpr int size = class_size<S>(k), depth = class_depth<S, Sign>(k);
    const int offset =
        class_offset<S, Sign>(k) + (k == 0 ? 0 : keep * ring_keep<S>());
    const int at = pull ? plane - Sign * (k - 1) : plane;
    // the slot of plane ``at``, by constant divisors: a phase runs this
    // for every class, and a block's thread often has one cell per phase
    const int slot =
        k == 0 && keep ? at % (depth + 1) : at % depth;
    r.at[k] = ring + (size_t(offset) + size_t(slot) * size) * t.cells;
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
// block of the written plane, in the ring form of St.
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

// The destination select of frozen populations: population q of cross
// cell c (bit q of ``frozen``) takes the lower level's post-collision value
// at the cell itself, from ``here`` (the ring's blocks of the cell's own
// plane), in place of the pulled one.
template <class S, class T, class V>
__device__ __forceinline__ void frozen_select(const RingPlanes<S, 1, V>& here,
                                              int c, uint32_t frozen,
                                              T (&v)[S::Q]) {
  if (frozen == 0) return;
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    constexpr int k = march_comp<S>(q) + 1;
    if ((frozen >> q) & 1u)
      v[q] = here.at[k][c * class_size<S>(k) + class_index<S>(q)];
  });
}

// Phase: the store of local plane ``plane`` (the grid's plane x): the
// interior pulled from the top level's ring into out, rounded to St; with
// ``bits`` (the plane's row of frozen bits; the periodic kernel passes
// none) the frozen populations selected at their cell.
template <class S, class St>
__device__ __forceinline__ void march_store(
    typename St::V* __restrict__ out, const typename St::T* top,
    const int64_t* table, const MarchGeom& t, const int64_t (&o)[3],
    int plane, int64_t x, const uint32_t* bits = nullptr, int keep = 0) {
  using T = typename St::T;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const int64_t plane_at = x * grid_stride(t, march_axis<S>());
  const RingPlanes<S, 1, const T> in =
      ring_planes<S, 1>(top, t, plane, true, keep);
  RingPlanes<S, 1, const T> here = in;
  if (bits != nullptr) here = ring_planes<S, 1>(top, t, plane, false, keep);
  for (BoxWalk w = interior_walk<S>(t); w.more(); w.next()) {
    int c;
    if (!march_interior<S>(t, o, w, c)) continue;
    const int64_t gi = plane_at + table[c];
    T v[S::Q];
    ring_pull<S, 1>(in, c, v);
    if (bits != nullptr) frozen_select<S>(here, c, bits[c], v);
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
// the masked march (the masked K2)
// ---------------------------------------------------------------------------
// A marched block's buffer with masks: the rings, the cross cells' grid
// offsets (march_bytes), then ``mask_rows`` rows of one code per cross
// cell and, with frozen populations, as many rows of frozen bits (bit q:
// population q is frozen there), 4-byte aligned (ops/cuda/build.py's
// march_bytes).
struct MarchLayout {
  size_t table, codes, bits, bytes;
};

__host__ __device__ __forceinline__ MarchLayout march_layout(int cells,
                                                             size_t values,
                                                             size_t itemsize,
                                                             int mask_rows,
                                                             bool frozen) {
  MarchLayout l;
  l.table = march_table_at(cells, values, itemsize);
  l.codes = march_bytes(cells, values, itemsize);
  l.bits = (l.codes + size_t(mask_rows) * cells + 3) / 4 * 4;
  l.bytes = frozen ? l.bits + size_t(mask_rows) * cells * sizeof(uint32_t)
                   : l.codes + size_t(mask_rows) * cells;
  return l;
}

// The ring values of one level of a masked launch per cross cell.
template <class S>
__host__ __device__ __forceinline__ int masked_level_values(bool frozen) {
  return kRing<S> + (frozen ? ring_keep<S>() : 0);
}

// The buffer of a masked launch of n_sub levels (n_sub + 1 mask rows).
template <class S>
__host__ __device__ __forceinline__ MarchLayout masked_layout(
    int cells, int n_sub, size_t itemsize, bool frozen) {
  return march_layout(cells, size_t(n_sub) * masked_level_values<S>(frozen),
                      itemsize, n_sub + 1, frozen);
}

// The grid's masks of a masked launch: codes, no-streaming mask and
// per-node field (the last two null when absent).
template <class St>
struct MarchMasks {
  const uint8_t* __restrict__ ncm;
  const uint8_t* __restrict__ nsm;
  const typename St::V* __restrict__ feq_field;
};

// Phase: level k of the masked march on local plane ``plane`` (the grid's
// plane at offset plane_at), on the cross cells at least k from the
// border. Level 0 reads the launch input, and the plane's codes (and
// frozen bits) into their rows ``codes`` and ``bits`` (the plane's; bits
// null when nothing is frozen); a level above pulls from level k - 1's
// ring, a frozen population from level k - 1's value at the cell itself
// (frozen_select), and reads the rows. Then the cell's kind: the collision
// C, or the replacement (replace_push), into level k's ring.
template <class C, class St, bool First>
__device__ __forceinline__ void masked_level(
    const typename C::Params& p, const BoundaryTable<typename C::T>& bt,
    const typename St::V* __restrict__ f, const MarchMasks<St>& m,
    typename St::T* ring, const int64_t* table, uint8_t* codes,
    uint32_t* bits, const MarchGeom& t, int k, int plane, int64_t plane_at,
    int keep) {
  using S = typename C::S;
  using T = typename C::T;
  const size_t level = size_t(masked_level_values<S>(keep != 0)) * t.cells;
  T* mine = ring + k * level;
  const int64_t n = t.n[0] * t.n[1] * t.n[2];
  const RingPlanes<S, 1, T> out =
      ring_planes<S, 1>(mine, t, plane, false, keep);
  // level k - 1's ring (unused by level 0): pulled, and (frozen launches)
  // at the cell's own plane
  T* lower = First ? mine : mine - level;
  const RingPlanes<S, 1, T> below =
      ring_planes<S, 1>(lower, t, First ? 1 : plane, true, keep);
  RingPlanes<S, 1, T> here = below;
  if (!First && bits != nullptr)
    here = ring_planes<S, 1>(lower, t, plane, false, keep);
  const CrossBox box = cross_box(t, k);
  for (BoxWalk w(box.ext[0], box.ext[1]); w.more(); w.next()) {
    const int c = cross_cell(t, box, w);
    T fv[S::Q], u[S::D], rho, u2;
    int code;
    if constexpr (First) {
      const int64_t gi = plane_at + table[c];
#pragma unroll
      for (int q = 0; q < S::Q; ++q) fv[q] = St::raw(f + q * n + gi);
      code = __ldg(m.ncm + gi);
      codes[c] = static_cast<uint8_t>(code);
      if (bits != nullptr) {
        uint32_t b = 0;
#pragma unroll
        for (int q = 0; q < S::Q; ++q)
          b |= uint32_t(__ldg(m.nsm + q * n + gi) != 0) << q;
        bits[c] = b;
      }
    } else {
      ring_pull<S, 1>(below, c, fv);
      if (bits != nullptr) frozen_select<S>(here, c, bits[c], fv);
      code = codes[c];
    }
    cell_moments<S, St::kDeviation>(fv, rho, u, u2);
    // the cell's post-collision values, gathered as the single-step
    // masked kernel gathers them, then one store to the ring for every kind
    T post[S::Q];
    const int kind = kind_of(bt.kind, code);
    if (kind == kCollide) {
      C::collide(p, fv, rho, u, u2, LocalStore<T>{post});
    } else {
      const int64_t gi = kind == kEquilibriumField ? plane_at + table[c] : 0;
      replace_push<S, St>(kind, bt.value[code < kMaxCodes ? code : 0], fv,
                          m.feq_field, n, gi, LocalStore<T>{post});
    }
    const RingStore<S, St> store{out, c};
    static_for<S::Q>([&](auto Q_) {
      constexpr int q = decltype(Q_)::value;
      store.template put<q>(post[q]);
    });
  }
}

// The units of one masked block, in the buffer at base: march_units'
// schedule with masked levels, the mask rows of plane p at row
// p % (n_sub + 1), and the frozen select in the store.
template <class C, class St>
__device__ __forceinline__ void masked_march_units(
    unsigned char* base, const typename St::V* __restrict__ f,
    typename St::V* __restrict__ out, const MarchGeom& t, int n_sub,
    const typename C::Params& p, const BoundaryTable<typename C::T>& bt,
    const MarchMasks<St>& m) {
  using S = typename C::S;
  using T = typename C::T;
  constexpr int M = march_axis<S>();
  const int keep = m.nsm != nullptr;
  const MarchLayout l = masked_layout<S>(t.cells, n_sub, sizeof(T), keep);
  T* ring = reinterpret_cast<T*>(base);
  int64_t* table = reinterpret_cast<int64_t*>(base + l.table);
  uint8_t* codes = base + l.codes;
  uint32_t* bits =
      keep ? reinterpret_cast<uint32_t*>(base + l.bits) : nullptr;
  const T* top =
      ring + size_t(n_sub - 1) * masked_level_values<S>(keep) * t.cells;
  const int64_t stride = grid_stride(t, M);
  const int rows = n_sub + 1;
  for (int64_t unit = blockIdx.x; unit < t.nunits; unit += gridDim.x) {
    int64_t o[3];
    march_origin<S>(t, unit, o);
    cross_table<S>(t, o, table);
    __syncthreads();
    const int planes = segment_planes<S>(t, o);
    const int last = planes + 2 * n_sub - 1;  // the last local plane
    // the mask row of plane s (s % rows), kept without a division per step
    for (int s = 0, row_s = 0; s <= last;
         ++s, row_s = row_s + 1 == rows ? 0 : row_s + 1) {
      for (int k = 0; k < n_sub; ++k) {
        const int plane = s - k;
        if (plane >= k && plane <= last - k) {
          const int row =
              (row_s >= k ? row_s - k : row_s - k + rows) * t.cells;
          const int64_t plane_at =
              wrap_near(o[M] - n_sub + plane, t.n[M]) * stride;
          uint32_t* plane_bits = keep ? bits + row : nullptr;
          if (k == 0) {
            masked_level<C, St, true>(p, bt, f, m, ring, table, codes + row,
                                      plane_bits, t, 0, plane, plane_at,
                                      keep);
          } else {
            masked_level<C, St, false>(p, bt, f, m, ring, table,
                                       codes + row, plane_bits, t, k, plane,
                                       plane_at, keep);
          }
        }
        __syncthreads();
      }
      const int plane = s - n_sub;
      const int row = row_s >= n_sub ? row_s - n_sub : row_s - n_sub + rows;
      if (plane >= n_sub && plane < n_sub + planes)
        march_store<S, St>(out, top, table, t, o, plane,
                           o[M] + plane - n_sub,
                           keep ? bits + row * t.cells : nullptr, keep);
      __syncthreads();
    }
  }
}

// The launch bounds of a masked block. On a 2D grid its cross-section is a
// row and several blocks share an SM (ops/cuda/build.py's row budgets): at
// most 256 threads, and in float32 compute registers for 1024 threads per
// SM (64 a thread: eight blocks of 128; at the periodic kernel's bound the
// D2Q9 instance took 111, and four blocks filled an SM's registers, PERF.md
// §6). Else the periodic kernel's bounds.
template <class S, class T>
constexpr int kMaskedThreads = S::D == 2 ? 256 : kMarchThreads<S, T>;
template <class S, class T>
constexpr int kMaskedMinBlocks = S::D == 2 && sizeof(T) == 4 ? 4 : 1;

// The masked kernel: ncm is the grid's codes, nsm and feq_field (null when
// absent) its no-streaming mask and per-node field; scratch (null: shared
// memory) holds tile_stride(masked_layout) per block.
template <class C, class St>
__global__ void __launch_bounds__(
    kMaskedThreads<typename C::S, typename C::T>,
    kMaskedMinBlocks<typename C::S, typename C::T>) masked_march_kernel(
    const typename St::V* __restrict__ f, typename St::V* __restrict__ out,
    unsigned char* scratch, const __grid_constant__ MarchGeom t, int n_sub,
    const __grid_constant__ typename C::Params p,
    const uint8_t* __restrict__ ncm, const uint8_t* __restrict__ nsm,
    const typename St::V* __restrict__ feq_field,
    const __grid_constant__ BoundaryTable<typename C::T> table) {
  using S = typename C::S;
  using T = typename C::T;
  static_assert(std::is_same_v<T, typename St::T>,
                "the policy computes in the storage's compute type");
  const MarchMasks<St> m{ncm, nsm, feq_field};
  with_buffer(scratch,
              masked_layout<S>(t.cells, n_sub, sizeof(T), nsm != nullptr)
                  .bytes,
              [&](unsigned char* base) {
                masked_march_units<C, St>(base, f, out, t, n_sub, p, table,
                                          m);
              });
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

// One launch of the masked kernel over the units of t with ``threads``
// threads per block; returns cudaGetLastError().
template <class C, class St>
int start_masked_march(const void* f, void* out, void* scratch,
                       const void* ncm, const void* nsm,
                       const void* feq_field, const MarchGeom& t, int n_sub,
                       int blocks, int threads, const typename C::Params& p,
                       const BoundaryTable<typename C::T>& table, int device,
                       void* stream) {
  using S = typename C::S;
  using T = typename C::T;
  using V = typename St::V;
  const auto kernel = masked_march_kernel<C, St>;
  if (threads < 1 || threads > kMaskedThreads<S, T>)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  const int64_t smem = tile_smem<TileTag<C, St, std::true_type>>(
      kernel, masked_layout<S>(t.cells, n_sub, sizeof(T), nsm != nullptr).bytes,
      scratch, device, err);
  if (smem < 0) return err;
  kernel<<<blocks, threads, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(f), static_cast<V*>(out),
      static_cast<unsigned char*>(scratch), t, n_sub, p,
      static_cast<const uint8_t*>(ncm), static_cast<const uint8_t*>(nsm),
      static_cast<const V*>(feq_field), table);
  return static_cast<int>(cudaGetLastError());
}

// Host launcher. Both forms march: (b0, b1, b2) is the cross-section's
// interior on the cross axes and the segment's planes on the march axis,
// ``threads`` per block (at most kMarchThreads, a masked one
// kMaskedThreads). A periodic launch (ncm null) runs march_kernel, scratch (null for shared memory) holding
// blocks * tile_stride(march_bytes) bytes; a masked launch (ncm given;
// nsm and feq_field may be null, kinds and values are the host table, the
// single-step masked entries') runs masked_march_kernel, scratch holding
// blocks * tile_stride(masked_layout's bytes). Returns cudaGetLastError().
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
  static_assert(sizeof(typename C::Params) + sizeof(MarchGeom) +
                        sizeof(BoundaryTable<T>) + 96 <=
                    kMaxParamBytes,
                "kernel parameters exceed the launch's parameter space");
  if (n_sub < 1 || blocks < 1 || (ncm == nullptr && nsm != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  MarchGeom t;
  if (!make_march<S>(n0, n1, n2, b0, b1, b2, n_sub, n_sub, t))
    return static_cast<int>(cudaErrorInvalidValue);
  if (ncm == nullptr) {
    const int err = use_device(device);
    if (err != 0) return err;
    return start_march<C, St>(f, out, scratch, t, n_sub, blocks, threads, p,
                              device, stream);
  }
  BoundaryTable<T> table{};
  if (!fill_kinds(kinds, table.kind))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < kMaxCodes; ++c)
    for (int q = 0; q < kMaxQ; ++q)
      table.value[c][q] = T(values[c * kMaxQ + q]);
  const int err = use_device(device);
  if (err != 0) return err;
  return start_masked_march<C, St>(f, out, scratch, ncm, nsm, feq_field, t,
                                   n_sub, blocks, threads, p, table, device,
                                   stream);
}

}  // namespace lt

// The blocked entry of POLICY on S with the storage STORAGE (whose compute
// type the policy runs in): n_sub sub-steps with ``blocks`` blocks of
// ``threads`` and the global ``scratch`` or null, marching columns of
// interior (b0, b1, b2) (the segment's planes on the march axis); with
// ``ncm`` null a periodic launch, else masked (``nsm`` and ``feq_field``
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
