// Lattice stencils, compile-time stencil queries and the boundary-code
// table, shared by the fused stream-collide kernel (stream_collide.cu) and
// its adjoint (adjoint.cu).
//
// The stencil tables are compile-time constants: the q loops of both
// kernels unroll by template recursion, so every table lookup folds into
// the code. A 2D grid [X, Y] runs as the 3D grid [1, X, Y].

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace lt {

constexpr int kBlock = 128;

// Only the velocity moment (moments.cu) takes D1Q3: the stream-collide
// kernels run 2D and 3D grids.
struct D1Q3 {
  static constexpr int D = 1, Q = 3;
  __host__ __device__ static constexpr int e(int q, int a) {
    constexpr int t[Q][D] = {{0}, {1}, {-1}};
    return t[q][a];
  }
  __host__ __device__ static constexpr double w(int q) {
    return q == 0 ? 2.0 / 3.0 : 1.0 / 6.0;
  }
};

struct D2Q9 {
  static constexpr int D = 2, Q = 9;
  __host__ __device__ static constexpr int e(int q, int a) {
    constexpr int t[Q][D] = {{0, 0}, {1, 0},  {0, 1},   {-1, 0}, {0, -1},
                             {1, 1}, {-1, 1}, {-1, -1}, {1, -1}};
    return t[q][a];
  }
  __host__ __device__ static constexpr double w(int q) {
    return q == 0 ? 4.0 / 9.0 : q < 5 ? 1.0 / 9.0 : 1.0 / 36.0;
  }
};

struct D3Q15 {
  static constexpr int D = 3, Q = 15;
  __host__ __device__ static constexpr int e(int q, int a) {
    constexpr int t[Q][D] = {
        {0, 0, 0},  {1, 0, 0},   {-1, 0, 0},  {0, 1, 0},  {0, -1, 0},
        {0, 0, 1},  {0, 0, -1},  {1, 1, 1},   {-1, -1, -1}, {1, 1, -1},
        {-1, -1, 1}, {1, -1, 1}, {-1, 1, -1}, {1, -1, -1}, {-1, 1, 1}};
    return t[q][a];
  }
  __host__ __device__ static constexpr double w(int q) {
    return q == 0 ? 2.0 / 9.0 : q < 7 ? 1.0 / 9.0 : 1.0 / 72.0;
  }
};

struct D3Q19 {
  static constexpr int D = 3, Q = 19;
  __host__ __device__ static constexpr int e(int q, int a) {
    constexpr int t[Q][D] = {
        {0, 0, 0},  {1, 0, 0},   {-1, 0, 0}, {0, 1, 0},  {0, -1, 0},
        {0, 0, 1},  {0, 0, -1},  {0, 1, 1},  {0, -1, -1}, {0, 1, -1},
        {0, -1, 1}, {1, 0, 1},   {-1, 0, -1}, {1, 0, -1}, {-1, 0, 1},
        {1, 1, 0},  {-1, -1, 0}, {1, -1, 0}, {-1, 1, 0}};
    return t[q][a];
  }
  __host__ __device__ static constexpr double w(int q) {
    return q == 0 ? 1.0 / 3.0 : q < 7 ? 1.0 / 18.0 : 1.0 / 36.0;
  }
};

struct D3Q27 {
  static constexpr int D = 3, Q = 27;
  __host__ __device__ static constexpr int e(int q, int a) {
    constexpr int t[Q][D] = {
        {0, 0, 0},   {1, 0, 0},   {-1, 0, 0},  {0, 1, 0},   {0, -1, 0},
        {0, 0, 1},   {0, 0, -1},  {0, 1, 1},   {0, -1, -1}, {0, 1, -1},
        {0, -1, 1},  {1, 0, 1},   {-1, 0, -1}, {1, 0, -1},  {-1, 0, 1},
        {1, 1, 0},   {-1, -1, 0}, {1, -1, 0},  {-1, 1, 0},  {1, 1, 1},
        {-1, -1, -1}, {1, 1, -1}, {-1, -1, 1}, {1, -1, 1},  {-1, 1, -1},
        {1, -1, -1}, {-1, 1, 1}};
    return t[q][a];
  }
  __host__ __device__ static constexpr double w(int q) {
    return q == 0    ? 8.0 / 27.0
           : q < 7   ? 2.0 / 27.0
           : q < 19  ? 1.0 / 54.0
                     : 1.0 / 216.0;
  }
};

// ---------------------------------------------------------------------------
// compile-time stencil queries
// ---------------------------------------------------------------------------
template <class S>
__host__ __device__ constexpr int opposite(int q) {
  for (int p = 0; p < S::Q; ++p) {
    bool match = true;
    for (int a = 0; a < S::D; ++a) match = match && S::e(p, a) == -S::e(q, a);
    if (match) return p;
  }
  return -1;
}

template <class S>
__host__ __device__ constexpr bool is_rest(int q) {
  for (int a = 0; a < S::D; ++a)
    if (S::e(q, a) != 0) return false;
  return true;
}

// The forward pair cache is keyed on the direction whose first non-zero
// component is positive.
template <class S>
__host__ __device__ constexpr bool is_canonical(int q) {
  for (int a = 0; a < S::D; ++a) {
    if (S::e(q, a) > 0) return true;
    if (S::e(q, a) < 0) return false;
  }
  return true;
}

// Component of e_q along axis 0..2 of the 3D launch grid.
template <class S>
__host__ __device__ constexpr int comp3(int q, int axis) {
  return S::D == 3 ? S::e(q, axis) : (axis == 0 ? 0 : S::e(q, axis - 1));
}

template <class S>
constexpr bool pair_weights_symmetric() {
  for (int q = 0; q < S::Q; ++q) {
    const int p = opposite<S>(q);
    if (p < 0 || S::w(q) != S::w(p)) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// the periodic neighbourhood of one cell
// ---------------------------------------------------------------------------
struct Neighbours {
  int64_t x[3], y[3], z[3];  // coordinate - 1, coordinate, coordinate + 1
  int64_t n, n1, n2;         // cells, and the extents of axes 1 and 2
};

// Cell (i, j, k) of the [n0, n1, n2] grid with its periodic neighbours,
// precomputed per axis with a branch (never % on a negative).
__device__ __forceinline__ Neighbours neighbours(int64_t i, int64_t j,
                                                 int64_t k, int64_t n0,
                                                 int64_t n1, int64_t n2) {
  Neighbours nb;
  nb.n = n0 * n1 * n2;
  nb.n1 = n1;
  nb.n2 = n2;
  nb.x[0] = i == 0 ? n0 - 1 : i - 1;
  nb.x[1] = i;
  nb.x[2] = i == n0 - 1 ? 0 : i + 1;
  nb.y[0] = j == 0 ? n1 - 1 : j - 1;
  nb.y[1] = j;
  nb.y[2] = j == n1 - 1 ? 0 : j + 1;
  nb.z[0] = k == 0 ? n2 - 1 : k - 1;
  nb.z[1] = k;
  nb.z[2] = k == n2 - 1 ? 0 : k + 1;
  return nb;
}

// Flat index of population q at the cell displaced by sign * e_q.
template <class S, int q, int sign>
__device__ __forceinline__ int64_t shifted_index(const Neighbours& nb) {
  constexpr int ex = sign * comp3<S>(q, 0), ey = sign * comp3<S>(q, 1),
                ez = sign * comp3<S>(q, 2);
  return q * nb.n + (nb.x[ex + 1] * nb.n1 + nb.y[ey + 1]) * nb.n2 +
         nb.z[ez + 1];
}

// ---------------------------------------------------------------------------
// boundary codes of the masked kernels
// ---------------------------------------------------------------------------
// The uint8 no_collision_mask holds a code per cell; the per-code table says
// what the cell's post-collision populations are. The order is KINDS of
// ops/cuda/stream_collide.py.
enum Kind : int {
  kCollide = 0,           // BGK (code 0)
  kBounceBack = 1,        // f_post[q] = f[opposite(q)], pre-collision
  kEquilibrium = 2,       // f_post[q] = the table's constant feq[q]
  kEquilibriumField = 3,  // f_post[q] = feq_field[q, cell]
  kIdentity = 4,          // f_post[q] = f[q] (outlets the replay rewrites)
};

constexpr int kMaxCodes = 8;  // codes 0..7
constexpr int kMaxQ = 27;

// Passed by value as a kernel parameter (__grid_constant__, so indexing it
// with a run-time code reads the parameter bank, not a local copy).
template <class T>
struct BoundaryTable {
  int kind[kMaxCodes];
  T value[kMaxCodes][kMaxQ];  // kEquilibrium codes only
};

struct CodeKinds {
  int kind[kMaxCodes];
};

// The kind of a cell's code; a code outside the table is identity, as on
// the TPU kernel (unclaimed codes keep f).
__device__ __forceinline__ int kind_of(const int (&kinds)[kMaxCodes],
                                       int code) {
  return code < kMaxCodes ? kinds[code] : int(kIdentity);
}

// Copy the host arrays of a C entry into the table; false if a kind is
// out of range.
inline bool fill_kinds(const int32_t* kinds, int (&out)[kMaxCodes]) {
  for (int c = 0; c < kMaxCodes; ++c) {
    if (kinds[c] < kCollide || kinds[c] > kIdentity) return false;
    out[c] = kinds[c];
  }
  return true;
}

// Select the current device for a launch; returns a cudaError_t.
inline int use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

inline dim3 launch_grid(int64_t n0, int64_t n1, int64_t n2) {
  return dim3(static_cast<unsigned>((n2 + kBlock - 1) / kBlock),
              static_cast<unsigned>(n1), static_cast<unsigned>(n0));
}

}  // namespace lt
