// Fused BGK collide-and-stream step for Hopper (sm_90a).
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel
// with the "bgk" collision fragment, no masks and one step per launch
// (n_sub = 1): it computes the same function as
// fused_stream_collide(f, e, w, opposite, cs, tau_inv).
//
// What bounds it: device memory. The arithmetic is a few flops per
// population; the traffic is the state itself. D3Q19 in float32 reads
// 19 * 4 B and writes 19 * 4 B per cell: 152 B per lattice update. The
// design reads each population once and writes it once:
//   * one thread per lattice cell, threads along the last (fastest) axis,
//     so every f[q, .] load of a warp is coalesced;
//   * the cell's q populations stay in registers; rho and j come from the
//     pair-folded add tree of _moments; the collided populations use the
//     opposite-pair (G, H) cache of the BGK fragment;
//   * each collided population is pushed to out[q, (x + e_q) mod N], the
//     same map as the TPU kernel's pull f_out[q, x] = f_post[q, x - e_q].
//     No neighbour is collided twice and no halo is loaded.
// The step is out of place (f -> out): a push into f itself would race.
//
// The stencil tables are compile-time constants: the q loops unroll by
// template recursion, so every table lookup folds into the code. A 2D grid
// [X, Y] runs as the 3D grid [1, X, Y].
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance. Each entry launches on the stream it is given and returns
// cudaGetLastError(); it neither allocates nor synchronises.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;

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

// The pair cache is keyed on the direction whose first non-zero component
// is positive.
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

struct Neighbours {
  int64_t x[3], y[3], z[3];  // coordinate - 1, coordinate, coordinate + 1
  int64_t n, n1, n2;         // cells, and the extents of axes 1 and 2
};

template <class S, class T, int q>
__device__ __forceinline__ void push(T* __restrict__ out, const Neighbours& nb,
                                     T value) {
  constexpr int ex = comp3<S>(q, 0), ey = comp3<S>(q, 1), ez = comp3<S>(q, 2);
  out[q * nb.n + (nb.x[ex + 1] * nb.n1 + nb.y[ey + 1]) * nb.n2 +
      nb.z[ez + 1]] = value;
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

template <class S, class T>
__global__ void __launch_bounds__(kBlock)
    stream_collide_kernel(const T* __restrict__ f, T* __restrict__ out,
                          int64_t n0, int64_t n1, int64_t n2, T tau_inv,
                          T inv_cs2, T half_inv_cs2) {
  const int64_t k = int64_t(blockIdx.x) * kBlock + threadIdx.x;
  if (k >= n2) return;
  const int64_t j = blockIdx.y;
  const int64_t i = blockIdx.z;

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
    u2 = u2 + ua * ua;
    up[a] = ua * inv_cs2;
  }

  const T keep = T(1) - tau_inv;
  const T base = tau_inv * (rho - rho * (u2 * half_inv_cs2));
  const T trho = tau_inv * rho;
  collide_push<S, T>(fv, out, nb, keep, base, trho, up);
}

template <class S, class T>
int launch(const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,
           T tau_inv, double cs, int device, void* stream) {
  static_assert(pair_weights_symmetric<S>(),
                "the pair cache needs w[q] == w[opposite[q]]");
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const double cs2 = cs * cs;
  const dim3 grid(static_cast<unsigned>((n2 + kBlock - 1) / kBlock),
                  static_cast<unsigned>(n1), static_cast<unsigned>(n0));
  stream_collide_kernel<S, T>
      <<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(f), static_cast<T*>(out), n0, n1, n2, tau_inv,
          T(1.0 / cs2), T(0.5 / cs2));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LT_ENTRY(NAME, S, T)                                                  \
  int NAME(const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,     \
           T tau_inv, double cs, int device, void* stream) {                  \
    return launch<S, T>(f, out, n0, n1, n2, tau_inv, cs, device, stream);     \
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

const char* lt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
