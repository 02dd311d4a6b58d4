// The velocity moment of a state, u = j / rho, and its adjoint (K5), for
// Hopper (sm_90a).
//
// Replaces no kernel of lettuce_tpu: its Flow.u is jnp (rho = sum_q f_q,
// j = sum_q e_q f_q, u = j / rho), which XLA fuses with the loss around
// it. Under PyTorch the same expression runs as a reduction, a cuBLAS
// product and a broadcast division, and autograd's backward as a second
// product, the division's broadcast cotangents and a broadcast add of rho's
// cotangent into the state's: some 4.9 ms an iteration of the 256^3 D3Q19
// gradient, where one pass each way needs about 1.1 ms. Flow.u is the
// port's public observable (a differentiable workflow puts its loss on
// velocity or energy; the torch collisions, equilibria and pressure outlets
// of the outlet replay call it), so ops/cuda/moments.py routes it here:
//
//   K5 forward:  rho = sum_q f_q (float32), u_a = (sum_q e_qa f_q) / rho;
//   K5 adjoint:  with g the cotangent of u,
//                grad f_q = (e_q . g - u . g) / rho,
//
// the exact vector-Jacobian product (d u_a / d f_q = (e_qa - u_a) / rho).
//
// What bounds them: device memory. Per cell the forward reads the q stored
// populations and writes d values of u in the state's dtype and rho in
// float32; the adjoint reads g and u (d values each) and rho and writes q
// values of the cotangent: D3Q19 float32 moves 92 B and 104 B a cell
// (bfloat16 and float16 48 B and 54 B). The arithmetic is a few adds per
// population. The design streams:
//   * a thread owns the cells of one 16-byte access along the flat cell
//     index (4 float32 or 8 16-bit values; one cell when the count or the
//     pointers do not allow it), so every access of a warp is 512
//     contiguous bytes and a thread has its q loads in flight at once
//     (304 B at D3Q19 float32);
//   * the forward folds them in float32 as K1's pair-folded add tree
//     (stream_collide.cuh's moments: the rest population, then each
//     opposite pair's sum to rho and difference to j), divides once per
//     component and rounds each stored value once; rho is not written
//     when the caller keeps no gradient (a null rho);
//   * the adjoint loads g, u and rho once, forms u . g and 1 / rho per
//     cell, and writes each cotangent plane as one 16-byte store; it reads
//     no state;
//   * the 16-byte stores are streaming (__stcs, evict first): a thread's q
//     stores land in q planes n values apart, and with the default policy
//     the adjoint's 19 write streams took 0.97 ms at D3Q19 256^3 float32 on
//     an H100 SXM (59 % of a saxpy's rate), against 0.61 ms streaming
//     (chip_smoke.py phase 37; PERF.md's kernel table).
// The cell index is flat, so any grid dimension: D1Q3, D2Q9, D3Q15, D3Q19
// and D3Q27; float32, bfloat16 and float16 storage, computed in float32.
//
// Plain C interface, loaded with ctypes, per stencil and storage:
//   lt_velocity_<stencil>_<storage>(f, u, rho, n, vectors, device, stream)
//   lt_velocity_adjoint_<stencil>_<storage>(g, u, rho, out, n, vectors,
//                                           device, stream)
// n cells; vectors selects the 16-byte accesses (n a multiple of the
// lanes, every pointer 16-byte aligned, else cudaErrorInvalidValue). Each
// entry launches on the stream it is given and returns cudaGetLastError();
// it neither allocates nor synchronises.

#include <climits>
#include <initializer_list>

#include "half_storage.cuh"

namespace lt {

constexpr int kMomentThreads = 256;

// The values of one 16-byte access of the stored type, in float32: 8 of a
// 16-bit storage policy St (element 2i in the low half of word i)...
template <class St, class V = typename St::V>
struct Lanes {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const V* p, float (&x)[N]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = St::from_bits(static_cast<unsigned short>(w[i] & 0xffffu));
      x[2 * i + 1] = St::from_bits(static_cast<unsigned short>(w[i] >> 16));
    }
  }
  __device__ __forceinline__ static void store(V* p, const float (&x)[N]) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = unsigned(St::bits(St::pack(x[2 * i]))) |
             (unsigned(St::bits(St::pack(x[2 * i + 1]))) << 16);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(w[0], w[1], w[2], w[3]));
  }
};

// ... and 4 of float32.
template <class St>
struct Lanes<St, float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p,
                                              float (&x)[N]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p,
                                               const float (&x)[N]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
  }
};

// N consecutive stored values from p, in float32 (N = 1: one value).
template <class St, int N>
__device__ __forceinline__ void load_cells(const typename St::V* p,
                                           float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = St::raw(p);
  } else {
    Lanes<St>::load(p, x);
  }
}

template <class St, int N>
__device__ __forceinline__ void store_cells(typename St::V* p,
                                            const float (&x)[N]) {
  if constexpr (N == 1) {
    *p = St::pack(x[0]);
  } else {
    Lanes<St>::store(p, x);
  }
}

// N consecutive float32 values (rho), in 16-byte accesses when N > 1.
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + i));
      x[i] = v.x;
      x[i + 1] = v.y;
      x[i + 2] = v.z;
      x[i + 3] = v.w;
    }
  }
}

template <int N>
__device__ __forceinline__ void store_f32(float* p, const float (&x)[N]) {
  if constexpr (N == 1) {
    *p = x[0];
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      __stcs(reinterpret_cast<float4*>(p + i),
             make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]));
    }
  }
}

// acc + e_q . x, unrolled over the d components.
template <class S, int q, int a = 0>
__device__ __forceinline__ float add_e_dot(float acc, const float (&x)[S::D]) {
  if constexpr (a < S::D) {
    if constexpr (S::e(q, a) == 1) {
      acc = acc + x[a];
    } else if constexpr (S::e(q, a) == -1) {
      acc = acc - x[a];
    }
    return add_e_dot<S, q, a + 1>(acc, x);
  } else {
    return acc;
  }
}

// K5 forward: u (and rho unless it is null) of the N cells from
// group * N on.
template <class S, class St, int N>
__global__ void __launch_bounds__(kMomentThreads)
    velocity_kernel(const typename St::V* __restrict__ f,
                    typename St::V* __restrict__ u,
                    float* __restrict__ rho_out, int64_t n, int64_t groups) {
  const int64_t group =
      int64_t(blockIdx.x) * kMomentThreads + int64_t(threadIdx.x);
  if (group >= groups) return;
  const int64_t cell = group * N;
  float rho[N], j[N][S::D];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    rho[k] = 0.f;
#pragma unroll
    for (int a = 0; a < S::D; ++a) j[k][a] = 0.f;
  }
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    if constexpr (is_rest<S>(q)) {
      float x[N];
      load_cells<St, N>(f + q * n + cell, x);
#pragma unroll
      for (int k = 0; k < N; ++k) rho[k] = rho[k] + x[k];
    } else if constexpr (opposite<S>(q) > q) {
      float x[N], y[N];
      load_cells<St, N>(f + q * n + cell, x);
      load_cells<St, N>(f + opposite<S>(q) * n + cell, y);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        rho[k] = rho[k] + (x[k] + y[k]);
        add_pair_diff<S, float, q>(x[k] - y[k], j[k]);
      }
    }
  });
#pragma unroll
  for (int a = 0; a < S::D; ++a) {
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = j[k][a] / rho[k];
    store_cells<St, N>(u + a * n + cell, v);
  }
  if (rho_out != nullptr) store_f32<N>(rho_out + cell, rho);
}

// K5 adjoint: the cotangent of the state at the N cells from group * N on.
template <class S, class St, int N>
__global__ void __launch_bounds__(kMomentThreads)
    velocity_adjoint_kernel(const typename St::V* __restrict__ g,
                            const typename St::V* __restrict__ u,
                            const float* __restrict__ rho,
                            typename St::V* __restrict__ out, int64_t n,
                            int64_t groups) {
  const int64_t group =
      int64_t(blockIdx.x) * kMomentThreads + int64_t(threadIdx.x);
  if (group >= groups) return;
  const int64_t cell = group * N;
  float gv[N][S::D], ug[N], inv[N];
  load_f32<N>(rho + cell, inv);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    inv[k] = 1.f / inv[k];
    ug[k] = 0.f;
  }
#pragma unroll
  for (int a = 0; a < S::D; ++a) {
    float ga[N], ua[N];
    load_cells<St, N>(g + a * n + cell, ga);
    load_cells<St, N>(u + a * n + cell, ua);
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gv[k][a] = ga[k];
      ug[k] = ug[k] + ua[k] * ga[k];
    }
  }
  static_for<S::Q>([&](auto Q_) {
    constexpr int q = decltype(Q_)::value;
    float v[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      v[k] = (add_e_dot<S, q>(0.f, gv[k]) - ug[k]) * inv[k];
    }
    store_cells<St, N>(out + q * n + cell, v);
  });
}

// The groups a launch of n cells covers: n / N with the 16-byte accesses
// (-1 when N does not divide n or a pointer is not 16-byte aligned), else
// n.
template <int N>
inline int64_t moment_groups(int64_t n, int vectors,
                             std::initializer_list<const void*> pointers) {
  if (!vectors) return n;
  if (n % N != 0) return -1;
  for (const void* p : pointers) {
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return -1;
  }
  return n / N;
}

inline bool moment_blocks(int64_t groups, unsigned& blocks) {
  const int64_t b = (groups + kMomentThreads - 1) / kMomentThreads;
  if (groups < 0 || b > INT_MAX) return false;
  blocks = static_cast<unsigned>(b);
  return true;
}

template <class S, class St>
int launch_velocity(const void* f, void* u, void* rho, int64_t n,
                    int vectors, int device, void* stream) {
  using V = typename St::V;
  constexpr int N = Lanes<St>::N;
  const int err = use_device(device);
  if (err != 0) return err;
  const int64_t groups = moment_groups<N>(n, vectors, {f, u, rho});
  unsigned blocks = 0;
  if (!moment_blocks(groups, blocks)) return int(cudaErrorInvalidValue);
  if (blocks == 0) return int(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto fp = static_cast<const V*>(f);
  const auto up = static_cast<V*>(u);
  const auto rp = static_cast<float*>(rho);
  if (vectors) {
    velocity_kernel<S, St, N>
        <<<blocks, kMomentThreads, 0, s>>>(fp, up, rp, n, groups);
  } else {
    velocity_kernel<S, St, 1>
        <<<blocks, kMomentThreads, 0, s>>>(fp, up, rp, n, groups);
  }
  return int(cudaGetLastError());
}

template <class S, class St>
int launch_velocity_adjoint(const void* g, const void* u, const void* rho,
                            void* out, int64_t n, int vectors, int device,
                            void* stream) {
  using V = typename St::V;
  constexpr int N = Lanes<St>::N;
  const int err = use_device(device);
  if (err != 0) return err;
  const int64_t groups = moment_groups<N>(n, vectors, {g, u, rho, out});
  unsigned blocks = 0;
  if (!moment_blocks(groups, blocks)) return int(cudaErrorInvalidValue);
  if (blocks == 0) return int(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto gp = static_cast<const V*>(g);
  const auto up = static_cast<const V*>(u);
  const auto rp = static_cast<const float*>(rho);
  const auto op = static_cast<V*>(out);
  if (vectors) {
    velocity_adjoint_kernel<S, St, N>
        <<<blocks, kMomentThreads, 0, s>>>(gp, up, rp, op, n, groups);
  } else {
    velocity_adjoint_kernel<S, St, 1>
        <<<blocks, kMomentThreads, 0, s>>>(gp, up, rp, op, n, groups);
  }
  return int(cudaGetLastError());
}

}  // namespace lt

#define LT_VELOCITY_ENTRIES(STENCIL, S, SUFFIX, ST)                           \
  int lt_velocity_##STENCIL##_##SUFFIX(const void* f, void* u, void* rho,    \
                                       int64_t n, int vectors, int device,    \
                                       void* stream) {                        \
    return lt::launch_velocity<lt::S, ST>(f, u, rho, n, vectors, device,      \
                                          stream);                            \
  }                                                                           \
  int lt_velocity_adjoint_##STENCIL##_##SUFFIX(                               \
      const void* g, const void* u, const void* rho, void* out, int64_t n,    \
      int vectors, int device, void* stream) {                                \
    return lt::launch_velocity_adjoint<lt::S, ST>(g, u, rho, out, n,          \
                                                  vectors, device, stream);   \
  }

#define LT_VELOCITY_STENCIL(STENCIL, S)                                       \
  LT_VELOCITY_ENTRIES(STENCIL, S, f32, lt::Same<float>)                       \
  LT_VELOCITY_ENTRIES(STENCIL, S, bf16, lt::Bf16)                             \
  LT_VELOCITY_ENTRIES(STENCIL, S, f16, lt::F16Storage)

extern "C" {

LT_VELOCITY_STENCIL(d1q3, D1Q3)
LT_VELOCITY_STENCIL(d2q9, D2Q9)
LT_VELOCITY_STENCIL(d3q15, D3Q15)
LT_VELOCITY_STENCIL(d3q19, D3Q19)
LT_VELOCITY_STENCIL(d3q27, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
