// 16-bit storage of the state for the fused collide-and-stream kernels of
// stream_collide.cuh: the storage policies of K1f (a bfloat16 or float16
// state) and K1e (bfloat16 deviations g = f - w_q), both computing in
// float32, and the C entries of their instances.
//
// Replaces the 16-bit paths of
// lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel (:1402):
// the storage/compute split (:1492-1495) and deviation storage
// (``dev_storage``: _moments :1260-1261, each fragment's shifted base term,
// the shifted boundary table :1576-1577 and per-node field :1693-1698).
//
// What bounds them: device memory, as for the float32 kernels, at half the
// bytes: D3Q19 moves 19 * 2 B in and 19 * 2 B out per cell, 76 B per
// lattice update (36 B on D2Q9, 108 B on D3Q27; a masked instance adds the
// 1-byte code). The design keeps every fragment policy unchanged in
// float32 and moves the 16-bit handling into the storage policy:
//   * a load converts each population to float32 (exact), and under
//     deviation storage the cell's moments come from the deviations
//     (rho = 1 + sum_q g_q, j = sum_q e_q g_q, as the TPU kernel's _moments)
//     before each population gains its w_q, a compile-time constant;
//   * a store rounds to nearest even (__float2bfloat16_rn, __float2half_rn,
//     what torch's .to() and XLA's convert do), after subtracting w_q under
//     deviation storage;
//   * the boundary table stays in float32 (f-space); the per-node
//     equilibrium field is stored like the state and decoded like a
//     population; bounce back needs no shift (w_q = w_opposite(q)).
// The TPU kernel instead shifts each fragment's base term by the weights,
// which keeps a deviation's f32 roundoff relative to the deviation. Here a
// population is rebuilt as g + w_q in float32 before the policy runs, so
// its roundoff is that of f (~3e-8 near w_q ~ 0.3), far below a bf16 ulp
// of a typical deviation (~4e-6 at 1e-3) but not of one that crosses zero.
// The periodic instances run one thread per cell with 2-byte loads and
// stores, as the float32 kernels; the masked ones give a thread several
// consecutive cells of a row and move each population's values as one
// vector (stream_collide.cuh's masked_cells_kernel): cells<S>() per stencil
// and storage, as ops/cuda/build.py's SHIPPED_CELLS.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "stream_collide.cuh"

namespace lt {

// Cells a thread of a masked 16-bit instance (masked_cells_kernel), per
// stencil (D2Q9, D3Q15, D3Q19, D3Q27) and storage (bfloat16, float16,
// bfloat16 deviations), as ops/cuda/build.py's SHIPPED_CELLS: the fastest
// of 1, 2 and 4 on the obstacles (chip_smoke.py phase 36).
constexpr int kShippedCells[4][3] = {
    {4, 4, 4}, {2, 2, 2}, {4, 4, 4}, {2, 2, 2}};

template <class S>
constexpr int shipped_cells(int storage) {
  return kShippedCells[S::Q == 9 ? 0 : S::Q == 15 ? 1 : S::Q == 19 ? 2 : 3]
                      [storage];
}

// bfloat16 state (Dev = false) or bfloat16 deviations (Dev = true).
template <bool Dev>
struct Bf16Storage {
  using T = float;
  using V = __nv_bfloat16;
  static constexpr bool kDeviation = Dev;
  __device__ __forceinline__ static float raw(const V* p) {
    return __bfloat162float(__ldg(p));
  }
  __device__ __forceinline__ static V pack(float x) {
    return __float2bfloat16_rn(x);
  }
  __device__ __forceinline__ static float from_bits(unsigned short b) {
    return __bfloat162float(__ushort_as_bfloat16(b));
  }
  __device__ __forceinline__ static unsigned short bits(V v) {
    return __bfloat16_as_ushort(v);
  }
  template <class S>
  static constexpr int cells() {
    return shipped_cells<S>(Dev ? 2 : 0);
  }
};

// float16 state.
struct F16Storage {
  using T = float;
  using V = __half;
  static constexpr bool kDeviation = false;
  __device__ __forceinline__ static float raw(const V* p) {
    return __half2float(__ldg(p));
  }
  __device__ __forceinline__ static V pack(float x) {
    return __float2half_rn(x);
  }
  __device__ __forceinline__ static float from_bits(unsigned short b) {
    return __half2float(__ushort_as_half(b));
  }
  __device__ __forceinline__ static unsigned short bits(V v) {
    return __half_as_ushort(v);
  }
  template <class S>
  static constexpr int cells() {
    return shipped_cells<S>(1);
  }
};

using Bf16 = Bf16Storage<false>;
using Bf16Dev = Bf16Storage<true>;

}  // namespace lt

// The 16-bit entries of a collision fragment: bfloat16 and float16 state
// (K1f) and bfloat16 deviations (K1e), periodic and masked.
#define LT_HALF_ENTRIES(FRAG, STENCIL, POLICY, S)                             \
  LT_HALF_STATE_ENTRIES(FRAG, STENCIL, POLICY, S)                             \
  LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, bf16_dev, lt::Bf16Dev)

// K1d at 16 bits: the emit-u entries of a fragment on a bfloat16 or
// float16 state, u in float32 (deviation storage has no gradient).
#define LT_HALF_EMIT_U_ENTRIES(FRAG, STENCIL, POLICY, S)                      \
  LT_COLLIDE_EMIT_U_ENTRY(FRAG, STENCIL, POLICY, S, bf16, lt::Bf16)           \
  LT_COLLIDE_EMIT_U_ENTRY(FRAG, STENCIL, POLICY, S, f16, lt::F16Storage)

// K1f only: a fragment that deviation storage refuses.
#define LT_HALF_STATE_ENTRIES(FRAG, STENCIL, POLICY, S)                       \
  LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, bf16, lt::Bf16)                  \
  LT_COLLIDE_ENTRY(FRAG, STENCIL, POLICY, S, f16, lt::F16Storage)
