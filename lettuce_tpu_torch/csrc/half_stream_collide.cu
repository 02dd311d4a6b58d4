// The 16-bit BGK instances of the fused collide-and-stream step for Hopper
// (sm_90a): K1f (bfloat16 and float16 state) and K1e (bfloat16 deviations
// g = f - w_q), each periodic and masked, for D2Q9, D3Q15, D3Q19 and D3Q27;
// and the emit-u instances of a 16-bit state (K1d at 16 bits: the forward
// of its gradient, u written in float32, stream_collide.py:1778-1779).
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel
// (:1402) with the "bgk" fragment on a 16-bit state (:1492-1495) and with
// ``dev_storage`` (:1260, :553). What bounds it and how the storage works:
// half_storage.cuh. The kernel templates and the BGK policy are those of
// stream_collide.cuh, run in float32.
//
// Plain C interface, loaded with ctypes: the entries of stream_collide.cu
// with the suffix bf16, f16 or bf16_dev (emit-u: bf16 and f16), tau_inv as
// a float.

#include "half_storage.cuh"

#define LT_HALF_BGK_ENTRY(STENCIL, S, SUFFIX, STORAGE)                        \
  int lt_stream_collide_##STENCIL##_##SUFFIX(                                 \
      const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,          \
      const int64_t* geometry, float tau_inv, double cs, int device,         \
      void* stream) {                                                         \
    using C = lt::Bgk<lt::S, float>;                                          \
    return lt::launch<C, false, STORAGE>(f, out, nullptr, n0, n1, n2,         \
                                         geometry, C::make(tau_inv, cs),     \
                                         device, stream);                     \
  }                                                                           \
  int lt_stream_collide_masked_##STENCIL##_##SUFFIX(                          \
      const void* f, void* out, const void* ncm, const void* nsm,            \
      const void* feq_field, const int32_t* kinds, const double* values,     \
      int64_t n0, int64_t n1, int64_t n2, const int64_t* geometry,           \
      float tau_inv, double cs, int device, void* stream) {                   \
    using C = lt::Bgk<lt::S, float>;                                          \
    return lt::launch_masked<C, false, STORAGE>(                              \
        f, out, nullptr, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        geometry, C::make(tau_inv, cs), device, stream);                      \
  }

#define LT_HALF_BGK_EMIT_U_ENTRY(STENCIL, S, SUFFIX, STORAGE)                 \
  int lt_stream_collide_emit_u_##STENCIL##_##SUFFIX(                          \
      const void* f, void* out, void* u_out, int64_t n0, int64_t n1,         \
      int64_t n2, const int64_t* geometry, float tau_inv, double cs,         \
      int device, void* stream) {                                             \
    using C = lt::Bgk<lt::S, float>;                                          \
    return lt::launch<C, true, STORAGE>(f, out, u_out, n0, n1, n2, geometry,  \
                                        C::make(tau_inv, cs), device,        \
                                        stream);                              \
  }                                                                           \
  int lt_stream_collide_masked_emit_u_##STENCIL##_##SUFFIX(                   \
      const void* f, void* out, void* u_out, const void* ncm,                \
      const void* nsm, const void* feq_field, const int32_t* kinds,          \
      const double* values, int64_t n0, int64_t n1, int64_t n2,              \
      const int64_t* geometry, float tau_inv, double cs, int device,         \
      void* stream) {                                                         \
    using C = lt::Bgk<lt::S, float>;                                          \
    return lt::launch_masked<C, true, STORAGE>(                               \
        f, out, u_out, ncm, nsm, feq_field, kinds, values, n0, n1, n2,       \
        geometry, C::make(tau_inv, cs), device, stream);                      \
  }

#define LT_HALF_BGK_ENTRIES(STENCIL, S)                                       \
  LT_HALF_BGK_ENTRY(STENCIL, S, bf16, lt::Bf16)                               \
  LT_HALF_BGK_ENTRY(STENCIL, S, f16, lt::F16Storage)                          \
  LT_HALF_BGK_ENTRY(STENCIL, S, bf16_dev, lt::Bf16Dev)                        \
  LT_HALF_BGK_EMIT_U_ENTRY(STENCIL, S, bf16, lt::Bf16)                        \
  LT_HALF_BGK_EMIT_U_ENTRY(STENCIL, S, f16, lt::F16Storage)

extern "C" {

LT_HALF_BGK_ENTRIES(d2q9, D2Q9)
LT_HALF_BGK_ENTRIES(d3q15, D3Q15)
LT_HALF_BGK_ENTRIES(d3q19, D3Q19)
LT_HALF_BGK_ENTRIES(d3q27, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
