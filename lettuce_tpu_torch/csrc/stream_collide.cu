// Fused BGK collide-and-stream step for Hopper (sm_90a).
//
// Replaces lettuce_tpu/ops/pallas/stream_collide.py::_stream_collide_kernel
// with the "bgk" collision fragment and one step per launch (n_sub = 1):
//   * the periodic instances compute the same function as
//     fused_stream_collide(f, e, w, opposite, cs, tau_inv) (no masks);
//   * the Masked instances add the kernel's mask pipeline
//     (stream_collide.py:1565-1605): the uint8 no_collision_mask code of
//     each cell selects a kind from a per-code BoundaryTable passed by
//     value (collide, bounce back, constant equilibrium, per-node
//     equilibrium field, identity), and the optional no_streaming_mask
//     freezes populations at their destination;
//   * with EmitU either also writes the pre-collision velocity u = j / rho
//     as the adjoint kernel's residual (adjoint.cu), at every cell.
//
// What bounds it: device memory. The arithmetic is a few flops per
// population; the traffic is the state itself. D3Q19 in float32 reads
// 19 * 4 B and writes 19 * 4 B per cell: 152 B per lattice update (164 B
// with EmitU, which writes 3 * 4 B of u more). The masked instances add the
// 1-byte code (D2Q9 float32: 73 B against 72), the 2 q bytes of the
// no-streaming mask only when a flow has one, and the field only on the
// cells whose code reads it. The design reads each population once and
// writes it once:
//   * one thread per lattice cell, threads along the last (fastest) axis,
//     so every f[q, .] load of a warp is coalesced;
//   * the cell's q populations stay in registers; rho and j come from the
//     pair-folded add tree of _moments; the collided populations use the
//     opposite-pair (G, H) cache of the BGK fragment;
//   * each post-collision population is pushed to out[q, (x + e_q) mod N],
//     the same map as the TPU kernel's pull f_out[q, x] = f_post[q, x - e_q].
//     No neighbour is collided twice and no halo is loaded.
// The no-streaming mask in the push: the TPU kernel pulls
// out[q, x] = nsm[q, x] ? f_post[q, x] : f_post[q, x - e_q]. Here thread x
// writes f_post[q, x] to out[q, x] when nsm[q, x] is set, and pushes it to
// x + e_q only when nsm[q, x + e_q] is clear, so every output element is
// written by exactly one thread (the forward mirror of the adjoint's
// re-routing) and a step is deterministic.
// The step is out of place (f -> out): a push into f itself would race.
// EmitU and Masked are separate instances, so the periodic primal entries
// never pay for the masks or the u writes.
//
// The kernel templates live in stream_collide.cuh, shared with the other
// collision fragments (collide_*.cu); this source holds the BGK instances.
//
// Plain C interface, loaded with ctypes: one entry per (stencil, dtype)
// instance, for each of periodic, periodic EmitU, Masked and Masked EmitU.
// Each entry launches on the stream it is given and returns
// cudaGetLastError(); it neither allocates nor synchronises.

#include "stream_collide.cuh"

#define LT_ENTRY(NAME, S, T)                                                  \
  int NAME(const void* f, void* out, int64_t n0, int64_t n1, int64_t n2,     \
           const int64_t* geometry, T tau_inv, double cs, int device,         \
           void* stream) {                                                    \
    return lt::launch<lt::Bgk<lt::S, T>, false>(                              \
        f, out, nullptr, n0, n1, n2, geometry,                                \
        lt::Bgk<lt::S, T>::make(tau_inv, cs), device, stream);                \
  }

#define LT_ENTRY_EMIT_U(NAME, S, T)                                           \
  int NAME(const void* f, void* out, void* u_out, int64_t n0, int64_t n1,    \
           int64_t n2, const int64_t* geometry, T tau_inv, double cs,         \
           int device, void* stream) {                                        \
    return lt::launch<lt::Bgk<lt::S, T>, true>(                               \
        f, out, u_out, n0, n1, n2, geometry,                                  \
        lt::Bgk<lt::S, T>::make(tau_inv, cs), device, stream);                \
  }

#define LT_ENTRY_MASKED(NAME, S, T)                                           \
  int NAME(const void* f, void* out, const void* ncm, const void* nsm,       \
           const void* feq_field, const int32_t* kinds,                       \
           const double* values, int64_t n0, int64_t n1, int64_t n2,          \
           const int64_t* geometry, T tau_inv, double cs, int device,         \
           void* stream) {                                                    \
    return lt::launch_masked<lt::Bgk<lt::S, T>, false>(                       \
        f, out, nullptr, ncm, nsm, feq_field, kinds, values, n0, n1, n2,     \
        geometry, lt::Bgk<lt::S, T>::make(tau_inv, cs), device, stream);     \
  }

#define LT_ENTRY_MASKED_EMIT_U(NAME, S, T)                                    \
  int NAME(const void* f, void* out, void* u_out, const void* ncm,           \
           const void* nsm, const void* feq_field, const int32_t* kinds,      \
           const double* values, int64_t n0, int64_t n1, int64_t n2,          \
           const int64_t* geometry, T tau_inv, double cs, int device,         \
           void* stream) {                                                    \
    return lt::launch_masked<lt::Bgk<lt::S, T>, true>(                        \
        f, out, u_out, ncm, nsm, feq_field, kinds, values, n0, n1, n2,       \
        geometry, lt::Bgk<lt::S, T>::make(tau_inv, cs), device, stream);     \
  }

#define LT_ENTRIES(STENCIL, S)                                                \
  LT_ENTRY(lt_stream_collide_##STENCIL##_f32, S, float)                       \
  LT_ENTRY(lt_stream_collide_##STENCIL##_f64, S, double)                      \
  LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_##STENCIL##_f32, S, float)         \
  LT_ENTRY_EMIT_U(lt_stream_collide_emit_u_##STENCIL##_f64, S, double)        \
  LT_ENTRY_MASKED(lt_stream_collide_masked_##STENCIL##_f32, S, float)         \
  LT_ENTRY_MASKED(lt_stream_collide_masked_##STENCIL##_f64, S, double)        \
  LT_ENTRY_MASKED_EMIT_U(lt_stream_collide_masked_emit_u_##STENCIL##_f32, S,  \
                         float)                                               \
  LT_ENTRY_MASKED_EMIT_U(lt_stream_collide_masked_emit_u_##STENCIL##_f64, S,  \
                         double)

extern "C" {

LT_ENTRIES(d2q9, D2Q9)
LT_ENTRIES(d3q15, D3Q15)
LT_ENTRIES(d3q19, D3Q19)
LT_ENTRIES(d3q27, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"
