// The KBC (entropic, Karlin-Boesch-Chikatamarla) collision fragment of the
// fused collide-and-stream kernel for Hopper (sm_90a), on D2Q9 and D3Q27.
//
// Replaces the "kbc" fragment of
// lettuce_tpu/ops/pallas/stream_collide.py::_make_collide (:997-1224), in
// the periodic and the masked kernel of stream_collide.cuh, in float32 and
// float64. The policy, what it computes and its design: kbc.cuh.
//
// What bounds it: arithmetic and registers on D3Q27 (27 populations, their
// feq, reciprocals and dh live at once).

#include "kbc.cuh"

// half_*.cu include this source for its policies alone
#ifndef LT_POLICIES_ONLY

extern "C" {

LT_COLLIDE_ENTRIES(kbc, d2q9, lt::Kbc, D2Q9)
LT_COLLIDE_ENTRIES(kbc, d3q27, lt::Kbc, D3Q27)
LT_ERROR_STRING_ENTRY

}  // extern "C"

#endif  // LT_POLICIES_ONLY
