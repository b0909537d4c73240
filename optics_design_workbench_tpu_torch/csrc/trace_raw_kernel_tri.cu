// Sample + trace kernel with raw hit records for NVIDIA Hopper (sm_90a), for
// scenes with a triangle table: trace_raw_kernel.cu's instances with TRI, in
// a source of their own so that they build in parallel with the rest.
//
// Replaces: as trace_raw_kernel.cu (makePallasRawStep), with the
// triangle-table sweep of the body `_makeKernel` (the JAX package's nTriSMEM
// / nTriChunks branches): see trace_common.cuh for the design.
//
// What bounds it on this card: operations, as for trace_raw_kernel.cu, plus
// per segment ~30 for each chunk box tested and ~40 for each triangle of the
// chunks the warp's lanes enter; the table is read from global memory through
// the read-only path (11 floats a triangle, broadcast to the warp).
//
// Interface: one plain-C launcher, `odwTraceRawTri`, loaded with ctypes; the
// arguments of `odwTraceRaw`.

#include "trace_common.cuh"

extern "C" int odwTraceRawTri(const float* table, const float* tri,
                              const float* box, const float* rayIn,
                              float* ring, unsigned long long* counters,
                              const long long* ip, const float* fp,
                              void* stream) {
  return launchTrace<OUT_RAW, true>(table, tri, box, rayIn, ring, nullptr,
                                    counters, ip, fp, stream);
}
