// Fused sample + trace + histogram kernel for NVIDIA Hopper (sm_90a), for
// scenes with a triangle table: trace_kernel.cu's instances with TRI, in a
// source of their own so that they build in parallel with the rest.
//
// Replaces: as trace_kernel.cu (makePallasTraceStep, in-kernel histogram),
// with the triangle-table sweep of the body `_makeKernel` (the JAX package's
// nTriSMEM / nTriChunks branches): see trace_common.cuh for the design.
//
// What bounds it on this card: operations, as for trace_kernel.cu, plus per
// segment ~30 for each chunk box tested and ~40 for each triangle of the
// chunks the warp's lanes enter; the table is read from global memory through
// the read-only path (11 floats a triangle, broadcast to the warp).
//
// Interface: one plain-C launcher, `odwTraceHistogramTri`, loaded with
// ctypes; the arguments of `odwTraceHistogram`.

#include "trace_common.cuh"

extern "C" int odwTraceHistogramTri(const float* table, const float* tri,
                                    const float* box, const float* rayIn,
                                    float* histPower, float* histCounts,
                                    unsigned long long* counters,
                                    const long long* ip, const float* fp,
                                    void* stream) {
  return launchTrace<OUT_HIST, true>(table, tri, box, rayIn, histPower,
                                     histCounts, counters, ip, fp, stream);
}
