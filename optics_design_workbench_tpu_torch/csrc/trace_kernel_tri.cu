// Fused sample + trace + histogram kernel for NVIDIA Hopper (sm_90a), for
// scenes with a table in device memory (a triangle table, a surface table or
// both): trace_kernel.cu's instances with TRI, in a source of their own so
// that they build in parallel with the rest.
//
// Replaces: as trace_kernel.cu (makePallasTraceStep, in-kernel histogram),
// with the triangle-table and surface-table sweeps of the body `_makeKernel`
// (the JAX package's nTriSMEM / nTriChunks and nSurfSMEM / surfChunkRuns
// branches): see trace_common.cuh for the design.
//
// What bounds it on this card: operations, as for trace_kernel.cu, plus per
// segment ~30 for each group box tested, for each chunk box of the groups the
// warp's lanes enter and for each leaf box of the chunks they enter, ~40 for
// each triangle of the triangle leaves they enter and 50-110 (by kind) for
// each row of the plain surface runs and of the surface leaves they enter,
// each lane's segment capped below its table winner so far plus the window;
// boxes and rows are read from global memory through the read-only path (two
// 16-byte loads a box, 11 floats a triangle, 21 a surface row, broadcast to
// the warp).
//
// Interface: one plain-C launcher, `odwTraceHistogramTri`, loaded with ctypes;
// the arguments of `odwTraceHistogram`.

#include "trace_common.cuh"

extern "C" int odwTraceHistogramTri(const float* table, const float* tri,
                                    const float* box, const float* surf,
                                    const float* surfBox, const float* rayIn,
                                    float* histPower, float* histCounts,
                                    unsigned long long* counters,
                                    const long long* ip, const float* fp,
                                    void* stream) {
  return launchTrace<OUT_HIST, true>(table, tri, box, surf, surfBox, rayIn,
                                     histPower, histCounts, counters, ip, fp,
                                     stream);
}
