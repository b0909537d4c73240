// Fused sample + trace + histogram kernel for NVIDIA Hopper (sm_90a).
//
// Replaces: the in-kernel-histogram call of the JAX package's Pallas trace
// kernel (optics_design_workbench_tpu/ops/pallas_trace.py, body `_makeKernel`,
// built by `makePallasTraceStep`). The body is trace_common.cuh in its
// OUT_HIST mode; see there for the scene coverage and the design.
//
// What bounds it on this card: operations, not bytes. In its main mode the
// kernel reads no per-ray data at all (rays are drawn from a counter-based
// generator in registers) and writes two atomics per recorded hit into a
// histogram that stays in L2, so device memory is idle; the work is a few
// hundred float32 operations per ray segment (one intersection test per
// surface, the winner's normal, Snell / mirror physics) plus a handful of
// sqrt / divide / sin / cos / exp calls per ray. Power is added in float32
// with atomicAdd straight to global memory; where the TPU kernel bins a tile
// with a one-hot matrix product, the lanes of a warp that land in one bin
// here add once, their power summed by shuffles (`addGrouped`), so a focused
// spot or line does not queue 32 atomics a warp on one L2 address.
//
// Interface: one plain-C launcher, `odwTraceHistogram`, loaded with ctypes.

#include "trace_common.cuh"

extern "C" int odwTraceHistogram(const float* table, const float* tri,
                                 const float* box, const float* surf,
                                 const float* surfBox, const float* rayIn,
                                 float* histPower, float* histCounts,
                                 unsigned long long* counters,
                                 const long long* ip, const float* fp,
                                 void* stream) {
  return launchTrace<OUT_HIST, false>(table, tri, box, surf, surfBox, rayIn,
                                      histPower, histCounts, counters, ip, fp,
                                      stream);
}
