// Variant-major parameter-sweep kernel for NVIDIA Hopper (sm_90a): sample +
// trace + histogram for V scene variants in ONE launch.
//
// Replaces: the sweep call of the JAX package's Pallas trace kernel
// (optics_design_workbench_tpu/ops/pallas_trace.py, `makePallasSweepStep` and
// the `sweepSpec` branches of the body `_makeKernel`). The body is
// trace_common.cuh in its OUT_HIST mode with the SWEEP flag; see there for
// the design. Where the TPU kernel keeps only the VARYING surface rows in a
// stacked scalar-memory table and bakes the rest in as constants, the scene
// here is data throughout, so every variant brings its whole table (surface
// rows, element rows, sampler block with the source's placement and
// wavelength): a swept surface, a swept refractive index and a swept source
// placement are the same case.
//
// What bounds it on this card: operations, as for the single-scene kernel.
// It reads V small tables (a few KB each, once per block) and writes two
// float32 atomics per recorded hit into V histograms that together stay in
// L2 (one pair per group of a warp's lanes in one bin, `addGrouped`); the
// work per ray segment is the single-scene kernel's. One launch for
// V variants saves V - 1 launches and V - 1 fetches, and fills the card when
// one variant's rays alone would not.
//
// Interface: one plain-C launcher, `odwTraceSweep`, loaded with ctypes.

#include "trace_common.cuh"

// The launch: trace_common.cuh `launchSweep` (no synchronisation, no
// allocation; returns cudaGetLastError()).
extern "C" int odwTraceSweep(const float* tables, const float* tri,
                             const float* box, const float* surf,
                             const float* surfBox, const float* rayIn,
                             float* histPower, float* histCounts,
                             unsigned long long* counters,
                             const long long* ip, const float* fp,
                             void* stream) {
  return launchSweep<false>(tables, tri, box, surf, surfBox, rayIn, histPower,
                            histCounts, counters, ip, fp, stream);
}
