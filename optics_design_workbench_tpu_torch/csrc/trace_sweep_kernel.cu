// Parameter-sweep kernel for NVIDIA Hopper (sm_90a): sample + trace +
// histogram for V scene variants in ONE launch, a block tracing its tile of
// rays through a group of consecutive variants.
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
// Every variant traces the same rays (common random numbers), so where the
// variants share the draw the work that does not depend on the variant is
// done once per ray for a block's group (ops/cuda_trace.py
// `sweepVariantGroup`): the group's tables are copied into shared memory
// behind one barrier, and each ray is drawn once (Philox, the stratum, the
// marginals and sin / cos) and then placed, traced and binned per variant;
// the counters are added once per variant and block. Two float32 atomics
// per recorded hit go into V histograms that together stay in L2 (one pair
// per group of a warp's lanes in one bin, `addGrouped`).
//
// Interface: plain-C functions loaded with ctypes: the launcher,
// `odwTraceSweep`, and `odwSweepPlan`, what the host's group rule reads of
// a launch.

// the sweep instances' launch bounds (trace_common.cuh `sweepMinBlocks`)
#define ODW_SWEEP_SOURCE
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

// trace_common.cuh `planSweep`: out[0] the launch's dynamic shared bytes,
// out[1] / out[2] the blocks an SM its instance holds with them / alone.
extern "C" int odwSweepPlan(const long long* ip, const float* fp,
                            long long* out) {
  return planSweep<false>(ip, fp, out);
}
