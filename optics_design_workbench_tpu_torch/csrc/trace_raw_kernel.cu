// Sample + trace kernel with raw per-hit records for NVIDIA Hopper (sm_90a).
//
// Replaces: the raw-records call of the JAX package's Pallas trace kernel
// (optics_design_workbench_tpu/ops/pallas_trace.py, body `_makeKernel` with
// rawRecords=True, built by `makePallasRawStep`). The body is
// trace_common.cuh in its OUT_RAW mode: EVERY hit on a recording element is
// kept (no histogram-bounds gate), as a float32 (9, hitSlots, N) tensor —
// element (-1 = empty), power after Beer-Lambert and before the interaction,
// isEntering, world hit point, INCOMING direction — slot-major, ray index
// fastest, every element written exactly once by the kernel (filled slots as
// they are hit, the rest when the ray ends).
//
// What bounds it on this card: operations at one ring slot (36 bytes per
// ray against a few thousand float32 operations), bytes from about three
// slots on: 36 * hitSlots bytes per ray are written whatever the ray hits.
//
// Interface: one plain-C launcher, `odwTraceRaw`, loaded with ctypes.

#include "trace_common.cuh"

extern "C" int odwTraceRaw(const float* table, const float* tri,
                           const float* box, const float* surf,
                           const float* surfBox, const float* rayIn,
                           float* ring,
                           unsigned long long* counters,
                           const long long* ip, const float* fp,
                           void* stream) {
  return launchTrace<OUT_RAW, false>(table, tri, box, surf, surfBox, rayIn,
                                     ring, nullptr, counters, ip, fp, stream);
}
