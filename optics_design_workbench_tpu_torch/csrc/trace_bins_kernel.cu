// Sample + trace kernel with per-ray (bin, power, count) outputs for NVIDIA
// Hopper (sm_90a); the histogram is formed outside the kernel.
//
// Replaces: the per-ray-output call of the JAX package's Pallas trace kernel
// (optics_design_workbench_tpu/ops/pallas_trace.py, body `_makeKernel` with
// histRows=None, built by `makePallasTraceStep` when the histogram does not
// fit the kernel or histPrecision is not 'default'). The body is
// trace_common.cuh in its OUT_BINS mode: the same gate as the histogram
// kernel (recording element, mapped detector, hit inside the bounds), but
// every ring slot goes to device memory as a float32 (3, hitSlots, N)
// tensor — bin index (-1 = empty), power, count — slot-major, ray index
// fastest, every element written exactly once by the kernel.
//
// What bounds it on this card: operations at the main path's shapes (the
// same bounce loop as the histogram kernel); its bytes are the ring,
// 12 * hitSlots bytes per ray, a quarter of the operation bound at one slot.
//
// Interface: one plain-C launcher, `odwTraceBins`, loaded with ctypes.

#include "trace_common.cuh"

extern "C" int odwTraceBins(const float* table, const float* tri,
                            const float* box, const float* surf,
                            const float* surfBox, const float* rayIn,
                            float* ring,
                            unsigned long long* counters,
                            const long long* ip, const float* fp,
                            void* stream) {
  return launchTrace<OUT_BINS, false>(table, tri, box, surf, surfBox, rayIn,
                                      ring, nullptr, counters, ip, fp, stream);
}
