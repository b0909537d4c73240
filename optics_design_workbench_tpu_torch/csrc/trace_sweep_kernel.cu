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
// L2; the work per ray segment is the single-scene kernel's. One launch for
// V variants saves V - 1 launches and V - 1 fetches, and fills the card when
// one variant's rays alone would not.
//
// Interface: one plain-C launcher, `odwTraceSweep`, loaded with ctypes.

#include "trace_common.cuh"

// ip[15] variants of ip[0] rays each, ip[16] floats per variant's histogram
// (the other parameters as for the single-scene launchers). The grid is
// variants x ceil(rays / block) blocks; threads past a variant's last ray
// are masked like the last block of a single-scene launch. No
// synchronisation, no allocation; returns cudaGetLastError().
extern "C" int odwTraceSweep(const float* tables, const float* rayIn,
                             float* histPower, float* histCounts,
                             unsigned long long* counters,
                             const long long* ip, const float* fp,
                             void* stream) {
  TraceParams p = traceParams(ip, fp);
  const long long variants = ip[15];
  p.histLen = ip[16];
  if (p.N <= 0 || variants <= 0) return 0;
  const long long perVariant = (p.N + kBlock - 1) / kBlock;
  const long long blocks = variants * perVariant;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  p.blocksPerVariant = (int)perVariant;
  size_t shmem = (size_t)p.tableLen * sizeof(float);
  // ip[22]: the tables have a scatter block; ip[23]: widened surface rows
  // (a kind or trim of B2 / B3)
  auto kernel =
      ip[23] ? (ip[22] ? traceKernel<OUT_HIST, true, true, false, true, true>
                       : traceKernel<OUT_HIST, true, true, false, false, true>)
      : ip[22] ? traceKernel<OUT_HIST, true, true, false, true>
      : needsB4(p) ? traceKernel<OUT_HIST, true, true, false, false>
                   : traceKernel<OUT_HIST, true, false, false, false>;
  if (int err = allowTable(kernel, shmem)) return err;
  kernel<<<(unsigned)blocks, kBlock, shmem, (cudaStream_t)stream>>>(
      p, tables, rayIn, histPower, histCounts, counters);
  return (int)cudaGetLastError();
}
