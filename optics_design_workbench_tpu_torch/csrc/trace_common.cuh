// Shared body of the trace kernels for NVIDIA Hopper (sm_90a): the sampler,
// the surface sweep, the physics and the bounce loop exist ONCE here, as one
// `__global__` function templated on its OUTPUT MODE, on whether it traces
// ONE scene or a variant-major SWEEP of scenes, on B4 (below), on SURF, the
// sampler (below), on SCAT, stochastic scatter (below), on GEOM, the other
// surface kinds and trims (below), on TRI, the triangle table in device
// memory, and on STAB, the surface table in device memory (below).
// Each kernel source (trace_kernel.cu, trace_bins_kernel.cu,
// trace_raw_kernel.cu, trace_sweep_kernel.cu) instantiates one mode, with
// and without B4, with SCAT on top of B4, GEOM (with and without SCAT) on
// top of B4, and the single-scene ones with each sampler, behind a plain-C
// launcher; its `_tri` twin instantiates the same mode with TRI on top of
// B4, with and without SCAT, GEOM and STAB (and each sampler).
//
// Replaces: the body `_makeKernel` of the JAX package's Pallas trace kernels
// (optics_design_workbench_tpu/ops/pallas_trace.py), but for its histogram
// layout:
// PLANE / SPHERE / CYLINDER surfaces with window, annulus and z-band trims,
// and in the GEOM instance every other kind (ASPHERE by 16 Newton steps
// from its osculating sphere, TRIANGLE by Moeller-Trumbore, CONE and QUADRIC
// by their quadratics, TORUS by the quartic through its resolvent cubic)
// with UV-bitmap and hole-primitive trims;
// Mirror / Lens / Absorber / Vacuum / Grating elements with Beer-Lambert
// absorption; n(wavelength) of dispersive elements as a Horner polynomial;
// sequential mode and per-source surface masks; the point-source sampler
// with affine, piecewise-polynomial and tent marginals and ray-index strata;
// the surface-source sampler (plane, sphere-zone and cylinder faces); the
// in-kernel stochastic scatter draw; the triangle-table sweep of meshes past
// 128 triangles; the surface-table sweep of assemblies past 256 analytic
// surfaces; the per-bounce surface culls; the per-ray hit-slot ring.
//
// The per-bounce culls (B12): where the source has an emission bound the
// host works out, per bounce, the surface rows some ray can reach there
// (ops/beam_cull.py) and appends a cull block to the table, its offset a
// launch parameter (cullOff, -1 without one; `inBounceSet` says the
// layout). The row loop skips a row outside the bounce's set before its
// intersection test, in the rows' order, so the lowest index still wins a
// tie; every lane of a warp is at the same bounce, so the test is
// warp-uniform. The triangle and surface tables are swept as before, and
// the sweep instances have no cull code, as the reference's sweep never
// culls.
//
// The two samplers are two compile-time instances (SURF), chosen by the
// launcher from the sampler kind of the tables: the point sampler draws two
// uniforms per ray, the surface sampler five (face, u, v, theta, phi — the
// reference's draw order, `_sampleRays`), picks the face whose area-CDF
// window holds the face draw by scanning the faces in order (as the
// reference's masks do: a binary search could pick another face where two
// windows touch), places the ray on it in closed form and turns the face
// normal by theta about a tangent and by phi about the normal. Strata are
// the point sampler's only: the reference's surface branch returns before
// them.
//
// The stage gate reads, for a surface, the uint32 word stage / 32 of its
// allowed-stage set (bit-cast into the table at the offset in its row), so
// sequential mode has no cap on its stages but the table's size.
//
// The grating, dispersion and the stage gate sit behind header flags of the
// launch (hasGrating, dispOff >= 0, gate, nStages > 0), the same for every
// thread, and behind the compile-time flag B4, which the launcher sets when
// any of them is on: a scene without them runs an instance without that
// code, so its work is what it was before B4. n(wavelength) is evaluated
// where it is read, for the winning element and for the medium on each
// bounce, instead of once per ray into a per-thread array (16 elements
// would spill to local memory); the polynomial's operations are the same,
// and with contraction off so are its bits.
//
// The other kinds and trims (GEOM, a compile-time instance built on the B4
// body, which the launcher picks from its geometry word): a GEOM table
// widens each surface row by kGeomCols (params, constants of the kind
// formed in double on the host, a bitmap's pixel map and the offset of its
// bit words, the offset and count of its hole primitives), so a scene of
// plane / sphere / cylinder with window trims runs an instance without that
// code and reads the rows it read before. The surface sampler's faces of
// kind cone, asphere, torus and triangle are GEOM's too.
//
// The triangle table (TRI, B7, a compile-time instance built on the B4 body,
// whose sources are trace_*_tri.cu): a mesh past the surface rows' 128
// triangles is swept after them from a table of world-frame rows [v0, e1, e2,
// element, orient] in GLOBAL memory (no part of the shared-memory table, no
// cap on its size), in Morton order of the centroids, chunked by kTriChunk
// rows with one padded box each, every kGroupChunks chunks with one group
// box, the union of theirs, and every kTriLeaf rows of a chunk with one
// padded leaf box. The sweep has three levels: per group the warp votes on
// the group box's slab test, in a group that any lane's segment enters per
// chunk on the chunk box's, and in a chunk that any lane's segment enters per
// leaf on the leaf box's; if any lane's segment enters a leaf's box, the live
// lanes sweep its rows together, so each row's loads are broadcasts. The
// three levels are one loop over the leaves that tests a group box at the
// group's first leaf and a chunk box at the chunk's first leaf (two nested
// loops held more registers and spilled: 236 bytes in K1's STAB instance;
// one call site for the three tests spilled more and ran 8-19 % slower,
// PERF.md §6). A lane's segment is capped at its nearest surface row plus the
// same-medium window, and below that, as the sweep goes on, at its nearest
// triangle so far plus the window (the cap shrinks with the lane's winner: a
// row beyond it cannot replace the table's one result). The cull only skips
// triangles no lane can hit, so any culling grain gives the same result; it
// is as tight as the warp's rays are coherent (the samplers' ray-index strata
// keep a block's rays in one (theta, phi) cell). The boxes are read as a pack
// in device memory (group boxes, then chunk boxes, then leaf boxes,
// kBoxStride floats each: two 16-byte loads through the read-only path; a
// copy in each block's shared memory was measured no faster, PERF.md §6).
// Inside the table the strict `<` keeps the lowest row on a tie; the table's
// winner replaces the surface winner only when strictly nearer, and counts
// for the other-medium tracker when the medium is not its element. A table
// winner brings its normal (the unnormalised e1 x e2 times orient / |e1 x
// e2|, in float32), its element and the world (x, y) as its chart.
//
// The surface table (STAB, B8, a compile-time instance built on TRI, in the
// same `_tri` sources; the launcher picks the TRI instances when either
// table is there, STAB ones when the surface table is, and a STAB instance
// skips the triangle sweep when there is no triangle table; a flag of its
// own because sweeping it in every TRI instance cost those 18 registers,
// PERF.md §6): past 256 analytic surfaces every plane / sphere / cylinder / cone
// / quadric with a window trim leaves the surface rows for a table of rows
// [rotation, offset, orient, element, p0..p4, trim1, trim2] in GLOBAL
// memory, swept after the triangle table in runs of one (kind, trim) each,
// the kind a switch outside the run's row loop. A run is plain (swept row by
// row) or chunked (Morton-ordered, kSurfChunk rows a chunk with one padded
// box each, a group box every kGroupChunks chunks of the run and a leaf box
// every kSurfLeaf rows of a chunk, culled in three levels by the warp's
// votes on the slab tests as the triangle table; a leaf of nothing but the
// rows that pad a run's last chunk has a box that no segment enters,
// ops/cuda_trace.py `_EMPTY_LEAF`),
// the segment capped at min(nearest so far, the plain runs' winner,
// mrlEff) plus the same-medium window, and below that at the table's winner
// so far plus the window); the plain runs come first. Each row is
// intersected from the ray in its frame in the reference's table form;
// the running winner keeps its distance, oriented world normal, element and
// local (x, y) chart. It replaces the winner so far only when strictly
// nearer (index -3) and enters the other-medium tracker only as that one
// winner, when the medium is not its element; a detector that is a table
// row bins the winner's local chart.
//
// Stochastic scatter (SCAT, a compile-time instance built on the B4 body,
// which the launcher picks from its scatter word): after the ideal new
// direction is formed, a ray that met a mirror or a lens whose element
// carries a scatter density draws (theta, phi) of the lobe (REFLECT on a
// mirror, REFRACT_ENTER / REFRACT_EXIT on a lens) and turns the lobe axis
// (the incidence-side normal for a mirror, the forward normal for a lens)
// by theta about axis x incoming direction and by phi about the lobe axis;
// then MODIFY, drawn likewise, turns the new direction about itself; every
// ray's direction is normalised once more. The draws evaluate the fitted
// constants of the table's scatter block (layout beside the enums below):
// piecewise Horner polynomials in the uniform, 2-D ones in (uniform,
// incidence angle), low-rank sums whose phi factors are polynomials or
// Fourier series, and DiracDelta events selected by a uniform. The
// incidence angle is arccos(d . n) through the reference's sqrt-times-
// polynomial form, so both packages condition on the same angle. Uniforms:
// in the uniform input mode bounce b reads rows samplerRows + b * rows per
// bounce (the lobe's u1, u2 [, u3, u4], then MODIFY's); otherwise each
// bounce makes one Philox call for the lobe and one for MODIFY, counter
// words (ray index, 2 + b, 0 or 1), apart from the sampler's.
//
// Output modes (what happens to a hit-ring slot):
//   OUT_HIST  the slot is added to the (D, H, W) power + count histograms
//             with float32 atomics. Only the LAST slot lives in registers:
//             an earlier slot is final once written and is added at once,
//             the last slot is the one an overflow overwrites and is flushed
//             after the loop, so histogram and overflow count equal those of
//             a full ring. That flush groups the warp's lanes by bin first
//             (`addGrouped`), so a warp whose rays pile into one bin issues
//             one atomic pair where it issued 32.
//   OUT_BINS  the ring is delivered per ray, (3, hitSlots, N): bin (-1 =
//             empty), power, count, gated exactly like OUT_HIST.
//   OUT_RAW   the ring is delivered per ray, (9, hitSlots, N): element (-1 =
//             empty), power, isEntering, world hit point, INCOMING
//             direction; every hit on a recording element, no bounds gate.
// In the two per-ray modes the ring lives in DEVICE MEMORY, slot-major with
// the ray index fastest: a slot is written through as it is hit (hitSlots is
// a run-time value, so a register or local-memory ring would be indexed
// dynamically), an overflow overwrites the last slot in place, and when the
// ray ends the thread fills its unwritten slots with -1 / 0. Every element
// of the output is therefore written by the kernel (the wrapper allocates
// with torch.empty), and a warp's 32 stores to one row are one 128-byte line.
//
// SWEEP (a compile-time flag, only with OUT_HIST): V scene tables of equal
// layout lie stacked in device memory and the grid is two-dimensional:
// blockIdx.x is the tile of rays, blockIdx.y a GROUP of Vb consecutive
// variants (the last group may be shorter; the launcher's Vb comes from the
// host, ops/cuda_trace.py `sweepVariantGroup`). A block copies its group's
// tables into shared memory together, behind one barrier, and each thread
// traces its ray through every variant of the group in turn: placement,
// the bounce loop and the flush against that variant's table, tables in
// device memory and histograms. The ray index, and with it the Philox
// counter, the stratum cell and the uniform / column inputs, is the index
// WITHIN the variant: every variant traces the same rays (common random
// numbers), and variant v of a sweep launch computes what the single-scene
// kernel computes for N = raysPerVariant on variant v's table, operation
// for operation. So where the host found the variants' marginals and
// focal words equal (`sharedDraws`) and the kernel samples (seed or uniform
// inputs), a thread draws its ray ONCE per group: the uniforms (Philox, the
// stratum) and the ray in the source's frame, kept in a per-thread slot of
// shared memory that each variant places by its own rotation, offset and
// wavelength. A group's counters are summed per variant (warp shuffles, one
// shared-memory pass) and added with one 64-bit atomic per nonzero total.
// Only the GROUPED instances (plain and B4) trace groups of more than one
// variant; a group of one, ray columns, variants with draws of their own,
// and the instances with scatter, the other kinds and trims (GEOM) or a
// table in device memory (TRI) take the other sweep instances, one variant
// a block (their variant loop is one pass: on the dish and wall sweeps the
// loop cost more in registers than the shared draw saved, and a group of
// one in the grouped plain instance ran 6 % slower than one variant a
// block, PERF.md §6). The single-scene instantiations read none of this:
// their variant loop is one pass.
//
// Common design: one thread per ray, all ray state in registers, a `for`
// over bounces that `break`s when the ray dies; the scene is DATA (a small
// surface / element / sampler table copied once per block into shared
// memory), so one binary serves every eligible scene; segment / hit /
// overflow totals are reduced per block and added with one 64-bit atomic
// each. Float contraction is switched off at build time (-fmad=false) so
// that the arithmetic is the plain PyTorch version's, operation for
// operation.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kSurfCols = 20;
constexpr int kElemCols = 18;
constexpr int kDispCols = 17;     // mid, 1/half, nCoef, 0, 13 coefficients
constexpr int kSegStride = 17;     // a, mid, 1/half, nCoef, 13 coefficients
constexpr int kMargLen = 264;      // kind, n, lo, hi/span, 260 payload floats
constexpr int kSamplerGeom = 16;   // finite, f, R(9), off(3), wavelength, pad
                                   // (surface: nFaces, 2 pi, .., wavelength)
constexpr int kFaceCols = 33;      // one emitting face of a surface sampler
constexpr int kGeomCols = 20;      // GEOM: the widening of a surface row
constexpr int kPrimCols = 9;       // one hole primitive of a surface
constexpr int kTriCols = 11;       // TRI: v0, e1, e2, element, orient
constexpr int kBoxStride = 8;      // TRI: a box of a pack, lo xyz, 0, hi xyz, 0
constexpr int kTriChunk = 32;      // TRI: rows per chunk
constexpr int kGroupChunks = 8;    // TRI: chunks per group box
constexpr int kSurfTableCols = 21; // STAB: a surface-table row (below)
constexpr int kSurfChunk = 16;     // STAB: surface-table rows per chunk
constexpr int kTriLeaf = 8;        // TRI: triangle rows per leaf box
constexpr int kSurfLeaf = 4;       // STAB: surface-table rows per leaf box
constexpr int kTriChunkLeaves = kTriChunk / kTriLeaf;
constexpr int kSurfChunkLeaves = kSurfChunk / kSurfLeaf;
constexpr int kMaxSurfRuns = 10;   // STAB: one run per (kind, window trim)
constexpr int kRunCols = 7;
constexpr int kBlock = 256;
// the launch words after the surface table's runs (ops/cuda_trace.py
// `_launchKernel`): the cull block's offset, the group boxes of the
// triangle and of the surface table
constexpr int kIpTail = 29 + kMaxSurfRuns * kRunCols;

// surface row columns
// S_STAGES: the offset of the surface's stage words, read only where the
// scene has a stage gate: ceil(stages / 32) uint32 words bit-cast into the
// table, bit q of which lets a ray whose clamped stage index is q hit the
// surface (without sequential mode one word: 1 = allowed, 0 = masked by
// the source)
enum { S_KIND = 0, S_ROT = 1, S_OFF = 10, S_ORIENT = 13, S_ELEM = 14,
       S_P0SQ = 15, S_TRIM0 = 16, S_TRIMA = 17, S_TRIMB = 18, S_STAGES = 19 };
// GEOM surface row columns past kSurfCols (ops/cuda_trace.py `_packTable`):
// params p0..p4, nine kind constants (triangle: e1, e2, unit normal;
// asphere: (1+k) c^2, 1/c, 1/c^2, sphere seed on; torus: (r/R)^2, r^2, the
// residual gate), a bitmap's 1/du, 1/dv, the offset of its bit words and
// its resolution (u0, v0 sit in S_TRIMA / S_TRIMB), the offset and count of
// its hole-primitive rows (shape, isAdd, isInverted, cx, cy, p0, p1, cosA,
// sinA)
enum { G_P = 20, G_X = 25, G_TRIM3 = 34, G_TRIM4 = 35, G_MASKOFF = 36,
       G_MASKRES = 37, G_PRIMOFF = 38, G_NPRIM = 39 };
// element row columns
enum { E_OPT = 0, E_N = 1, E_REFL = 2, E_ABSLEN = 3, E_REC = 4, E_DET = 5,
       E_BX0 = 6, E_BX1 = 7, E_BY0 = 8, E_BY1 = 9, E_MEDIUM = 10,
       E_DISP = 11, E_GTYPE = 12, E_GLPM = 13, E_GDIR = 14, E_GORDER = 17 };
// emitting-face row columns (ops/cuda_trace.py `_packSurfaceSampler`):
// kind, rectangle flag, four sampling constants (rectangle: half-widths;
// disc: rOut^2 - rIn^2, rIn^2; sphere zone: z1, z2 - z1, R^2, 1/R;
// cylinder: z1, z2 - z1, R), placement, orient, area-CDF window
// F_X: twelve more constants of a cone, asphere, torus or triangle face
// (`surface_source.faceExtraConstants`; an asphere's or torus's first is the
// offset of its radius / tube-angle marginal from the sampler block)
enum { F_KIND = 0, F_RECT = 1, F_C = 2, F_ROT = 6, F_OFF = 15, F_ORIENT = 18,
       F_CUMLO = 19, F_CUMHI = 20, F_X = 21 };
// the scatter block (ops/cuda_trace.py `_packScatter`), right after the
// element rows: a header of kScHeader floats (entry count, uniform rows per
// bounce, the lobe's rows, MODIFY's rows, whether the incidence angle is
// needed, the 13 arccos coefficients at SC_ACOS), one entry row per
// (element, kind) and then the specs; offsets count from the block's
// start. A spec is [kind, n, lo, hi, ...]: SPEC_PWPOLY as a marginal
// block; SPEC_PWPOLY2D then cMid, 1/cHalf, nU, nC and n rectangles of
// kRectHead floats and nU x nC coefficients (u power major); SPEC_LOWRANK
// then n offset pairs (its pwpoly2d, its phi factor). A 1-D function block
// (kFnCols floats) is FN_CONST (value), FN_POLY1D (mid, 1/half, nCoef,
// ascending coefficients) or FN_FOURIER (c0, nTerms, 0, a1, b1, ...); an
// event is a (cumulative probability, value) pair of them.
constexpr int kScHeader = 24;
constexpr int kScEntryCols = 8;
constexpr int kFnCols = 34;
constexpr int kRectHead = 8;
constexpr int kAcosCoeffs = 13;
enum { SC_N = 0, SC_ROWS = 1, SC_LOBEROWS = 2, SC_MODROWS = 3, SC_COND = 4,
       SC_ACOS = 8 };
enum { EN_ELEM = 0, EN_KIND = 1, EN_PHI = 2, EN_THETA = 3, EN_PHIDISC = 4,
       EN_NPHIDISC = 5, EN_THETADISC = 6, EN_NTHETADISC = 7 };
enum { SPEC_PWPOLY = 1, SPEC_PWPOLY2D = 3, SPEC_LOWRANK = 4 };
enum { FN_CONST = 0, FN_POLY1D = 1, FN_FOURIER = 2 };
enum { SCAT_REFLECT = 0, SCAT_REFRACT_ENTER = 1, SCAT_REFRACT_EXIT = 2,
       SCAT_MODIFY = 3 };
// a surface-table run (ops/cuda_trace.py `surfaceRuns`)
enum { RUN_KIND = 0, RUN_TRIM0 = 1, RUN_FIRST = 2, RUN_LAST = 3, RUN_ROW0 = 4,
       RUN_CHUNKED = 5, RUN_GROUP0 = 6 };
enum { KIND_PLANE = 0, KIND_SPHERE = 1, KIND_CYLINDER = 2, KIND_ASPHERE = 3,
       KIND_TRIANGLE = 4, KIND_CONE = 5, KIND_QUADRIC = 6, KIND_TORUS = 7 };
enum { OPT_MIRROR = 0, OPT_LENS = 1, OPT_GRATING = 2, OPT_ABSORBER = 3,
       OPT_VACUUM = 4 };
enum { MODE_SEED = 0, MODE_UNIFORMS = 1, MODE_COLUMNS = 2 };
enum { OUT_HIST = 0, OUT_BINS = 1, OUT_RAW = 2 };

// SWEEP: the most variants a block traces (its group), and the floats a
// thread of a GROUPED block keeps of its ray for them (its origin and
// direction in the source's frame)
constexpr int kMaxVariantGroup = 16;
constexpr int kSlotFloats = 6;

struct TraceParams {
  long long N;
  unsigned long long seed;
  int tableLen, nSurf, nElem, samplerOff, mode;
  int H, W, maxIntersections, hitSlots, anyMedium;
  long long strataTile;
  int G1, G2;
  float mrlEff, maxRayLength, tMin, window, powerTol, invG1, invG2;
  // SWEEP only: the variants a block traces (its group); a single-scene
  // launch keeps in the same word the offset of the cull block (B12; -1:
  // every bounce sweeps every row). A field of its own took the instances
  // without B4 from 40 to 44 registers (PERF.md §6).
  union { int cullOff; int groupSize; };
  // SWEEP only: floats per variant's histogram, variants of the launch
  int histLen, nVariants;
  // header flags of the scene: any grating; sequential stages (0: none);
  // some surface not always allowed; offset of the dispersion block (-1:
  // no dispersive element)
  int hasGrating, nStages, gate, dispOff;
};

// ---- Philox4x32-10, written out (Salmon et al. 2011): counter = ray index,
// key = seed. Two of the four output words are used per ray. ----
__device__ __forceinline__ void philox4x32(uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3,
                                           uint32_t k0, uint32_t k1,
                                           uint32_t out[4]) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
    uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
    uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
    c0 = n0; c1 = lo1; c2 = n2; c3 = lo0;
    k0 += W0; k1 += W1;
  }
  out[0] = c0; out[1] = c1; out[2] = c2; out[3] = c3;
}

// high 23 bits -> float32 uniform in [0, 1)
__device__ __forceinline__ float bitsToUniform(uint32_t x) {
  return (float)(x >> 9) * (1.0f / 8388608.0f);
}

// inverse-CDF transform of one marginal block (see ops/cuda_trace.py
// `_packMarginal` for the layout)
__device__ float marginal(const float* m, float u) {
  int kind = (int)m[0];
  if (kind == 0) return m[2] + u * m[3];                 // affine: lo + u*span
  int n = (int)m[1];
  const float* data = m + 4;
  if (kind == 1) {                                       // piecewise Horner
    float out = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* seg = data + i * kSegStride;
      float s = (u - seg[1]) * seg[2];
      int nc = (int)seg[3];
      float acc = seg[4 + nc - 1];
      for (int c = nc - 2; c >= 0; --c) acc = acc * s + seg[4 + c];
      if (i == 0 || u >= seg[0]) out = acc;
    }
    return fminf(fmaxf(out, m[2]), m[3]);
  }
  // tent table of n knots on a uniform [0, 1] grid: only the two knots
  // around pos carry weight
  float pos = u * (float)(n - 1);
  int j = min(max((int)pos, 0), n - 2);
  float w0 = fmaxf(0.f, 1.f - fabsf(pos - (float)j));
  float w1 = fmaxf(0.f, 1.f - fabsf(pos - ((float)j + 1.f)));
  return w0 * data[j] + w1 * data[j + 1];
}

// n(wavelength) from one dispersion row: Horner in the scaled wavelength
__device__ __forceinline__ float dispersionN(const float* d, float wl) {
  float s = (wl - d[0]) * d[1];
  int nc = (int)d[2];
  float acc = d[4 + nc - 1];
  for (int c = nc - 2; c >= 0; --c) acc = acc * s + d[4 + c];
  return acc;
}

// Rodrigues rotation of v about the unit axis a by `ang`, in the
// reference's operation order (`_rotColumns`)
__device__ __forceinline__ void rotate(float& vx, float& vy, float& vz,
                                       float ax, float ay, float az,
                                       float ang) {
  float c = cosf(ang), s = sinf(ang);
  float cx = ay * vz - az * vy;
  float cy = az * vx - ax * vz;
  float cz = ax * vy - ay * vx;
  float dot = ax * vx + ay * vy + az * vz;
  float omc = 1.f - c;
  float rx = vx * c + cx * s + ax * dot * omc;
  float ry = vy * c + cy * s + ay * dot * omc;
  float rz = vz * c + cz * s + az * dot * omc;
  vx = rx; vy = ry; vz = rz;
}

// ---- stochastic scatter (B5): the evaluators of the fitted constants, in
// the reference's operation order (device_sampler.evalPwpoly2d,
// evalLowRankTheta, evalFourier, evalPoly1d, evalDiscreteEvents,
// arccosApprox) ----

// a 1-D function block at c
__device__ float evalFn1d(const float* f, float c) {
  const int kind = (int)f[0];
  if (kind == FN_CONST) return f[1];
  if (kind == FN_POLY1D) {
    float s = (c - f[1]) * f[2];
    int nc = (int)f[3];
    float acc = f[4 + nc - 1];
    for (int j = nc - 2; j >= 0; --j) acc = acc * s + f[4 + j];
    return acc;
  }
  // Fourier series by the angle-addition recurrence
  const float c1 = cosf(c), s1 = sinf(c);
  float out = f[1] + f[4] * c1 + f[5] * s1;
  float cp = 1.f, sp = 0.f, cm = c1, sm = s1;
  const int nT = (int)f[2];
  for (int m = 2; m <= nT; ++m) {
    float cn = 2.f * c1 * cm - cp;
    cp = cm; cm = cn;
    float sn = 2.f * c1 * sm - sp;
    sp = sm; sm = sn;
    out = out + f[4 + 2 * (m - 1)] * cm + f[5 + 2 * (m - 1)] * sm;
  }
  return out;
}

// a pwpoly2d spec at (u, c): the last rectangle whose closed box holds
// (u, scaled c) wins, else the first — only that one is evaluated
__device__ float evalPwpoly2d(const float* sp, float u, float c) {
  const int n = (int)sp[1], nU = (int)sp[6], nC = (int)sp[7];
  const int stride = kRectHead + nU * nC;
  const float s = (c - sp[4]) * sp[5];
  int sel = 0;
  for (int r = n - 1; r >= 1; --r) {
    const float* rr = sp + 8 + r * stride;
    if (u >= rr[0] && u <= rr[1] && s >= rr[2] && s <= rr[3]) {
      sel = r;
      break;
    }
  }
  const float* rr = sp + 8 + sel * stride;
  const float x = (u - rr[4]) * rr[5];
  const float cc = (s - rr[6]) * rr[7];
  const float* coef = rr + kRectHead;
  float acc = 0.f;
  for (int i = nU - 1; i >= 0; --i) {
    const float* row = coef + i * nC;
    float h = row[nC - 1];
    for (int j = nC - 2; j >= 0; --j) h = h * cc + row[j];
    acc = (i == nU - 1) ? h : acc * x + h;
  }
  return fminf(fmaxf(acc, sp[2]), sp[3]);
}

// one marginal spec of an entry at u (conditioned on c = theta_in and, for
// a low-rank spec, on the drawn phi)
__device__ float evalScatterSpec(const float* sc, const float* sp, float u,
                                 float c, float phi) {
  const int kind = (int)sp[0];
  if (kind == SPEC_PWPOLY) return marginal(sp, u);
  if (kind == SPEC_PWPOLY2D) return evalPwpoly2d(sp, u, c);
  const int n = (int)sp[1];
  float out = 0.f;
  for (int k = 0; k < n; ++k) {
    const float bv = evalFn1d(sc + (int)sp[5 + 2 * k], phi);
    const float term = evalPwpoly2d(sc + (int)sp[4 + 2 * k], u, c) * bv;
    out = k == 0 ? term : out + term;
  }
  return fminf(fmaxf(out, sp[2]), sp[3]);
}

// discrete (DiracDelta) events: the event index is the count of cumulative
// probabilities below u; u past the last keeps the continuous draw
__device__ float discreteEvents(const float* d, int n, float c, float u,
                                float cont) {
  float out = 0.f, prevCum = 0.f;
  for (int ev = 0; ev < n; ++ev) {
    const float v = evalFn1d(d + (2 * ev + 1) * kFnCols, c);
    out = (ev == 0 || u > prevCum) ? v : out;
    prevCum = evalFn1d(d + 2 * ev * kFnCols, c);
  }
  return u <= prevCum ? out : cont;
}

// (theta, phi) of one entry: phi first, then theta conditioned on it
__device__ void drawEntry(const float* sc, const float* en, float thetaIn,
                          float u1, float u2, float u3, float u4,
                          float& theta, float& phi) {
  phi = evalScatterSpec(sc, sc + (int)en[EN_PHI], u1, thetaIn, 0.f);
  if (en[EN_NPHIDISC] > 0.f)
    phi = discreteEvents(sc + (int)en[EN_PHIDISC], (int)en[EN_NPHIDISC],
                         thetaIn, u3, phi);
  theta = evalScatterSpec(sc, sc + (int)en[EN_THETA], u2, thetaIn, phi);
  if (en[EN_NTHETADISC] > 0.f)
    theta = discreteEvents(sc + (int)en[EN_THETADISC],
                           (int)en[EN_NTHETADISC], thetaIn, u4, theta);
}

// arccos(mu) for mu in [0, 1] as sqrt(1 - x) * P(2x - 1)
__device__ __forceinline__ float arccosApprox(const float* P, float mu) {
  const float x = fminf(fmaxf(mu, 0.f), 1.f);
  const float s = 2.f * x - 1.f;
  float acc = P[kAcosCoeffs - 1];
  for (int k = kAcosCoeffs - 2; k >= 0; --k) acc = acc * s + P[k];
  return sqrtf(fmaxf(1.f - x, 0.f)) * acc;
}

// unit b x d, or a perpendicular of b (b x x-hat, else b x y-hat) where b
// and d are nearly parallel
__device__ __forceinline__ void lobeAxis(float bx, float by, float bz,
                                         float dx, float dy, float dz,
                                         float& ax, float& ay, float& az) {
  ax = by * dz - bz * dy;
  ay = bz * dx - bx * dz;
  az = bx * dy - by * dx;
  const float ax2 = ax * ax + ay * ay + az * az;
  if (ax2 < 1e-12f) {
    const float alt2 = bz * bz + by * by;
    if (alt2 > 1e-12f) { ax = 0.f; ay = bz; az = -by; }
    else { ax = -bz; ay = 0.f; az = bx; }
  }
  const float ainv = rsqrtf(ax * ax + ay * ay + az * az + 1e-20f);
  ax *= ainv; ay *= ainv; az *= ainv;
}

// The scatter section of one bounce (see the header): `sc` is the scatter
// block, `elem` the winner's element, (nx, ny, nz) the normal on the side
// the ray travels to, d the incoming and nd the new direction (in / out).
__device__ void scatterBounce(const float* sc, const TraceParams& p,
                              const float* rayIn, long long i, int bounce,
                              int samplerRows, int elem, bool isMirror,
                              bool isLens, bool isEntering, float dDotN,
                              float nx, float ny, float nz, float dx,
                              float dy, float dz, float& ndx, float& ndy,
                              float& ndz) {
  const int nEnt = (int)sc[SC_N];
  const int kindL = isMirror ? SCAT_REFLECT
                    : (isLens ? (isEntering ? SCAT_REFRACT_ENTER
                                            : SCAT_REFRACT_EXIT) : -1);
  int lobeE = -1, modE = -1;
  for (int k = 0; k < nEnt; ++k) {
    const float* en = sc + kScHeader + k * kScEntryCols;
    if ((int)en[EN_ELEM] != elem) continue;
    const int kind = (int)en[EN_KIND];
    if (kind == SCAT_MODIFY) {
      if (isMirror || isLens) modE = k;
    } else if (kind == kindL) {
      lobeE = k;
    }
  }
  if (lobeE >= 0 || modE >= 0) {
    const float thetaIn = sc[SC_COND] != 0.f
        ? arccosApprox(sc + SC_ACOS, fminf(fmaxf(dDotN, 0.f), 1.f)) : 0.f;
    const int lobeRows = (int)sc[SC_LOBEROWS];
    const long long row0 = samplerRows + (long long)bounce * (int)sc[SC_ROWS];
    const uint32_t lo = (uint32_t)i;
    const uint32_t hi = (uint32_t)((unsigned long long)i >> 32);
    const uint32_t k0 = (uint32_t)p.seed, k1 = (uint32_t)(p.seed >> 32);
    uint32_t rnd[4];
    if (lobeE >= 0) {
      float u1, u2, u3 = 0.f, u4 = 0.f;
      if (p.mode == MODE_UNIFORMS) {
        u1 = rayIn[row0 * p.N + i];
        u2 = rayIn[(row0 + 1) * p.N + i];
        if (lobeRows == 4) {
          u3 = rayIn[(row0 + 2) * p.N + i];
          u4 = rayIn[(row0 + 3) * p.N + i];
        }
      } else {
        philox4x32(lo, hi, 2u + (uint32_t)bounce, 0u, k0, k1, rnd);
        u1 = bitsToUniform(rnd[0]); u2 = bitsToUniform(rnd[1]);
        u3 = bitsToUniform(rnd[2]); u4 = bitsToUniform(rnd[3]);
      }
      float th, ph;
      drawEntry(sc, sc + kScHeader + lobeE * kScEntryCols, thetaIn, u1, u2,
                u3, u4, th, ph);
      const float nSgn = isMirror ? -1.f : 1.f;
      const float lnx = nx * nSgn, lny = ny * nSgn, lnz = nz * nSgn;
      float ax, ay, az;
      lobeAxis(lnx, lny, lnz, dx, dy, dz, ax, ay, az);
      float sx = lnx, sy = lny, sz = lnz;
      rotate(sx, sy, sz, ax, ay, az, th);
      rotate(sx, sy, sz, lnx, lny, lnz, ph);
      ndx = sx; ndy = sy; ndz = sz;
    }
    if (modE >= 0) {
      float m1, m2, m3 = 0.f, m4 = 0.f;
      if (p.mode == MODE_UNIFORMS) {
        const long long r = row0 + lobeRows;
        m1 = rayIn[r * p.N + i];
        m2 = rayIn[(r + 1) * p.N + i];
        if ((int)sc[SC_MODROWS] == 4) {
          m3 = rayIn[(r + 2) * p.N + i];
          m4 = rayIn[(r + 3) * p.N + i];
        }
      } else {
        philox4x32(lo, hi, 2u + (uint32_t)bounce, 1u, k0, k1, rnd);
        m1 = bitsToUniform(rnd[0]); m2 = bitsToUniform(rnd[1]);
        m3 = bitsToUniform(rnd[2]); m4 = bitsToUniform(rnd[3]);
      }
      float th, ph;
      drawEntry(sc, sc + kScHeader + modE * kScEntryCols, thetaIn, m1, m2,
                m3, m4, th, ph);
      float ax, ay, az;
      lobeAxis(ndx, ndy, ndz, dx, dy, dz, ax, ay, az);
      float sx = ndx, sy = ndy, sz = ndz;
      rotate(sx, sy, sz, ax, ay, az, th);
      rotate(sx, sy, sz, ndx, ndy, ndz, ph);
      ndx = sx; ndy = sy; ndz = sz;
    }
  }
  const float inv = rsqrtf(ndx * ndx + ndy * ndy + ndz * ndz + 1e-20f);
  ndx *= inv; ndy *= inv; ndz *= inv;
}

// The local position and canonical normal on a face of kind cone, asphere,
// torus or triangle (B2's faces; GEOM only), in the reference's operation
// order (`_localSampleColumns`): the cone's z from its area CDF in closed
// form, an asphere's radius and a torus's tube angle from their fitted
// inverse CDFs (a marginal block of the sampler), a triangle's point from
// two uniforms folded into the triangle.
__device__ __noinline__ void sampleGeomFace(const float* sg, const float* fr,
                                            float u, float v, float a,
                                            float& lx, float& ly, float& lz,
                                            float& nlx, float& nly,
                                            float& nlz) {
  const float* X = fr + F_X;
  const int kind = (int)fr[F_KIND];
  if (kind == KIND_TRIANGLE) {
    const bool flip = u + v > 1.f;
    const float aa = flip ? 1.f - u : u, bb = flip ? 1.f - v : v;
    lx = X[0] + aa * X[3] + bb * X[6];
    ly = X[1] + aa * X[4] + bb * X[7];
    lz = X[2] + aa * X[5] + bb * X[8];
    nlx = X[9]; nly = X[10]; nlz = X[11];
    return;
  }
  const float ca = cosf(a), sa = sinf(a);
  if (kind == KIND_CONE) {
    float z;
    if (X[7] != 0.f) {
      z = X[5] + u * X[6];
    } else {
      const float target = fr[F_C] + u * fr[F_C + 1];
      const float disc = fmaxf(fr[F_C + 2] + fr[F_C + 3] * target, 0.f);
      z = (-X[0] + sqrtf(disc)) * X[1];
    }
    const float rr = X[0] + z * X[2];
    lx = rr * ca; ly = rr * sa; lz = z;
    nlx = ca * X[3]; nly = sa * X[3]; nlz = 0.f - X[4];
  } else if (kind == KIND_ASPHERE) {
    const float r = marginal(sg + (int)X[0], u);
    const float c0 = X[1], K1 = X[2];
    const float r2 = r * r;
    const float root = sqrtf(fmaxf(1.f - K1 * r2, 1e-12f));
    const float opr = 1.f + root;
    const float sag = c0 * r2 / opr + r2 * r2 * (X[3] + r2 * (X[4] + r2 * X[5]));
    const float g = c0 * (2.f / opr + K1 * r2 / (root * (opr * opr)))
                    + X[6] * r2 + X[7] * r2 * r2 + X[8] * (r2 * (r2 * r2));
    const float ninv = rsqrtf(g * g * r2 + 1.f + 1e-20f);
    lx = r * ca; ly = r * sa; lz = sag;
    nlx = -g * r * ca * ninv; nly = -g * r * sa * ninv; nlz = ninv;
  } else {                         // torus
    const float vT = marginal(sg + (int)X[0], u);
    const float cv = cosf(vT), sv = sinf(vT);
    const float rad = X[1] + X[2] * cv;
    lx = rad * ca; ly = rad * sa; lz = X[2] * sv;
    nlx = cv * ca; nly = cv * sa; nlz = sv;
  }
}

// The surface-source sampler (B6): the reference's `_surfaceSampleColumns`
// for one ray from its five uniforms. `sg` is the sampler block: nFaces,
// 2 pi, wavelength at 14, the theta marginal, the face rows. GEOM adds the
// faces of kind cone, asphere, torus and triangle.
template <bool GEOM>
__device__ void sampleSurface(const float* sg, float uF, float u, float v,
                              float uT, float uP, float& ox, float& oy,
                              float& oz, float& dx, float& dy, float& dz) {
  const int nFaces = (int)sg[0];
  const float* faces = sg + kSamplerGeom + kMargLen;
  int sel = -1;                    // the last window holding uF wins
  for (int f = 0; f < nFaces; ++f) {
    const float* fr = faces + f * kFaceCols;
    if (uF >= fr[F_CUMLO] && uF < fr[F_CUMHI]) sel = f;
  }
  float nx = 0.f, ny = 0.f, nz = 1.f;
  ox = 0.f; oy = 0.f; oz = 0.f;
  if (sel >= 0) {
    const float* fr = faces + sel * kFaceCols;
    const float c0 = fr[F_C], c1 = fr[F_C + 1], c2 = fr[F_C + 2],
                c3 = fr[F_C + 3];
    const float a = sg[1] * v;
    float lx, ly, lz, nlx = 0.f, nly = 0.f, nlz = 1.f;
    const int kind = (int)fr[F_KIND];
    if (kind == KIND_PLANE) {
      if (fr[F_RECT] != 0.f) {
        lx = (2.f * u - 1.f) * c0;
        ly = (2.f * v - 1.f) * c1;
      } else {
        float r = sqrtf(u * c0 + c1);
        lx = r * cosf(a);
        ly = r * sinf(a);
      }
      lz = 0.f;
    } else if (GEOM && kind != KIND_SPHERE && kind != KIND_CYLINDER) {
      sampleGeomFace(sg, fr, u, v, a, lx, ly, lz, nlx, nly, nlz);
    } else {
      const float z = c0 + u * c1;
      if (kind == KIND_SPHERE) {
        float rr = sqrtf(fmaxf(c2 - z * z, 0.f));
        lx = rr * cosf(a);
        ly = rr * sinf(a);
        nlx = lx * c3; nly = ly * c3; nlz = z * c3;
      } else {                     // cylinder
        float ca = cosf(a), sa = sinf(a);
        lx = c2 * ca;
        ly = c2 * sa;
        nlx = ca; nly = sa; nlz = 0.f;
      }
      lz = z;
    }
    const float* R = fr + F_ROT;
    ox = R[0] * lx + R[1] * ly + R[2] * lz + fr[F_OFF];
    oy = R[3] * lx + R[4] * ly + R[5] * lz + fr[F_OFF + 1];
    oz = R[6] * lx + R[7] * ly + R[8] * lz + fr[F_OFF + 2];
    const float o = fr[F_ORIENT];
    nx = (R[0] * nlx + R[1] * nly + R[2] * nlz) * o;
    ny = (R[3] * nlx + R[4] * nly + R[5] * nlz) * o;
    nz = (R[6] * nlx + R[7] * nly + R[8] * nlz) * o;
  }
  const float ninv = rsqrtf(nx * nx + ny * ny + nz * nz + 1e-20f);
  nx *= ninv; ny *= ninv; nz *= ninv;
  // tangent: cross(n, x-hat), or cross(n, y-hat) where n is nearly x
  const bool useX = fabsf(nx) < 0.9f;
  float tx = useX ? 0.f : -nz;
  float ty = useX ? nz : 0.f;
  float tz = useX ? -ny : nx;
  const float tinv = rsqrtf(tx * tx + ty * ty + tz * tz + 1e-20f);
  tx *= tinv; ty *= tinv; tz *= tinv;
  const float theta = marginal(sg + kSamplerGeom, uT);
  const float phi = uP * sg[1];
  dx = nx; dy = ny; dz = nz;
  rotate(dx, dy, dz, tx, ty, tz, theta);
  rotate(dx, dy, dz, nx, ny, nz, phi);
  const float dinv = rsqrtf(dx * dx + dy * dy + dz * dz + 1e-20f);
  dx *= dinv; dy *= dinv; dz *= dinv;
}

__device__ __forceinline__ float signf(float x) {
  return (float)(x > 0.f) - (float)(x < 0.f);
}

// ray-surface distance in the surface's local frame, or kBig
__device__ float intersect(const float* r, float ox, float oy, float oz,
                           float dx, float dy, float dz, float tMin) {
  const float* R = r + S_ROT;
  float lox = R[0] * ox + R[1] * oy + R[2] * oz + r[S_OFF];
  float loy = R[3] * ox + R[4] * oy + R[5] * oz + r[S_OFF + 1];
  float loz = R[6] * ox + R[7] * oy + R[8] * oz + r[S_OFF + 2];
  float ldx = R[0] * dx + R[1] * dy + R[2] * dz;
  float ldy = R[3] * dx + R[4] * dy + R[5] * dz;
  float ldz = R[6] * dx + R[7] * dy + R[8] * dz;
  int kind = (int)r[S_KIND];
  float tA = r[S_TRIMA], tB = r[S_TRIMB];
  if (kind == KIND_PLANE) {
    float dzS = fabsf(ldz) < 1e-12f ? 1e-12f : ldz;
    float t = -loz / dzS;
    float x = lox + t * ldx, y = loy + t * ldy;
    bool ok;
    if (r[S_TRIM0] == 1.f) {
      ok = (fabsf(x) <= tA) && (fabsf(y) <= tB);
    } else {                       // annulus; tA, tB hold the SQUARED radii
      float r2 = x * x + y * y;
      ok = (r2 >= tA) && (r2 <= tB);
    }
    return ((t > tMin) && ok) ? t : kBig;
  }
  float a, b, c;
  if (kind == KIND_SPHERE) {
    a = ldx * ldx + ldy * ldy + ldz * ldz;
    b = 2.f * (lox * ldx + loy * ldy + loz * ldz);
    c = lox * lox + loy * loy + loz * loz - r[S_P0SQ];
  } else {                         // cylinder about local z
    a = ldx * ldx + ldy * ldy;
    b = 2.f * (lox * ldx + loy * ldy);
    c = lox * lox + loy * loy - r[S_P0SQ];
  }
  float disc = b * b - 4.f * a * c;
  bool okD = disc >= 0.f;
  float sqD = sqrtf(fmaxf(disc, 0.f));
  float q = -0.5f * (b + signf(b + 1e-30f) * sqD);
  float aS = fabsf(a) < 1e-20f ? 1e-20f : a;
  float qS = fabsf(q) < 1e-20f ? 1e-20f : q;
  float t1 = q / aS, t2 = c / qS;
  float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
  float zLo = loz + lo * ldz, zHi = loz + hi * ldz;
  float loV = (okD && (lo > tMin) && (zLo >= tA) && (zLo <= tB)) ? lo : kBig;
  float hiV = (okD && (hi > tMin) && (zHi >= tA) && (zHi <= tB)) ? hi : kBig;
  return fminf(loV, hiV);
}

// ---- B2 / B3 (GEOM only): the other surface kinds and the trims of CAD
// faces, in the reference's operation order (`_intersectConst`,
// `_bitmapOkConst`, `_applyPrimsConst`, geometry/surfaces
// `_quarticSmallestRoot`), every power written as products ----

// The reference's branchless polynomial atan2 (`chartAtan2`): it sets the
// bitmaps' azimuth pixels and the torus's tube angle.
__device__ __forceinline__ float chartAtan2(float y, float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  const float a = lo / fmaxf(hi, 1e-30f);
  const bool big = a > 0.41421356237309503f;     // tan(pi/8)
  const float aa = big ? (a - 1.f) / (a + 1.f) : a;
  const float z = aa * aa;
  float p = ((8.05374449538e-2f * z - 1.38776856032e-1f) * z
             + 1.99777106478e-1f) * z - 3.33329491539e-1f;
  p = p * z * aa + aa;
  if (big) p = p + 0.7853981633974483f;
  if (ay > ax) p = 1.5707963267948966f - p;
  if (x < 0.f) p = 3.14159265358979323846f - p;
  return y < 0.f ? -p : p;
}

// A bitmap trim (flag 2): the pixel of chart point (u, v) inside the R x R
// window, and its bit (row-major over (iv, iu), LSB first).
__device__ bool bitmapOk(const float* r, const float* smem, float u,
                         float v) {
  const float R = r[G_MASKRES];
  const float pu = (u - r[S_TRIMA]) * r[G_TRIM3];
  const float pv = (v - r[S_TRIMB]) * r[G_TRIM4];
  if (!(pu >= 0.f && pu < R && pv >= 0.f && pv < R)) return false;
  const int idx = (int)floorf(pv) * (int)R + (int)floorf(pu);
  const uint32_t w = __float_as_uint(smem[(int)r[G_MASKOFF] + (idx >> 5)]);
  return (w >> (idx & 31)) & 1u;
}

// Hole-primitive trims (flags 3, 4): (base OR any add-prim) AND NOT any
// hole-prim, on the local point (x, y, z).
__device__ bool applyPrims(const float* r, const float* smem, float x,
                           float y, float z, bool base) {
  const float* h = smem + (int)r[G_PRIMOFF];
  const int n = (int)r[G_NPRIM];
  bool add = false, hole = false;
  for (int k = 0; k < n; ++k, h += kPrimCols) {
    const float shape = h[0], cx = h[3], cy = h[4], p0 = h[5], p1 = h[6],
                ca = h[7], sa = h[8];
    const float dxp = x - cx, dyp = y - cy;
    bool in;
    if (shape > 5.5f) {
      in = x * cx + y * cy + z * p0 >= p1;
    } else if (shape > 4.5f) {
      in = (cx * x * x + cy * x * y + p0 * y * y + p1 * x + ca * y + sa)
           <= 0.f;
    } else if (shape > 3.5f) {
      const float xr = ca * dxp + sa * dyp;
      const float yr = -sa * dxp + ca * dyp;
      in = yr <= p0 * xr * xr + p1 * xr;
    } else if (shape > 2.5f) {
      in = dxp * p0 + dyp * p1 >= 0.f;
    } else if (shape > 1.5f) {
      in = dxp * dxp + dyp * dyp <= p0;
    } else {
      const float xr = ca * dxp + sa * dyp;
      const float yr = -sa * dxp + ca * dyp;
      in = fabsf(xr) <= p0 && fabsf(yr) <= p1;
    }
    if (h[2] != 0.f) in = !in;
    if (h[1] != 0.f) add = add || in;
    else hole = hole || in;
  }
  return (base || add) && !hole;
}

// The trim of a charted kind at local point (xx, yy, z) whose band
// coordinate is v, on top of the kind's own test `pre`: the bitmap over
// (azimuth, v), or the band [S_TRIMA, S_TRIMB] with the hole primitives.
__device__ bool chartOk(const float* r, const float* smem, float trim0,
                        float xx, float yy, float z, float v, bool pre) {
  if (trim0 == 2.f) return pre && bitmapOk(r, smem, chartAtan2(yy, xx), v);
  bool band = pre && (v >= r[S_TRIMA]) && (v <= r[S_TRIMB]);
  if (trim0 == 3.f) band = applyPrims(r, smem, xx, yy, z, band);
  return band;
}

// stable roots of t^2 + b t + c, sorted; +inf where there are none
__device__ __forceinline__ void quadRoots(float b, float c, float& lo,
                                          float& hi) {
  const float disc = b * b - 4.f * c;
  const bool ok = disc >= 0.f;
  const float sq = ok ? sqrtf(disc) : 0.f;
  const float q = -0.5f * (b + signf(b + 1e-30f) * sq);
  const float t2 = c / (fabsf(q) < 1e-20f ? 1e-20f : q);
  lo = ok ? fminf(q, t2) : INFINITY;
  hi = ok ? fmaxf(q, t2) : INFINITY;
}

// an asphere: the vertex-plane start, the osculating sphere's nearest
// positive root where the curvature allows, 16 Newton steps on z - sag(r),
// then the residual gate and the r-band trim (inlined into the surface
// sweep: on the card that spills less and runs faster than a call out of
// line, PERF.md §6)
__device__ __forceinline__ float intersectAsphere(
    const float* r, const float* smem, float lox, float loy, float loz,
    float ldx, float ldy, float ldz, float tMin) {
  const float* P = r + G_P;
  const float* X = r + G_X;
  const float c0 = P[0], a4 = P[2], a6 = P[3], a8 = P[4], K1 = X[0];
  const float dzS = fabsf(ldz) < 1e-9f ? (ldz >= 0.f ? 1e-9f : -1e-9f) : ldz;
  float t = fmaxf(-loz / dzS, 0.f);
  if (X[3] != 0.f) {
    const float ocz = loz - X[1];
    const float b = 2.f * (lox * ldx + loy * ldy + ocz * ldz);
    const float cc = lox * lox + loy * loy + ocz * ocz - X[2];
    const float disc = b * b - 4.f * cc;
    const bool okD = disc >= 0.f;
    const float sqD = sqrtf(fmaxf(disc, 0.f));
    const float q = -0.5f * (b + signf(b + 1e-30f) * sqD);
    const float t2 = cc / (fabsf(q) < 1e-20f ? 1e-20f : q);
    const float lo = fminf(q, t2), hi = fmaxf(q, t2);
    const float sph = (okD && lo > tMin) ? lo : ((okD && hi > tMin) ? hi : t);
    t = okD ? sph : t;
  }
  const float K4 = 4.f * a4, K6 = 6.f * a6, K8 = 8.f * a8;
  for (int it = 0; it < 16; ++it) {
    const float x = lox + t * ldx, y = loy + t * ldy, z = loz + t * ldz;
    const float r2 = x * x + y * y;
    const float rootA = sqrtf(fmaxf(1.f - K1 * r2, 1e-12f));
    const float opr = 1.f + rootA;
    const float sag = c0 * r2 / opr + r2 * r2 * (a4 + r2 * (a6 + r2 * a8));
    const float g = c0 * (2.f / opr + K1 * r2 / (rootA * (opr * opr)))
                    + K4 * r2 + K6 * r2 * r2 + K8 * (r2 * (r2 * r2));
    const float f = z - sag;
    float slope = -g * x * ldx - g * y * ldy + ldz;
    if (fabsf(slope) < 1e-12f) slope = slope >= 0.f ? 1e-12f : -1e-12f;
    t = t - f / slope;
  }
  const float x = lox + t * ldx, y = loy + t * ldy, z = loz + t * ldz;
  const float r2 = x * x + y * y;
  const float rootA = sqrtf(fmaxf(1.f - K1 * r2, 1e-12f));
  const float opr = 1.f + rootA;
  const float sag = c0 * r2 / opr + r2 * r2 * (a4 + r2 * (a6 + r2 * a8));
  const bool ok = (t > tMin) && (fabsf(z - sag) < 1e-4f)
                  && chartOk(r, smem, r[S_TRIM0], x, y, z, sqrtf(r2), true);
  return ok ? t : kBig;
}

// a torus: the ray re-anchored at its closest approach to the centre and
// scaled by R, the quartic's smallest valid root by Ferrari through the
// resolvent cubic (28 damped Newton steps from above) and three Newton
// polish steps per candidate, mapped back (inlined, as the asphere)
__device__ __forceinline__ float intersectTorus(
    const float* r, const float* smem, float lox, float loy, float loz,
    float ldx, float ldy, float ldz, float tMin) {
  const float R0 = r[G_P];
  const float rr2 = r[G_X], rT2 = r[G_X + 1], resTol = r[G_X + 2];
  const float trim0 = r[S_TRIM0];
  const float dd = ldx * ldx + ldy * ldy + ldz * ldz;
  const float ddS = dd < 1e-20f ? 1e-20f : dd;
  const float tMid = -(lox * ldx + loy * ldy + loz * ldz) / ddS;
  const float stretch = sqrtf(ddS) / R0;
  const float osx = (lox + tMid * ldx) / R0;
  const float osy = (loy + tMid * ldy) / R0;
  const float osz = (loz + tMid * ldz) / R0;
  const float invL = rsqrtf(ddS);
  const float dsx = ldx * invL, dsy = ldy * invL, dsz = ldz * invL;
  const float K = osx * osx + osy * osy + osz * osz + 1.f - rr2;
  const float bq = 2.f * (osx * dsx + osy * dsy + osz * dsz);
  const float exy = dsx * dsx + dsy * dsy;
  const float fxy = osx * dsx + osy * dsy;
  const float gxy = osx * osx + osy * osy;
  const float b = 2.f * bq;
  const float c = bq * bq + 2.f * K - 4.f * exy;
  const float d = 2.f * bq * K - 8.f * fxy;
  const float e = K * K - 4.f * gxy;
  const float tauMin = (tMin - tMid) * stretch;
  // depressed quartic u^4 + p u^2 + q u + r with t = u - b/4
  const float b4 = b / 4.f;
  const float bb = b * b;
  const float p = c - 3.f * b * b / 8.f;
  const float q = d - b * c / 2.f + b * bb / 8.f;
  const float rq = e - b * d / 4.f + bb * c / 16.f - 3.f * (bb * bb) / 256.f;
  // largest root of S^3 + 2p S^2 + (p^2 - 4r) S - q^2
  const float B = 2.f * p, C = p * p - 4.f * rq, D = -q * q;
  float S = 1.f + fmaxf(fabsf(B), fmaxf(fabsf(C), fabsf(D)));
  for (int it = 0; it < 28; ++it) {
    const float f = ((S + B) * S + C) * S + D;
    float fp = (3.f * S + 2.f * B) * S + C;
    if (fabsf(fp) < 1e-20f) fp = 1e-20f;
    const float step = f / fp;
    S = S - fminf(fmaxf(step, -fabsf(S) - 1.f), fabsf(S) + 1.f);
  }
  S = fmaxf(S, 0.f);
  const bool biquad = S < 1e-10f * (1.f + fabsf(p));
  const float s = sqrtf(biquad ? 1.f : S);
  const float sSafe = biquad ? 1.f : s;
  float A = 0.5f * (p + S - q / sSafe);
  float Bb = 0.5f * (p + S + q / sSafe);
  if (biquad) {
    float y1, y2;
    quadRoots(p, rq, y1, y2);
    A = y1 < INFINITY ? -y1 : 0.f;
    Bb = y2 < INFINITY ? -y2 : 0.f;
  }
  const float sQ = biquad ? 0.f : s;
  float u[4];
  quadRoots(sQ, A, u[0], u[1]);
  quadRoots(-sQ, Bb, u[2], u[3]);
  float tauBest = INFINITY;
  for (int k = 0; k < 4; ++k) {
    float tau = u[k] < INFINITY ? u[k] - b4 : INFINITY;
    for (int it = 0; it < 3; ++it) {
      const float f = (((tau + b) * tau + c) * tau + d) * tau + e;
      float fp = ((4.f * tau + 3.f * b) * tau + 2.f * c) * tau + d;
      if (fabsf(fp) < 1e-20f) fp = 1e-20f;
      if (tau < INFINITY) tau = tau - f / fp;
    }
    if (!(tau > tauMin && tau < INFINITY)) continue;
    // the residual gate (spurious factorisation roots) and the tube-angle
    // trim
    const float t = tMid + tau / stretch;
    const float x = lox + t * ldx, y = loy + t * ldy, z = loz + t * ldz;
    const float sxy = sqrtf(x * x + y * y);
    const float dr = sxy - R0;
    const float g = dr * dr + z * z - rT2;
    if (fabsf(g) < resTol
        && chartOk(r, smem, trim0, x, y, z, chartAtan2(z, dr), true))
      tauBest = fminf(tauBest, tau);
  }
  return tauBest < kBig ? tMid + tauBest / stretch : kBig;
}

// Ray-surface distance of every kind and trim (GEOM): plane / sphere /
// cylinder with window trims are `intersect`'s; this adds the trims of B3 on
// them and the kinds of B2.
__device__ float intersectGeom(const float* r, const float* smem, float ox,
                               float oy, float oz, float dx, float dy,
                               float dz, float tMin) {
  const int kind = (int)r[S_KIND];
  const float trim0 = r[S_TRIM0];
  if (kind <= KIND_CYLINDER && (trim0 == 0.f || trim0 == 1.f))
    return intersect(r, ox, oy, oz, dx, dy, dz, tMin);
  const float* R = r + S_ROT;
  const float lox = R[0] * ox + R[1] * oy + R[2] * oz + r[S_OFF];
  const float loy = R[3] * ox + R[4] * oy + R[5] * oz + r[S_OFF + 1];
  const float loz = R[6] * ox + R[7] * oy + R[8] * oz + r[S_OFF + 2];
  const float ldx = R[0] * dx + R[1] * dy + R[2] * dz;
  const float ldy = R[3] * dx + R[4] * dy + R[5] * dz;
  const float ldz = R[6] * dx + R[7] * dy + R[8] * dz;
  const float tA = r[S_TRIMA], tB = r[S_TRIMB];
  const float* P = r + G_P;
  if (kind == KIND_TRIANGLE) {     // Moeller-Trumbore
    const float* X = r + G_X;
    const float e1x = X[0], e1y = X[1], e1z = X[2];
    const float e2x = X[3], e2y = X[4], e2z = X[5];
    const float pvx = ldy * e2z - ldz * e2y;
    const float pvy = ldz * e2x - ldx * e2z;
    const float pvz = ldx * e2y - ldy * e2x;
    const float det = e1x * pvx + e1y * pvy + e1z * pvz;
    const float detS = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float tvx = lox - P[0], tvy = loy - P[1], tvz = loz - P[2];
    const float u = (tvx * pvx + tvy * pvy + tvz * pvz) / detS;
    const float qvx = tvy * e1z - tvz * e1y;
    const float qvy = tvz * e1x - tvx * e1z;
    const float qvz = tvx * e1y - tvy * e1x;
    const float v = (ldx * qvx + ldy * qvy + ldz * qvz) / detS;
    const float t = (e2x * qvx + e2y * qvy + e2z * qvz) / detS;
    const bool ok = (fabsf(det) > 1e-12f) && (u >= 0.f) && (v >= 0.f)
                    && (u + v <= 1.f) && (t > tMin);
    return ok ? t : kBig;
  }
  if (kind == KIND_PLANE) {        // a bitmap, or a window with primitives
    const float dzS = fabsf(ldz) < 1e-12f ? 1e-12f : ldz;
    const float t = -loz / dzS;
    const float x = lox + t * ldx, y = loy + t * ldy;
    bool ok;
    if (trim0 == 2.f) {
      ok = bitmapOk(r, smem, x, y);
    } else if (trim0 == 4.f) {
      ok = (fabsf(x) <= tA) && (fabsf(y) <= tB);
    } else {                       // annulus; tA, tB hold the SQUARED radii
      const float r2 = x * x + y * y;
      ok = (r2 >= tA) && (r2 <= tB);
    }
    if (trim0 != 2.f) ok = applyPrims(r, smem, x, y, 0.f, ok);
    return ((t > tMin) && ok) ? t : kBig;
  }
  if (kind == KIND_ASPHERE)
    return intersectAsphere(r, smem, lox, loy, loz, ldx, ldy, ldz, tMin);
  if (kind == KIND_TORUS)
    return intersectTorus(r, smem, lox, loy, loz, ldx, ldy, ldz, tMin);
  // sphere and cylinder (their chart trims), cone, quadric: a quadratic in t
  float a, b, c, w0 = 0.f, wd = 0.f;
  if (kind == KIND_SPHERE) {
    a = ldx * ldx + ldy * ldy + ldz * ldz;
    b = 2.f * (lox * ldx + loy * ldy + loz * ldz);
    c = lox * lox + loy * loy + loz * loz - r[S_P0SQ];
  } else if (kind == KIND_CYLINDER) {
    a = ldx * ldx + ldy * ldy;
    b = 2.f * (lox * ldx + loy * ldy);
    c = lox * lox + loy * loy - r[S_P0SQ];
  } else if (kind == KIND_CONE) {  // |(x, y)| = r0 + z tanA, one nappe
    const float r0 = P[0], tanA = P[1];
    w0 = r0 + loz * tanA;
    wd = ldz * tanA;
    a = ldx * ldx + ldy * ldy - wd * wd;
    b = 2.f * (lox * ldx + loy * ldy - w0 * wd);
    c = lox * lox + loy * loy - w0 * w0;
  } else {                         // principal-axis quadric
    const float qa = P[0], qb = P[1], qc = P[2], qz = P[3], q0 = P[4];
    a = qa * ldx * ldx + qb * ldy * ldy + qc * ldz * ldz;
    b = 2.f * (qa * lox * ldx + qb * loy * ldy + qc * loz * ldz) + qz * ldz;
    c = qa * lox * lox + qb * loy * loy + qc * loz * loz + qz * loz + q0;
  }
  const float disc = b * b - 4.f * a * c;
  bool okD = disc >= 0.f;
  const float sqD = sqrtf(fmaxf(disc, 0.f));
  const float q = -0.5f * (b + signf(b + 1e-30f) * sqD);
  const float aS = fabsf(a) < 1e-20f ? 1e-20f : a;
  const float qS = fabsf(q) < 1e-20f ? 1e-20f : q;
  float t1 = q / aS, t2 = c / qS;
  if (kind == KIND_QUADRIC) {      // the linear case: the root -c / b
    const float linT = -c / (fabsf(b) < 1e-20f ? 1e-20f : b);
    const bool isLin = (fabsf(a) < 1e-14f * (fabsf(b) + 1e-20f))
                       && (fabsf(b) > 1e-20f);
    if (isLin) { t1 = linT; t2 = kBig; okD = true; }
  }
  const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
  float out = kBig;
  for (int k = 0; k < 2; ++k) {
    const float t = k == 0 ? lo : hi;
    const float z = loz + t * ldz;
    const bool pre = kind != KIND_CONE || (w0 + t * wd >= 0.f);
    const bool ok = (trim0 == 0.f || trim0 == 1.f)
        ? pre && (z >= tA) && (z <= tB)
        : chartOk(r, smem, trim0, lox + t * ldx, loy + t * ldy, z, z, pre);
    out = fminf(out, (okD && (t > tMin) && ok) ? t : kBig);
  }
  return out;
}

// ---- B7 (TRI only): the triangle table ----
// table and box pack in global memory (the pack: nGroups group boxes, then
// nChunks chunk boxes, then ceil(n / kTriLeaf) leaf boxes, kBoxStride
// floats each), with their counts (a sweep's launch offsets them to the
// block's variant)
struct TriTable {
  const float* tri;
  const float* box;
  int n, nChunks, nGroups;
};

// the leaf boxes of a triangle table of n rows in nChunks chunks (none for
// a table swept flat)
__device__ __forceinline__ int triLeaves(int n, int nChunks) {
  return nChunks > 0 ? (n + kTriLeaf - 1) / kTriLeaf : 0;
}

// Moeller-Trumbore of the ray against table row r (the JAX package's
// `_triBody`, operation for operation); a strictly nearer hit replaces the
// running winner (tT, its normal, its element). The row is read as scalars:
// three 16-byte loads from a 12-float padded copy ran 2-3 % faster on the
// dishes but raised the registers or spills of three instances and not the
// walls' time (PERF.md §6).
__device__ __forceinline__ void triangleTest(
    const float* __restrict__ r, float ox, float oy, float oz, float dx,
    float dy, float dz, float tMin, float maxRayLength, float& tT,
    float& nxT, float& nyT, float& nzT, int& elT) {
  const float p0x = __ldg(r), p0y = __ldg(r + 1), p0z = __ldg(r + 2);
  const float e1x = __ldg(r + 3), e1y = __ldg(r + 4), e1z = __ldg(r + 5);
  const float e2x = __ldg(r + 6), e2y = __ldg(r + 7), e2z = __ldg(r + 8);
  const float pvx = dy * e2z - dz * e2y;
  const float pvy = dz * e2x - dx * e2z;
  const float pvz = dx * e2y - dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const float detS = fabsf(det) < 1e-12f ? 1e-12f : det;
  const float tvx = ox - p0x, tvy = oy - p0y, tvz = oz - p0z;
  const float u = (tvx * pvx + tvy * pvy + tvz * pvz) / detS;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float v = (dx * qvx + dy * qvy + dz * qvz) / detS;
  const float t = (e2x * qvx + e2y * qvy + e2z * qvz) / detS;
  const bool ok = (fabsf(det) > 1e-12f) && (u >= 0.f) && (v >= 0.f)
                  && (u + v <= 1.f) && (t > tMin) && (t <= maxRayLength);
  if (ok && t < tT) {
    tT = t;
    const float cnx = e1y * e2z - e1z * e2y;
    const float cny = e1z * e2x - e1x * e2z;
    const float cnz = e1x * e2y - e1y * e2x;
    const float inv = __ldg(r + 10)
                      * rsqrtf(cnx * cnx + cny * cny + cnz * cnz + 1e-30f);
    nxT = cnx * inv; nyT = cny * inv; nzT = cnz * inv;
    elT = (int)__ldg(r + 9);
  }
}

// The slab test of box b of a pack (lo xyz, 0, hi xyz, 0: two 16-byte
// loads) against the ray's segment [0, cap] (the JAX package's
// `_slabSurvives`; iv: the sign-preserving inverse direction, |d| clamped
// at 1e-30), voted by the warp's live lanes.
__device__ __forceinline__ bool anyLaneEnters(
    const float* __restrict__ b, unsigned lanes, float ox, float oy,
    float oz, float ivx, float ivy, float ivz, float cap) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(b + 4));
  const float tx1 = (lo.x - ox) * ivx, tx2 = (hi.x - ox) * ivx;
  const float ty1 = (lo.y - oy) * ivy, ty2 = (hi.y - oy) * ivy;
  const float tz1 = (lo.z - oz) * ivz, tz2 = (hi.z - oz) * ivz;
  const float tN = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)),
                         fmaxf(fminf(tz1, tz2), 0.f));
  const float tF = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)),
                         fminf(fmaxf(tz1, tz2), cap));
  return __any_sync(lanes, tN <= tF);
}

// The nearest triangle of the table along the ray (tT = kBig, elT = -1
// where none), a table of one chunk or less (no boxes) swept flat, else in
// three levels, in one loop over the leaves in ascending order: at a
// group's first leaf its group box, at a chunk's first leaf its chunk box,
// then the leaf's box, each voted on by the warp's live lanes with the slab
// test (the JAX package's `_slabSurvives`: sign-preserving inverse
// direction, |d| clamped at 1e-30); a box no lane enters skips the rest of
// its group, chunk or leaf, and the live lanes sweep a leaf's rows together
// when its box lets any of them in. A lane tests a box against its segment
// capped at min(tCap, its nearest triangle so far + window): a row past
// that cannot replace the nearest triangle, the table's one result, so no
// result moves (rows keep their order and the strict `<`).
__device__ void sweepTriangles(const TriTable& tt, float ox, float oy,
                               float oz, float dx, float dy, float dz,
                               float tMin, float maxRayLength, float tCap,
                               float window, float& tT, float& nxT,
                               float& nyT, float& nzT, int& elT) {
  tT = kBig;
  if (tt.nChunks == 0) {
    for (int k = 0; k < tt.n; ++k)
      triangleTest(tt.tri + k * kTriCols, ox, oy, oz, dx, dy, dz, tMin,
                   maxRayLength, tT, nxT, nyT, nzT, elT);
    return;
  }
  const float ivx = (dx < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dx), 1e-30f);
  const float ivy = (dy < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dy), 1e-30f);
  const float ivz = (dz < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dz), 1e-30f);
  // the lanes of the warp still in the bounce loop (the others broke out)
  const unsigned lanes = __activemask();
  const float* groups = tt.box;
  const float* chunks = groups + tt.nGroups * kBoxStride;
  const float* leaves = chunks + tt.nChunks * kBoxStride;
  constexpr int kGroupLeaves = kGroupChunks * kTriChunkLeaves;
  const int nLeaves = triLeaves(tt.n, tt.nChunks);
  for (int l = 0; l < nLeaves; ++l) {
    if (l % kGroupLeaves == 0
        && !anyLaneEnters(groups + (l / kGroupLeaves) * kBoxStride, lanes, ox,
                          oy, oz, ivx, ivy, ivz, fminf(tCap, tT + window))) {
      l += kGroupLeaves - 1;
      continue;
    }
    if (l % kTriChunkLeaves == 0
        && !anyLaneEnters(chunks + (l / kTriChunkLeaves) * kBoxStride, lanes,
                          ox, oy, oz, ivx, ivy, ivz,
                          fminf(tCap, tT + window))) {
      l += kTriChunkLeaves - 1;
      continue;
    }
    if (!anyLaneEnters(leaves + l * kBoxStride, lanes, ox, oy, oz, ivx, ivy,
                       ivz, fminf(tCap, tT + window)))
      continue;
    const int base = l * kTriLeaf;
    const int nIn = min(kTriLeaf, tt.n - base);
    for (int k = 0; k < nIn; ++k)
      triangleTest(tt.tri + (base + k) * kTriCols, ox, oy, oz, dx, dy, dz,
                   tMin, maxRayLength, tT, nxT, nyT, nzT, elT);
  }
}

// ---- B8 (STAB only): the surface table ----
// its runs, as the launcher passes them (ops/cuda_trace.py `surfaceRuns`):
// plain runs first, then chunked runs; rows [first, last) of a plain run,
// chunks [first, last) of a chunked run, whose chunk c covers the kSurfChunk
// rows from rowStart + (c - first) * kSurfChunk and whose groups of
// kGroupChunks chunks are the group boxes from group0 on
struct SurfTable {
  int n, nChunks, nGroups, nRuns;
  int run[kMaxSurfRuns][kRunCols];
};

// the running winner of the surface table: distance, oriented world normal,
// local (x, y) chart, element (-1: none)
struct TableHit {
  float t, nx, ny, nz, lx, ly;
  int el;
};

// Surface-table row r (kind KIND; `window`: trim flag 1, else 0) against
// the ray, in the JAX package's operation order (`_surfBody`: the ray into
// the row's frame, `_intersectConst(localCoords=...)`, `_normalConst`, the
// normal out through the transposed rotation times orient): a row's values
// are float32, so the squares of its radius and annulus radii are formed in
// float32 here, where the surface rows carry them formed in double. A hit
// strictly nearer than the running winner and within mrlEff replaces it.
template <int KIND>
__device__ __forceinline__ void tableRow(
    const float* __restrict__ r, bool window, float ox, float oy, float oz,
    float dx, float dy, float dz, float tMin, float mrlEff, TableHit& w) {
  const float r00 = __ldg(r), r01 = __ldg(r + 1), r02 = __ldg(r + 2);
  const float r10 = __ldg(r + 3), r11 = __ldg(r + 4), r12 = __ldg(r + 5);
  const float r20 = __ldg(r + 6), r21 = __ldg(r + 7), r22 = __ldg(r + 8);
  const float lox = r00 * ox + r01 * oy + r02 * oz + __ldg(r + 9);
  const float loy = r10 * ox + r11 * oy + r12 * oz + __ldg(r + 10);
  const float loz = r20 * ox + r21 * oy + r22 * oz + __ldg(r + 11);
  const float ldx = r00 * dx + r01 * dy + r02 * dz;
  const float ldy = r10 * dx + r11 * dy + r12 * dz;
  const float ldz = r20 * dx + r21 * dy + r22 * dz;
  const float tA = __ldg(r + 19), tB = __ldg(r + 20);
  float t;
  if constexpr (KIND == KIND_PLANE) {
    const float dzS = fabsf(ldz) < 1e-12f ? 1e-12f : ldz;
    t = -loz / dzS;
    const float x = lox + t * ldx, y = loy + t * ldy;
    bool ok;
    if (window) {
      ok = (fabsf(x) <= tA) && (fabsf(y) <= tB);
    } else {
      const float r2 = x * x + y * y;
      ok = (r2 >= tA * tA) && (r2 <= tB * tB);
    }
    if (!((t > tMin) && ok)) t = kBig;
  } else {
    const float p0 = __ldg(r + 14), p1 = __ldg(r + 15);
    float a, b, c, w0 = 0.f, wd = 0.f;
    if constexpr (KIND == KIND_SPHERE) {
      a = ldx * ldx + ldy * ldy + ldz * ldz;
      b = 2.f * (lox * ldx + loy * ldy + loz * ldz);
      c = lox * lox + loy * loy + loz * loz - p0 * p0;
    } else if constexpr (KIND == KIND_CYLINDER) {
      a = ldx * ldx + ldy * ldy;
      b = 2.f * (lox * ldx + loy * ldy);
      c = lox * lox + loy * loy - p0 * p0;
    } else if constexpr (KIND == KIND_CONE) {
      w0 = p0 + loz * p1;
      wd = ldz * p1;
      a = ldx * ldx + ldy * ldy - wd * wd;
      b = 2.f * (lox * ldx + loy * ldy - w0 * wd);
      c = lox * lox + loy * loy - w0 * w0;
    } else {                       // principal-axis quadric
      const float p2 = __ldg(r + 16), p3 = __ldg(r + 17), p4 = __ldg(r + 18);
      a = p0 * ldx * ldx + p1 * ldy * ldy + p2 * ldz * ldz;
      b = 2.f * (p0 * lox * ldx + p1 * loy * ldy + p2 * loz * ldz) + p3 * ldz;
      c = p0 * lox * lox + p1 * loy * loy + p2 * loz * loz + p3 * loz + p4;
    }
    const float disc = b * b - 4.f * a * c;
    bool okD = disc >= 0.f;
    const float sqD = sqrtf(fmaxf(disc, 0.f));
    const float q = -0.5f * (b + signf(b + 1e-30f) * sqD);
    const float aS = fabsf(a) < 1e-20f ? 1e-20f : a;
    const float qS = fabsf(q) < 1e-20f ? 1e-20f : q;
    float t1 = q / aS, t2 = c / qS;
    if constexpr (KIND == KIND_QUADRIC) {  // the linear case: root -c / b
      const float linT = -c / (fabsf(b) < 1e-20f ? 1e-20f : b);
      const bool isLin = (fabsf(a) < 1e-14f * (fabsf(b) + 1e-20f))
                         && (fabsf(b) > 1e-20f);
      if (isLin) { t1 = linT; t2 = kBig; okD = true; }
    }
    const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
    t = kBig;
    for (int k = 0; k < 2; ++k) {
      const float tk = k == 0 ? lo : hi;
      const float z = loz + tk * ldz;
      bool ok = okD && (tk > tMin) && (z >= tA) && (z <= tB);
      if constexpr (KIND == KIND_CONE) ok = ok && (w0 + tk * wd >= 0.f);
      t = fminf(t, ok ? tk : kBig);
    }
  }
  if (!(t < w.t && t <= mrlEff)) return;
  w.t = t;
  const float lx = lox + t * ldx, ly = loy + t * ldy, lz = loz + t * ldz;
  float nlx = 0.f, nly = 0.f, nlz = 1.f;
  if constexpr (KIND == KIND_SPHERE) {
    const float inv = rsqrtf(lx * lx + ly * ly + lz * lz + 1e-20f);
    nlx = lx * inv; nly = ly * inv; nlz = lz * inv;
  } else if constexpr (KIND == KIND_CYLINDER) {
    const float inv = rsqrtf(lx * lx + ly * ly + 1e-20f);
    nlx = lx * inv; nly = ly * inv; nlz = 0.f;
  } else if constexpr (KIND == KIND_QUADRIC) {
    const float n0 = 2.f * __ldg(r + 14) * lx, n1 = 2.f * __ldg(r + 15) * ly;
    const float n2 = 2.f * __ldg(r + 16) * lz + __ldg(r + 17);
    const float inv = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
    nlx = n0 * inv; nly = n1 * inv; nlz = n2 * inv;
  } else if constexpr (KIND == KIND_CONE) {
    float rr = sqrtf(lx * lx + ly * ly);
    if (rr < 1e-12f) rr = 1e-12f;
    const float n0 = lx / rr, n1 = ly / rr, n2 = -__ldg(r + 15);
    const float inv = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
    nlx = n0 * inv; nly = n1 * inv; nlz = n2 * inv;
  }
  const float orient = __ldg(r + 12);
  w.nx = (r00 * nlx + r10 * nly + r20 * nlz) * orient;
  w.ny = (r01 * nlx + r11 * nly + r21 * nlz) * orient;
  w.nz = (r02 * nlx + r12 * nly + r22 * nlz) * orient;
  w.lx = lx;
  w.ly = ly;
  w.el = (int)__ldg(r + 13);
}

// One run of the surface table: a plain run row by row; a chunked run in
// three levels, in one loop over its leaves: at a group's first leaf its
// group box, at a chunk's first leaf its chunk box, then the leaf's box,
// each voted on by the live lanes, a box no lane enters skipping the rest of
// its group, chunk or leaf, and a leaf's rows swept by the live lanes
// together when its box lets any of them in; a lane's segment capped at
// min(tCap, the table's winner so far + window), as in `sweepTriangles`.
// Leaf l of the table covers the kSurfLeaf rows from rowStart + (l - first
// * kSurfChunkLeaves) * kSurfLeaf of the run whose chunks hold it.
template <int KIND>
__device__ void sweepRun(const int* run, const float* __restrict__ rows,
                         const float* __restrict__ groups,
                         const float* __restrict__ chunks,
                         const float* __restrict__ leaves, unsigned lanes,
                         float ox, float oy, float oz, float dx, float dy,
                         float dz, float ivx, float ivy, float ivz,
                         float tMin, float mrlEff, float tCap, float window,
                         TableHit& w) {
  const bool window1 = run[RUN_TRIM0] != 0;
  if (!run[RUN_CHUNKED]) {
    for (int k = run[RUN_FIRST]; k < run[RUN_LAST]; ++k)
      tableRow<KIND>(rows + k * kSurfTableCols, window1, ox, oy, oz, dx, dy,
                     dz, tMin, mrlEff, w);
    return;
  }
  // one loop over the run's leaves (two nested loops held more registers:
  // 236 bytes of spills in K1's instance, PERF.md §6)
  constexpr int kGroupLeaves = kGroupChunks * kSurfChunkLeaves;
  const int first = run[RUN_FIRST] * kSurfChunkLeaves;
  const int last = run[RUN_LAST] * kSurfChunkLeaves;
  const float* g = groups + run[RUN_GROUP0] * kBoxStride;
  const float* base = rows + run[RUN_ROW0] * kSurfTableCols;
  for (int l = first; l < last; ++l) {
    if ((l - first) % kGroupLeaves == 0) {
      const bool in = anyLaneEnters(g, lanes, ox, oy, oz, ivx, ivy, ivz,
                                    fminf(tCap, w.t + window));
      g += kBoxStride;
      if (!in) {
        l += kGroupLeaves - 1;
        continue;
      }
    }
    if (l % kSurfChunkLeaves == 0
        && !anyLaneEnters(chunks + (l / kSurfChunkLeaves) * kBoxStride, lanes,
                          ox, oy, oz, ivx, ivy, ivz,
                          fminf(tCap, w.t + window))) {
      l += kSurfChunkLeaves - 1;
      continue;
    }
    if (!anyLaneEnters(leaves + l * kBoxStride, lanes, ox, oy, oz, ivx, ivy,
                       ivz, fminf(tCap, w.t + window)))
      continue;
    const float* r = base + (l - first) * kSurfLeaf * kSurfTableCols;
    for (int k = 0; k < kSurfLeaf; ++k)
      tableRow<KIND>(r + k * kSurfTableCols, window1, ox, oy, oz, dx, dy, dz,
                     tMin, mrlEff, w);
  }
}

// The surface table's winner along the ray (w.t = kBig, w.el = -1 where
// none), the JAX package's sweep: the plain runs, then the chunked runs,
// whose boxes are tested against the segment capped at min(tBest, the plain
// runs' winner, mrlEff) + window, and below that at the table's winner so
// far + window (the cull only skips rows that could not win the bounce, so
// any culling grain gives the same result). The kind is a switch per run,
// outside its row loop. Inside the table the strict `<` keeps the first row
// swept on a tie.
// `box`: the table's box pack (its group boxes, then its chunk boxes, then
// kSurfChunkLeaves leaf boxes a chunk).
__device__ void sweepSurfaceTable(const SurfTable& st,
                                  const float* __restrict__ rows,
                                  const float* __restrict__ box, float ox,
                                  float oy, float oz, float dx, float dy,
                                  float dz, float tMin, float mrlEff,
                                  float tBest, float window, TableHit& w) {
  const float* groups = box;
  const float* chunks = box + st.nGroups * kBoxStride;
  const float* leaves = chunks + st.nChunks * kBoxStride;
  w.t = kBig;
  w.el = -1;
  w.nx = w.ny = w.nz = w.lx = w.ly = 0.f;
  // the lanes of the warp still in the bounce loop (the others broke out)
  const unsigned lanes = __activemask();
  const float ivx = (dx < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dx), 1e-30f);
  const float ivy = (dy < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dy), 1e-30f);
  const float ivz = (dz < 0.f ? -1.f : 1.f) / fmaxf(fabsf(dz), 1e-30f);
  float tCap = 0.f;
  bool capped = false;             // the plain runs come first
  for (int k = 0; k < st.nRuns; ++k) {
    const int* run = st.run[k];
    if (run[RUN_CHUNKED] && !capped) {
      tCap = fminf(fminf(tBest, w.t), mrlEff) + window;
      capped = true;
    }
    switch (run[RUN_KIND]) {
      case KIND_PLANE:
        sweepRun<KIND_PLANE>(run, rows, groups, chunks, leaves, lanes, ox, oy,
                             oz, dx, dy, dz, ivx, ivy, ivz, tMin, mrlEff,
                             tCap, window, w);
        break;
      case KIND_SPHERE:
        sweepRun<KIND_SPHERE>(run, rows, groups, chunks, leaves, lanes, ox,
                              oy, oz, dx, dy, dz, ivx, ivy, ivz, tMin,
                              mrlEff, tCap, window, w);
        break;
      case KIND_CYLINDER:
        sweepRun<KIND_CYLINDER>(run, rows, groups, chunks, leaves, lanes, ox,
                                oy, oz, dx, dy, dz, ivx, ivy, ivz, tMin,
                                mrlEff, tCap, window, w);
        break;
      case KIND_CONE:
        sweepRun<KIND_CONE>(run, rows, groups, chunks, leaves, lanes, ox, oy,
                            oz, dx, dy, dz, ivx, ivy, ivz, tMin, mrlEff,
                            tCap, window, w);
        break;
      default:
        sweepRun<KIND_QUADRIC>(run, rows, groups, chunks, leaves, lanes, ox,
                               oy, oz, dx, dy, dz, ivx, ivy, ivz, tMin,
                               mrlEff, tCap, window, w);
    }
  }
}

// B12: whether surface row s is in the set that bounce `bounce` sweeps:
// the cull block at cullOff holds the bounce count B, then per bounce the
// offset of its set's words (-1: every row), each set ceil(nSurf / 32)
// uint32 words, bit s for row s (int32 / uint32 bit-cast into the table).
// A test in the row loop rather than a loop over the set's rows: the
// per-bounce list and count held in registers took the instances without
// B4 from 40 to 46-48 registers (PERF.md §6); this test holds nothing.
__device__ __forceinline__ bool inBounceSet(const float* smem, int cullOff,
                                            int bounce, int s) {
  const float* c = smem + cullOff;
  if (bounce >= __float_as_int(c[0])) return true;
  const int off = __float_as_int(c[1 + bounce]);
  if (off < 0) return true;
  const float* w = smem + off;
  return ((__float_as_uint(w[s >> 5]) >> (s & 31)) & 1u) != 0u;
}

// whether a ray at stage `stage` may hit surface row r (a stage gate)
__device__ __forceinline__ bool stageAllowed(const float* smem,
                                             const float* r, int stage) {
  const uint32_t w = __float_as_uint(smem[(int)r[S_STAGES] + (stage >> 5)]);
  return (w >> (stage & 31)) & 1u;
}

// The canonical local normal of the kinds of B2 at local point l (GEOM), in
// the reference's operation order (`_normalFromCols`: its param columns are
// float32, so (1 + k) c^2 is formed in float32 here).
__device__ void geomNormal(const float* r, int kind, float lx, float ly,
                           float lz, float& nlx, float& nly, float& nlz) {
  const float* P = r + G_P;
  if (kind == KIND_TRIANGLE) {
    nlx = r[G_X + 6]; nly = r[G_X + 7]; nlz = r[G_X + 8];
  } else if (kind == KIND_QUADRIC) {
    const float n0 = 2.f * P[0] * lx, n1 = 2.f * P[1] * ly;
    const float n2 = 2.f * P[2] * lz + P[3];
    const float inv = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
    nlx = n0 * inv; nly = n1 * inv; nlz = n2 * inv;
  } else if (kind == KIND_CONE) {
    float rr = sqrtf(lx * lx + ly * ly);
    if (rr < 1e-12f) rr = 1e-12f;
    const float n0 = lx / rr, n1 = ly / rr, n2 = -P[1];
    const float inv = rsqrtf(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20f);
    nlx = n0 * inv; nly = n1 * inv; nlz = n2 * inv;
  } else if (kind == KIND_ASPHERE) {
    const float c0 = P[0], kk = P[1], a4 = P[2], a6 = P[3], a8 = P[4];
    const float r2 = lx * lx + ly * ly;
    const float K1 = (1.f + kk) * c0 * c0;
    const float rootA = sqrtf(fmaxf(1.f - K1 * r2, 1e-12f));
    const float opr = 1.f + rootA;
    const float g = c0 * (2.f / opr + K1 * r2 / (rootA * (opr * opr)))
                    + 4.f * a4 * r2 + 6.f * a6 * r2 * r2
                    + 8.f * a8 * (r2 * (r2 * r2));
    const float inv = rsqrtf(g * g * r2 + 1.f + 1e-20f);
    nlx = -g * lx * inv; nly = -g * ly * inv; nlz = inv;
  } else if (kind == KIND_TORUS) {
    float sxy = sqrtf(lx * lx + ly * ly);
    if (sxy < 1e-12f) sxy = 1e-12f;
    const float scale = P[0] / sxy;
    const float n0 = lx * (1.f - scale), n1 = ly * (1.f - scale);
    const float inv = rsqrtf(n0 * n0 + n1 * n1 + lz * lz + 1e-20f);
    nlx = n0 * inv; nly = n1 * inv; nlz = lz * inv;
  }
}

// OUT_HIST's flush of a ray's last ring slot (bin b, power w), after the
// bounce loop: the lanes that flush together (__activemask) group by bin
// (__match_any_sync), and one lane of each group adds the group's summed
// power and its lane count to the output. Only the order of the float
// additions differs from one atomic pair a lane.
__device__ __forceinline__ void addGrouped(float* out0, float* out1,
                                           const int b, const float w) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes = __activemask();
  const unsigned peers = __match_any_sync(lanes, b);
  // the group's power: each lane pulls its group's members' powers one by
  // one, as many rounds as the largest group has members (1: no group)
  const int rounds = (int)__reduce_max_sync(lanes, (unsigned)__popc(peers));
  float sum = w;
  if (rounds > 1) {
    sum = 0.f;
    unsigned m = peers;
    for (int k = 0; k < rounds; ++k) {
      const float v = __shfl_sync(lanes, w, m ? __ffs(m) - 1 : lane);
      if (m) {
        sum += v;
        m &= m - 1;
      }
    }
  }
  if (lane != __ffs(peers) - 1) return;
  atomicAdd(out0 + b, sum);
  atomicAdd(out1 + b, (float)__popc(peers));
}

// The point sampler's two uniforms of ray i: read (uniform mode) or drawn
// by Philox (counter = ray index, key = seed), then stratified by the ray's
// cell where the launch has strata (a property of the ray index). `narrow`:
// the ray index and the cell fit 32 bits, and the cell comes from 32-bit
// divisions (the same integers, so the same floats).
__device__ __forceinline__ void pointUniforms(const TraceParams& p,
                                              const float* rayIn,
                                              long long i, bool narrow,
                                              float& u1, float& u2) {
  if (p.mode == MODE_UNIFORMS) {
    u1 = rayIn[i];
    u2 = rayIn[p.N + i];
  } else {
    uint32_t rnd[4];
    philox4x32((uint32_t)i, (uint32_t)((unsigned long long)i >> 32), 0u,
               0u, (uint32_t)p.seed, (uint32_t)(p.seed >> 32), rnd);
    u1 = bitsToUniform(rnd[0]);
    u2 = bitsToUniform(rnd[1]);
  }
  if (p.G1 > 0) {
    float i1, i2;
    if (narrow) {
      const unsigned cell = (unsigned)i / (unsigned)p.strataTile;
      i1 = (float)(cell / (unsigned)p.G2);
      i2 = (float)(cell % (unsigned)p.G2);
    } else {
      const long long cell = i / p.strataTile;
      i1 = (float)(cell / p.G2);
      i2 = (float)(cell % p.G2);
    }
    u1 = (i1 + u1) * p.invG1;
    u2 = (i2 + u2) * p.invG2;
  }
}

// The point sampler's ray in the source's own frame from its two uniforms
// and sampler block `sg`: the two marginals, then the focal geometry.
__device__ __forceinline__ void pointLocal(const float* sg, float u1,
                                           float u2, float& lox, float& loy,
                                           float& loz, float& ldx, float& ldy,
                                           float& ldz) {
  float t = marginal(sg + kSamplerGeom, u1);
  float ph = marginal(sg + kSamplerGeom + kMargLen, u2);
  float sp = sinf(ph), cp = cosf(ph);
  if (sg[0] != 0.f) {          // finite focal length
    float f = sg[1];
    float st = sinf(t), ct = cosf(t);
    ldx = st * sp; ldy = -st * cp; ldz = ct;
    lox = -f * ldx; loy = -f * ldy; loz = f * (1.f - ldz);
  } else {                     // collimated: t is the radius
    ldx = 0.f; ldy = 0.f; ldz = 1.f;
    lox = t * cp; loy = -t * sp; loz = 0.f;
  }
}

// SWEEP: the ray index (blockIdx.x * kBlock + threadIdx.x) and the block's
// row of groups (blockIdx.y) read anew from the special registers where the
// variant loop needs them: a volatile read is neither hoisted nor kept, so
// no register holds them across the bounce loop.
__device__ __forceinline__ long long freshRayIndex() {
  unsigned b, t;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return (long long)b * kBlock + t;
}

__device__ __forceinline__ long long freshFirstVariant(const TraceParams& p) {
  unsigned g;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(g));
  return (long long)g * p.groupSize;
}

// The sweep instances' blocks an SM, which their sources
// (trace_sweep_kernel*.cu, which define ODW_SWEEP_SOURCE) ask of ptxas as a
// launch bound: one variant a block keeps the occupancy of the
// variant-major kernel it replaces (PERF.md §6: without the bound the
// scatter instance went from 64 to 79 registers, 3 blocks an SM, and the
// diffuser's heights ran 9 % slower), the GROUPED instances that of their
// registers (48 and 62).
constexpr int sweepMinBlocks(bool B4, bool SCAT, bool GEOM, bool TRI,
                             bool STAB, bool GROUPED) {
  return !B4 ? (GROUPED ? 5 : 6) : !(SCAT || GEOM || TRI) ? 4
         : !TRI || !(SCAT || GEOM || STAB) ? 4 : 3;
}
#ifdef ODW_SWEEP_SOURCE
#define ODW_KERNEL_BOUNDS                                             \
  __launch_bounds__(kBlock,                                           \
                    sweepMinBlocks(B4, SCAT, GEOM, TRI, STAB, GROUPED))
#else
#define ODW_KERNEL_BOUNDS __launch_bounds__(kBlock)
#endif

// OUT_HIST: out0 / out1 are the power / count histograms. OUT_BINS and
// OUT_RAW: out0 is the (rows, hitSlots, N) ring, out1 is unused. SWEEP:
// `table` holds V tables of p.tableLen floats, out0 / out1 V histograms of
// p.histLen floats, `counters` V triples; p.N is the rays PER VARIANT and
// `rayIn` (shared by all variants) has p.N columns; blockIdx.x is the ray
// tile, blockIdx.y the variant or, in the GROUPED instances, the group of
// p.groupSize > 1 variants (the last group may be shorter) that share the
// draw.
template <int OUT, bool SWEEP, bool B4, bool SURF, bool SCAT,
          bool GEOM = false, bool TRI = false, bool STAB = false,
          bool GROUPED = false>
__global__ void ODW_KERNEL_BOUNDS
traceKernel(TraceParams p, const float* __restrict__ table, TriTable tt,
            const SurfTable stab, const float* __restrict__ surfRows,
            const float* __restrict__ surfBox,
            const float* __restrict__ rayIn, float* __restrict__ out0,
            float* __restrict__ out1,
            unsigned long long* __restrict__ counters) {
  static_assert(!SWEEP || OUT == OUT_HIST, "the sweep bins in the kernel");
  static_assert(!(SWEEP && SURF), "the sweep samples point sources only");
  static_assert(!SCAT || B4, "scatter is built on the B4 body");
  static_assert(!GEOM || B4, "the other kinds and trims are built on B4");
  static_assert(!TRI || B4, "the triangle table is built on B4");
  static_assert(!STAB || TRI, "the surface table is built on TRI");
  static_assert(!GROUPED || (SWEEP && !SCAT && !GEOM && !TRI),
                "groups of variants in the plain and B4 sweeps only");
  // a GEOM table widens every surface row by kGeomCols
  constexpr int kRow = GEOM ? kSurfCols + kGeomCols : kSurfCols;
  // SWEEP: the instances that trace a group of more than one variant a
  // block; the other sweep instances trace one variant a block, whose
  // variant loop is one pass
  constexpr bool kGroups = GROUPED;
  const long long firstRay = (long long)blockIdx.x * blockDim.x;
  // SWEEP: the block's variants, variant0 .. variant0 + nVar - 1, whose
  // tables lie one after the other in `table` and are copied together
  int nVar = 1;
  long long variant0 = 0;
  if constexpr (kGroups) {
    variant0 = (long long)blockIdx.y * p.groupSize;
    table += variant0 * p.tableLen;
    nVar = min(p.groupSize, p.nVariants - (int)variant0);
  } else if constexpr (SWEEP) {
    // one variant a block: its table, tables in device memory, histograms
    // and counters once, as the single-scene kernel reads them
    variant0 = blockIdx.y;
    table += variant0 * p.tableLen;
    if constexpr (TRI) {
      tt.tri += variant0 * tt.n * kTriCols;
      tt.box += variant0 * (tt.nGroups + tt.nChunks
                            + triLeaves(tt.n, tt.nChunks)) * kBoxStride;
    }
    if constexpr (STAB) {
      surfRows += variant0 * stab.n * kSurfTableCols;
      surfBox += variant0 * (stab.nGroups
                             + (1 + kSurfChunkLeaves) * stab.nChunks)
                 * kBoxStride;
    }
    out0 += variant0 * p.histLen;
    out1 += variant0 * p.histLen;
    counters += variant0 * 3;
  }
  extern __shared__ float smem[];
  for (int k = threadIdx.x; k < nVar * p.tableLen; k += blockDim.x)
    smem[k] = table[k];
  __syncthreads();

  const long long i = firstRay + threadIdx.x;
  // GROUPED: after the tables, the variants' per-warp totals (3 per
  // variant and warp), then a slot of kSlotFloats floats per thread
  // (column-major, one column a thread) that holds ray i in the source's
  // frame, the draw every variant of the group shares (`sharedDraws`: the
  // same marginals and focal words; the launcher takes seed and uniform
  // inputs only). It is filled once per ray and read once per variant.
  const int held = kGroups ? min(p.groupSize, p.nVariants) : 1;
  int* groupRed = reinterpret_cast<int*>(smem + held * p.tableLen);
  volatile float* const slots =
      smem + held * p.tableLen + held * 3 * (kBlock / 32);
  if (kGroups && i < p.N) {
    volatile float* slot = slots + threadIdx.x;
    float u1, u2, lo[3], ld[3];
    pointUniforms(p, rayIn, i,
                  p.N <= 0xffffffffLL && p.strataTile <= 0xffffffffLL, u1,
                  u2);
    pointLocal(smem + p.samplerOff, u1, u2, lo[0], lo[1], lo[2], ld[0],
               ld[1], ld[2]);
    for (int k = 0; k < 3; ++k) {
      slot[k * kBlock] = lo[k];
      slot[(3 + k) * kBlock] = ld[k];
    }
  }

  // per-ray modes: distance between two rows of the ring
  const long long rowStride = (long long)p.hitSlots * p.N;
  int segs = 0, hitN = 0;
  // one pass for each of the block's variants (one pass without SWEEP)
  for (int var = 0; var < nVar; ++var) {
    const long long ray = kGroups ? freshRayIndex() : i;
    // this variant's table in shared memory and its histograms (the
    // grouped instances have no tables in device memory)
    const float* tab = smem;
    float* o0 = out0;
    float* o1 = out1;
    if constexpr (kGroups) {
      const long long variant = freshFirstVariant(p) + var;
      tab = smem + var * p.tableLen;
      o0 += variant * p.histLen;
      o1 += variant * p.histLen;
    }
    const float* surfT = tab;
    const float* elemT = tab + p.nSurf * kRow;
    segs = 0;
    hitN = 0;
    int lastBin = -1;              // OUT_HIST: the ring's last slot
    float lastW = 0.f;
    float* ring = o0 + ray;        // per-ray modes: this ray's column

    if (ray < p.N) {
      float ox, oy, oz, dx, dy, dz, pw, wl;
      if (!kGroups && p.mode == MODE_COLUMNS) {
        ox = rayIn[ray];             oy = rayIn[p.N + ray];
        oz = rayIn[2 * p.N + ray];   dx = rayIn[3 * p.N + ray];
        dy = rayIn[4 * p.N + ray];   dz = rayIn[5 * p.N + ray];
        pw = rayIn[6 * p.N + ray];   wl = rayIn[7 * p.N + ray];
      } else if constexpr (SURF) {
        // ---- in-kernel surface-source sampler: five uniforms per ray; in
        // seed mode the second Philox call takes counter word 2 = 1 ----
        float uF, u, v, uT, uP;
        if (p.mode == MODE_UNIFORMS) {
          uF = rayIn[ray];            u = rayIn[p.N + ray];
          v = rayIn[2 * p.N + ray];   uT = rayIn[3 * p.N + ray];
          uP = rayIn[4 * p.N + ray];
        } else {
          const uint32_t lo = (uint32_t)ray;
          const uint32_t hi = (uint32_t)((unsigned long long)ray >> 32);
          const uint32_t k0 = (uint32_t)p.seed;
          const uint32_t k1 = (uint32_t)(p.seed >> 32);
          uint32_t rnd[4];
          philox4x32(lo, hi, 0u, 0u, k0, k1, rnd);
          uF = bitsToUniform(rnd[0]);
          u = bitsToUniform(rnd[1]);
          v = bitsToUniform(rnd[2]);
          uT = bitsToUniform(rnd[3]);
          philox4x32(lo, hi, 1u, 0u, k0, k1, rnd);
          uP = bitsToUniform(rnd[0]);
        }
        const float* sg = tab + p.samplerOff;
        sampleSurface<GEOM>(sg, uF, u, v, uT, uP, ox, oy, oz, dx, dy, dz);
        pw = 1.f;
        wl = sg[14];
      } else {
        // ---- in-kernel point-source sampler: the ray in the source's
        // frame (drawn, or the group's shared draw), then this variant's
        // placement ----
        const float* sg = tab + p.samplerOff;
        float lox, loy, loz, ldx, ldy, ldz;
        if (kGroups) {
          volatile float* slot = slots + (ray & (kBlock - 1));
          lox = slot[0];            loy = slot[kBlock];
          loz = slot[2 * kBlock];   ldx = slot[3 * kBlock];
          ldy = slot[4 * kBlock];   ldz = slot[5 * kBlock];
        } else {
          float u1, u2;
          pointUniforms(p, rayIn, ray, false, u1, u2);
          pointLocal(sg, u1, u2, lox, loy, loz, ldx, ldy, ldz);
        }
        const float* R = sg + 2;
        ox = R[0] * lox + R[1] * loy + R[2] * loz + sg[11];
        oy = R[3] * lox + R[4] * loy + R[5] * loz + sg[12];
        oz = R[6] * lox + R[7] * loy + R[8] * loz + sg[13];
        dx = R[0] * ldx + R[1] * ldy + R[2] * ldz;
        dy = R[3] * ldx + R[4] * ldy + R[5] * ldz;
        dz = R[6] * ldx + R[7] * ldy + R[8] * ldz;
        pw = 1.f;
        wl = sg[14];
      }
      int medium = -1;               // element id of the medium, -1 = vacuum
      int seq = 0;                   // sequential mode: the ray's stage index
      for (int bounce = 0; bounce < p.maxIntersections; ++bounce) {
        // ---- nearest hit: online argmin (strict <: lowest index wins ties)
        // plus the nearest surface NOT of the current medium, over the
        // surfaces the ray's stage allows (a skipped surface is one whose
        // distance is kBig: it changes no other surface's index) ----
        float tBest = kBig, tOth = kBig;
        int sBest = -1, sOth = -1;
        const int stage = B4 ? min(seq, max(p.nStages, 1) - 1) : 0;
        for (int s = 0; s < p.nSurf; ++s) {
          const float* r = surfT + s * kRow;
          // B12: a row outside this bounce's set (the sweep never culls)
          if (!SWEEP && p.cullOff >= 0
              && !inBounceSet(tab, p.cullOff, bounce, s)) continue;
          if (B4 && p.gate && !stageAllowed(tab, r, stage)) continue;
          float t;
          if constexpr (GEOM)
            t = intersectGeom(r, tab, ox, oy, oz, dx, dy, dz, p.tMin);
          else
            t = intersect(r, ox, oy, oz, dx, dy, dz, p.tMin);
          if (t < tBest) { tBest = t; sBest = s; }
          if (p.anyMedium) {
            int e = (int)r[S_ELEM];
            float tO = (elemT[e * kElemCols + E_MEDIUM] != 0.f && medium == e)
                           ? kBig : t;
            if (tO < tOth) { tOth = tO; sOth = s; }
          }
        }
        // ---- B7: the triangle table after the surface rows (index -2) ----
        float nxT = 0.f, nyT = 0.f, nzT = 0.f;
        int elT = -1;
        TableHit sw;
        if constexpr (TRI) {
          if (!STAB || tt.n > 0) {
            float tT;
            sweepTriangles(tt, ox, oy, oz, dx, dy, dz, p.tMin, p.maxRayLength,
                           fminf(tBest, p.mrlEff) + p.window, p.window, tT,
                           nxT, nyT, nzT, elT);
            if (tT < tBest) { tBest = tT; sBest = -2; }
            if (p.anyMedium) {
              const float tO = medium != elT ? tT : kBig;
              if (tO < tOth) { tOth = tO; sOth = -2; }
            }
          }
        }
        // ---- B8: the surface table after that (index -3); its winner
        // enters the other-medium tracker as that one winner ----
        if constexpr (STAB) {
          if (stab.nRuns > 0) {
            sweepSurfaceTable(stab, surfRows, surfBox, ox, oy, oz, dx, dy, dz,
                              p.tMin, p.mrlEff, tBest, p.window, sw);
            if (sw.t < tBest) { tBest = sw.t; sBest = -3; }
            if (p.anyMedium) {
              const float tO = medium != sw.el ? sw.t : kBig;
              if (tO < tOth) { tOth = tO; sOth = -3; }
            }
          }
        }
        bool hasHit = tBest <= p.mrlEff;
        if (!p.anyMedium) { tOth = tBest; sOth = sBest; }
        bool hasPref = (tOth <= p.mrlEff) && (tOth <= tBest + p.window);
        float tSel = hasPref ? tOth : tBest;
        int sIdx = hasPref ? sOth : sBest;
        float tSeg = hasHit ? tSel : p.maxRayLength;
        float px = ox + tSeg * dx, py = oy + tSeg * dy, pz = oz + tSeg * dz;
        ++segs;
        if (!hasHit) break;        // escaped: the segment counts, the ray ends

        // ---- winner attributes: local point, normal by kind, world normal
        // through the transposed rotation times orient; a table triangle's
        // tracked normal and element, the world (x, y) as its chart; a
        // surface-table winner's tracked normal, element and local chart ----
        float lx, ly, nxA, nyA, nzA;
        int elem;
        if (TRI && sIdx == -2) {
          lx = px; ly = py;
          nxA = nxT; nyA = nyT; nzA = nzT;
          elem = elT;
        } else if (STAB && sIdx == -3) {
          lx = sw.lx; ly = sw.ly;
          nxA = sw.nx; nyA = sw.ny; nzA = sw.nz;
          elem = sw.el;
        } else {
          const float* r = surfT + sIdx * kRow;
          const float* R = r + S_ROT;
          lx = R[0] * px + R[1] * py + R[2] * pz + r[S_OFF];
          ly = R[3] * px + R[4] * py + R[5] * pz + r[S_OFF + 1];
          float lz = R[6] * px + R[7] * py + R[8] * pz + r[S_OFF + 2];
          int kind = (int)r[S_KIND];
          float nlx = 0.f, nly = 0.f, nlz = 1.f;
          if (kind == KIND_SPHERE) {
            float inv = rsqrtf(lx * lx + ly * ly + lz * lz + 1e-20f);
            nlx = lx * inv; nly = ly * inv; nlz = lz * inv;
          } else if (kind == KIND_CYLINDER) {
            float inv = rsqrtf(lx * lx + ly * ly + 1e-20f);
            nlx = lx * inv; nly = ly * inv; nlz = 0.f;
          } else if constexpr (GEOM) {
            geomNormal(r, kind, lx, ly, lz, nlx, nly, nlz);
          }
          float orient = r[S_ORIENT];
          nxA = (R[0] * nlx + R[3] * nly + R[6] * nlz) * orient;
          nyA = (R[1] * nlx + R[4] * nly + R[7] * nlz) * orient;
          nzA = (R[2] * nlx + R[5] * nly + R[8] * nlz) * orient;
          elem = (int)r[S_ELEM];
        }
        const float* er = elemT + elem * kElemCols;

        float cosA = dx * nxA + dy * nyA + dz * nzA;
        bool isEntering = cosA < 0.f;
        float sgn = isEntering ? -1.f : 1.f;
        float nx = nxA * sgn, ny = nyA * sgn, nz = nzA * sgn;

        float nElem = er[E_N];
        if (B4 && p.dispOff >= 0 && er[E_DISP] != 0.f)
          nElem = dispersionN(tab + p.dispOff + elem * kDispCols, wl);

        // ---- Beer-Lambert along the segment, before the interaction ----
        bool inMedium = medium >= 0;
        float nMed = 1.f, absLenMed = kBig;
        if (inMedium) {
          const float* mr = elemT + medium * kElemCols;
          nMed = mr[E_N];
          if (B4 && p.dispOff >= 0 && mr[E_DISP] != 0.f)
            nMed = dispersionN(tab + p.dispOff + medium * kDispCols, wl);
          absLenMed = mr[E_ABSLEN];
          float factor = absLenMed <= 0.f ? 0.f
                         : (absLenMed >= kBig ? 1.f : expf(-tSeg / absLenMed));
          pw = pw * factor;
        }

        // ---- interactions ----
        float dDotN = dx * nx + dy * ny + dz * nz;
        float mxD = dx - 2.f * nx * dDotN;
        float myD = dy - 2.f * ny * dDotN;
        float mzD = dz - 2.f * nz * dDotN;
        float n1 = inMedium ? nMed : 1.f;
        float n2 = isEntering ? nElem : 1.f;
        float mu = n1 / n2;
        float sin2 = fmaxf(1.f - dDotN * dDotN, 0.f);
        float root = 1.f - mu * mu * sin2;
        bool tir = root < 0.f;
        float sq = sqrtf(fmaxf(root, 0.f));
        float tx = dx - nx * dDotN, ty = dy - ny * dDotN, tz = dz - nz * dDotN;
        float snx = tir ? mxD : mu * tx + nx * sq;
        float sny = tir ? myD : mu * ty + ny * sq;
        float snz = tir ? mzD : mu * tz + nz * sq;

        int opt = (int)er[E_OPT];
        bool isMirror = opt == OPT_MIRROR, isLens = opt == OPT_LENS;
        bool isAbsorber = opt == OPT_ABSORBER;
        float ndx = isMirror ? mxD : (isLens ? snx : dx);
        float ndy = isMirror ? myD : (isLens ? sny : dy);
        float ndz = isMirror ? mzD : (isLens ? snz : dz);
        bool lensExit = isLens && !isEntering && !tir && (medium == elem);
        int newMedium = (isLens && isEntering) ? elem
                        : (lensExit ? -1 : medium);
        float newPw = isMirror ? pw * er[E_REFL] : (isAbsorber ? 0.f : pw);
        bool seqInc = isMirror || isAbsorber || opt == OPT_VACUUM || lensExit;

        if (B4 && p.hasGrating && opt == OPT_GRATING) {
          // ---- Ludwig-1970 line grating with the incidence-side normal: the
          // line direction (world frame) and the normal span the grating
          // frame; the diffracted direction solves a quadratic whose negative
          // discriminant is an evanescent order ----
          bool isReflG = er[E_GTYPE] == 0.f;
          float gn1 = isReflG ? n1 : 1.f;
          float gn2 = isReflG ? n1 : nElem;
          float gmu = gn1 / gn2;
          float gdx = er[E_GDIR], gdy = er[E_GDIR + 1], gdz = er[E_GDIR + 2];
          float nix = -nx, niy = -ny, niz = -nz;
          float pgx = gdy * niz - gdz * niy;
          float pgy = gdz * nix - gdx * niz;
          float pgz = gdx * niy - gdy * nix;
          float pinv = rsqrtf(pgx * pgx + pgy * pgy + pgz * pgz + 1e-20f);
          pgx *= pinv; pgy *= pinv; pgz *= pinv;
          float dgx = niy * pgz - niz * pgy;
          float dgy = niz * pgx - nix * pgz;
          float dgz = nix * pgy - niy * pgx;
          float dinv = rsqrtf(dgx * dgx + dgy * dgy + dgz * dgz + 1e-20f);
          dgx *= dinv; dgy *= dinv; dgz *= dinv;
          float lamUm = wl / 1000.f;
          float spacing = 1000.f / er[E_GLPM];
          float Tt = er[E_GORDER] * lamUm / (gn1 * spacing);
          float Vg = gmu * (dx * nix + dy * niy + dz * niz);
          float Wg = gmu * gmu - 1.f + Tt * Tt
                     - 2.f * gmu * Tt * (dx * dgx + dy * dgy + dz * dgz);
          float discG = Vg * Vg - Wg;
          float gsq = sqrtf(fmaxf(discG, 0.f));
          float qg = isReflG ? -Vg + gsq : -Vg - gsq;
          if (isEntering) {
            float ggx = gmu * dx - Tt * dgx + qg * nix;
            float ggy = gmu * dy - Tt * dgy + qg * niy;
            float ggz = gmu * dz - Tt * dgz + qg * niz;
            float ginv = rsqrtf(ggx * ggx + ggy * ggy + ggz * ggz + 1e-20f);
            ndx = ggx * ginv; ndy = ggy * ginv; ndz = ggz * ginv;
            if (discG < 0.f) newPw = 0.f;        // evanescent order
          } else if (!isReflG) {
            // a transmissive grating exiting its substrate refracts like a
            // lens; a reflective one passes non-entering rays through
            ndx = snx; ndy = sny; ndz = snz;
          }
          bool transExit = !isReflG && !isEntering && !tir;
          if (!isReflG)
            newMedium = isEntering ? elem : (transExit ? -1 : medium);
          seqInc = (isReflG && isEntering) || transExit;
        }
        float inv = rsqrtf(ndx * ndx + ndy * ndy + ndz * ndz + 1e-20f);
        ndx *= inv; ndy *= inv; ndz *= inv;
        if constexpr (SCAT)
          scatterBounce(tab + p.nSurf * kRow + p.nElem * kElemCols, p,
                        rayIn, ray, bounce, SURF ? 5 : 2, elem, isMirror, isLens,
                        isEntering, dDotN, nx, ny, nz, dx, dy, dz, ndx, ndy,
                        ndz);
        // the stage advances on every interaction but a lens or
        // transmission-grating ENTRY
        if (B4 && p.nStages > 0 && seqInc) ++seq;

        // ---- record the detector pass (power AFTER absorption, BEFORE the
        // interaction) into the hit ring; slot = min(hitN, hitSlots - 1), so
        // an overflow overwrites the last slot ----
        if constexpr (OUT == OUT_RAW) {
          // every hit on a recording element: no bounds gate, no detector map
          if (er[E_REC] > 0.5f) {
            float* o = ring + (long long)min(hitN, p.hitSlots - 1) * p.N;
            o[0] = (float)elem;
            o[rowStride] = pw;
            o[2 * rowStride] = isEntering ? 1.f : 0.f;
            o[3 * rowStride] = px;
            o[4 * rowStride] = py;
            o[5 * rowStride] = pz;
            o[6 * rowStride] = dx;   // the INCOMING direction
            o[7 * rowStride] = dy;
            o[8 * rowStride] = dz;
            ++hitN;
          }
        } else {
          float bx0 = er[E_BX0], by0 = er[E_BY0];
          float fx = (lx - bx0) / (er[E_BX1] - bx0);
          float fy = (ly - by0) / (er[E_BY1] - by0);
          int det = (int)er[E_DET];
          bool inside = (fx >= 0.f) && (fx < 1.f) && (fy >= 0.f) && (fy < 1.f)
                        && (er[E_REC] > 0.5f) && (det >= 0);
          if (inside) {
            int ix = (int)floorf(fx * (float)p.W);
            int iy = (int)floorf(fy * (float)p.H);
            int bin = (det * p.H + iy) * p.W + ix;
            if constexpr (OUT == OUT_BINS) {
              float* o = ring + (long long)min(hitN, p.hitSlots - 1) * p.N;
              o[0] = (float)bin;
              o[rowStride] = pw;
              o[2 * rowStride] = 1.f;
            } else if (hitN < p.hitSlots - 1) {
              atomicAdd(o0 + bin, pw);
              atomicAdd(o1 + bin, 1.f);
            } else {                 // the last slot: an overflow overwrites it
              lastBin = bin;
              lastW = pw;
            }
            ++hitN;
          }
        }

        if (!(newPw >= p.powerTol)) break;
        ox = px; oy = py; oz = pz;
        dx = ndx; dy = ndy; dz = ndz;
        pw = newPw;
        medium = newMedium;
      }
      if constexpr (OUT == OUT_HIST) {
        if (lastBin >= 0) addGrouped(o0, o1, lastBin, lastW);
      } else {
        // the slots this ray never reached: -1 in the key row, 0 elsewhere
        constexpr int ringRows = OUT == OUT_RAW ? 9 : 3;
        for (int s = min(hitN, p.hitSlots); s < p.hitSlots; ++s) {
          float* o = ring + (long long)s * p.N;
          o[0] = -1.f;
          for (int k = 1; k < ringRows; ++k) o[k * rowStride] = 0.f;
        }
      }
    }

    // a group's variant: its totals (segments, filled ring slots, ring
    // overflow), summed over the warp and kept per warp
    if constexpr (kGroups) {
      int c0 = segs, c1 = min(hitN, p.hitSlots);
      int c2 = max(hitN - p.hitSlots, 0);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        c0 += __shfl_down_sync(0xffffffffu, c0, o);
        c1 += __shfl_down_sync(0xffffffffu, c1, o);
        c2 += __shfl_down_sync(0xffffffffu, c2, o);
      }
      const int t = (int)(freshRayIndex() & (kBlock - 1));
      if ((t & 31) == 0) {
        int* r = groupRed + var * 3 * (kBlock / 32) + (t >> 5);
        r[0] = c0;
        r[kBlock / 32] = c1;
        r[2 * (kBlock / 32)] = c2;
      }
    }
  }

  if constexpr (kGroups) {
    // ---- the group's totals: thread 3 v + k adds total k of variant v
    // over the warps, one 64-bit atomic where it is not 0 ----
    __syncthreads();
    if ((int)threadIdx.x < 3 * nVar) {
      unsigned long long total = 0;
      for (int w = 0; w < kBlock / 32; ++w)
        total += groupRed[threadIdx.x * (kBlock / 32) + w];
      if (total)
        atomicAdd(counters + freshFirstVariant(p) * 3 + threadIdx.x, total);
    }
  } else {
    // ---- per-block totals: segments, filled ring slots (= recorded hits),
    // ring overflow ----
    int ovf = max(hitN - p.hitSlots, 0);
    __shared__ int red[3][kBlock / 32];
    int v0 = segs, v1 = min(hitN, p.hitSlots), v2 = ovf;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v0 += __shfl_down_sync(0xffffffffu, v0, o);
      v1 += __shfl_down_sync(0xffffffffu, v1, o);
      v2 += __shfl_down_sync(0xffffffffu, v2, o);
    }
    int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
      red[0][warp] = v0; red[1][warp] = v1; red[2][warp] = v2;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
      unsigned long long total = 0;
      for (int w = 0; w < kBlock / 32; ++w) total += red[threadIdx.x][w];
      if (total) atomicAdd(counters + threadIdx.x, total);
    }
  }
}


// The scalar parameters from the HOST arrays `ip` / `fp` (see
// ops/cuda_trace.py `_launchKernel` for their order).
// ip[24] / ip[25]: the triangle table's rows and chunks (TRI); past the
// runs and the cull block's offset, its group boxes (ip[kIpTail + 1])
inline TriTable triTable(const float* tri, const float* box,
                         const long long* ip) {
  return TriTable{tri, box, (int)ip[24], (int)ip[25], (int)ip[kIpTail + 1]};
}

// ip[26] / ip[27] / ip[28]: the surface table's rows, chunks and runs, then
// kMaxSurfRuns runs of kRunCols words (STAB); its group boxes at
// ip[kIpTail + 2]
inline SurfTable surfTable(const long long* ip) {
  SurfTable st{(int)ip[26], (int)ip[27], (int)ip[kIpTail + 2], (int)ip[28],
               {}};
  for (int k = 0; k < kMaxSurfRuns; ++k)
    for (int j = 0; j < kRunCols; ++j)
      st.run[k][j] = (int)ip[29 + k * kRunCols + j];
  return st;
}

// whether the tables have a table in device memory (the TRI instances)
inline bool hasGlobalTables(const long long* ip) {
  return ip[24] > 0 || ip[26] > 0;
}

inline TraceParams traceParams(const long long* ip, const float* fp) {
  TraceParams p;
  p.N = ip[0];
  p.seed = (unsigned long long)ip[1];
  p.tableLen = (int)ip[2];
  p.nSurf = (int)ip[3];
  p.nElem = (int)ip[4];
  p.samplerOff = (int)ip[5];
  p.mode = (int)ip[6];
  p.H = (int)ip[7];
  p.W = (int)ip[8];
  p.maxIntersections = (int)ip[9];
  p.hitSlots = (int)ip[10];
  p.anyMedium = (int)ip[11];
  p.strataTile = ip[12];
  p.G1 = (int)ip[13];
  p.G2 = (int)ip[14];
  p.mrlEff = fp[0];
  p.maxRayLength = fp[1];
  p.tMin = fp[2];
  p.window = fp[3];
  p.powerTol = fp[4];
  p.invG1 = fp[5];
  p.invG2 = fp[6];
  p.histLen = 0;
  p.nVariants = 0;
  p.hasGrating = (int)ip[17];
  p.nStages = (int)ip[18];
  p.gate = (int)ip[19];
  p.dispOff = (int)ip[20];
  // the word after the surface table's runs: the cull block's offset (B12)
  p.cullOff = (int)ip[kIpTail];
  return p;
}

// Whether a launch needs the B4 instance: any header flag of the grating,
// dispersion, sequential mode or a surface mask.
inline bool needsB4(const TraceParams& p) {
  return p.hasGrating || p.nStages > 0 || p.gate || p.dispOff >= 0;
}

// The table lives in dynamic shared memory: past the default 48 KB an
// instance has to be allowed more (up to what a block may hold on the
// card; the wrapper refuses larger tables before they get here).
template <typename Kernel>
int allowTable(Kernel kernel, size_t shmem) {
  if (shmem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
}

// Launch `kernel` on `stream` with the table allowed its shared memory.
template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t shmem, void* stream,
           const TraceParams& p, const float* table, const TriTable& tt,
           const SurfTable& st, const float* surfTab, const float* surfBox,
           const float* rayIn, float* out0, float* out1,
           unsigned long long* counters) {
  if (int err = allowTable(kernel, shmem)) return err;
  kernel<<<grid, kBlock, shmem, (cudaStream_t)stream>>>(
      p, table, tt, st, surfTab, surfBox, rayIn, out0, out1, counters);
  return (int)cudaGetLastError();
}

// Launch one output mode on `stream`, from the instances with the tables in
// device memory (TRI: a triangle table, ip[24] > 0, or a surface table,
// ip[26] > 0) or from those without them, as the source that instantiates
// this asks; no synchronisation, no allocation. Returns cudaGetLastError(),
// or cudaErrorInvalidValue for tables the source's instances do not take.
template <int OUT, bool TRI>
int launchTrace(const float* table, const float* tri, const float* box,
                const float* surfTab, const float* surfBox, const float* rayIn,
                float* out0, float* out1, unsigned long long* counters,
                const long long* ip, const float* fp, void* stream) {
  TraceParams p = traceParams(ip, fp);
  if (hasGlobalTables(ip) != TRI) return (int)cudaErrorInvalidValue;
  if (p.N <= 0) return 0;
  const long long blocks = (p.N + kBlock - 1) / kBlock;
  const TriTable tt = triTable(tri, box, ip);
  const SurfTable st = surfTable(ip);
  const size_t shmem = (size_t)p.tableLen * sizeof(float);
  // ip[21]: the tables' sampler, 0 point source, 1 surface source; ip[22]:
  // the table has a scatter block; ip[23]: the scene has a kind or trim of
  // B2 / B3 (widened surface rows)
  const bool surf = ip[21] == 1 && p.mode != MODE_COLUMNS;
  const bool scat = ip[22] != 0, geom = ip[23] != 0;
  constexpr int O = OUT;
  constexpr bool T = true, F = false;
  auto go = [&](auto kernel) {
    return launch(kernel, dim3((unsigned)blocks), shmem, stream, p, table,
                  tt, st, surfTab, surfBox, rayIn, out0, out1, counters);
  };
  if constexpr (TRI) {             // every TRI instance is built on B4
    // STAB (S): the instances that also sweep a surface table (ip[26] > 0)
    auto pick = [&](auto stab) {
      constexpr bool S = decltype(stab)::value;
      if (geom)
        return scat ? (surf ? go(traceKernel<O, F, T, T, T, T, T, S>)
                            : go(traceKernel<O, F, T, F, T, T, T, S>))
                    : (surf ? go(traceKernel<O, F, T, T, F, T, T, S>)
                            : go(traceKernel<O, F, T, F, F, T, T, S>));
      return scat ? (surf ? go(traceKernel<O, F, T, T, T, F, T, S>)
                          : go(traceKernel<O, F, T, F, T, F, T, S>))
                  : (surf ? go(traceKernel<O, F, T, T, F, F, T, S>)
                          : go(traceKernel<O, F, T, F, F, F, T, S>));
    };
    return ip[26] > 0 ? pick(std::true_type{}) : pick(std::false_type{});
  } else {
    if (geom)
      return scat ? (surf ? go(traceKernel<O, F, T, T, T, T>)
                          : go(traceKernel<O, F, T, F, T, T>))
                  : (surf ? go(traceKernel<O, F, T, T, F, T>)
                          : go(traceKernel<O, F, T, F, F, T>));
    if (scat)
      return surf ? go(traceKernel<O, F, T, T, T>)
                  : go(traceKernel<O, F, T, F, T>);
    if (needsB4(p))
      return surf ? go(traceKernel<O, F, T, T, F>)
                  : go(traceKernel<O, F, T, F, F>);
    return surf ? go(traceKernel<O, F, F, T, F>)
                : go(traceKernel<O, F, F, F, F>);
  }
}

// A sweep block's dynamic shared memory: one variant a block, its table
// (as the single-scene kernel); a group of more than one variant, the
// tables of min(group, variants) variants, their per-warp totals and the
// per-thread slot (kernel above).
inline size_t sweepSharedBytes(long long tableLen, long long variants,
                               long long group) {
  if (group == 1) return (size_t)tableLen * sizeof(float);
  const long long held = group < variants ? group : variants;
  return (size_t)(held * (tableLen + 3 * (kBlock / 32))
                  + kSlotFloats * kBlock) * sizeof(float);
}

// The sweep's scalar parameters, TRI as for launchTrace: ip[15] variants of
// ip[0] rays each, ip[16] floats per variant's histogram, past the words of
// launchTrace the variants of a group (ip[kIpTail + 3]) and whether they
// share the sampler's draw (ip[kIpTail + 4]). Returns cudaErrorInvalidValue
// for a group the tables cannot take: more than one variant needs the plain
// or B4 instance (no table in device memory, no scatter, no GEOM), a shared
// draw and seed or uniform inputs.
template <bool TRI>
int sweepParams(const long long* ip, const float* fp, TraceParams& p) {
  p = traceParams(ip, fp);
  if (hasGlobalTables(ip) != TRI) return (int)cudaErrorInvalidValue;
  const long long variants = ip[15], group = ip[kIpTail + 3];
  if (group < 1 || group > kMaxVariantGroup || ip[16] > 2147483647LL
      || variants > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  if (group > 1 && (TRI || ip[22] != 0 || ip[23] != 0
                    || ip[kIpTail + 4] == 0 || p.mode == MODE_COLUMNS))
    return (int)cudaErrorInvalidValue;
  p.histLen = (int)ip[16];
  p.nVariants = (int)variants;
  p.groupSize = (int)group;
  return 0;
}

// Call go(kernel) with the sweep instance for these tables: ip[22] a
// scatter block, ip[23] widened surface rows (a kind or trim of B2 / B3),
// ip[26] > 0 a surface table (TRI's STAB); the GROUPED instances for a
// group of more than one variant.
template <bool TRI, typename Go>
int pickSweep(const long long* ip, const TraceParams& p, Go go) {
  const bool scat = ip[22] != 0, geom = ip[23] != 0;
  constexpr int O = OUT_HIST;
  constexpr bool T = true, F = false;
  if constexpr (TRI) {
    auto pick = [&](auto stab) {
      constexpr bool S = decltype(stab)::value;
      if (geom)
        return scat ? go(traceKernel<O, T, T, F, T, T, T, S>)
                    : go(traceKernel<O, T, T, F, F, T, T, S>);
      return scat ? go(traceKernel<O, T, T, F, T, F, T, S>)
                  : go(traceKernel<O, T, T, F, F, F, T, S>);
    };
    return ip[26] > 0 ? pick(std::true_type{}) : pick(std::false_type{});
  } else {
    if (geom)
      return scat ? go(traceKernel<O, T, T, F, T, T>)
                  : go(traceKernel<O, T, T, F, F, T>);
    if (scat) return go(traceKernel<O, T, T, F, T>);
    if (p.groupSize > 1)
      return needsB4(p) ? go(traceKernel<O, T, T, F, F, F, F, F, T>)
                        : go(traceKernel<O, T, F, F, F, F, F, F, T>);
    return needsB4(p) ? go(traceKernel<O, T, T, F, F>)
                      : go(traceKernel<O, T, F, F, F>);
  }
}

// The sweep's launch (OUT_HIST; sweepParams for ip): the grid is
// ceil(rays / block) x ceil(variants / group) blocks; threads past a
// variant's last ray are masked like the last block of a single-scene
// launch. No synchronisation, no allocation; returns cudaGetLastError().
template <bool TRI>
int launchSweep(const float* tables, const float* tri, const float* box,
                const float* surfTab, const float* surfBox, const float* rayIn,
                float* histPower, float* histCounts,
                unsigned long long* counters, const long long* ip,
                const float* fp, void* stream) {
  TraceParams p;
  if (int err = sweepParams<TRI>(ip, fp, p)) return err;
  if (p.N <= 0 || p.nVariants <= 0) return 0;
  const long long tiles = (p.N + kBlock - 1) / kBlock;
  const long long groups = (p.nVariants + p.groupSize - 1) / p.groupSize;
  if (tiles > 2147483647LL || groups > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t shmem = sweepSharedBytes(p.tableLen, p.nVariants, p.groupSize);
  const dim3 grid((unsigned)tiles, (unsigned)groups);
  const TriTable tt = triTable(tri, box, ip);
  const SurfTable st = surfTable(ip);
  return pickSweep<TRI>(ip, p, [&](auto kernel) {
    return launch(kernel, grid, shmem, stream, p, tables, tt, st, surfTab,
                  surfBox, rayIn, histPower, histCounts, counters);
  });
}

// What the host's group rule (ops/cuda_trace.py `sweepVariantGroup`) reads
// of the launch that launchSweep would make for ip: out[0] its dynamic
// shared bytes, out[1] the blocks of its instance an SM holds with them,
// out[2] the blocks an SM that instance's registers and threads allow.
// Returns a CUDA error, or sweepParams's.
template <bool TRI>
int planSweep(const long long* ip, const float* fp, long long* out) {
  TraceParams p;
  if (int err = sweepParams<TRI>(ip, fp, p)) return err;
  const size_t shmem = sweepSharedBytes(p.tableLen, p.nVariants, p.groupSize);
  return pickSweep<TRI>(ip, p, [&](auto kernel) {
    int blocks = 0, regBlocks = 0;
    if (int err = allowTable(kernel, shmem)) return err;
    if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, kernel, kBlock, shmem))
      return err;
    if (int err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &regBlocks, kernel, kBlock, 0))
      return err;
    out[0] = (long long)shmem;
    out[1] = blocks;
    out[2] = regBlocks;
    return 0;
  });
}

}  // namespace
