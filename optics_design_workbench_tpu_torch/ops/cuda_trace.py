'''
Trace kernels for Hopper: sample (or read) rays and run the whole bounce
loop per ray in ONE kernel launch per step, with three output modes of one
shared body (csrc/trace_common.cuh) and a variant-major sweep of the first:

  traceHistogram  detector hits are binned inside the kernel — nothing
                  ray-shaped in device memory on the main path
  traceBins       the hit ring comes back per ray as (bin, power, count);
                  `binRing` forms the histogram outside, in float64
  traceRaw        the hit ring comes back per ray as raw records (element,
                  power, isEntering, point, incoming direction) for storage
  traceSweep      `traceHistogram` for V scene variants in one launch: V
                  stacked tables in, V histograms out, the same rays in
                  every variant (common random numbers); a block traces
                  its rays through a group of variants
                  (`sweepVariantGroup`), drawing each ray once where the
                  variants share the draw

Counterpart of the JAX package's ops/pallas_trace.py (`makePallasTraceStep`
in its in-kernel-histogram and per-ray-output modes, `makePallasRawStep`,
`makePallasSweepStep`). This module holds

  * the host rows: `_sceneRows` turns a compiled scene + histogram spec into
    per-surface / per-element python-float rows, `buildTraceTables` packs
    them (and the sampler spec) into the float32 table the kernels read,
    `packSweepTables` / `buildSweepTables` stack one such table per variant;
  * the kernels' WRAPPERS `traceHistogram`, `traceBins`, `traceRaw`,
    `traceSweep`: each checks its inputs, launches its kernel for CUDA
    tensors (counting launches in `launchCounts`), and runs its plain
    version for CPU tensors — and only for those: on a CUDA tensor it
    launches the kernel or raises;
  * `lastLaunch`, each wrapper's last launch (grid, shared bytes and the
    histogram kernels' binning, HIST_MODE);
  * the plain PyTorch versions `traceHistogramPlain`, `traceBinsPlain`,
    `traceRawPlain`, `traceSweepPlain`: one bounce loop of column-wise
    tensor ops (`_bounceLoopPlain`) that follows the kernels step by step,
    with three epilogues (the sweep's is the histogram's, variant by
    variant);
  * `makeTraceStep`, `makeRawStep` and `makeSweepStep`, which make the
    user-level steps.

Three input modes of every kernel: (a) seed only — rays are drawn in the
kernel from Philox4x32-10 keyed by (seed, ray index); (b) the in-kernel
sampler fed its uniform arrays (two for a point source, five for a surface
source); (c) eight ray columns ox..dz, pw, wl. The
main path uses (a); (b) and (c) exist so that kernel, plain version and the
JAX package can be fed the same numbers.

Scene coverage of this slice (`ineligibleReason` names what is refused):
every surface kind (plane, sphere, cylinder, asphere, triangle, cone,
quadric, torus) with window, annulus and band trims, UV bitmap trims and
hole-primitive trims (a scene with a kind or trim beyond plane / sphere /
cylinder with window trims widens its surface rows and runs the kernels'
GEOM instance, `needsGeom`);
Mirror / Lens / Absorber / Vacuum / Grating (Ludwig line gratings,
reflective and transmissive); Beer-Lambert absorption; dispersive n(lambda)
as a fitted polynomial per element; sequential mode (a per-ray stage index
gating each surface) and per-source surface masks; stochastic scatter
(the lobe of a mirror or lens and the ray modification, drawn per bounce
from the fitted constants of `tracing/scatter.scatterConstants`, packed as
the table's scatter block). In-kernel samplers: the point source and the
surface source (faces of every kind, up to 32). Any number of surfaces and
elements, as long as the shared-memory table fits a thread block: past 256
analytic surfaces every plane / sphere / cylinder / cone / quadric with a
window trim leaves the surface rows for the surface table in device memory
(`tableSurfaces`), past 128 triangles every triangle for the triangle table
(`tableTriangles`); what stays a surface row (bitmap and hole-primitive
trims, aspheres, tori) is capped at 256, and sequential mode and source
masks keep a scene to 256 analytic surfaces, as in the reference. Given
the source's emission bound, the histogram, per-ray-bin and raw kernels
sweep on each bounce only the surface rows some ray can reach there (the
reference's per-bounce culls, `_cullSets`: the table's cull block); the
sweep kernel, like the reference's, sweeps every row on every bounce.
'''

import ctypes
import hashlib

import numpy as np
import torch

from .. import KernelError, hostArray as _hostArray, resolveDevice
from ..distributions.device_sampler import ACOS_POLY
from ..geometry import surfaces as GS
from ..models.surface_source import rotColumns as _rotPlain
from ..tracing import scatter as SC
from ..tracing.element_table import (MIRROR, LENS, GRATING, ABSORBER,
                                     VACUUM, EP_GRATTYPE, EP_GRATLPM,
                                     EP_GRATDIRX, EP_GRATDIRY, EP_GRATDIRZ,
                                     EP_GRATORDER)
from . import beam_cull

_BIG = 3.0e38

# table capacities of the one compiled kernel (the wrapper raises beyond).
# Surfaces: the reference keeps up to MAX_SURFACES analytic surfaces as
# immediates; past them its closed-form kinds with window trims ride its
# surface table (below) and at most MAX_SURFACES others stay. The
# shared-memory table lives in a thread block's shared memory: up to 227 KB
# on Hopper, less what the kernel's own reduction needs.
MAX_SURFACES = 256
MAX_TABLE_BYTES = 227 * 1024 - 1024
# Past MAX_SURFACES analytic surfaces (ROADMAP B8) every surface of a kind of
# TABLE_SURF_KINDS with a window trim (flag 0 or 1) leaves the surface rows
# for the SURFACE TABLE: rows of SURF_TABLE_COLS float32 [rot (9), off (3),
# orient, elemF, p0..p4, trim1, trim2], sorted stably by (kind, trim0) into
# runs; a run longer than _SURF_CHUNK whose members all have a bounding
# sphere is Morton-ordered by its centres, cut into chunks of _SURF_CHUNK
# rows with one padded world AABB each (the last padded with never-hit rows),
# the other runs are swept in full. Table and boxes are device tensors of
# their own (no part of the shared-memory table, no cap on their size); the
# kernels sweep them after the triangle table.
TABLE_SURF_KINDS = (GS.PLANE, GS.SPHERE, GS.CYLINDER, GS.CONE, GS.QUADRIC)
_SURF_CHUNK = 16
SURF_TABLE_COLS = 21
# runs of the surface table: one per (kind, trim0), plain runs first, each
# (kind, trim0, first, last, rowStart, chunked, group0) for the kernels: rows
# [first, last) of a plain run, chunks [first, last) of a chunked run, whose
# chunk c covers rows rowStart + (c - first) * _SURF_CHUNK on and whose
# groups of SWEEP_GROUP chunks (below) start at group box group0
MAX_SURF_RUNS = 2 * len(TABLE_SURF_KINDS)
RUN_COLS = 7
# Meshes past TABLE_TRIANGLES triangles leave the surface rows (ROADMAP B7):
# each triangle becomes a world-frame row of the TRIANGLE TABLE, [v0, e1,
# e2, elemF, orient] (TRI_COLS floats), Morton-ordered by centroid into
# chunks of _TRI_CHUNK rows with one padded world AABB each (BOX_COLS:
# lo xyz, hi xyz). Table and boxes are device tensors of their own, read
# from global memory (no part of the shared-memory table, no cap on their
# size); the kernels sweep them after the surface rows.
TABLE_TRIANGLES = 128
_TRI_CHUNK = 32
TRI_COLS = 11
BOX_COLS = 6
# The kernels' three-level sweep of both tables: a GROUP box is the union
# of SWEEP_GROUP consecutive chunk boxes (of one run, in the surface table),
# and a LEAF box the padded world AABB of _TRI_LEAF consecutive rows of a
# triangle chunk or of _SURF_LEAF of a surface chunk; a warp tests a
# group's chunk boxes only when it enters the group, and a chunk's leaf
# boxes only when it enters the chunk. The kernels read the boxes as a PACK
# per table in device memory, the group boxes, then the chunk boxes, then
# the leaf boxes, BOX_STRIDE floats each (lo xyz, 0, hi xyz, 0: two 16-byte
# loads).
SWEEP_GROUP = 8
BOX_STRIDE = 8
_TRI_LEAF = 8
_SURF_LEAF = 4
# the box of a surface leaf of nothing but the rows that pad a run's last
# chunk (`_dummySurfRow`): a point at 3e38 on every axis, which no segment
# capped below 2.9e38 enters (on each axis its slab lies at or beyond 3e38
# along the ray, or behind the origin: every |direction component| <= 1)
_EMPTY_LEAF = np.full(BOX_COLS, 3e38, np.float32)
MAX_PWPOLY_SEGMENTS = 12
MAX_PWPOLY_COEFFS = 13
MAX_TENT_KNOTS = 257
MAX_HIT_SLOTS = 6
# n(lambda) fit: degree <= 12 in the scaled wavelength, to 2e-5
MAX_DISP_COEFFS = 13
DISP_FIT_TOL = 2e-5

# table layout — keep in step with csrc/trace_common.cuh. A surface row ends
# with the offset of its stage words (column 19: where a scene with a stage
# gate keeps, per surface, ceil(stages / 32) uint32 words bit-cast into the
# float table, bit q of the set allowing stage q); an element row with its
# dispersion flag (11) and grating columns (12-17); a scene with dispersion
# adds one block row per element: mid, 1/half, coefficient count, 0,
# coefficients.
SURF_COLS = 20
# A scene with a surface kind or a trim beyond plane / sphere / cylinder
# with window trims (B2, B3) widens each surface row by GEOM_COLS: the
# params p0..p4 (G_P), nine kind constants (G_X; triangle: edges e1, e2 and
# unit normal, each formed in double and rounded once; asphere: (1+k) c^2,
# 1/c, 1/c^2 and whether the sphere seed applies; torus: (r/R)^2, r^2 and
# the residual gate), a bitmap's 1/du, 1/dv, the offset of its bit words and
# its resolution, and the offset and count of its hole-primitive rows
# (PRIM_COLS each: shape, isAdd, isInverted, cx, cy, p0, p1, cosA, sinA).
# Bitmaps are bits in uint32 words bit-cast into the table, row-major over
# (iv, iu), LSB first.
GEOM_COLS = 20
G_P, G_X, G_TRIM3, G_TRIM4 = 20, 25, 34, 35
G_MASKOFF, G_MASKRES, G_PRIMOFF, G_NPRIM = 36, 37, 38, 39
PRIM_COLS = 9
ELEM_COLS = 18
DISP_COLS = 4 + MAX_DISP_COEFFS
_SEG_STRIDE = 4 + MAX_PWPOLY_COEFFS
_MARG_LEN = 264
_SAMPLER_GEOM = 16
# a surface-source sampler block: the geometry block (face count, 2 pi,
# wavelength at 14), the theta marginal, then one row per face: kind,
# rectangle flag, the four sampling constants of
# `surface_source.faceSamplingConstants`, the placement R (9, row-major)
# and offset (3), orient, and the face's area-CDF window [cumLo, cumHi);
# faces of kind cone, asphere, torus and triangle carry FACE_XCOLS more
# constants at F_X (`surface_source.faceExtraConstants`), an asphere or
# torus face also a marginal block of its radius / tube-angle inverse CDF
# after the face rows, at the offset (from the sampler block's start) its
# first extra constant holds
FACE_XCOLS = 12
F_X = 21
FACE_COLS = F_X + FACE_XCOLS
# the in-kernel samplers and the uniforms each draws per ray (the uniform
# seam's rows): point (first, phi); surface (face, u, v, theta, phi)
SAMPLER_POINT, SAMPLER_SURFACE = 0, 1
SAMPLER_UNIFORMS = {SAMPLER_POINT: 2, SAMPLER_SURFACE: 5}
# the scatter block (B5), right after the element rows. A header: entry
# count, uniform rows per bounce (lobe + modify), lobe rows, modify rows,
# whether the incidence angle is needed, then the arccos polynomial's
# coefficients (ascending) at SC_ACOS; one row per (element, kind) entry:
# element, kind, offsets of the phi and theta specs, offset and count of
# the phi and theta events (offsets from the block's start); then the
# specs. A spec starts [kind, n, lo, hi]: pwpoly (kind 1, the marginal
# layout: n segments of _SEG_STRIDE), pwpoly2d (kind 3, then cMid,
# 1/cHalf, nU, nC and n rectangles of a, b, ca, cb, midU, 1/halfU, midC,
# 1/halfC and nU x nC coefficients, u power major), low-rank (kind 4, n
# pairs of offsets: its pwpoly2d and its phi factor). A 1-D function (an
# event's cumulative probability or value, a phi factor) is a block of
# FN_COLS: const (0, value), poly1d (1, mid, 1/half, nCoef, ascending
# coefficients) or Fourier (2, c0, nTerms, 0, a1, b1, a2, b2, ...); an
# event is a (cumulative, value) pair of them.
SC_HEADER = 24
SC_ACOS = 8
SC_ENTRY_COLS = 8
SPEC_PWPOLY, SPEC_PWPOLY2D, SPEC_LOWRANK = 1, 3, 4
FN_CONST, FN_POLY1D, FN_FOURIER = 0, 1, 2
FN_COLS = 4 + 30

MODE_SEED, MODE_UNIFORMS, MODE_COLUMNS = 0, 1, 2

# default ray-index stratum size on the card: one thread block (256 rays)
# per (theta, phi) cell — the finest strata whose rays still share a block
DEFAULT_STRATA_TILE = 256

# wrapper -> (library stem under csrc/, C launcher, number of output tensors).
# The instances with the tables in device memory (the triangle table, B7,
# and the surface table, B8) live in a source of their own per wrapper,
# stem + '_tri' with the launcher + 'Tri', so that they build in parallel
# with the rest; a wrapper launches from it when its tables have either.
_KERNELS = {'traceHistogram': ('trace_kernel', 'odwTraceHistogram', 2),
            'traceBins': ('trace_bins_kernel', 'odwTraceBins', 1),
            'traceRaw': ('trace_raw_kernel', 'odwTraceRaw', 1),
            'traceSweep': ('trace_sweep_kernel', 'odwTraceSweep', 2)}

# number of kernel launches made through each wrapper (one is added where
# the wrapper launches its kernel, and nowhere else)
launchCounts = {name: 0 for name in _KERNELS}
# how the histogram kernels bin a detector pass (B11): the lanes of a warp
# that land in one bin add once, straight into the output
HIST_MODE = 'warp'
KERNEL_BLOCK = 256               # csrc kBlock: threads (= rays) of a block
# each wrapper's last launch: its grid, dynamic shared bytes and, for the
# histogram kernels, HIST_MODE; for the sweep kernel also its variant group
# and whether the group's variants shared the draw (None before a launch)
lastLaunch = {name: None for name in _KERNELS}

# The sweep kernel's variant groups (csrc/trace_common.cuh, SWEEP): a block
# traces its tile of rays through up to MAX_VARIANT_GROUP variants (csrc
# kMaxVariantGroup) that share the draw, their tables together in its
# shared memory. `sweepVariantGroup` takes the largest group whose launch
# keeps every block an SM that its instance's registers allow and fills the
# card SWEEP_WAVES times over, so that long blocks do not leave the last
# wave's SMs idle (PERF.md §6: at 8 variants x 100,000 rays two waves of
# groups of two ran 1.8 % slower than one variant a block); the launch
# facts come from the kernel library (`_sweepPlan`). Ray columns, variants with draws of their own, and tables
# with scatter, another surface kind or trim (GEOM) or a table in device
# memory take groups of one (`sweepGroupsAllowed`; PERF.md §6: a variant
# loop cost the 1800-triangle dish and the 522-surface wall 3-16 % at every
# group size).
MAX_VARIANT_GROUP = 16
SWEEP_WAVES = 3


def numSurfacesStatic(scene):
  return int(scene['surfaces']['kind'].shape[0])


def eligible(scene):
  '''Static host-side check whether the kernel supports this scene.'''
  return ineligibleReason(scene) is None


def ineligibleReason(scene):
  '''None when the kernel supports this scene, else a short human-readable
  reason naming the feature this slice does not cover.'''
  if 'scatter' in scene and scatterConstantsOf(scene) is None:
    flags = scene['scatter'].get('flags')
    nCombos = 0 if flags is None else int(_hostArray(flags).sum())
    if nCombos > SC.MAX_COMBOS:
      return (f'{nCombos} scattering (element, kind) combinations > the '
              f'{SC.MAX_COMBOS} the kernel draws from')
    return SC.GATHER_ONLY_REASON
  if 'nTable' in scene['elements'] and not dispersionFitsInKernel(scene):
    return ('dispersive n(wavelength) tables do not fit the in-kernel '
            f'polynomial model (degree <= {MAX_DISP_COEFFS - 1} to '
            f'{DISP_FIT_TOL})')
  kinds = _hostArray(scene['surfaces']['kind'])
  nTri = tableTriangles(scene)
  if nTri:
    # the JAX package's own refusals for meshes past its immediates: its
    # stage gates and per-source masks are per-surface constants; the
    # record tracer (tracing/tracer.py) takes these scenes
    if 'seqMask' in scene:
      return (f'{nTri} mesh triangles with sequential mode: stage gates '
              f'are per-surface immediates (<=128 tris)')
    if 'surfMask' in scene:
      triMask = _hostArray(scene['surfMask']).astype(bool)[
          kinds == GS.TRIANGLE]
      if not triMask.all():
        return (f'{nTri} mesh triangles with a per-source ignore mask on '
                f'mesh surfaces (<=128 tris for masked meshes)')
  trims0 = _hostArray(scene['surfaces']['trim'])[:, 0]
  nOther = len(kinds) - int((kinds == GS.TRIANGLE).sum())
  if nOther > MAX_SURFACES:
    # the JAX package's own refusals past its immediates: what stays a
    # surface row is capped, and stage gates and per-source masks are
    # per-surface constants there
    nComplex = nOther - int(_tableSurfaceMask(kinds, trims0).sum())
    if nComplex > MAX_SURFACES:
      return (f'{nComplex} analytic surfaces with bitmap/prim trims or '
              f'iterative kinds > the {MAX_SURFACES}-surface immediates '
              f'budget (simple window-trimmed surfaces ride the SMEM table)')
    if 'seqMask' in scene or 'surfMask' in scene:
      return (f'{nOther} analytic surfaces with sequential mode or a '
              f'per-source ignore mask: stage/mask gates are per-surface '
              f'immediates (<={MAX_SURFACES} surfaces for masked scenes)')
  bad = sorted(set(kinds.tolist()) - set(GS._KIND_NAMES))
  if bad:
    return f'unknown surface kinds {bad}'
  if not np.isin(trims0, (0., 1., 2., 3., 4.)).all():
    return 'unknown trim flags (0 to 4 are defined)'
  if (trims0 == 2.).any() and 'trimMasks' not in scene['surfaces']:
    return "bitmap trims (flag 2) without the scene's trimMasks"
  if (trims0 > 2.5).any() and 'trimPrims' not in scene['surfaces']:
    return "hole-primitive trims (flags 3, 4) without the scene's trimPrims"
  return None


def tableTriangles(scene):
  '''How many of the scene's triangles ride the triangle table: all of
  them past TABLE_TRIANGLES (as the JAX package switches its mesh sweep
  on), else none.'''
  nTri = int((_hostArray(scene['surfaces']['kind']) == GS.TRIANGLE).sum())
  return nTri if nTri > TABLE_TRIANGLES else 0


def _tableSurfaceMask(kinds, trims0):
  '''Which surfaces are of a kind and trim the surface table takes.'''
  return np.isin(kinds, TABLE_SURF_KINDS) & np.isin(trims0, (0., 1.))


def tableSurfaces(scene):
  '''Boolean mask of the surfaces that ride the surface table: past
  MAX_SURFACES analytic (non-triangle) surfaces every one of a kind of
  TABLE_SURF_KINDS with a window trim (as the JAX package switches its
  surface table on), else none.'''
  kinds = _hostArray(scene['surfaces']['kind'])
  trims0 = _hostArray(scene['surfaces']['trim'])[:, 0]
  if len(kinds) - int((kinds == GS.TRIANGLE).sum()) <= MAX_SURFACES:
    return np.zeros(len(kinds), bool)
  return _tableSurfaceMask(kinds, trims0)


def needsGeom(scene):
  '''Whether the scene's surface ROWS need the kernels' GEOM instance: a
  surface kind beyond plane / sphere / cylinder, or a bitmap or
  hole-primitive trim (triangles of the triangle table and surfaces of the
  surface table are not rows).'''
  kinds = _hostArray(scene['surfaces']['kind'])
  trims0 = _hostArray(scene['surfaces']['trim'])[:, 0]
  rows = kinds != GS.TRIANGLE if tableTriangles(scene) \
      else np.ones(len(kinds), bool)
  rows &= ~tableSurfaces(scene)
  return bool(not np.isin(kinds[rows], GS.BASIC_KINDS).all()
              or not np.isin(trims0[rows], GS.BASIC_TRIMS).all())


# scatterConstants per scatter table, keyed by a digest of the tables (the
# fits take up to seconds; a scene is checked and packed several times)
_SCATTER_CONSTS = {}


def scatterConstantsOf(scene):
  '''`tracing/scatter.scatterConstants` of the scene, computed once per
  distinct scatter table.'''
  if 'scatter' not in scene:
    return None
  sc = scene['scatter']
  h = hashlib.sha1()
  for k in sorted(sc):
    a = np.ascontiguousarray(_hostArray(sc[k]))
    h.update(k.encode() + str(a.dtype).encode() + str(a.shape).encode())
    h.update(a.tobytes())
  key = h.hexdigest()
  if key not in _SCATTER_CONSTS:
    _SCATTER_CONSTS[key] = SC.scatterConstants(scene)
  return _SCATTER_CONSTS[key]


def _fnBlock(spec):
  '''A 1-D function spec (const, poly1d, fourier) as a (FN_COLS,) float64
  row (see the scatter block's layout).'''
  out = np.zeros(FN_COLS)
  if spec[0] == 'const':
    out[:2] = (FN_CONST, spec[1])
  elif spec[0] == 'poly1d':
    _, mid, half, coeffs = spec
    if len(coeffs) > FN_COLS - 4:
      raise ValueError(f'poly1d degree {len(coeffs) - 1} > {FN_COLS - 5}')
    out[:4] = (FN_POLY1D, mid, 1.0 / half, len(coeffs))
    out[4:4 + len(coeffs)] = coeffs
  else:
    _, c0, terms = spec
    if 2 * len(terms) > FN_COLS - 4:
      raise ValueError(f'{len(terms)} Fourier terms > {(FN_COLS - 4) // 2}')
    out[:4] = (FN_FOURIER, c0, len(terms), 0.)
    out[4:4 + 2 * len(terms)] = np.asarray(terms, float).reshape(-1)
  return out


def _specBlock(spec, base, parts):
  '''Append a marginal spec (pwpoly, pwpoly2d, lowrank) to `parts` (a list
  of float64 arrays that starts at the scatter block's start) and return
  its offset; `base` is the length of `parts` so far.'''
  kind = spec[0]
  off = base
  if kind == 'pwpoly':
    _, segs, lo, hi = spec
    block = np.zeros(4 + len(segs) * _SEG_STRIDE)
    block[:4] = (SPEC_PWPOLY, len(segs), lo, hi)
    for i, (a, _b, mid, half, coeffs) in enumerate(segs):
      if len(coeffs) > MAX_PWPOLY_COEFFS:
        raise ValueError(f'pwpoly degree {len(coeffs) - 1} > '
                         f'{MAX_PWPOLY_COEFFS - 1}')
      o = 4 + i * _SEG_STRIDE
      block[o:o + 4] = (a, mid, 1.0 / half, len(coeffs))
      block[o + 4:o + 4 + len(coeffs)] = coeffs
    parts.append(block)
    return off, base + len(block)
  if kind == 'pwpoly2d':
    _, rects, lo, hi, cMid, cHalf = spec
    nU, nC = len(rects[0][8]), len(rects[0][8][0])
    stride = 8 + nU * nC
    block = np.zeros(8 + len(rects) * stride)
    block[:8] = (SPEC_PWPOLY2D, len(rects), lo, hi, cMid, 1.0 / cHalf, nU,
                 nC)
    for i, (a, b, ca, cb, midU, halfU, midC, halfC, coeffs) in \
        enumerate(rects):
      o = 8 + i * stride
      block[o:o + 8] = (a, b, ca, cb, midU, 1.0 / halfU, midC, 1.0 / halfC)
      block[o + 8:o + stride] = np.asarray(coeffs, float).reshape(-1)
    parts.append(block)
    return off, base + len(block)
  if kind == 'lowrank':
    _, comps, lo, hi = spec
    head = np.zeros(4 + 2 * len(comps))
    head[:4] = (SPEC_LOWRANK, len(comps), lo, hi)
    parts.append(head)
    base += len(head)
    for i, (aspec, bspec) in enumerate(comps):
      aOff, base = _specBlock(aspec, base, parts)
      parts.append(_fnBlock(bspec))
      head[4 + 2 * i:6 + 2 * i] = (aOff, base)
      base += FN_COLS
    return off, base
  raise ValueError(f'unknown scatter spec kind {kind!r}')


def _packScatter(consts):
  '''The scatter block of `scatterConstants` entries as a float32 array,
  each constant formed in double and rounded to float32 once (as the
  reference's python constants are), and its facts (uniform rows per bounce
  of the lobe and of MODIFY).'''
  lobe, mods = SC.splitEntries(consts)
  lobeRows, modRows = SC.uniformsPerBounce(lobe), SC.uniformsPerBounce(mods)
  n = len(consts)
  head = np.zeros(SC_HEADER + n * SC_ENTRY_COLS)
  head[:5] = (n, lobeRows + modRows, lobeRows, modRows,
              float(SC.needsIncidence(consts)))
  head[SC_ACOS:SC_ACOS + len(ACOS_POLY)] = ACOS_POLY
  parts = [head]
  base = len(head)
  for i, (e, k, phiSpec, thetaSpec, phiDisc, thetaDisc) in enumerate(consts):
    row = head[SC_HEADER + i * SC_ENTRY_COLS:
               SC_HEADER + (i + 1) * SC_ENTRY_COLS]
    row[:2] = (e, k)
    row[2], base = _specBlock(phiSpec, base, parts)
    row[3], base = _specBlock(thetaSpec, base, parts)
    for col, disc in ((4, phiDisc), (6, thetaDisc)):
      row[col:col + 2] = (base, len(disc))
      for cumSpec, valSpec in disc:
        parts += [_fnBlock(cumSpec), _fnBlock(valSpec)]
        base += 2 * FN_COLS
  block = np.concatenate(parts)
  assert len(block) == base
  return block.astype(np.float32), dict(scatterRows=lobeRows + modRows,
                                        lobeRows=lobeRows, modRows=modRows)


def _dispersionPolys(scene, deg=MAX_DISP_COEFFS - 1, tol=DISP_FIT_TOL):
  '''{elemIdx: (mid, half, coeffsAscending)} for dispersive elements: n on
  the scene's wavelength grid fitted by an even-degree polynomial (4 ..
  `deg`) in the scaled wavelength (lambda - mid) / half, the lowest degree
  that meets `tol`. Raises ValueError for a row no such fit meets (callers
  gate on `dispersionFitsInKernel`). The JAX package's `_dispersionPolys`,
  step for step.'''
  elements = scene['elements']
  if 'nTable' not in elements:
    return {}
  lam = _hostArray(elements['nLambda']).astype(float)
  nTab = _hostArray(elements['nTable']).astype(float)
  hasDisp = _hostArray(elements['hasDispersion'])
  mid, half = (lam[0] + lam[-1]) / 2., max((lam[-1] - lam[0]) / 2., 1e-9)
  s = (lam - mid) / half
  out = {}
  for e in range(nTab.shape[0]):
    if not hasDisp[e]:
      continue
    for d in range(4, deg + 1, 2):
      c = np.polyfit(s, nTab[e], d)
      if np.abs(np.polyval(c, s) - nTab[e]).max() <= tol:
        out[e] = (float(mid), float(half), tuple(float(x) for x in c[::-1]))
        break
    else:
      raise ValueError(f'dispersion row of element {e} cannot be fitted to '
                       f'{tol} by a degree-{deg} polynomial')
  return out


def dispersionFitsInKernel(scene):
  '''True when every dispersive n(lambda) row fits the kernel's
  polynomial.'''
  try:
    _dispersionPolys(scene)
    return True
  except ValueError:
    return False


def _staticMasks(scene):
  '''(surfAllowed, seqSpec) from the scene's per-source surface mask
  (`surfMask`) and sequential-mode mask (`seqMask`), as the JAX package
  forms them: surfAllowed the sorted list of surfaces a ray may hit, or None
  for all; seqSpec (nStages, {surface: allowed-stage tuple}), or None
  without sequential mode. A surface allowed at no stage is not allowed.'''
  S = numSurfacesStatic(scene)
  surfMask = np.ones(S, dtype=bool)
  if 'surfMask' in scene:
    surfMask = _hostArray(scene['surfMask']).astype(bool)
  seqSpec = None
  if 'seqMask' in scene:
    seq = _hostArray(scene['seqMask']).astype(bool)
    Q = seq.shape[0]
    stages = {s: tuple(np.nonzero(seq[:, s])[0].tolist()) for s in range(S)}
    seqSpec = (Q, stages)
    surfMask &= seq.any(axis=0)
  allowed = None if surfMask.all() \
      else sorted(s for s in range(S) if surfMask[s])
  return allowed, seqSpec


def _bitsToInt(indices, n):
  '''The python int whose bits `indices` (of n) are set.'''
  bits = np.zeros(n, bool)
  bits[list(indices)] = True
  return int.from_bytes(np.packbits(bits, bitorder='little').tobytes(),
                        'little')


def _sceneRows(scene, histSpec):
  '''Extract python-float scene constants (host side). Returns
  (surfRows, elemRows, nStages, masks, triRows): one dict per surface row (kind,
  world->local rotation r00..r22 and offset t0..t2, orient, elemF, p0..p8,
  trim0..trim4, the unclamped (trim1, trim2) `_rawTrim`, stage bitmask
  `stages`; a triangle's `triE1`, `triE2`,
  `triN` formed in double from its float32 vertices; a bitmap-trimmed
  surface's `maskSlot` and `maskRes`; a hole-primitive surface's
  `holePrims`, its active rows) and per element (optF, n, refl, absLen,
  rec, detF, histogram bounds, grating type / lines per mm / line
  direction / order, `nPoly` = (mid, half, ascending coefficients) or
  None), the number of sequential stages (0 without sequential mode) and
  the distinct (R, R) bitmaps the surfaces' `maskSlot` index, and the
  rows of the triangle table (`tableTriangles`; else empty): per triangle,
  in scene order, [v0, e1, e2, elemF, orient] in the WORLD frame as float64,
  its vertices mapped out of a non-identity row transform through
  R^T (v - t) in double, and the entries of the surface table
  (`tableSurfaces`; else empty): per surface, in scene order, (kind, trim0,
  its float32 SURF_TABLE_COLS row, its `_boundingSphere`). The JAX
  package's `_sceneRows` (with `smemTris` and `smemSurfs` where it switches
  them on), step for step.

  Bit q of `stages` lets a ray whose stage index, clamped to nStages - 1,
  is q hit the surface. Without sequential mode the bitmask is 1 for a
  surface the source's mask allows and 0 for one it does not; with it, the
  bits of the surface's stages (0 for a masked surface). A surface whose
  bitmask is 0 is never hit, but keeps its row and its index.'''
  surf = scene['surfaces']
  packed = _hostArray(surf['packed']).astype(float)
  trims = _hostArray(surf['trim']).astype(float)
  kinds = _hostArray(surf['kind'])
  maskStack = _hostArray(surf['trimMasks']) if 'trimMasks' in surf else None
  maskIdx = _hostArray(surf['trimMaskIdx']) if 'trimMaskIdx' in surf \
      else None
  prims = _hostArray(surf['trimPrims']).astype(float) \
      if 'trimPrims' in surf else None
  allowed, seqSpec = _staticMasks(scene)
  masks, maskSlotOf = [], {}
  surfRows, triRows, surfEntries = [], [], []
  toTable = tableTriangles(scene) > 0
  toSurfTable = tableSurfaces(scene)
  for s in range(numSurfacesStatic(scene)):
    p = packed[s]
    if allowed is not None and s not in allowed:
      stages = 0
    elif seqSpec is None:
      stages = 1
    else:
      stages = _bitsToInt(seqSpec[1][s], seqSpec[0])
    row = dict(
        kind=int(kinds[s]),
        r00=float(p[0]), r01=float(p[1]), r02=float(p[2]),
        r10=float(p[3]), r11=float(p[4]), r12=float(p[5]),
        r20=float(p[6]), r21=float(p[7]), r22=float(p[8]),
        t0=float(p[9]), t1=float(p[10]), t2=float(p[11]),
        orient=float(p[12]), elemF=float(p[13]),
        **{f'p{k}': float(p[15 + k]) for k in range(9)},
        trim0=float(trims[s, 0]), trim1=float(trims[s, 1]),
        trim2=float(min(trims[s, 2], _BIG)), trim3=float(trims[s, 3]),
        trim4=float(trims[s, 4]), stages=stages,
        # the unclamped window, for the host's bounding spheres and culls
        _rawTrim=(float(trims[s, 1]), float(trims[s, 2])),
        ident=bool(np.allclose(p[0:9], np.eye(3).reshape(-1), atol=1e-12)
                   and np.allclose(p[9:12], 0., atol=1e-12)))
    if row['kind'] == GS.TRIANGLE and toTable:
      v = np.array([row[f'p{k}'] for k in range(9)]).reshape(3, 3)
      if not row['ident']:
        Rm = np.array([row[k] for k in ('r00', 'r01', 'r02', 'r10', 'r11',
                                        'r12', 'r20', 'r21', 'r22')])
        Rm = Rm.reshape(3, 3)
        tv = np.array([row['t0'], row['t1'], row['t2']])
        v = np.stack([Rm.T @ (vk - tv) for vk in v])
      triRows.append(np.concatenate([v[0], v[1] - v[0], v[2] - v[0],
                                     [row['elemF'], row['orient']]]))
      continue
    if toSurfTable[s]:
      surfEntries.append((row['kind'], row['trim0'], np.array(
          [row[k] for k in _SURF_TABLE_KEYS], dtype=np.float32),
          _boundingSphere(row)))
      continue
    if row['kind'] == GS.TRIANGLE:
      v0 = np.array([row['p0'], row['p1'], row['p2']])
      e1 = np.array([row['p3'], row['p4'], row['p5']]) - v0
      e2 = np.array([row['p6'], row['p7'], row['p8']]) - v0
      nT = np.cross(e1, e2)
      nT = nT / max(np.linalg.norm(nT), 1e-30)
      row['triE1'] = tuple(float(x) for x in e1)
      row['triE2'] = tuple(float(x) for x in e2)
      row['triN'] = tuple(float(x) for x in nT)
    if row['trim0'] == 2.:
      mi = int(maskIdx[s])
      if mi not in maskSlotOf:
        maskSlotOf[mi] = len(masks)
        masks.append(np.asarray(maskStack[mi]))
      row['maskSlot'] = maskSlotOf[mi]
      row['maskRes'] = int(maskStack[mi].shape[0])
    elif row['trim0'] in (3., 4.):
      row['holePrims'] = tuple(tuple(float(x) for x in hole)
                               for hole in prims[s] if hole[0] > 0.5)
    surfRows.append(row)
  ep = _hostArray(scene['elements']['packed']).astype(float)
  elemToDet = _hostArray(histSpec['elemToDet'])
  boundsArr = _hostArray(histSpec['bounds'])
  nPolys = _dispersionPolys(scene)
  elemRows = []
  for e in range(ep.shape[0]):
    det = int(elemToDet[e])
    b = boundsArr[det] if det >= 0 else np.array([0., 1., 0., 1.])
    absLen = float(ep[e, 3])
    elemRows.append(dict(
        optF=float(ep[e, 0]), n=float(ep[e, 1]), refl=float(ep[e, 2]),
        absLen=absLen if np.isfinite(absLen) else _BIG,
        rec=float(ep[e, 10]), detF=float(det),
        bx0=float(b[0]), bx1=float(b[1]), by0=float(b[2]), by1=float(b[3]),
        gratType=float(ep[e, EP_GRATTYPE]),
        gratLpm=float(max(ep[e, EP_GRATLPM], 1e-9)),
        gratDirX=float(ep[e, EP_GRATDIRX]),
        gratDirY=float(ep[e, EP_GRATDIRY]),
        gratDirZ=float(ep[e, EP_GRATDIRZ]),
        gratOrder=float(ep[e, EP_GRATORDER]), nPoly=nPolys.get(e)))
  return (surfRows, elemRows, (seqSpec[0] if seqSpec is not None else 0),
          masks, triRows, surfEntries)


# the columns of a surface-table row, from a `_sceneRows` row dict
_SURF_TABLE_KEYS = ('r00', 'r01', 'r02', 'r10', 'r11', 'r12', 'r20', 'r21',
                    'r22', 't0', 't1', 't2', 'orient', 'elemF', 'p0', 'p1',
                    'p2', 'p3', 'p4', 'trim1', 'trim2')


def _boundingSphere(row):
  '''Conservative world-frame bounding sphere (centre, radius) of a
  surface row or surface-table entry, or None where the surface is
  unbounded (an infinite trim), carries a bitmap trim (its trim columns are
  a UV chart, not a window) or a boolean-ADD hole primitive (area beyond the
  base window): such a surface is never culled. The JAX package's
  `_boundingSphere`.'''
  for hole in row.get('holePrims', ()):
    flag = float(hole[0])
    if flag > 0.5 and 5.5 < (flag - 20. if flag > 15.5 else flag) < 15.5:
      return None                   # an ADD primitive
  if row.get('trim0') == 2.:
    return None                     # a bitmap trim
  kind = row['kind']
  t1, t2 = row['_rawTrim']          # UNclamped (trim2 may be +inf)
  c = np.zeros(3)
  if kind == GS.PLANE:
    # window (1) and primitive-trimmed window (4): the half-diagonal
    rho = float(np.hypot(t1, t2)) if row['trim0'] in (1., 4.) else t2
  elif kind == GS.SPHERE:
    rho = row['p0']
  elif kind == GS.CYLINDER:
    if not (np.isfinite(t1) and np.isfinite(t2)):
      return None
    c[2] = (t1 + t2) / 2.
    rho = float(np.hypot(row['p0'], (t2 - t1) / 2.))
  elif kind == GS.CONE:
    if not (np.isfinite(t1) and np.isfinite(t2)):
      return None
    c[2] = (t1 + t2) / 2.
    rMax = max(abs(row['p0'] + t1 * row['p1']),
               abs(row['p0'] + t2 * row['p1']))
    rho = float(np.hypot(rMax, (t2 - t1) / 2.))
  elif kind == GS.ASPHERE:
    if not np.isfinite(t2):
      return None
    c0, kk = row['p0'], row['p1']
    r2 = t2 * t2
    root = np.sqrt(max(1. - (1. + kk) * c0 * c0 * r2, 1e-12))
    sag = c0 * r2 / (1. + root) + r2 * r2 * (
        row['p2'] + r2 * (row['p3'] + r2 * row['p4']))
    rho = float(t2 + abs(sag))
  elif kind == GS.QUADRIC:
    if not (np.isfinite(t1) and np.isfinite(t2)):
      return None
    qa, qb = row['p0'], row['p1']
    if qa <= 0 or qb <= 0:
      return None
    # w(z) = -(p2 z^2 + p3 z + p4) is quadratic: its largest value on
    # [t1, t2] is at an end or at the vertex
    zs = [t1, t2]
    if abs(row['p2']) > 0:
      zv = -row['p3'] / (2. * row['p2'])
      if t1 < zv < t2:
        zs.append(zv)
    w = [-(row['p2'] * z * z + row['p3'] * z + row['p4']) for z in zs]
    rMax = float(np.sqrt(max(max(w), 0.) / min(qa, qb)))
    c[2] = (t1 + t2) / 2.
    rho = float(np.hypot(rMax, (t2 - t1) / 2.))
  elif kind == GS.TORUS:
    rho = row['p0'] + row['p1']
  elif kind == GS.TRIANGLE:
    v = np.array([row[f'p{k}'] for k in range(9)]).reshape(3, 3)
    c = v.mean(0)
    rho = float(max(np.linalg.norm(vk - c) for vk in v))
  else:
    return None
  if not np.isfinite(rho):
    return None
  if row['ident']:
    return c, rho
  R = np.array([[row['r00'], row['r01'], row['r02']],
                [row['r10'], row['r11'], row['r12']],
                [row['r20'], row['r21'], row['r22']]])
  tv = np.array([row['t0'], row['t1'], row['t2']])
  # local = R world + t, so the world point of local c is R^T (c - t)
  return R.T @ (c - tv), rho


def _firstBounceSurfs(surfRows, bound):
  '''Indices (into surfRows) of the rows REACHABLE at bounce 0 from the
  source's emission envelope `bound` (originCenter, axis, cosAlpha,
  originRadius: `PointSource.emissionBound`): a row whose bounding sphere
  lies wholly outside the cone fattened by the origin radius cannot be the
  first hit of any ray. Rows without a bounding sphere always stay. The JAX
  package's `_firstBounceSurfs`.'''
  o, axis, cosA, rO = bound
  o = np.asarray(o, float)
  axis = np.asarray(axis, float)
  axis = axis / max(np.linalg.norm(axis), 1e-30)
  alpha = float(np.arccos(np.clip(cosA, -1., 1.)))
  keep = []
  for s, row in enumerate(surfRows):
    bs = _boundingSphere(row)
    if bs is None:
      keep.append(s)
      continue
    cw, rho = bs
    rho = rho + rO
    d = cw - o
    dist = float(np.linalg.norm(d))
    if dist <= rho:
      keep.append(s)
      continue
    beta = float(np.arccos(np.clip(float(d @ axis) / dist, -1., 1.)))
    if beta <= alpha + np.arcsin(min(rho / dist, 1.)) + 1e-6:
      keep.append(s)
  return keep


def _cullSets(surfRows, elemRows, scatterConsts, emissionBound,
              maxIntersections, surfAllowed, triRows, surfEntries):
  '''The surface rows each bounce sweeps (ROADMAP B12): a list of
  `maxIntersections` entries, each the ascending row positions that can be
  that bounce's hit (ascending, so the lowest index still wins a tie), or
  None for a full sweep. `surfAllowed` is the sorted row positions the
  source's mask and the stage sets admit (None: every row); a set equal to
  it is full. The sets come from `beam_cull.propagateBounceSets`, bounce 0's
  cut further to `_firstBounceSurfs`; where the triangle or surface table
  (`triRows`, `surfEntries`, which the propagation cannot see) holds a
  mirror, lens, grating or scattering element, only bounce 0 culls. The
  JAX package's `_beamCullSets` without the unrolled prefix and the tail
  union of its Mosaic loop: each bounce here sweeps its own set, which
  never holds a row that the reference's set for that bounce lacks.'''
  tableElems = {int(r[9]) for r in triRows}
  tableElems |= {int(e[2][13]) for e in surfEntries}
  scatterElems = {int(c[0]) for c in (scatterConsts or ())}
  unsafe = any(elemRows[e]['optF'] not in (float(ABSORBER), float(VACUUM))
               or e in scatterElems for e in tableElems)
  sets = beam_cull.propagateBounceSets(
      surfRows, elemRows, scatterConsts, emissionBound, maxIntersections,
      allowed=surfAllowed, unsafeAfterBounce0=unsafe,
      boundingSphere=_boundingSphere)
  if sets and sets[0] is not None:
    first = set(_firstBounceSurfs(surfRows, emissionBound))
    sets[0] = [s for s in sets[0] if s in first]
  everyRow = (list(range(len(surfRows))) if surfAllowed is None
              else sorted(surfAllowed))
  return [None if ss is None or ss == everyRow else ss for ss in sets]


def _cullBlock(sets, nRows, base, room):
  '''The cull block of the kernels' table for the per-bounce `sets` of
  `_cullSets` over `nRows` surface rows, as int32 words bit-cast into
  float32, to be placed at table offset `base` with `room` words to spare;
  or None where no bounce culls. Layout: the bounce count B, then per
  bounce the table offset of its set (-1 for a full sweep), then the sets,
  each ceil(nRows / 32) uint32 words with bit s for row s, a set stored
  once however many bounces sweep it. A set that does not fit in `room` is
  swept in full instead (never wrong, only not culled), so the block never
  pushes the table past MAX_TABLE_BYTES: at maxIntersections 100 and 256
  rows the offsets take 101 words and each distinct set 8.'''
  B, nWords = len(sets), -(-nRows // 32)
  if all(ss is None for ss in sets) or 1 + B > room:
    return None
  words = [B] + [-1] * B
  offsetOf = {}
  for b, ss in enumerate(sets):
    if ss is None:
      continue
    key = tuple(ss)
    if key not in offsetOf:
      if len(words) + nWords > room:
        continue                    # no room: this bounce sweeps in full
      bits = np.zeros(32 * nWords, bool)
      bits[list(key)] = True
      offsetOf[key] = base + len(words)
      words += np.packbits(bits, bitorder='little').view('<u4') \
          .view(np.int32).tolist()
    words[1 + b] = offsetOf[key]
  if all(w < 0 for w in words[1:1 + B]):
    return None
  return np.asarray(words, np.int32).view(np.float32)


def _dummySurfRow(kind, trim0):
  '''A surface-table row that no ray hits (an empty trim window, well-
  conditioned params): what pads a chunked run's last chunk to _SURF_CHUNK
  rows. The JAX package's `_dummySurfRow`.'''
  t1, t2 = (-1., -1.) if trim0 == 1. else (2., 1.)
  return np.array([1., 0., 0., 0., 1., 0., 0., 0., 1.,   # identity rotation
                   0., 0., 0., 1., 0.,                    # off, orient, elem
                   1., 1., 0., 0., 0.,                    # p0..p4
                   t1, t2], dtype=np.float32)


def _chunkSurfRows(entries):
  '''The surface table of `_sceneRows`' entries (kind, trim0, row, bounding
  sphere) and its sweep structure, as the JAX package's `_chunkSurfRows`
  makes them: the entries sorted stably by (kind, trim0) into runs; a run
  longer than _SURF_CHUNK whose members all have a bounding sphere in Morton
  order of the centres, cut into chunks of _SURF_CHUNK rows (the last padded
  with `_dummySurfRow`), each with the world AABB of its members' spheres
  padded by 1e-5 of its largest coordinate (at least 1e-5); the other runs
  as they are. Returns (float32 (nRows, SURF_TABLE_COLS) table, plain runs
  ((kind, trim0, rowStart, rowStop), ...), float32 (nChunks, BOX_COLS)
  boxes, chunked runs ((kind, trim0, chunkStart, chunkStop, rowStart),
  ...)).'''
  return _surfTableParts(entries)[:4]


def _surfTableParts(entries):
  '''`_chunkSurfRows`' table, runs and chunk boxes, and the float32
  (nChunks * _SURF_CHUNK // _SURF_LEAF, BOX_COLS) leaf boxes of the chunks,
  _SURF_LEAF rows each in chunk order: the AABB of the leaf's members'
  spheres padded as the chunk boxes are, formed in float64 and rounded
  once; a leaf of nothing but padding rows `_EMPTY_LEAF`.'''
  entries = sorted(entries, key=lambda e: (e[0], e[1]))
  grouped = []
  for ent in entries:
    if grouped and grouped[-1][0] == ent[0] and grouped[-1][1] == ent[1]:
      grouped[-1][2].append(ent)
    else:
      grouped.append((ent[0], ent[1], [ent]))
  tableRows, plainRuns, chunkBoxes, chunkRuns, leaves = [], [], [], [], []
  for kind, trim0, run in grouped:
    spheres = [e[3] for e in run]
    if len(run) > _SURF_CHUNK and all(b is not None for b in spheres):
      cen = np.array([b[0] for b in spheres], np.float64)
      rho = np.array([b[1] for b in spheres], np.float64)
      order = _mortonOrder(cen)
      run = [run[i] for i in order]
      cen, rho = cen[order], rho[order]
      rowStart, c0 = len(tableRows), len(chunkBoxes)
      nCh = -(-len(run) // _SURF_CHUNK)
      for c in range(nCh):
        sl = slice(c * _SURF_CHUNK, min((c + 1) * _SURF_CHUNK, len(run)))
        lo = (cen[sl] - rho[sl, None]).min(0)
        hi = (cen[sl] + rho[sl, None]).max(0)
        pad = 1e-5 * max(1., float(np.abs(np.stack([lo, hi])).max()))
        chunkBoxes.append(np.concatenate([lo - pad, hi + pad]))
        for a in range(c * _SURF_CHUNK, (c + 1) * _SURF_CHUNK, _SURF_LEAF):
          b = min(a + _SURF_LEAF, len(run))
          leaves.append(_paddedBox(np.concatenate(
              [cen[a:b] - rho[a:b, None], cen[a:b] + rho[a:b, None]]))
              if a < b else _EMPTY_LEAF)
        rows = [e[2] for e in run[sl]]
        rows += [_dummySurfRow(kind, trim0)] * (_SURF_CHUNK - len(rows))
        tableRows += rows
      chunkRuns.append((kind, trim0, c0, c0 + nCh, rowStart))
    else:
      rowStart = len(tableRows)
      tableRows += [e[2] for e in run]
      plainRuns.append((kind, trim0, rowStart, rowStart + len(run)))
  table = (np.stack(tableRows).astype(np.float32) if tableRows
           else np.zeros((0, SURF_TABLE_COLS), np.float32))
  boxes = (np.stack(chunkBoxes).astype(np.float32) if chunkBoxes
           else np.zeros((0, BOX_COLS), np.float32))
  leaves = (np.stack(leaves).astype(np.float32) if leaves
            else np.zeros((0, BOX_COLS), np.float32))
  return table, tuple(plainRuns), boxes, tuple(chunkRuns), leaves


def surfaceRuns(plainRuns, chunkRuns):
  '''The runs of a surface table in the kernels' sweep order and form
  (plain runs, then chunked runs; MAX_SURF_RUNS rows of RUN_COLS ints: kind,
  trim0, first, last, rowStart, chunked, group0: a chunked run's first
  group box, `groupSpans`).'''
  runs = [(k, int(t0), a, b, a, 0, 0) for k, t0, a, b in plainRuns]
  g0 = 0
  for k, t0, c0, c1, r0 in chunkRuns:
    runs.append((k, int(t0), c0, c1, r0, 1, g0))
    g0 += -(-(c1 - c0) // SWEEP_GROUP)
  assert len(runs) <= MAX_SURF_RUNS
  return runs


def groupSpans(spans):
  '''The chunk ranges [first, last) of the group boxes over chunk ranges
  `spans` ((first, last), ...: the whole triangle table, or each chunked
  run of the surface table): each span cut into SWEEP_GROUP chunks a group,
  the last group shorter, so that no group spans two runs.'''
  return [(c, min(c + SWEEP_GROUP, c1)) for c0, c1 in spans
          for c in range(c0, c1, SWEEP_GROUP)]


def _groupBoxes(boxes, spans):
  '''float32 (nGroups, BOX_COLS) group boxes of float32 chunk `boxes` over
  chunk ranges `spans` (`groupSpans`): each the union of its chunks' boxes
  (the least lo, the largest hi; no padding of its own), so a segment that
  enters a chunk's box, tested in the same float32 operations, enters its
  group's.'''
  out = [np.concatenate([boxes[a:b, :3].min(0), boxes[a:b, 3:].max(0)])
         for a, b in groupSpans(spans)]
  return (np.stack(out).astype(np.float32) if out
          else np.zeros((0, BOX_COLS), np.float32))


def _boxPack(groups, boxes, leaves):
  '''The kernels' box pack of a table (numpy, any leading dimensions): its
  group boxes, then its chunk boxes, then its leaf boxes, each widened to
  BOX_STRIDE floats (lo xyz, 0, hi xyz, 0).'''
  both = np.concatenate([groups, boxes, leaves], axis=-2)
  pack = np.zeros(both.shape[:-1] + (BOX_STRIDE,), np.float32)
  pack[..., 0:3] = both[..., 0:3]
  pack[..., 4:7] = both[..., 3:6]
  return pack


def _paddedBox(pts):
  '''The float64 [lo xyz, hi xyz] AABB of (n, 3) float64 points padded by
  1e-5 of its largest coordinate (at least 1e-5): the chunk boxes' padding
  (the JAX package's `_chunkTriangles`), so that a leaf's box, formed from
  a subset of its chunk's points, lies inside the chunk's box.'''
  lo, hi = pts.min(0), pts.max(0)
  pad = 1e-5 * max(1., float(np.abs(np.stack([lo, hi])).max()))
  return np.concatenate([lo - pad, hi + pad])


def _triLeafBoxes(triTable, nChunks):
  '''The float32 (ceil(nTri / _TRI_LEAF), BOX_COLS) leaf boxes of the
  Morton-ordered triangle table of `_chunkTriangles`: the padded world AABB
  of each _TRI_LEAF rows' vertices, formed in float64 and rounded once (a
  table swept flat, `nChunks` 0, has none).'''
  n = len(triTable) if nChunks else 0
  v0 = triTable[:n, 0:3].astype(np.float64)
  pts = np.stack([v0, v0 + triTable[:n, 3:6], v0 + triTable[:n, 6:9]], 1)
  out = [_paddedBox(pts[a:a + _TRI_LEAF].reshape(-1, 3))
         for a in range(0, n, _TRI_LEAF)]
  return (np.stack(out).astype(np.float32) if out
          else np.zeros((0, BOX_COLS), np.float32))


def triLeafCount(nTri, nChunks):
  '''The leaf boxes of a triangle table of `nTri` rows in `nChunks`
  chunks (the kernels' `triLeaves`).'''
  return -(-nTri // _TRI_LEAF) if nChunks else 0


def _mortonOrder(cen):
  '''Stable Morton (Z-curve) order of (n, 3) points: rows close in space
  land in one chunk, so the chunks' boxes stay tight. The JAX package's
  `_mortonOrder`.'''
  cen = np.asarray(cen, np.float64)
  lo, hi = cen.min(0), cen.max(0)
  span = np.maximum(hi - lo, 1e-12)
  q = np.clip(((cen - lo) / span * 1023.).astype(np.int64), 0, 1023)

  def spread(x):
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x

  code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
  return np.argsort(code, kind='stable')


def _chunkTriangles(triTable):
  '''The float32 (nTri, TRI_COLS) triangle table in Morton order of its
  centroids, and its (nChunks, BOX_COLS) float32 chunk boxes [lo xyz, hi
  xyz]: the world AABB of each _TRI_CHUNK rows, padded by 1e-5 of the
  largest coordinate (at least 1e-5). A table of one chunk or less keeps its
  order and gets no boxes (it is swept flat). The JAX package's
  `_chunkTriangles`.'''
  n = len(triTable)
  if n <= _TRI_CHUNK:
    return triTable, np.zeros((0, BOX_COLS), np.float32)
  v0 = triTable[:, 0:3].astype(np.float64)
  v1 = v0 + triTable[:, 3:6]
  v2 = v0 + triTable[:, 6:9]
  order = _mortonOrder((v0 + v1 + v2) / 3.)
  triTable = triTable[order]
  v0, v1, v2 = v0[order], v1[order], v2[order]
  nChunks = -(-n // _TRI_CHUNK)
  boxes = np.zeros((nChunks, BOX_COLS), np.float64)
  for c in range(nChunks):
    sl = slice(c * _TRI_CHUNK, min((c + 1) * _TRI_CHUNK, n))
    pts = np.concatenate([v0[sl], v1[sl], v2[sl]])
    pad = 1e-5 * max(1., float(np.abs(pts).max()))
    boxes[c, :3] = pts.min(0) - pad
    boxes[c, 3:] = pts.max(0) + pad
  return triTable, boxes.astype(np.float32)


def autoHitSlots(scene, histSpec, maxIntersections):
  '''Topology-derived hit-slot count: per recording element, the number of
  possible passes is 1 for an absorber (the ray dies there) and
  1 + (number of OTHER reflective elements) otherwise — a ray can only
  re-cross a pass-through detector after being turned around. Capped at
  MAX_HIT_SLOTS and at maxIntersections; the `hitOverflow` counter reports
  any dropped passes beyond the cap.'''
  opts = _hostArray(scene['elements']['optType'])
  ep = _hostArray(scene['elements']['packed'])
  elemToDet = _hostArray(histSpec['elemToDet'])
  reflective = (opts == MIRROR) | ((opts == GRATING)
                                   & (ep[:, EP_GRATTYPE] == 0))
  nReflect = int(reflective.sum())
  bound = 0
  for e in np.nonzero(elemToDet >= 0)[0]:
    if opts[e] == ABSORBER:
      bound += 1
    else:
      bound += 1 + nReflect - int(reflective[e])
  return max(1, min(maxIntersections, bound, MAX_HIT_SLOTS))


def tileStrata(raysPerStep, strataTile):
  '''(G1, G2) of the ray-index strata: cell = rayIndex // strataTile, the
  cells form a G1 x G2 latin grid over the two sampler quantiles (G2 the
  power of two nearest below sqrt(cells)). None when the step does not
  decompose.'''
  if strataTile <= 0 or raysPerStep % strataTile:
    return None
  nCells = raysPerStep // strataTile
  if nCells <= 1:
    return None
  G2 = 1 << (max(int(nCells).bit_length() - 1, 0) // 2)
  G1 = nCells // G2
  return (int(G1), int(G2)) if G1 * G2 == nCells else None


def _packMarginal(spec):
  '''One marginal of the sampler spec as a (_MARG_LEN,) float32 block:
  [kind, n, lo, hi | span, payload]. affine: kind 0, lo and the span hi-lo
  (formed in double like the reference's python constants). pwpoly: kind 1,
  n segments of (a, mid, 1/half, nCoef, ascending coefficients), clamp
  [lo, hi]. table: kind 2, n tent knots.'''
  out = np.zeros(_MARG_LEN, np.float64)
  kind = spec[0]
  if kind == 'affine':
    _, lo, hi = spec
    out[:4] = (0., 0., lo, hi - lo)
  elif kind == 'pwpoly':
    _, segs, lo, hi = spec
    if len(segs) > MAX_PWPOLY_SEGMENTS:
      raise ValueError(f'{len(segs)} pwpoly segments > {MAX_PWPOLY_SEGMENTS}')
    out[:4] = (1., len(segs), lo, hi)
    for i, (a, _b, mid, half, coeffs) in enumerate(segs):
      if len(coeffs) > MAX_PWPOLY_COEFFS:
        raise ValueError(f'pwpoly degree {len(coeffs) - 1} > '
                         f'{MAX_PWPOLY_COEFFS - 1}')
      o = 4 + i * _SEG_STRIDE
      out[o:o + 4] = (a, mid, 1.0 / half, len(coeffs))
      out[o + 4:o + 4 + len(coeffs)] = coeffs
  elif kind == 'table':
    _, table = spec
    if len(table) > MAX_TENT_KNOTS or len(table) < 2:
      raise ValueError(f'{len(table)} tent knots outside [2, '
                       f'{MAX_TENT_KNOTS}]')
    out[:4] = (2., len(table), 0., 0.)
    out[4:4 + len(table)] = table
  else:
    raise ValueError(f'unknown marginal kind {kind!r}')
  return out.astype(np.float32)


def _kindConstants(r):
  '''The nine kind constants of a surface row (G_X), each formed in double
  from the row's float32 params and rounded once, as the reference bakes
  them: triangle (e1, e2, unit normal); asphere ((1+k) c^2, 1/c, 1/c^2,
  1 where the sphere seed applies); torus ((r/R)^2, r^2, the residual
  gate 2e-3 r^2 + 1e-6 R^2).'''
  out = np.zeros(9)
  if r['kind'] == GS.TRIANGLE:
    out[:] = r['triE1'] + r['triE2'] + r['triN']
  elif r['kind'] == GS.ASPHERE:
    c0, kk = r['p0'], r['p1']
    out[0] = (1 + kk) * c0 * c0
    if abs(c0) > 1e-12:
      R = 1. / c0
      out[1:4] = (R, R * R, 1.)
  elif r['kind'] == GS.TORUS:
    R0, rT = r['p0'], r['p1']
    out[:3] = ((rT / R0) ** 2, rT * rT, 2e-3 * rT * rT + 1e-6 * R0 * R0)
  return out


def _primRow(hole):
  '''One hole primitive (flag, cx, cy, p0, p1, cosA, sinA) as the kernel's
  row: shape, isAdd, isInverted decoded from the flag as the reference
  decodes it, then the six payload values.'''
  flag = hole[0]
  isInv = flag > 15.5
  rem = flag - 20. if isInv else flag
  isAdd = rem > 5.5
  shape = rem - 10. if isAdd else rem
  return (shape, float(isAdd), float(isInv)) + tuple(hole[1:7])


def _packTable(scene, histSpec, samplerSpec=None, marginalCache=None,
               emissionBound=None, maxIntersections=0):
  '''The kernel's table of one compiled scene as host numpy, and its static
  facts: (float32 (tableLen,) array, dict(nSurf, nElem, nTri, nTriChunks,
  nTriGroups, nTriLeaves, triTable, triBoxes, triGroups, triLeaves,
  nSurfTable, nSurfChunks, nSurfGroups, nSurfLeaves, surfTable, surfBoxes,
  surfGroups, surfLeaves, surfPlainRuns,
  surfChunkRuns, samplerOff, bins, nDet, anyMedium, hasGrating,
  nStages, gate, dispOff, cullOff, geom, surfRows, elemRows, samplerSpec,
  scatter, scatterConsts, scatterRows, lobeRows, modRows)).
  With the source's `emissionBound` (see `_cullSets`) the table ends with
  the cull block of the first `maxIntersections` bounces (`_cullBlock`) at
  `cullOff`; -1 where there is no bound or no bounce culls anything.
  `triTable` / `triBoxes` are the float32 triangle table and its chunk
  boxes (`_chunkTriangles`) of a mesh past TABLE_TRIANGLES, else None;
  `surfTable` / `surfBoxes` the float32 surface table and its chunk boxes,
  `surfPlainRuns` / `surfChunkRuns` its runs (`_chunkSurfRows`) of a scene
  past MAX_SURFACES analytic surfaces, else None and (); `triGroups` /
  `surfGroups` their group boxes (`_groupBoxes`); none of them is
  part of `table`, and `nSurf` counts the surface rows only.
  `gate` says some surface is not always allowed (a masked surface, or
  sequential mode), `dispOff` where the dispersion block starts (-1: no
  dispersive element); these and hasGrating / nStages are the kernel's
  header flags, so a scene without them skips that code. `geom` says the
  surface rows are widened by GEOM_COLS (a kind or trim of B2 / B3; the
  kernels' GEOM instance). `scatter` says
  the table holds a scatter block (right after the element rows), drawn
  from `scatterRows` uniforms per bounce (`lobeRows` for the lobe, then
  `modRows` for MODIFY).
  `triLeaves` / `surfLeaves` (`_triLeafBoxes`, `_surfTableParts`) their
  leaf boxes, `nTriLeaves` / `nSurfLeaves` their counts.
  `marginalCache` (a dict) lets several calls that share marginal specs
  pack each only once. Raises ValueError for scenes the kernel does not
  cover.'''
  reason = ineligibleReason(scene)
  if reason is not None:
    raise ValueError(f'scene is not eligible for the CUDA trace kernel: '
                     f'{reason}')
  surfRows, elemRows, nStages, masks, triRows, surfEntries = _sceneRows(
      scene, histSpec)
  S, E = len(surfRows), len(elemRows)
  triTable = triBoxes = triGroups = triLeaves = None
  if triRows:
    triTable, triBoxes = _chunkTriangles(np.asarray(triRows, np.float32))
    triGroups = _groupBoxes(triBoxes, [(0, len(triBoxes))])
    triLeaves = _triLeafBoxes(triTable, len(triBoxes))
  surfTable = surfBoxes = surfGroups = surfLeaves = None
  plainRuns = chunkRuns = ()
  if surfEntries:
    surfTable, plainRuns, surfBoxes, chunkRuns, surfLeaves = \
        _surfTableParts(surfEntries)
    surfGroups = _groupBoxes(surfBoxes, [r[2:4] for r in chunkRuns])
  geom = needsGeom(scene)
  rowCols = SURF_COLS + (GEOM_COLS if geom else 0)
  surfT = np.zeros((S, rowCols), np.float64)
  for s, r in enumerate(surfRows):
    annulus = r['kind'] == GS.PLANE and r['trim0'] in (0., 3.)
    # constants the reference squares in double before rounding to float32
    tA, tB = ((r['trim1'] ** 2, r['trim2'] ** 2) if annulus
              else (r['trim1'], r['trim2']))
    surfT[s, :SURF_COLS - 1] = [
        r['kind'], r['r00'], r['r01'], r['r02'], r['r10'], r['r11'],
        r['r12'], r['r20'], r['r21'], r['r22'], r['t0'], r['t1'], r['t2'],
        r['orient'], r['elemF'], r['p0'] ** 2, r['trim0'], tA, tB]
    if geom:
      surfT[s, G_P:G_P + 5] = [r[f'p{k}'] for k in range(5)]
      surfT[s, G_X:G_X + 9] = _kindConstants(r)
      surfT[s, G_TRIM3:G_TRIM4 + 1] = (r['trim3'], r['trim4'])
      surfT[s, G_MASKRES] = r.get('maskRes', 0)
      surfT[s, G_NPRIM] = len(r.get('holePrims', ()))
  elemT = np.zeros((E, ELEM_COLS), np.float64)
  dispT = np.zeros((E, DISP_COLS), np.float64)
  for e, r in enumerate(elemRows):
    elemT[e] = [r['optF'], r['n'], r['refl'], r['absLen'], r['rec'],
                r['detF'], r['bx0'], r['bx1'], r['by0'], r['by1'],
                float(r['optF'] in (float(LENS), float(GRATING))),
                float(r['nPoly'] is not None), r['gratType'], r['gratLpm'],
                r['gratDirX'], r['gratDirY'], r['gratDirZ'], r['gratOrder']]
    if r['nPoly'] is not None:
      # the reference's constants: mid and 1/half formed in double, each
      # rounded to float32 once, like every coefficient
      mid, half, coeffs = r['nPoly']
      dispT[e, :4] = (mid, 1.0 / half, len(coeffs), 0.)
      dispT[e, 4:4 + len(coeffs)] = coeffs
  parts = [elemT.astype(np.float32).reshape(-1)]
  consts = scatterConstantsOf(scene)
  scatFacts = dict(scatterRows=0, lobeRows=0, modRows=0)
  if consts:
    block, scatFacts = _packScatter(consts)
    parts.append(block)
  dispOff = -1
  if elemT[:, 11].any():
    dispOff = S * rowCols + sum(len(x) for x in parts)
    parts.append(dispT.astype(np.float32).reshape(-1))
  samplerOff, samplerKind = -1, SAMPLER_POINT
  if samplerSpec is not None and samplerSpec.get('type') == 'surface':
    samplerKind = SAMPLER_SURFACE
    samplerOff = S * rowCols + sum(len(x) for x in parts)
    parts.extend(_packSurfaceSampler(samplerSpec))
  elif samplerSpec is not None:
    place = np.zeros(_SAMPLER_GEOM, np.float32)
    place[0] = 1. if samplerSpec['finite'] else 0.
    place[1] = samplerSpec['f']
    place[2:11] = np.asarray(samplerSpec['R'], float).reshape(-1)
    place[11:14] = samplerSpec['off']
    place[14] = samplerSpec['wavelength']
    samplerOff = S * rowCols + sum(len(x) for x in parts)
    parts.append(place)
    for key in ('first', 'phi'):
      spec = samplerSpec[key]
      block = None if marginalCache is None else marginalCache.get(id(spec))
      if block is None:
        block = _packMarginal(spec)
        if marginalCache is not None:
          marginalCache[id(spec)] = block
      parts.append(block)
  # the blocks the surface rows point into: stage words, bitmap words,
  # hole-primitive rows
  gate = any(r['stages'] != (1 << max(nStages, 1)) - 1 for r in surfRows)
  base = S * rowCols + sum(len(x) for x in parts)
  tail = []
  if gate:
    nWords = max(1, -(-nStages // 32))
    words = np.zeros((S, nWords), np.uint32)
    for s, r in enumerate(surfRows):
      surfT[s, 19] = base + s * nWords
      words[s] = np.frombuffer(r['stages'].to_bytes(4 * nWords, 'little'),
                               '<u4')
    tail.append(words.reshape(-1).view(np.float32))
    base += words.size
  maskOff = []
  for m in masks:
    maskOff.append(base)
    bits = np.packbits((np.asarray(m) > 0).reshape(-1), bitorder='little')
    bits = np.concatenate([bits, np.zeros(-len(bits) % 4, np.uint8)])
    tail.append(bits.view('<u4').astype(np.uint32).view(np.float32))
    base += len(tail[-1])
  for s, r in enumerate(surfRows):
    if 'maskSlot' in r:
      surfT[s, G_MASKOFF] = maskOff[r['maskSlot']]
    if r.get('holePrims'):
      surfT[s, G_PRIMOFF] = base
      rows = np.array([_primRow(h) for h in r['holePrims']], np.float64)
      tail.append(rows.astype(np.float32).reshape(-1))
      base += len(tail[-1])
  cullOff = -1
  if emissionBound is not None and maxIntersections > 0:
    allowed = [s for s, r in enumerate(surfRows) if r['stages'] != 0]
    sets = _cullSets(surfRows, elemRows, consts, emissionBound,
                     int(maxIntersections),
                     None if len(allowed) == S else allowed, triRows,
                     surfEntries)
    block = _cullBlock(sets, S, base, MAX_TABLE_BYTES // 4 - base)
    if block is not None:
      cullOff = base
      tail.append(block)
      base += len(block)
  with np.errstate(over='ignore'):      # an unbounded radius squares to inf
    parts = [surfT.astype(np.float32).reshape(-1)] + parts + tail
  H, W = histSpec['bins']
  table = np.concatenate(parts)
  assert len(table) == base
  if table.nbytes > MAX_TABLE_BYTES:
    raise ValueError(f"the kernel's table of {table.nbytes} bytes > the "
                     f'{MAX_TABLE_BYTES} a thread block holds in shared '
                     f'memory')
  return table, dict(
      nSurf=S, nElem=E, nTri=len(triRows),
      nTriChunks=0 if triBoxes is None else len(triBoxes),
      nTriGroups=0 if triGroups is None else len(triGroups),
      nTriLeaves=0 if triLeaves is None else len(triLeaves),
      triTable=triTable, triBoxes=triBoxes, triGroups=triGroups,
      triLeaves=triLeaves,
      nSurfTable=0 if surfTable is None else len(surfTable),
      nSurfChunks=0 if surfBoxes is None else len(surfBoxes),
      nSurfGroups=0 if surfGroups is None else len(surfGroups),
      nSurfLeaves=0 if surfLeaves is None else len(surfLeaves),
      surfTable=surfTable, surfBoxes=surfBoxes, surfGroups=surfGroups,
      surfLeaves=surfLeaves,
      surfPlainRuns=plainRuns,
      surfChunkRuns=chunkRuns,
      samplerOff=samplerOff, bins=(int(H), int(W)),
      nDet=int(_hostArray(histSpec['bounds']).shape[0]),
      anyMedium=bool(elemT[:, 10].any()),
      hasGrating=bool((elemT[:, 0] == GRATING).any()), nStages=nStages,
      gate=gate, dispOff=dispOff, cullOff=cullOff, geom=geom,
      surfRows=surfRows, elemRows=elemRows,
      samplerSpec=samplerSpec, samplerKind=samplerKind,
      scatter=bool(consts), scatterConsts=consts or None, **scatFacts)


def _packSurfaceSampler(spec):
  '''The sampler block of a surface source (`SurfaceSource.samplerSpec()`)
  as float32 parts: the geometry block, the theta marginal, the face rows
  (see FACE_COLS). Every constant is formed in double from the spec and
  rounded to float32 once, as the reference bakes its python constants.'''
  from ..models.surface_source import (MAX_SAMPLER_FACES,
                                      faceExtraConstants,
                                      faceSamplingConstants)
  faces = spec['faces']
  if not 1 <= len(faces) <= MAX_SAMPLER_FACES:
    raise ValueError(f'{len(faces)} emitting faces outside [1, '
                     f'{MAX_SAMPLER_FACES}]')
  geom = np.zeros(_SAMPLER_GEOM, np.float64)
  geom[0] = len(faces)
  geom[1] = 2. * np.pi
  geom[14] = spec['wavelength']
  rows = np.zeros((len(faces), FACE_COLS), np.float64)
  margs = []
  base = _SAMPLER_GEOM + _MARG_LEN + len(faces) * FACE_COLS
  for i, f in enumerate(faces):
    rows[i, 0] = f['kind']
    rows[i, 1] = 1. if f['trim'][0] > 0.5 else 0.
    rows[i, 2:6] = faceSamplingConstants(f)
    rows[i, 6:15] = np.asarray(f['R'], float).reshape(-1)
    rows[i, 15:18] = f['off']
    rows[i, 18:21] = (f['orient'], f['cumLo'], f['cumHi'])
    rows[i, F_X:] = faceExtraConstants(f)
    if f['kind'] in (GS.ASPHERE, GS.TORUS):
      rows[i, F_X] = base            # its radius / tube-angle marginal
      margs.append(_packMarginal(f['rSpec']))
      base += _MARG_LEN
  return [geom.astype(np.float32), _packMarginal(spec['theta']),
          rows.astype(np.float32).reshape(-1)] + margs


def buildTraceTables(scene, histSpec, samplerSpec=None, device='cuda',
                     emissionBound=None, maxIntersections=0):
  '''Pack a compiled scene (+ optionally a point- or surface-source
  sampler spec) into the kernel's tables. Returns a dict with the float32
  `table` tensor on `device` (surface rows, element rows, sampler block,
  the per-bounce culls of the source's `emissionBound` over
  `maxIntersections` bounces where it has one: `tableCullSets`), the
  `triTable` and `triBoxes` tensors of a mesh past TABLE_TRIANGLES and
  the `surfTable` and `surfBoxes` tensors of a scene past MAX_SURFACES
  analytic surfaces (or None), the host rows, and the static facts the
  step needs (bins, detector count, anyMedium, samplerKind).
  Raises ValueError for scenes the kernel does not cover.'''
  dev = resolveDevice(device)
  table, facts = _packTable(scene, histSpec, samplerSpec,
                            emissionBound=emissionBound,
                            maxIntersections=maxIntersections)
  return dict(facts, table=torch.as_tensor(table, device=dev),
              **_globalTensors(facts, dev))


# the tables the kernels read from device memory, beside the shared-memory
# table, and their box packs (`_boxPack`: pack -> (group boxes, chunk
# boxes, leaf boxes)), which the kernels read in place of the boxes
_GLOBAL_TABLES = ('triTable', 'triBoxes', 'triGroups', 'triLeaves',
                  'surfTable', 'surfBoxes', 'surfGroups', 'surfLeaves')
_BOX_PACKS = {'triBoxPack': ('triGroups', 'triBoxes', 'triLeaves'),
              'surfBoxPack': ('surfGroups', 'surfBoxes', 'surfLeaves')}


def _globalTensors(facts, dev):
  '''The triangle table, the surface table, their chunk, group and leaf
  boxes and their box packs of packed `facts` as float32 tensors on `dev`
  (None where the scene has none).'''
  out = {k: None if facts[k] is None
         else torch.as_tensor(np.ascontiguousarray(facts[k]), device=dev)
         for k in _GLOBAL_TABLES}
  for k, (groups, boxes, leaves) in _BOX_PACKS.items():
    out[k] = None if facts[boxes] is None else torch.as_tensor(
        _boxPack(facts[groups], facts[boxes], facts[leaves]), device=dev)
  return out


def tableCullSets(tables, maxIntersections):
  '''The rows each of `maxIntersections` bounces sweeps, read back from the
  tables' cull block (`_cullBlock`): per bounce the ascending row
  positions, or None for a full sweep (every bounce of tables without a
  block, and every bounce past the block's own count).'''
  off = tables.get('cullOff', -1)
  if off < 0:
    return [None] * maxIntersections
  words = tables['table'].detach().cpu().numpy().view(np.int32)
  nWords = -(-tables['nSurf'] // 32)
  sets = []
  for b in range(maxIntersections):
    at = words[off + 1 + b] if b < words[off] else -1
    if at < 0:
      sets.append(None)
      continue
    bits = np.unpackbits(words[at:at + nWords].astype('<u4').view(np.uint8),
                         bitorder='little')[:tables['nSurf']]
    sets.append(np.flatnonzero(bits).tolist())
  return sets


def samplerSpecWithGeom(samplerSpec, geomRow):
  '''`samplerSpec` with the source placement and wavelength of `geomRow`,
  a (13,) row [R row-major (9), offset (3), wavelength]: what a sweep whose
  variants move or recolour one source brings per variant.'''
  row = np.asarray(geomRow, np.float32).reshape(13)
  return dict(samplerSpec, R=row[:9].reshape(3, 3), off=row[9:12],
              wavelength=float(row[12]))


class SweepUnavailable(Exception):
  '''The variants of a sweep cannot ride ONE launch of the sweep kernel
  (fewer than two of them, or they differ in structure and not only in
  values). Callers trace such a sweep variant by variant.'''


def packSweepTables(scenes, histSpec, samplerSpecs):
  '''Stack the kernel tables of V compiled scene variants (host numpy
  scene dicts) that share one histogram spec. `samplerSpecs` is one sampler
  spec per variant (the source's placement and wavelength may differ from
  variant to variant: they are part of each table), or None for a sweep fed
  ray columns. Returns (float32 (V, tableLen) numpy array, facts) with the
  facts of `_packTable` for the sweep as a whole (a mesh's `triTable` and
  `triBoxes` stacked per variant, (V, nTri, TRI_COLS) and (V, nTriChunks,
  BOX_COLS), a surface table's `surfTable` and `surfBoxes` likewise, (V,
  nSurfTable, SURF_TABLE_COLS) and (V, nSurfChunks, BOX_COLS), and the
  group and leaf boxes of both likewise) plus
  `nVariants`,
  `tableLen`, `sameSource` (no variant moves or recolours the source),
  `sharedDraws` (every variant's source draws the same ray in its own
  frame: the same two marginal blocks and focal words, bit for bit; the
  placement and wavelength may differ, `sharedDrawsOf`) and the
  per-variant `surfRows` / `elemRows` lists.

  Raises SweepUnavailable unless the variants have the same STRUCTURE: the
  same numbers of surfaces and elements, per surface row the same kind,
  trim mode and element, the same runs of the surface table, per element
  the same optical type, recording flag and detector, and dispersion in all variants or in none. Everything else is
  data and may differ: each variant's element rows, grating constants,
  n(lambda) polynomials and surface masks are its own. Scatter constants
  must be equal in every variant: they are not swept (the reference's
  sweep step bakes variant 0's into every variant; ROADMAP C), so variants
  whose densities differ raise SweepUnavailable and are traced one by one.
  The stacked tables carry no cull block (`cullOff` -1): the sweep
  kernel sweeps every row on every bounce, as the reference's sweep step
  takes no emission bound. Sequential mode
  raises SweepUnavailable, as the reference's sweep step refuses it
  (`makePallasSweepStep`); the sweeper then traces the variants one launch
  each, with the stage gate.'''
  V = len(scenes)
  if V < 2:
    raise SweepUnavailable('needs >= 2 variants')
  if samplerSpecs is None:
    samplerSpecs = [None] * V
  if len(samplerSpecs) != V:
    raise ValueError(f'{len(samplerSpecs)} sampler specs for {V} variants')
  if any(spec is not None and spec.get('type') == 'surface'
         for spec in samplerSpecs):
    # as the reference's sweep step refuses it (makePallasSweepStep)
    raise SweepUnavailable('needs an in-kernel point-source sampler')
  cache, tables, facts = {}, [], []
  for scene, spec in zip(scenes, samplerSpecs):
    reason = ineligibleReason(scene)
    if reason is not None:
      raise SweepUnavailable(reason)
    if 'seqMask' in scene:
      raise SweepUnavailable('sequential mode')
    t, f = _packTable(scene, histSpec, spec, marginalCache=cache)
    tables.append(t)
    facts.append(f)
  f0 = facts[0]
  for v, f in enumerate(facts[1:], 1):
    if f['nSurf'] != f0['nSurf']:
      raise SweepUnavailable(f'surface counts differ (variant {v})')
    if f['nElem'] != f0['nElem']:
      raise SweepUnavailable(f'element counts differ (variant {v})')
    if f['nTri'] != f0['nTri']:
      raise SweepUnavailable(f'triangle-table sizes differ (variant {v})')
    if any(f[k] != f0[k] for k in ('nSurfTable', 'surfPlainRuns',
                                   'surfChunkRuns')):
      raise SweepUnavailable(f'surface-table runs differ (variant {v})')
    if f['scatterConsts'] != f0['scatterConsts']:
      raise SweepUnavailable(f'scatter constants differ (variant {v})')
    if f['samplerOff'] != f0['samplerOff'] or f['dispOff'] != f0['dispOff']:
      raise SweepUnavailable('some variants have a sampler or dispersion '
                             'and some none')
    if f['geom'] != f0['geom'] or len(tables[v]) != len(tables[0]):
      raise SweepUnavailable(f'table layouts differ (variant {v}: the '
                             f'surface kinds, trims, bitmap sizes or stage '
                             f'gate)')
    for s, (a, b) in enumerate(zip(f0['surfRows'], f['surfRows'])):
      if any(a[k] != b[k] for k in ('kind', 'trim0', 'elemF')):
        raise SweepUnavailable(f'surface {s}: kind, trim mode or element '
                               f'differs (variant {v})')
    for e, (a, b) in enumerate(zip(f0['elemRows'], f['elemRows'])):
      if any(a[k] != b[k] for k in ('optF', 'rec', 'detF')):
        raise SweepUnavailable(f'element {e}: optical type, recording flag '
                               f'or detector differs (variant {v})')
  stacked = np.stack(tables)
  tri = {k: None if f0[k] is None else np.stack([f[k] for f in facts])
         for k in _GLOBAL_TABLES}
  off = f0['samplerOff']
  geom = stacked[:, off:off + _SAMPLER_GEOM]
  sameSource = off < 0 or bool((geom == geom[0]).all())
  return stacked, dict(
      nVariants=V, sameSource=sameSource,
      sharedDraws=sharedDrawsOf(stacked, off), tableLen=int(stacked.shape[1]),
      nSurf=f0['nSurf'], nElem=f0['nElem'], nTri=f0['nTri'],
      nTriChunks=f0['nTriChunks'], nTriGroups=f0['nTriGroups'],
      nTriLeaves=f0['nTriLeaves'], nSurfTable=f0['nSurfTable'],
      nSurfChunks=f0['nSurfChunks'], nSurfGroups=f0['nSurfGroups'],
      nSurfLeaves=f0['nSurfLeaves'], surfPlainRuns=f0['surfPlainRuns'],
      surfChunkRuns=f0['surfChunkRuns'], **tri, samplerOff=f0['samplerOff'],
      bins=f0['bins'], nDet=f0['nDet'],
      anyMedium=any(f['anyMedium'] for f in facts),
      hasGrating=f0['hasGrating'], nStages=0,
      gate=any(f['gate'] for f in facts), dispOff=f0['dispOff'], cullOff=-1,
      geom=f0['geom'],
      samplerKind=SAMPLER_POINT, scatter=f0['scatter'],
      scatterConsts=f0['scatterConsts'], scatterRows=f0['scatterRows'],
      lobeRows=f0['lobeRows'], modRows=f0['modRows'],
      surfRows=[f['surfRows'] for f in facts],
      elemRows=[f['elemRows'] for f in facts])


def sharedDrawsOf(stacked, samplerOff):
  '''Whether the point sampler of every row of the stacked float32 (V,
  tableLen) tables draws the same ray in the source's own frame from the
  same uniforms: the focal words (finite, f) and both marginal blocks equal
  bit for bit. The placement (rotation, offset) and the wavelength may
  differ. False without a sampler block.'''
  if samplerOff < 0:
    return False
  draw = np.concatenate(
      [stacked[:, samplerOff:samplerOff + 2],
       stacked[:, samplerOff + _SAMPLER_GEOM:
               samplerOff + _SAMPLER_GEOM + 2 * _MARG_LEN]], axis=1)
  bits = draw.view(np.uint32)
  return bool((bits == bits[0]).all())


def sweepGroupsAllowed(tables, mode):
  '''Whether the sweep kernel traces these tables in groups of more than
  one variant for input `mode`: where the variants share the draw
  (`sharedDraws`) and the kernel samples (seed or uniforms), in its plain
  or B4 instance (no scatter, no other surface kind or trim (GEOM), no
  table in device memory).'''
  return bool(tables.get('sharedDraws', False) and mode != MODE_COLUMNS
              and not (tables.get('scatter') or tables.get('geom')
                       or tables.get('nTri', 0)
                       or tables.get('nSurfTable', 0)))


def sweepVariantGroup(nVariants, raysPerVariant, plan, smCount):
  '''The variants a block of the sweep kernel traces (its group, Vb): the
  largest of MAX_VARIANT_GROUP, ..., 4, 2 whose launch keeps every block an
  SM that its instance's registers allow and whose grid of
  ceil(raysPerVariant / 256) x ceil(nVariants / Vb) blocks fills the
  `smCount` SMs SWEEP_WAVES times over at that many blocks an SM; else 1.
  `plan(Vb)` gives (shared bytes, blocks an SM with them, blocks an SM its
  instance allows alone) of the launch (`_sweepPlan`). A group may be
  larger than the sweep (one group then holds every variant). For tables
  `sweepGroupsAllowed` refuses, `traceSweep` takes 1 without asking.'''
  tiles = -(-int(raysPerVariant) // KERNEL_BLOCK)
  vb = MAX_VARIANT_GROUP
  while vb > 1:
    _bytes, blocks, regBlocks = plan(vb)
    if (blocks >= regBlocks and tiles * -(-int(nVariants) // vb)
        >= SWEEP_WAVES * int(smCount) * blocks):
      return vb
    vb //= 2
  return 1


def sweepGroups(nVariants, group):
  '''The (first variant, count) of each block row of the sweep kernel's
  grid (blockIdx.y): consecutive groups of `group` variants, the last one
  shorter where `group` does not divide nVariants.'''
  return [(g, min(group, nVariants - g)) for g in range(0, nVariants, group)]


def buildSweepTables(scenes, histSpec, samplerSpecs, device='cuda'):
  '''`packSweepTables` with the stacked table as ONE float32 (V, tableLen)
  tensor on `device`: what `traceSweep` reads.'''
  dev = resolveDevice(device)
  stacked, facts = packSweepTables(scenes, histSpec, samplerSpecs)
  return dict(facts, table=torch.as_tensor(stacked, device=dev),
              **_globalTensors(facts, dev))


def variantTables(sweepTables, v):
  '''Variant `v` of a sweep's tables in the form of `buildTraceTables`
  (its `table` a view of the stacked tensor): what the single-scene
  wrappers and plain versions take.'''
  return dict(sweepTables, table=sweepTables['table'][v],
              surfRows=sweepTables['surfRows'][v],
              elemRows=sweepTables['elemRows'][v],
              **{k: None if sweepTables[k] is None else sweepTables[k][v]
                 for k in _GLOBAL_TABLES + tuple(_BOX_PACKS)})


# --------------------------------------------------------- plain PyTorch path

def _marginalPlain(m, u):
  '''Plain version of the kernel's `marginal` on a packed float32 block.'''
  kind, n = int(m[0]), int(m[1])
  if kind == 0:
    return float(m[2]) + u * float(m[3])
  if kind == 1:
    out = None
    for i in range(n):
      seg = m[4 + i * _SEG_STRIDE:4 + (i + 1) * _SEG_STRIDE]
      s = (u - float(seg[1])) * float(seg[2])
      nc = int(seg[3])
      acc = torch.full_like(u, float(seg[4 + nc - 1]))
      for c in range(nc - 2, -1, -1):
        acc = acc * s + float(seg[4 + c])
      out = acc if out is None else torch.where(u >= float(seg[0]), acc, out)
    return torch.clamp(out, float(m[2]), float(m[3]))
  from ..distributions.device_sampler import tentInterp
  return tentInterp(torch.as_tensor(m[4:4 + n], device=u.device), u)


def samplerWavelength(tables):
  '''The wavelength (nm, as the kernel reads it: float32) of the sampler
  block of single-scene `tables`: what every ray the sampler draws
  carries.'''
  if tables['samplerOff'] < 0:
    raise ValueError('these tables have no sampler block: give the '
                     'wavelength as the eighth ray column')
  return float(tables['table'][tables['samplerOff'] + 14])


def sampleRaysPlain(tables, u1, u2, strata=None, strataTile=0):
  '''Plain version of the in-kernel point-source sampler: two uniform
  float32 (N,) tensors -> the ray columns (ox..dz, pw). `strata` = (G1, G2)
  stratifies the two quantiles by ray-index cell. The draw
  (`sampleLocalPlain`), then the placement (`placeRaysPlain`).'''
  return placeRaysPlain(tables, sampleLocalPlain(tables, u1, u2, strata,
                                                 strataTile))


def sampleLocalPlain(tables, u1, u2, strata=None, strataTile=0):
  '''The point sampler's draw: the two uniforms (stratified where `strata`
  is given), the two marginals and the focal geometry -> the ray in the
  source's own frame, (lox, loy, loz, ldx, ldy, ldz) float32 tensors. What
  the variants of a sweep with `sharedDraws` share.'''
  tab = tables['table'].detach().cpu().numpy()
  sg = tab[tables['samplerOff']:]
  if strata is not None:
    G1, G2 = strata
    cell = torch.arange(u1.shape[0], device=u1.device) // int(strataTile)
    i1 = (cell // G2).to(torch.float32)
    i2 = (cell % G2).to(torch.float32)
    u1 = (i1 + u1) * float(np.float32(1.0 / G1))
    u2 = (i2 + u2) * float(np.float32(1.0 / G2))
  t = _marginalPlain(sg[_SAMPLER_GEOM:_SAMPLER_GEOM + _MARG_LEN], u1)
  ph = _marginalPlain(sg[_SAMPLER_GEOM + _MARG_LEN:
                         _SAMPLER_GEOM + 2 * _MARG_LEN], u2)
  from ..models.point_source import pointLocal
  return pointLocal(t, ph, bool(sg[0] != 0.), float(sg[1]))


def placeRaysPlain(tables, local):
  '''The point sampler's placement: the ray of `sampleLocalPlain` turned
  and moved by the tables' source rotation and offset -> the ray columns
  (ox..dz, pw).'''
  from ..models.point_source import placeColumns
  sg = tables['table'].detach().cpu().numpy()[tables['samplerOff']:]
  cols = placeColumns(local, sg[2:11].reshape(3, 3), sg[11:14],
                      float(sg[14]))
  return tuple(cols[k] for k in ('ox', 'oy', 'oz', 'dx', 'dy', 'dz', 'pw'))


def sampleSurfaceRaysPlain(tables, uniforms):
  '''Plain version of the in-kernel surface-source sampler: five uniform
  float32 (N,) rows (face, u, v, theta quantile, phi quantile) -> the ray
  columns (ox..dz, pw): theta through the packed marginal, phi = 2 pi
  times its quantile, then `surface_source.surfaceSampleColumns` on the
  spec's faces (whose float32 constants are the packed rows').'''
  from ..models.surface_source import surfaceSampleColumns
  tab = tables['table'].detach().cpu().numpy()
  sg = tab[tables['samplerOff']:]
  spec = tables['samplerSpec']
  uF, u, v, uT, uP = (uniforms[k] for k in range(5))
  theta = _marginalPlain(sg[_SAMPLER_GEOM:_SAMPLER_GEOM + _MARG_LEN], uT)
  phi = uP * float(sg[1])
  cols = surfaceSampleColumns(spec['faces'], uF, u, v, theta, phi,
                              float(sg[14]))
  return tuple(cols[k] for k in ('ox', 'oy', 'oz', 'dx', 'dy', 'dz', 'pw'))


def samplerColumnsPlain(tables, uniforms, strata=None, strataTile=0):
  '''The seven ray columns the tables' in-kernel sampler draws from the
  float32 `uniforms` (one row per draw: `samplerUniforms(tables)` rows),
  by its plain version. `strata` applies to the point sampler only.'''
  if tables['samplerKind'] == SAMPLER_SURFACE:
    return sampleSurfaceRaysPlain(tables, uniforms)
  return sampleRaysPlain(tables, uniforms[0], uniforms[1], strata,
                         strataTile)


def samplerUniforms(tables):
  '''How many uniforms the tables' in-kernel sampler draws per ray (the
  first rows of the uniform input mode): 2 for a point source, 5 for a
  surface source.'''
  return SAMPLER_UNIFORMS[tables['samplerKind']]


def uniformRows(tables, maxIntersections):
  '''The rows of the uniform input mode: the sampler's draws, then for
  every bounce the scatter draws (`tables['scatterRows']`: the lobe's u1,
  u2 and, with discrete events, u3, u4; then MODIFY's likewise) — the JAX
  package's order for its uniform seam (`uniformProvider='input'`).'''
  return samplerUniforms(tables) \
      + tables.get('scatterRows', 0) * int(maxIntersections)


def _full(like, value):
  return torch.full_like(like, float(value))


def _fmax(x, value):
  '''fmaxf(x, value): a NaN x gives `value`, as in the kernels.'''
  return torch.fmax(x, _full(x, value))


def _bitmapOkPlain(r, tab, u, v):
  '''The bitmap trim (flag 2) of surface row `r` at chart coordinates
  (u, v): the pixel inside the R x R window and its bit set.'''
  R = int(r[G_MASKRES])
  pu = (u - float(r[17])) * float(r[G_TRIM3])
  pv = (v - float(r[18])) * float(r[G_TRIM4])
  inWin = (pu >= 0) & (pu < float(R)) & (pv >= 0) & (pv < float(R))
  zero = torch.zeros_like(pu)
  iu = torch.floor(torch.where(inWin, pu, zero)).to(torch.int64)
  iv = torch.floor(torch.where(inWin, pv, zero)).to(torch.int64)
  idx = iv * R + iu
  off = int(r[G_MASKOFF])
  words = torch.as_tensor(
      tab[off:off + -(-R * R // 32)].view(np.uint32).astype(np.int64),
      device=u.device)
  bit = (words[idx >> 5] >> (idx & 31)) & 1
  return inWin & (bit == 1)


def _primsPlain(r, tab, x, y, z, baseOk):
  '''Hole-primitive trims (flags 3, 4) of surface row `r`: (base OR any
  add-prim) AND NOT any hole-prim, the reference's `_applyPrimsConst`.'''
  off, n = int(r[G_PRIMOFF]), int(r[G_NPRIM])
  addHit = holeHit = None
  for h in range(n):
    shape, isAdd, isInv, cx, cy, p0, p1, ca, sa = (
        float(v) for v in tab[off + h * PRIM_COLS:off + (h + 1) * PRIM_COLS])
    inP = GS.primInside(shape, x, y, z, cx, cy, p0, p1, ca, sa)
    if isInv:
      inP = ~inP
    if isAdd:
      addHit = inP if addHit is None else addHit | inP
    else:
      holeHit = inP if holeHit is None else holeHit | inP
  out = baseOk if addHit is None else baseOk | addHit
  return out if holeHit is None else out & ~holeHit


def _quadraticPlain(a, b, c):
  '''(okD, t1, t2) of a t^2 + b t + c in the kernels' stable form: whether
  the discriminant is not negative, q / a and c / q.'''
  disc = b * b - 4. * a * c
  okD = disc >= 0
  sqD = torch.sqrt(torch.clamp(disc, min=0.))
  q = -0.5 * (b + torch.sign(b + 1e-30) * sqD)
  aS = torch.where(torch.abs(a) < 1e-20, _full(a, 1e-20), a)
  qS = torch.where(torch.abs(q) < 1e-20, _full(q, 1e-20), q)
  t1, t2 = q / aS, c / qS
  return okD, t1, t2


def _intersectPlain(r, ox, oy, oz, dx, dy, dz, tMin, tab=None):
  '''Plain version of the kernels' `intersect` (plane / sphere / cylinder
  with window trims) and `intersectGeom` (every kind and trim) for one
  float32 surface row `r` (numpy) against all rays; `tab` is the whole
  table (bitmap words and hole-primitive rows).'''
  R = [float(x) for x in r[1:10]]
  lox = R[0] * ox + R[1] * oy + R[2] * oz + float(r[10])
  loy = R[3] * ox + R[4] * oy + R[5] * oz + float(r[11])
  loz = R[6] * ox + R[7] * oy + R[8] * oz + float(r[12])
  ldx = R[0] * dx + R[1] * dy + R[2] * dz
  ldy = R[3] * dx + R[4] * dy + R[5] * dz
  ldz = R[6] * dx + R[7] * dy + R[8] * dz
  kind = int(r[0])
  trim0 = float(r[16])
  tA, tB = float(r[17]), float(r[18])
  big = torch.full_like(ox, _BIG)
  P = [float(x) for x in r[G_P:G_P + 5]] if len(r) > SURF_COLS else None
  X = [float(x) for x in r[G_X:G_X + 9]] if len(r) > SURF_COLS else None

  def chartOk(xx, yy, z, v, pre=None):
    '''The trim of a charted kind at the local point (xx, yy, z) whose
    band coordinate is v, on top of the kind's own test `pre`: the bitmap
    over (azimuth, v), or the band, with the hole primitives over it.'''
    if trim0 == 2.:
      ok = _bitmapOkPlain(r, tab, GS.chartAtan2(yy, xx), v)
      return ok if pre is None else pre & ok
    band = (v >= tA) & (v <= tB)
    if pre is not None:
      band = pre & band
    if trim0 == 3.:
      band = _primsPlain(r, tab, xx, yy, z, band)
    return band

  if kind == GS.TRIANGLE:
    p0, p1, p2 = P[0], P[1], P[2]
    e1x, e1y, e1z, e2x, e2y, e2z = X[:6]
    pvx = ldy * e2z - ldz * e2y
    pvy = ldz * e2x - ldx * e2z
    pvz = ldx * e2y - ldy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    detS = torch.where(torch.abs(det) < 1e-12, _full(det, 1e-12), det)
    tvx, tvy, tvz = lox - p0, loy - p1, loz - p2
    u = (tvx * pvx + tvy * pvy + tvz * pvz) / detS
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (ldx * qvx + ldy * qvy + ldz * qvz) / detS
    t = (e2x * qvx + e2y * qvy + e2z * qvz) / detS
    ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > tMin))
    return torch.where(ok, t, big)
  if kind == GS.PLANE:
    dzS = torch.where(torch.abs(ldz) < 1e-12, torch.full_like(ldz, 1e-12),
                      ldz)
    t = -loz / dzS
    x, y = lox + t * ldx, loy + t * ldy
    if trim0 == 2.:
      ok = _bitmapOkPlain(r, tab, x, y)
    elif trim0 in (1., 4.):
      ok = (torch.abs(x) <= tA) & (torch.abs(y) <= tB)
    else:
      r2 = x * x + y * y
      ok = (r2 >= tA) & (r2 <= tB)
    if trim0 in (3., 4.):
      ok = _primsPlain(r, tab, x, y, 0., ok)
    return torch.where((t > tMin) & ok, t, big)
  if kind in (GS.SPHERE, GS.CYLINDER, GS.CONE, GS.QUADRIC):
    wOk = None
    if kind == GS.SPHERE:
      a = ldx * ldx + ldy * ldy + ldz * ldz
      b = 2. * (lox * ldx + loy * ldy + loz * ldz)
      c = lox * lox + loy * loy + loz * loz - float(r[15])
    elif kind == GS.CYLINDER:
      a = ldx * ldx + ldy * ldy
      b = 2. * (lox * ldx + loy * ldy)
      c = lox * lox + loy * loy - float(r[15])
    elif kind == GS.CONE:
      r0, tanA = P[0], P[1]
      w0 = r0 + loz * tanA
      wd = ldz * tanA
      a = ldx * ldx + ldy * ldy - wd * wd
      b = 2. * (lox * ldx + loy * ldy - w0 * wd)
      c = lox * lox + loy * loy - w0 * w0
      wOk = lambda t: w0 + t * wd >= 0
    else:
      qa, qb, qc, qz, q0 = P
      a = qa * ldx * ldx + qb * ldy * ldy + qc * ldz * ldz
      b = 2. * (qa * lox * ldx + qb * loy * ldy + qc * loz * ldz) + qz * ldz
      c = qa * lox * lox + qb * loy * loy + qc * loz * loz + qz * loz + q0
    okD, t1, t2 = _quadraticPlain(a, b, c)
    if kind == GS.QUADRIC:
      # the linear case: a ~ 0 with b != 0 has the single root -c / b
      linT = -c / torch.where(torch.abs(b) < 1e-20, _full(b, 1e-20), b)
      isLin = (torch.abs(a) < 1e-14 * (torch.abs(b) + 1e-20)) \
          & (torch.abs(b) > 1e-20)
      t1 = torch.where(isLin, linT, t1)
      t2 = torch.where(isLin, big, t2)
      okD = okD | isLin
    lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
    out = []
    for t in (lo, hi):
      z = loz + t * ldz
      pre = None if wOk is None else wOk(t)
      if trim0 in (0., 1.):
        ok = (z >= tA) & (z <= tB)
        ok = ok if pre is None else pre & ok
      else:
        ok = chartOk(lox + t * ldx, loy + t * ldy, z, z, pre)
      out.append(torch.where(okD & (t > tMin) & ok, t, big))
    return torch.fmin(out[0], out[1])
  if kind == GS.ASPHERE:
    return _asphereT(P, X, r, tab, lox, loy, loz, ldx, ldy, ldz, tMin,
                     big, chartOk)
  return _torusT(P, X, lox, loy, loz, ldx, ldy, ldz, tMin, big, chartOk)


def _asphereT(P, X, r, tab, lox, loy, loz, ldx, ldy, ldz, tMin, big,
              chartOk):
  '''The asphere's distance: the vertex-plane start, the osculating
  sphere's nearest positive root where the curvature allows, 16 Newton
  steps on z - sag(r), then the residual gate (< 1e-4) and the r-band trim
  (the reference's ASPHERE branch).'''
  c0, kk, a4, a6, a8 = P
  K1, Rs, RRs, seed = X[:4]
  dzS = torch.where(torch.abs(ldz) < 1e-9,
                    torch.where(ldz >= 0, _full(ldz, 1e-9), _full(ldz, -1e-9)),
                    ldz)
  t = _fmax(-loz / dzS, 0.)
  if seed:
    ocz = loz - Rs
    b = 2. * (lox * ldx + loy * ldy + ocz * ldz)
    cc = lox * lox + loy * loy + ocz * ocz - RRs
    disc = b * b - 4. * cc
    okD = disc >= 0
    sqD = torch.sqrt(torch.clamp(disc, min=0.))
    q = -0.5 * (b + torch.sign(b + 1e-30) * sqD)
    t2 = cc / torch.where(torch.abs(q) < 1e-20, _full(q, 1e-20), q)
    lo, hi = torch.fmin(q, t2), torch.fmax(q, t2)
    sph = torch.where(okD & (lo > tMin), lo,
                      torch.where(okD & (hi > tMin), hi, t))
    t = torch.where(okD, sph, t)
  K4, K6, K8 = 4. * a4, 6. * a6, 8. * a8

  def sagAt(r2):
    rootA = torch.sqrt(_fmax(1. - K1 * r2, 1e-12))
    opr = 1. + rootA
    return rootA, opr, c0 * r2 / opr + r2 * r2 * (a4 + r2 * (a6 + r2 * a8))

  for _ in range(16):
    x, y, z = lox + t * ldx, loy + t * ldy, loz + t * ldz
    r2 = x * x + y * y
    rootA, opr, sag = sagAt(r2)
    g = (c0 * (_full(opr, 2.) / opr + K1 * r2 / (rootA * (opr * opr)))
         + K4 * r2 + K6 * r2 * r2 + K8 * (r2 * (r2 * r2)))
    f = z - sag
    slope = -g * x * ldx - g * y * ldy + ldz
    slope = torch.where(torch.abs(slope) < 1e-12,
                        torch.where(slope >= 0, _full(slope, 1e-12),
                                    _full(slope, -1e-12)), slope)
    t = t - f / slope
  x, y, z = lox + t * ldx, loy + t * ldy, loz + t * ldz
  r2 = x * x + y * y
  _rootA, _opr, sag = sagAt(r2)
  ok = (t > tMin) & (torch.abs(z - sag) < 1e-4) \
      & chartOk(x, y, z, torch.sqrt(r2))
  return torch.where(ok, t, big)


def _torusT(P, X, lox, loy, loz, ldx, ldy, ldz, tMin, big, chartOk):
  '''The torus's distance: the ray re-anchored at its closest approach
  to the centre and scaled by R, the quartic's smallest valid root
  (residual gate and tube-angle trim), mapped back (the reference's TORUS
  branch).'''
  R0, rT = P[0], P[1]
  rr2, rT2, resTol = X[:3]
  dd = ldx * ldx + ldy * ldy + ldz * ldz
  ddS = torch.where(dd < 1e-20, _full(dd, 1e-20), dd)
  tMid = -(lox * ldx + loy * ldy + loz * ldz) / ddS
  R0t = _full(dd, R0)
  stretch = torch.sqrt(ddS) / R0t
  osx = (lox + tMid * ldx) / R0t
  osy = (loy + tMid * ldy) / R0t
  osz = (loz + tMid * ldz) / R0t
  invL = torch.rsqrt(ddS)
  dsx, dsy, dsz = ldx * invL, ldy * invL, ldz * invL
  K = osx * osx + osy * osy + osz * osz + 1. - rr2
  bq = 2. * (osx * dsx + osy * dsy + osz * dsz)
  exy = dsx * dsx + dsy * dsy
  fxy = osx * dsx + osy * dsy
  gxy = osx * osx + osy * osy
  b = 2. * bq
  c = bq * bq + 2. * K - 4. * exy
  dL = 2. * bq * K - 8. * fxy
  e = K * K - 4. * gxy

  def valid(tau):
    t = tMid + tau / stretch
    x, y, z = lox + t * ldx, loy + t * ldy, loz + t * ldz
    sxy = torch.sqrt(x * x + y * y)
    dr = sxy - R0
    g = dr * dr + z * z - rT2
    return (torch.abs(g) < resTol) & chartOk(x, y, z, GS.chartAtan2(z, dr))

  tauMin = (tMin - tMid) * stretch
  tau = GS.quarticSmallestRoot(b, c, dL, e, tauMin, valid)
  t = tMid + tau / stretch
  return torch.where(tau < _BIG, t, big)


def _hornerPlain(d, wl):
  '''Plain version of the kernel's `dispersionN`: n(wl) from one packed
  float32 dispersion row (mid, 1/half, count, 0, ascending coefficients).'''
  sW = (wl - float(d[0])) * float(d[1])
  nc = int(d[2])
  acc = torch.full_like(wl, float(d[4 + nc - 1]))
  for c in range(nc - 2, -1, -1):
    acc = acc * sW + float(d[4 + c])
  return acc


def _lobeAxisPlain(bx, by, bz, dx, dy, dz):
  '''The rotation axis of a scatter draw: unit b x d, or an arbitrary
  perpendicular of b (b x x-hat, else b x y-hat) where b and d are nearly
  parallel.'''
  axX = by * dz - bz * dy
  axY = bz * dx - bx * dz
  axZ = bx * dy - by * dx
  ax2 = axX * axX + axY * axY + axZ * axZ
  zero = torch.zeros_like(bx)
  altX, altY, altZ = zero, bz, -by                  # b x x_hat
  alt2X, alt2Y, alt2Z = -bz, zero, bx               # b x y_hat
  alt2 = altY * altY + altZ * altZ
  useAlt, altOk = ax2 < 1e-12, alt2 > 1e-12
  axX = torch.where(useAlt, torch.where(altOk, altX, alt2X), axX)
  axY = torch.where(useAlt, torch.where(altOk, altY, alt2Y), axY)
  axZ = torch.where(useAlt, torch.where(altOk, altZ, alt2Z), axZ)
  ainv = torch.rsqrt(axX * axX + axY * axY + axZ * axZ + 1e-20)
  return axX * ainv, axY * ainv, axZ * ainv


def _scatterPlain(consts, rows, lobeRows, elem, isMirror, isLens,
                  isEntering, dDotN, nx, ny, nz, dx, dy, dz, ndx, ndy, ndz):
  '''The kernels' scatter section for one bounce: the lobe (REFLECT on a
  mirror, REFRACT_ENTER / REFRACT_EXIT on a lens) turns the ideal direction
  into a draw about the lobe axis (the incidence-side normal for a mirror,
  the forward normal for a lens), then MODIFY turns the result about
  itself; then the direction is normalised again (every ray, as the
  reference does). `rows` are this bounce's uniform rows, the lobe's
  first.'''
  lobe, mods = SC.splitEntries(consts)
  thetaIn = SC.incidenceAngle(dDotN) if SC.needsIncidence(consts) else None

  def draw(entries, kind, u):
    u = list(u) + [None, None]
    theta, phi = SC.scatterDrawConst(entries, elem, kind, thetaIn, *u[:4])
    applies = torch.zeros_like(isMirror)
    for e, k, *_specs in entries:
      applies = applies | ((elem == e) & (kind == k))
    return theta, phi, applies

  if lobe:
    kindL = torch.where(isMirror, 0, torch.where(
        isLens & isEntering, 1, torch.where(isLens, 2, -1)))
    thetaS, phiS, applies = draw(lobe, kindL, rows[:lobeRows])
    nSgn = torch.where(isMirror, -1., 1.)
    lnx, lny, lnz = nx * nSgn, ny * nSgn, nz * nSgn
    ax = _lobeAxisPlain(lnx, lny, lnz, dx, dy, dz)
    s1 = _rotPlain(lnx, lny, lnz, *ax, thetaS)
    s1 = _rotPlain(*s1, lnx, lny, lnz, phiS)
    ndx = torch.where(applies, s1[0], ndx)
    ndy = torch.where(applies, s1[1], ndy)
    ndz = torch.where(applies, s1[2], ndz)
  if mods:
    kindM = torch.where(isMirror | isLens, 3, -1)
    thetaM, phiM, appliesM = draw(mods, kindM, rows[lobeRows:])
    ax = _lobeAxisPlain(ndx, ndy, ndz, dx, dy, dz)
    s2 = _rotPlain(ndx, ndy, ndz, *ax, thetaM)
    s2 = _rotPlain(*s2, ndx, ndy, ndz, phiM)
    ndx = torch.where(appliesM, s2[0], ndx)
    ndy = torch.where(appliesM, s2[1], ndy)
    ndz = torch.where(appliesM, s2[2], ndz)
  inv = torch.rsqrt(ndx * ndx + ndy * ndy + ndz * ndz + 1e-20)
  return ndx * inv, ndy * inv, ndz * inv


def _bounceLoopPlain(tables, columns, maxIntersections, maxRayLength,
                     distTol, powerTol, hitSlots, output,
                     scatterUniforms=None, triangleStats=None,
                     surfaceStats=None, cullStats=None):
  '''The kernels' bounce loop as column-wise tensor ops, step by step in the
  kernels' operation order: nearest hit over the surface rows of the
  bounce's set (`tableCullSets`: the rows the tables' cull block leaves,
  every row without one) that the ray's stage allows, with the
  other-medium tracker and same-medium window, winner normal, n(lambda) of
  the winner and of the medium, Beer-Lambert, mirror / Snell / TIR /
  grating, medium, power and stage updates, and the hit ring
  (slot = min(hitN, hitSlots-1): an overflow overwrites the last slot). ONE
  loop for the three output modes; `output` selects the record gate and
  what a ring slot holds:

    'hist'  gate: recording element with a detector, hit inside the bounds;
            slot = (bin int64, power)
    'bins'  same gate; slot = (bin as float32, power, count 1)
    'raw'   gate: recording element, no bounds; slot = (element, power,
            isEntering, px, py, pz, incoming dx, dy, dz), all float32

  `columns` are ox, oy, oz, dx, dy, dz, pw and, optionally, the wavelength
  (without it every ray has the sampler's wavelength). A scene with
  scatter needs `scatterUniforms`: float32 (scatterRows * maxIntersections,
  N), bounce-major (the rows after the sampler's in `uniformRows`). A
  mesh's triangle table is swept after the surface rows, a surface table
  after that; `triangleStats` and `surfaceStats`, dicts, are added the work
  the kernels' cull leaves to those sweeps (`_TriangleTablePlain.sweep`,
  `_SurfaceTablePlain.sweep`). `cullStats`, a dict, gets the per-bounce
  row sets (`sets`) and is added the segments each bounce traces
  (`segmentsByBounce`): what the bound's count of swept rows weighs.

  Returns (ring, segments, hitN): ring a list of (hitSlots, N) tensors, one
  per slot field, the first -1 and the others 0 where a slot was never
  written; segments a 0-d int64 tensor; hitN the per-ray pass count.'''
  ox, oy, oz, dx, dy, dz, pw = columns[:7]
  dev = ox.device
  N = ox.shape[0]
  consts = tables.get('scatterConsts')
  if consts:
    rpb = tables['scatterRows']
    if scatterUniforms is None \
        or tuple(scatterUniforms.shape) != (rpb * maxIntersections, N):
      raise ValueError(f'a scene with scatter needs its uniform rows: '
                       f'({rpb * maxIntersections}, {N}) scatterUniforms')
  tab = tables['table'].detach().cpu().numpy()
  S, E = tables['nSurf'], tables['nElem']
  geom = tables.get('geom', False)
  rowCols = SURF_COLS + (GEOM_COLS if geom else 0)
  surfT = tab[:S * rowCols].reshape(S, rowCols)
  elemT = tab[S * rowCols:S * rowCols + E * ELEM_COLS].reshape(E, ELEM_COLS)
  # (a scene of triangle-table rows only gathers its never-used surface
  # attributes from one zero row)
  surfD = torch.as_tensor(surfT if S else np.zeros((1, rowCols), np.float32),
                          device=dev)
  elemD = torch.as_tensor(elemT, device=dev)
  tri = surfTab = None
  if tables.get('nTri', 0):
    tri = _TriangleTablePlain(tables['triTable'], tables['triBoxes'],
                              tables['triGroups'], tables['triLeaves'], dev)
  if tables.get('nSurfTable', 0):
    surfTab = _SurfaceTablePlain(tables, dev)
  H, W = tables['bins']
  anyMedium = tables['anyMedium']
  hasGrating, dispOff = tables['hasGrating'], tables['dispOff']
  nStages, gate = tables['nStages'], tables['gate']
  wl = columns[7] if len(columns) > 7 else None
  if wl is None and (hasGrating or dispOff >= 0):
    wl = torch.full_like(ox, samplerWavelength(tables))
  # n(wl) per dispersive element: constant along a ray
  nOf = {}
  if dispOff >= 0:
    dispT = tab[dispOff:dispOff + E * DISP_COLS].reshape(E, DISP_COLS)
    nOf = {e: _hornerPlain(dispT[e], wl) for e in range(E)
           if elemT[e, 11] != 0}
  f32 = lambda x: float(np.float32(x))
  mrlEff = f32(min(float(maxRayLength), 0.5 * _BIG))
  mrl, tMin = f32(maxRayLength), f32(distTol)
  window, pTol = f32(2 * distTol), f32(powerTol)

  medium = torch.full((N,), -1, dtype=torch.int64, device=dev)
  alive = torch.ones((N,), dtype=torch.bool, device=dev)
  segs = torch.zeros((), dtype=torch.int64, device=dev)
  hitN = torch.zeros((N,), dtype=torch.int64, device=dev)
  seq = torch.zeros((N,), dtype=torch.int64, device=dev)
  nFields = dict(hist=2, bins=3, raw=9)[output]
  keyDtype = torch.int64 if output == 'hist' else torch.float32
  ring = [torch.full((hitSlots, N), -1, dtype=keyDtype, device=dev)] + [
      torch.zeros((hitSlots, N), dtype=torch.float32, device=dev)
      for _ in range(nFields - 1)]
  canBeMedium = elemD[:, 10] != 0
  one = torch.ones((), dtype=torch.float32, device=dev)
  big = torch.full((N,), _BIG, dtype=torch.float32, device=dev)
  # the stage words of each surface (a scene with a stage gate): word
  # stage >> 5, bit stage & 31
  nWords = max(1, -(-nStages // 32))
  stageWords = {}
  if gate:
    for s in range(S):
      off = int(surfT[s, 19])
      stageWords[s] = tab[off:off + nWords].view(np.uint32)
  allStages = (1 << max(nStages, 1)) - 1
  sets = tableCullSets(tables, maxIntersections)
  if cullStats is not None:
    cullStats['sets'] = sets
    byBounce = cullStats.setdefault('segmentsByBounce',
                                    [0] * maxIntersections)

  for bounce in range(maxIntersections):
    tBest, tOth = big, big
    sBest = torch.full((N,), -1, dtype=torch.int64, device=dev)
    sOth = sBest
    stage = torch.clamp(seq, max=max(nStages, 1) - 1)
    if cullStats is not None:
      byBounce[bounce] += int(alive.sum())
    for s in (range(S) if sets[bounce] is None else sets[bounce]):
      bits = allStages
      if gate:
        bits = int.from_bytes(stageWords[s].astype('<u4').tobytes(), 'little')
      if bits == 0:
        continue                   # masked: never hit, keeps its index
      t = _intersectPlain(surfT[s], ox, oy, oz, dx, dy, dz, tMin, tab)
      if bits != allStages:        # the stage gate, before both trackers
        words = torch.as_tensor(stageWords[s].astype(np.int64), device=dev)
        allowed = (words[stage >> 5] >> (stage & 31)) & 1
        t = torch.where(allowed == 1, t, big)
      b = t < tBest
      sBest = torch.where(b, s, sBest)
      tBest = torch.where(b, t, tBest)
      if anyMedium:
        e = int(surfT[s, 14])
        tO = torch.where(medium == e, big, t) if bool(canBeMedium[e]) else t
        bO = tO < tOth
        sOth = torch.where(bO, s, sOth)
        tOth = torch.where(bO, tO, tOth)
    if tri is not None:
      # B7: the triangle table after the surface rows; its nearest triangle
      # replaces the surface winner only when strictly nearer (index -2),
      # and counts for the other-medium tracker when the medium is not ITS
      # element
      tCap = torch.clamp(tBest, max=mrlEff) + window
      tT, nT, elT = tri.sweep(ox, oy, oz, dx, dy, dz, tMin, mrl, tCap, alive,
                              triangleStats, window)
      b = tT < tBest
      sBest = torch.where(b, -2, sBest)
      tBest = torch.where(b, tT, tBest)
      if anyMedium:
        tO = torch.where(medium != elT, tT, big)
        bO = tO < tOth
        sOth = torch.where(bO, -2, sOth)
        tOth = torch.where(bO, tO, tOth)
    if surfTab is not None:
      # B8: the surface table after the triangle table; its winner replaces
      # the winner so far only when strictly nearer (index -3), and enters
      # the other-medium tracker only as that one winner, when the medium
      # is not ITS element
      tS, nS, elS, lS = surfTab.sweep(ox, oy, oz, dx, dy, dz, tMin, mrlEff,
                                      tBest, window, alive, surfaceStats)
      b = tS < tBest
      sBest = torch.where(b, -3, sBest)
      tBest = torch.where(b, tS, tBest)
      if anyMedium:
        tO = torch.where(medium != elS, tS, big)
        bO = tO < tOth
        sOth = torch.where(bO, -3, sOth)
        tOth = torch.where(bO, tO, tOth)
    hasHit = tBest <= mrlEff
    if not anyMedium:
      tOth, sOth = tBest, sBest
    hasPref = (tOth <= mrlEff) & (tOth <= tBest + window)
    tSel = torch.where(hasPref, tOth, tBest)
    sRaw = torch.where(hasPref, sOth, sBest)
    sIdx = sRaw.clamp(min=0)
    tSeg = torch.where(hasHit, tSel, torch.full_like(tSel, mrl))
    px, py, pz = ox + tSeg * dx, oy + tSeg * dy, oz + tSeg * dz
    segs = segs + alive.sum()
    live = alive & hasHit

    # winner attributes
    row = surfD[sIdx]
    R = [row[:, 1 + k] for k in range(9)]
    lx = R[0] * px + R[1] * py + R[2] * pz + row[:, 10]
    ly = R[3] * px + R[4] * py + R[5] * pz + row[:, 11]
    lz = R[6] * px + R[7] * py + R[8] * pz + row[:, 12]
    kind = row[:, 0]
    invS = torch.rsqrt(lx * lx + ly * ly + lz * lz + 1e-20)
    invC = torch.rsqrt(lx * lx + ly * ly + 1e-20)
    isS, isC = kind == GS.SPHERE, kind == GS.CYLINDER
    zero = torch.zeros_like(lx)
    nlx = torch.where(isS, lx * invS, torch.where(isC, lx * invC, zero))
    nly = torch.where(isS, ly * invS, torch.where(isC, ly * invC, zero))
    nlz = torch.where(isS, lz * invS, torch.where(isC, zero, one))
    if geom:
      nlx, nly, nlz = _geomNormalPlain(row, kind, lx, ly, lz, nlx, nly, nlz)
    orient = row[:, 13]
    nxA = (R[0] * nlx + R[3] * nly + R[6] * nlz) * orient
    nyA = (R[1] * nlx + R[4] * nly + R[7] * nlz) * orient
    nzA = (R[2] * nlx + R[5] * nly + R[8] * nlz) * orient
    elem = row[:, 14].to(torch.int64)
    if tri is not None:
      # a table winner: its tracked normal and element, the world (x, y)
      # as its chart
      isTri = sRaw == -2
      nxA = torch.where(isTri, nT[0], nxA)
      nyA = torch.where(isTri, nT[1], nyA)
      nzA = torch.where(isTri, nT[2], nzA)
      lx = torch.where(isTri, px, lx)
      ly = torch.where(isTri, py, ly)
      elem = torch.where(isTri, elT, elem)
    if surfTab is not None:
      # a surface-table winner: its tracked normal, element and local
      # (x, y) chart
      isTab = sRaw == -3
      nxA = torch.where(isTab, nS[0], nxA)
      nyA = torch.where(isTab, nS[1], nyA)
      nzA = torch.where(isTab, nS[2], nzA)
      lx = torch.where(isTab, lS[0], lx)
      ly = torch.where(isTab, lS[1], ly)
      elem = torch.where(isTab, elS, elem)
    er = elemD[elem]

    cosA = dx * nxA + dy * nyA + dz * nzA
    isEntering = cosA < 0
    sgn = torch.where(isEntering, -one, one)
    nx, ny, nz = nxA * sgn, nyA * sgn, nzA * sgn

    # n(wl) of the winner and of the medium (dispersive elements)
    nElem = er[:, 1]
    medClamped = medium.clamp(min=0)
    medRow = elemD[medClamped]
    nMed, absLenMed = medRow[:, 1], medRow[:, 3]
    for e, nE in nOf.items():
      nElem = torch.where(elem == e, nE, nElem)
      nMed = torch.where(medClamped == e, nE, nMed)

    # Beer-Lambert
    inMedium = medium >= 0
    factor = torch.where(absLenMed <= 0, zero,
                         torch.where(absLenMed >= _BIG, one,
                                     torch.exp(-tSeg / absLenMed)))
    pw = torch.where(inMedium, pw * factor, pw)

    # interactions
    dDotN = dx * nx + dy * ny + dz * nz
    mxD = dx - 2. * nx * dDotN
    myD = dy - 2. * ny * dDotN
    mzD = dz - 2. * nz * dDotN
    n1 = torch.where(inMedium, nMed, one)
    n2 = torch.where(isEntering, nElem, one)
    mu = n1 / n2
    sin2 = torch.clamp(1. - dDotN * dDotN, min=0.)
    root = 1. - mu * mu * sin2
    tir = root < 0
    sq = torch.sqrt(torch.clamp(root, min=0.))
    tx, ty, tz = dx - nx * dDotN, dy - ny * dDotN, dz - nz * dDotN
    snx = torch.where(tir, mxD, mu * tx + nx * sq)
    sny = torch.where(tir, myD, mu * ty + ny * sq)
    snz = torch.where(tir, mzD, mu * tz + nz * sq)
    opt = er[:, 0]
    isMirror, isLens, isAbsorber = opt == MIRROR, opt == LENS, opt == ABSORBER
    isGrating = opt == GRATING
    ndx = torch.where(isMirror, mxD, torch.where(isLens, snx, dx))
    ndy = torch.where(isMirror, myD, torch.where(isLens, sny, dy))
    ndz = torch.where(isMirror, mzD, torch.where(isLens, snz, dz))
    if hasGrating:
      # Ludwig-1970 line grating with the incidence-side normal
      isReflG = er[:, 12] == 0
      gn1 = torch.where(isReflG, n1, one)
      gn2 = torch.where(isReflG, n1, nElem)
      gmu = gn1 / gn2
      gDirX, gDirY, gDirZ = er[:, 14], er[:, 15], er[:, 16]
      nix, niy, niz = -nx, -ny, -nz
      pgx = gDirY * niz - gDirZ * niy
      pgy = gDirZ * nix - gDirX * niz
      pgz = gDirX * niy - gDirY * nix
      pinv = torch.rsqrt(pgx * pgx + pgy * pgy + pgz * pgz + 1e-20)
      pgx, pgy, pgz = pgx * pinv, pgy * pinv, pgz * pinv
      dgx = niy * pgz - niz * pgy
      dgy = niz * pgx - nix * pgz
      dgz = nix * pgy - niy * pgx
      dinv = torch.rsqrt(dgx * dgx + dgy * dgy + dgz * dgz + 1e-20)
      dgx, dgy, dgz = dgx * dinv, dgy * dinv, dgz * dinv
      # true divisions, as in the kernel: on the card PyTorch turns a
      # python-scalar divisor into a multiply by its reciprocal, and on
      # either device `scalar / tensor` into reciprocal-and-multiply, each
      # up to an ulp away from the quotient
      thousand = torch.full_like(wl, 1000.)
      lamUm = wl / thousand
      spacing = thousand / er[:, 13]
      Tt = er[:, 17] * lamUm / (gn1 * spacing)
      Vg = gmu * (dx * nix + dy * niy + dz * niz)
      Wg = (gmu * gmu - 1. + Tt * Tt
            - 2. * gmu * Tt * (dx * dgx + dy * dgy + dz * dgz))
      discG = Vg * Vg - Wg
      evanescent = discG < 0
      gsq = torch.sqrt(torch.clamp(discG, min=0.))
      qg = torch.where(isReflG, -Vg + gsq, -Vg - gsq)
      ggx = gmu * dx - Tt * dgx + qg * nix
      ggy = gmu * dy - Tt * dgy + qg * niy
      ggz = gmu * dz - Tt * dgz + qg * niz
      ginv = torch.rsqrt(ggx * ggx + ggy * ggy + ggz * ggz + 1e-20)
      ggx, ggy, ggz = ggx * ginv, ggy * ginv, ggz * ginv
      # a reflective grating passes non-entering rays through; a
      # transmissive one exiting its substrate refracts like a lens
      ndx = torch.where(isGrating, torch.where(
          isEntering, ggx, torch.where(isReflG, dx, snx)), ndx)
      ndy = torch.where(isGrating, torch.where(
          isEntering, ggy, torch.where(isReflG, dy, sny)), ndy)
      ndz = torch.where(isGrating, torch.where(
          isEntering, ggz, torch.where(isReflG, dz, snz)), ndz)
    inv = torch.rsqrt(ndx * ndx + ndy * ndy + ndz * ndz + 1e-20)
    ndx, ndy, ndz = ndx * inv, ndy * inv, ndz * inv
    if consts:
      ndx, ndy, ndz = _scatterPlain(
          consts, scatterUniforms[bounce * rpb:(bounce + 1) * rpb],
          tables['lobeRows'], elem, isMirror, isLens, isEntering, dDotN, nx,
          ny, nz, dx, dy, dz, ndx, ndy, ndz)

    lensExit = isLens & ~isEntering & ~tir & (medium == elem)
    newMedium = torch.where(isLens & isEntering, elem,
                            torch.where(lensExit, -1, medium))
    newPw = torch.where(isMirror, pw * er[:, 2],
                        torch.where(isAbsorber, zero, pw))
    seqInc = isMirror | isAbsorber | (opt == VACUUM) | lensExit
    if hasGrating:
      gTrans = isGrating & ~isReflG
      gratExit = gTrans & ~isEntering & ~tir
      newMedium = torch.where(gTrans & isEntering, elem,
                              torch.where(gratExit, -1, newMedium))
      newPw = torch.where(isGrating & isEntering & evanescent, zero, newPw)
      seqInc = seqInc | (isGrating & isReflG & isEntering) | gratExit

    # hit ring: power AFTER absorption and BEFORE the interaction
    if output == 'raw':
      inside = (er[:, 4] > 0.5) & live
      fields = (elem.to(torch.float32), pw, isEntering.to(torch.float32),
                px, py, pz, dx, dy, dz)
    else:
      bx0, by0 = er[:, 6], er[:, 8]
      fx = (lx - bx0) / (er[:, 7] - bx0)
      fy = (ly - by0) / (er[:, 9] - by0)
      det = er[:, 5].to(torch.int64)
      inside = ((fx >= 0) & (fx < 1) & (fy >= 0) & (fy < 1)
                & (er[:, 4] > 0.5) & (det >= 0) & live)
      ix = torch.floor(fx * float(W)).to(torch.int64)
      iy = torch.floor(fy * float(H)).to(torch.int64)
      binIdx = (det * H + iy) * W + ix
      fields = ((binIdx, pw) if output == 'hist'
                else (binIdx.to(torch.float32), pw, torch.ones_like(pw)))
    slot = torch.clamp(hitN, max=hitSlots - 1)
    for k in range(hitSlots):
      take = inside & (slot == k)
      for field, value in zip(ring, fields):
        field[k] = torch.where(take, value, field[k])
    hitN = hitN + inside.to(torch.int64)

    ox = torch.where(alive, px, ox)
    oy = torch.where(alive, py, oy)
    oz = torch.where(alive, pz, oz)
    dx = torch.where(live, ndx, dx)
    dy = torch.where(live, ndy, dy)
    dz = torch.where(live, ndz, dz)
    pw = torch.where(live, newPw, pw)
    medium = torch.where(live, newMedium, medium)
    if nStages:
      seq = seq + (live & seqInc).to(torch.int64)
    alive = live & (newPw >= pTol)
  return ring, segs, hitN


class _TriangleTablePlain:
  '''The triangle table (B7) of the plain version: the table's rows on
  the device, each triangle's oriented unit normal, and the sweep.'''

  def __init__(self, triTable, triBoxes, triGroups, triLeaves, dev):
    self.rows = torch.as_tensor(triTable, device=dev).reshape(-1, TRI_COLS)
    self.boxes = self.groups = self.leaves = None
    if triBoxes is not None and len(triBoxes):
      self.boxes = torch.as_tensor(triBoxes, device=dev).reshape(-1, BOX_COLS)
      self.groups = torch.as_tensor(triGroups, device=dev).reshape(
          -1, BOX_COLS)
      self.leaves = torch.as_tensor(triLeaves, device=dev).reshape(
          -1, BOX_COLS)
    r = self.rows
    e1x, e1y, e1z, e2x, e2y, e2z = (r[:, k] for k in range(3, 9))
    cnx = e1y * e2z - e1z * e2y
    cny = e1z * e2x - e1x * e2z
    cnz = e1x * e2y - e1y * e2x
    inv = r[:, 10] * torch.rsqrt(cnx * cnx + cny * cny + cnz * cnz + 1e-30)
    self.normals = torch.stack([cnx * inv, cny * inv, cnz * inv])
    self.elems = r[:, 9].to(torch.int64)

  def sweep(self, ox, oy, oz, dx, dy, dz, tMin, maxRayLength, tCap, alive,
            stats=None, window=0.):
    '''(tT, (nx, ny, nz), elT) of the nearest triangle of every ray:
    Moeller-Trumbore on the world-frame rows in the kernels' operation
    order, swept in blocks of one chunk's rows as (rays x rows) tensors; the
    first row wins a tie inside a block (`torch.min`), a strict `<` across
    blocks, so the lowest table row wins. No cull (it changes no result):
    with a `stats` dict the boxes only count what the cull of the kernels
    leaves to sweep (what their bound is computed from): to `rayBounces`
    the live rays, to `chunks` and `triangles` those of the chunk boxes
    each one's segment, capped at `tCap`, enters; and what the two- and
    three-level sweeps with the shrinking cap leave (`_CapCount`, with the
    `window`).'''
    nTri = self.rows.shape[0]
    step = _TRI_CHUNK if self.boxes is not None else nTri
    big = torch.full_like(ox, _BIG)
    tT, idx = big, torch.zeros(ox.shape, dtype=torch.int64, device=ox.device)
    o = [x[:, None] for x in (ox, oy, oz)]
    d = [x[:, None] for x in (dx, dy, dz)]
    count = None
    if stats is not None and self.boxes is not None:
      count = _CapCount(stats, 'capTriangles', ox, oy, oz, dx, dy, dz,
                        window, alive)
      count.cap(tCap, big)
    for base in range(0, nTri, step):
      r = self.rows[base:base + step]
      dist = self.distances(r, o, d, tMin, maxRayLength)
      tBlock, k = torch.min(dist, dim=1)
      better = tBlock < tT
      tT = torch.where(better, tBlock, tT)
      idx = torch.where(better, k + base, idx)
      if count is not None:
        c = base // _TRI_CHUNK
        if c % SWEEP_GROUP == 0:
          count.group(self.groups[c // SWEEP_GROUP])
        count.chunk(self.boxes[c], tBlock, r.shape[0])
        for a in range(0, r.shape[0], _TRI_LEAF):
          count.leaf(self.leaves[(base + a) // _TRI_LEAF],
                     dist[:, a:a + _TRI_LEAF].min(1).values,
                     min(_TRI_LEAF, r.shape[0] - a))
    if count is not None:
      count.done()
    if stats is not None:
      self._count(stats, ox, oy, oz, dx, dy, dz, tCap, alive)
    hit = tT < _BIG
    nT = self.normals[:, idx]
    return tT, nT, torch.where(hit, self.elems[idx], -1)

  @staticmethod
  def distances(r, o, d, tMin, maxRayLength):
    '''Moeller-Trumbore of the rays (origins `o`, directions `d`: (N, 1)
    columns) against table rows `r`, in the kernels' operation order: the
    (N, rows) distances, _BIG where a row is missed.'''
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (r[None, :, k]
                                                   for k in range(9))
    pvx = d[1] * e2z - d[2] * e2y
    pvy = d[2] * e2x - d[0] * e2z
    pvz = d[0] * e2y - d[1] * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    detS = torch.where(torch.abs(det) < 1e-12, _full(det, 1e-12), det)
    tvx, tvy, tvz = o[0] - p0x, o[1] - p0y, o[2] - p0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) / detS
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (d[0] * qvx + d[1] * qvy + d[2] * qvz) / detS
    t = (e2x * qvx + e2y * qvy + e2z * qvz) / detS
    ok = ((torch.abs(det) > 1e-12) & (u >= 0) & (v >= 0) & (u + v <= 1)
          & (t > tMin) & (t <= maxRayLength))
    return torch.where(ok, t, _full(t, _BIG))

  def _count(self, stats, ox, oy, oz, dx, dy, dz, tCap, alive):
    nTri = self.rows.shape[0]
    nAlive = int(alive.sum())
    for k in ('rayBounces', 'chunks', 'triangles'):
      stats.setdefault(k, 0)
    stats['rayBounces'] += nAlive
    if self.boxes is None:
      stats['triangles'] += nAlive * nTri
    else:
      enters = _slabEnters(self.boxes, ox, oy, oz, dx, dy, dz, tCap, alive)
      sizes = [min(_TRI_CHUNK, nTri - c * _TRI_CHUNK)
               for c in range(len(enters))]
      stats['chunks'] += int(enters.sum())
      stats['triangles'] += int((enters.cpu() * torch.tensor(sizes)).sum())


def _tableIntersectPlain(kind, trim0, r, ox, oy, oz, dx, dy, dz, tMin):
  '''Distances of the rays (columns (N, 1)) to surface-table rows `r`
  ((1, n) per column) of one run's kind and trim: the kernels'
  `tableIntersect`, the JAX package's `_intersectConst(localCoords=...)` on
  float32 row values, so a square of a row value is formed in float32.
  Returns (t (N, n), lox, loy, loz, ldx, ldy, ldz).'''
  r00, r01, r02, r10, r11, r12, r20, r21, r22 = (r[k] for k in range(9))
  lox = r00 * ox + r01 * oy + r02 * oz + r[9]
  loy = r10 * ox + r11 * oy + r12 * oz + r[10]
  loz = r20 * ox + r21 * oy + r22 * oz + r[11]
  ldx = r00 * dx + r01 * dy + r02 * dz
  ldy = r10 * dx + r11 * dy + r12 * dz
  ldz = r20 * dx + r21 * dy + r22 * dz
  p0, p1, p2, p3, p4, tA, tB = (r[k] for k in range(14, 21))
  local = (lox, loy, loz, ldx, ldy, ldz)
  if kind == GS.PLANE:
    dzS = torch.where(torch.abs(ldz) < 1e-12, _full(ldz, 1e-12), ldz)
    t = -loz / dzS
    x, y = lox + t * ldx, loy + t * ldy
    if trim0 == 1.:
      ok = (torch.abs(x) <= tA) & (torch.abs(y) <= tB)
    else:
      r2 = x * x + y * y
      ok = (r2 >= tA * tA) & (r2 <= tB * tB)
    return (torch.where((t > tMin) & ok, t, _full(t, _BIG)),) + local
  wd = None
  if kind == GS.SPHERE:
    a = ldx * ldx + ldy * ldy + ldz * ldz
    b = 2. * (lox * ldx + loy * ldy + loz * ldz)
    c = lox * lox + loy * loy + loz * loz - p0 * p0
  elif kind == GS.CYLINDER:
    a = ldx * ldx + ldy * ldy
    b = 2. * (lox * ldx + loy * ldy)
    c = lox * lox + loy * loy - p0 * p0
  elif kind == GS.CONE:
    w0 = p0 + loz * p1
    wd = ldz * p1
    a = ldx * ldx + ldy * ldy - wd * wd
    b = 2. * (lox * ldx + loy * ldy - w0 * wd)
    c = lox * lox + loy * loy - w0 * w0
  else:
    a = p0 * ldx * ldx + p1 * ldy * ldy + p2 * ldz * ldz
    b = 2. * (p0 * lox * ldx + p1 * loy * ldy + p2 * loz * ldz) + p3 * ldz
    c = p0 * lox * lox + p1 * loy * loy + p2 * loz * loz + p3 * loz + p4
  okD, t1, t2 = _quadraticPlain(a, b, c)
  if kind == GS.QUADRIC:
    # the linear case: a ~ 0 with b != 0 has the single root -c / b
    linT = -c / torch.where(torch.abs(b) < 1e-20, _full(b, 1e-20), b)
    isLin = (torch.abs(a) < 1e-14 * (torch.abs(b) + 1e-20)) \
        & (torch.abs(b) > 1e-20)
    t1 = torch.where(isLin, linT, t1)
    t2 = torch.where(isLin, _full(t2, _BIG), t2)
    okD = okD | isLin
  lo, hi = torch.fmin(t1, t2), torch.fmax(t1, t2)
  out = []
  for t in (lo, hi):
    z = loz + t * ldz
    ok = okD & (t > tMin) & (z >= tA) & (z <= tB)
    if wd is not None:
      ok = ok & (w0 + t * wd >= 0)
    out.append(torch.where(ok, t, _full(t, _BIG)))
  return (torch.fmin(out[0], out[1]),) + local


def _tableNormalPlain(kind, r, lx, ly, lz):
  '''The canonical local normal of a surface-table row's kind at local
  point l (`_normalConst` on float32 row values); `r` its (N,) columns.'''
  zero = torch.zeros_like(lx)
  if kind == GS.PLANE:
    return zero, zero, torch.ones_like(lx)
  if kind == GS.SPHERE:
    inv = torch.rsqrt(lx * lx + ly * ly + lz * lz + 1e-20)
    return lx * inv, ly * inv, lz * inv
  if kind == GS.CYLINDER:
    inv = torch.rsqrt(lx * lx + ly * ly + 1e-20)
    return lx * inv, ly * inv, zero
  if kind == GS.QUADRIC:
    n0, n1 = 2. * r[14] * lx, 2. * r[15] * ly
    n2 = 2. * r[16] * lz + r[17]
  else:                                 # a cone
    rr = torch.sqrt(lx * lx + ly * ly)
    rS = torch.where(rr < 1e-12, _full(rr, 1e-12), rr)
    n0, n1, n2 = lx / rS, ly / rS, -r[15]
  inv = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20)
  return n0 * inv, n1 * inv, n2 * inv


class _SurfaceTablePlain:
  '''The surface table (B8) of the plain version: the table's rows and
  chunk boxes on the device, and the sweep.'''

  def __init__(self, tables, dev):
    self.rows = torch.as_tensor(tables['surfTable'], device=dev).reshape(
        -1, SURF_TABLE_COLS)
    self.boxes = self.groups = self.leaves = None
    if tables['nSurfChunks']:
      self.boxes = torch.as_tensor(tables['surfBoxes'], device=dev).reshape(
          -1, BOX_COLS)
      self.groups = torch.as_tensor(tables['surfGroups'], device=dev) \
          .reshape(-1, BOX_COLS)
      self.leaves = torch.as_tensor(tables['surfLeaves'], device=dev) \
          .reshape(-1, BOX_COLS)
    # blocks in the kernels' sweep order, (kind, trim0, first row, rows,
    # chunk or None): the plain runs by _SURF_CHUNK rows, then each chunk
    self.plain = [(k, t0, a, min(_SURF_CHUNK, b - a), None)
                  for k, t0, a0, b in tables['surfPlainRuns']
                  for a in range(a0, b, _SURF_CHUNK)]
    self.chunked = [(k, t0, r0 + (c - c0) * _SURF_CHUNK, _SURF_CHUNK, c)
                    for k, t0, c0, c1, r0 in tables['surfChunkRuns']
                    for c in range(c0, c1)]
    # the group box each chunk that opens a group opens (`groupSpans`)
    self.opens = {a: g for g, (a, _b) in enumerate(groupSpans(
        [r[2:4] for r in tables['surfChunkRuns']]))}

  def sweep(self, ox, oy, oz, dx, dy, dz, tMin, mrlEff, tBest, window,
            alive, stats=None):
    '''(tS, (nx, ny, nz), elS, (lx, ly)) of the table's winner for every
    ray: the nearest row at most `mrlEff` away, its oriented world normal,
    element (-1 where none) and local (x, y) chart, each block of rows
    swept as (rays x rows) tensors in the kernels' order and operation
    order; the first row wins a tie inside a block (`torch.min`), a strict
    `<` across blocks, as the kernels' row by row sweep. No cull (it
    changes no winner that could win the bounce): with a `stats` dict the
    chunk boxes only count what the kernels' cull leaves to sweep (what
    their bound is computed from): to `rayBounces` the live rays, to
    `chunks` the boxes each one's segment, capped at min(tBest, the plain
    runs' winner, mrlEff) + window, enters, to `rows` (a dict by kind) the
    rows of the plain runs and of those chunks; and what the two- and
    three-level sweeps with the shrinking cap leave (`_CapCount`: its
    `capRows` by kind count the plain runs' rows too).'''
    big = torch.full_like(ox, _BIG)
    zero = torch.zeros_like(ox)
    tS, nx, ny, nz, lx, ly = big, zero, zero, zero, zero, zero
    el = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    o = [x[:, None] for x in (ox, oy, oz)]
    d = [x[:, None] for x in (dx, dy, dz)]
    tPlain, count = big, None
    if stats is not None:
      count = _CapCount(stats, 'capRows', ox, oy, oz, dx, dy, dz, window,
                        alive)
      for kind, _t0, _a, n, _c in self.plain:
        count.plainRows(kind, n)
    leavesPerChunk = _SURF_CHUNK // _SURF_LEAF
    for i, (kind, trim0, a, n, c) in enumerate(self.plain + self.chunked):
      if i == len(self.plain):
        tPlain = tS
        if count is not None:
          count.cap(torch.clamp(torch.minimum(tBest, tPlain), max=mrlEff)
                    + window, tPlain)
      r = self.rows[a:a + n]
      t = _tableIntersectPlain(kind, trim0, [r[None, :, k] for k in
                                             range(SURF_TABLE_COLS)],
                               *o, *d, tMin)[0]
      t = torch.where(t <= mrlEff, t, _full(t, _BIG))
      tBlock, k = torch.min(t, dim=1)
      if count is not None and c is not None:
        if c in self.opens:
          count.group(self.groups[self.opens[c]])
        count.chunk(self.boxes[c], tBlock, n, kind)
        for j in range(leavesPerChunk):
          count.leaf(self.leaves[c * leavesPerChunk + j],
                     t[:, j * _SURF_LEAF:(j + 1) * _SURF_LEAF].min(1).values,
                     _SURF_LEAF, kind)
      better = tBlock < tS
      # the winner's attributes, from its row, in the kernels' order
      rk = [x for x in self.rows[a + k].T]
      _t, lox, loy, loz, ldx, ldy, ldz = _tableIntersectPlain(
          kind, trim0, rk, ox, oy, oz, dx, dy, dz, tMin)
      lxH, lyH, lzH = lox + tBlock * ldx, loy + tBlock * ldy, \
          loz + tBlock * ldz
      nlx, nly, nlz = _tableNormalPlain(kind, rk, lxH, lyH, lzH)
      orn = rk[12]
      tS = torch.where(better, tBlock, tS)
      nx = torch.where(better, (rk[0] * nlx + rk[3] * nly + rk[6] * nlz)
                       * orn, nx)
      ny = torch.where(better, (rk[1] * nlx + rk[4] * nly + rk[7] * nlz)
                       * orn, ny)
      nz = torch.where(better, (rk[2] * nlx + rk[5] * nly + rk[8] * nlz)
                       * orn, nz)
      el = torch.where(better, rk[13].to(torch.int64), el)
      lx = torch.where(better, lxH, lx)
      ly = torch.where(better, lyH, ly)
    if not self.chunked:
      tPlain = tS
    if count is not None:
      count.done()
    if stats is not None:
      tCap = torch.clamp(torch.minimum(tBest, tPlain), max=mrlEff) + window
      self._count(stats, ox, oy, oz, dx, dy, dz, tCap, alive)
    return tS, (nx, ny, nz), el, (lx, ly)

  def _count(self, stats, ox, oy, oz, dx, dy, dz, tCap, alive):
    nAlive = int(alive.sum())
    for k in ('rayBounces', 'chunks'):
      stats.setdefault(k, 0)
    rows = stats.setdefault('rows', {})
    stats['rayBounces'] += nAlive
    for kind, _t0, _a, n, _c in self.plain:
      rows[kind] = rows.get(kind, 0) + nAlive * n
    if self.boxes is None:
      return
    enters = _slabEnters(self.boxes, ox, oy, oz, dx, dy, dz, tCap,
                         alive).tolist()
    stats['chunks'] += sum(enters)
    for kind, _t0, _a, n, c in self.chunked:
      rows[kind] = rows.get(kind, 0) + enters[c] * n


def _inverseDirections(dx, dy, dz):
  '''The kernels' sign-preserving inverse direction (|d| clamped at
  1e-30).'''
  return [torch.where(x < 0, -1., 1.) / torch.clamp(torch.abs(x), min=1e-30)
          for x in (dx, dy, dz)]


def _slabIn(b, o, inv, tCap):
  '''Whether each ray's segment [0, tCap] from origins `o` enters box `b`
  (lo xyz, hi xyz): the kernels' slab test, operation for operation.'''
  t1 = [(b[k] - x) * iv for k, x, iv in zip(range(3), o, inv)]
  t2 = [(b[3 + k] - x) * iv for k, x, iv in zip(range(3), o, inv)]
  tN = torch.maximum(torch.maximum(torch.minimum(t1[0], t2[0]),
                                   torch.minimum(t1[1], t2[1])),
                     torch.clamp(torch.minimum(t1[2], t2[2]), min=0.))
  tF = torch.minimum(torch.minimum(torch.maximum(t1[0], t2[0]),
                                   torch.maximum(t1[1], t2[1])),
                     torch.minimum(torch.maximum(t1[2], t2[2]), tCap))
  return tN <= tF


def _slabEnters(boxes, ox, oy, oz, dx, dy, dz, tCap, alive):
  '''Per chunk box, how many of the live rays the kernels' slab test lets
  in (the ray's segment, capped at `tCap`, enters the box): an int64
  (nBoxes,) tensor.'''
  inv = _inverseDirections(dx, dy, dz)
  return torch.stack([(_slabIn(boxes[c], (ox, oy, oz), inv, tCap)
                       & alive).sum() for c in range(boxes.shape[0])])


def _warpAny(mask):
  '''Per ray, whether any ray of its warp (32 consecutive rays) is in
  `mask`.'''
  n = mask.shape[0]
  pad = -n % 32
  if pad:
    mask = torch.cat([mask, mask.new_zeros(pad)])
  return mask.view(-1, 32).any(1).repeat_interleave(32)[:n]


class _CapView:
  '''One view of `_CapCount`: a two- or three-level sweep (`leaves`), by
  each ray alone or by its warp (`warp`), its counts added to dict `out` at
  `done`.'''

  def __init__(self, out, rowsKey, leaves, warp, alive):
    self.out, self.rowsKey, self.leaves, self.warp = out, rowsKey, leaves, warp
    self.inGroup = self.inChunk = alive
    self.tRun, self.sums = None, {}
    out.setdefault(rowsKey, {} if rowsKey == 'capRows' else 0)
    for k in ('groupTests', 'chunkTests', 'capChunks') + (
        ('leafTests', 'capLeaves') if leaves else ()):
      out.setdefault(k, 0)

  def add(self, key, n):
    self.sums[key] = self.sums.get(key, 0) + n

  def enter(self, count, box, within):
    '''The rays of `within` that enter `box` (by the warp: every ray of
    `within` whose warp has one that does), each segment capped at
    min(the entry cap, the ray's running winner + window).'''
    e = _slabIn(box, count.o, count.inv,
                torch.minimum(count.tCap, self.tRun + count.window)) & within
    return _warpAny(e) & within if self.warp else e

  def swept(self, entered, tBlock, nRows, kind):
    self.add(('rows', kind), entered.sum() * nRows)
    self.tRun = torch.where(entered & (tBlock < self.tRun), tBlock,
                            self.tRun)

  def done(self):
    for key, n in self.sums.items():
      if key[0] == 'rows':
        if key[1] is None:
          self.out[self.rowsKey] += int(n)
        else:
          rows = self.out[self.rowsKey]
          rows[key[1]] = rows.get(key[1], 0) + int(n)
      else:
        self.out[key] += int(n)


class _CapCount:
  '''What the kernels' sweep of a table leaves to the live rays, added to
  `stats` in three views of the same boxes and rows. The two-level sweep,
  each ray alone, in the keys of `stats` itself: a group box is tested
  (`groupTests`), and the chunk boxes of an entered group (`chunkTests`),
  each against the segment capped at min(the entry cap, the ray's running
  winner + `window`), the winner over the chunks it entered so far; the
  chunks entered (`capChunks`) and their rows (`stats[rowsKey]`, by kind
  where a `kind` is given). The kernels' three-level sweep, each ray alone,
  in `stats['threeLevel']`: likewise, and the leaf boxes of an entered
  chunk tested (`leafTests`), the leaves entered (`capLeaves`) and only
  their rows swept, the winner over the leaves entered so far. The three-
  level sweep as a warp runs it, in `stats['warp']`: the 32 consecutive
  rays of a warp that are live all enter a box that any of them enters,
  test the next boxes and sweep the rows, each updating its winner (counts
  per live ray, as above). The
  plain runs' rows of a surface table (`plainRows`) count in every view.
  Counts add up on the device and reach `stats` at `done`.'''

  def __init__(self, stats, rowsKey, ox, oy, oz, dx, dy, dz, window, alive):
    self.o, self.inv = (ox, oy, oz), _inverseDirections(dx, dy, dz)
    self.window, self.alive, self.tCap = window, alive, None
    self.views = [_CapView(stats, rowsKey, False, False, alive)] + [
        _CapView(stats.setdefault(key, {}), rowsKey, leaves, warp, alive)
        for key, leaves, warp in (('threeLevel', True, False),
                                  ('warp', True, True))]

  def plainRows(self, kind, n):
    for v in self.views:
      v.add(('rows', kind), self.alive.sum() * n)

  def cap(self, tCap, tRun):
    '''The entry cap of the chunked part and the winner it starts from.'''
    self.tCap = tCap
    for v in self.views:
      v.tRun = tRun

  def group(self, box):
    for v in self.views:
      v.add('groupTests', self.alive.sum())
      v.inGroup = v.enter(self, box, self.alive)

  def chunk(self, box, tBlock, nRows, kind=None):
    for v in self.views:
      v.add('chunkTests', v.inGroup.sum())
      e = v.enter(self, box, v.inGroup)
      v.add('capChunks', e.sum())
      if v.leaves:
        v.inChunk = e
      else:
        v.swept(e, tBlock, nRows, kind)

  def leaf(self, box, tLeaf, nRows, kind=None):
    for v in self.views:
      if v.leaves:
        v.add('leafTests', v.inChunk.sum())
        e = v.enter(self, box, v.inChunk)
        v.add('capLeaves', e.sum())
        v.swept(e, tLeaf, nRows, kind)

  def done(self):
    for v in self.views:
      v.done()


def _geomNormalPlain(row, kind, lx, ly, lz, nlx, nly, nlz):
  '''The winner's canonical local normal for the kinds of B2, over the
  plane / sphere / cylinder normals (nlx, nly, nlz), from the winners'
  (N, rowCols) rows: the reference's `_normalFromCols`, whose param
  columns are float32 (so (1 + k) c^2 is formed in float32 here).'''
  P = [row[:, G_P + k] for k in range(5)]
  tiny = lambda x: torch.where(x < 1e-12, _full(x, 1e-12), x)
  # triangle: its unit normal, formed in double and rounded once
  isT = kind == GS.TRIANGLE
  nlx = torch.where(isT, row[:, G_X + 6], nlx)
  nly = torch.where(isT, row[:, G_X + 7], nly)
  nlz = torch.where(isT, row[:, G_X + 8], nlz)
  # quadric: +grad f
  n0, n1 = 2. * P[0] * lx, 2. * P[1] * ly
  n2 = 2. * P[2] * lz + P[3]
  inv = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20)
  isQ = kind == GS.QUADRIC
  nlx = torch.where(isQ, n0 * inv, nlx)
  nly = torch.where(isQ, n1 * inv, nly)
  nlz = torch.where(isQ, n2 * inv, nlz)
  # cone: radial, tipped by -tanA
  rS = tiny(torch.sqrt(lx * lx + ly * ly))
  n0, n1, n2 = lx / rS, ly / rS, -P[1]
  inv = torch.rsqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-20)
  isC = kind == GS.CONE
  nlx = torch.where(isC, n0 * inv, nlx)
  nly = torch.where(isC, n1 * inv, nly)
  nlz = torch.where(isC, n2 * inv, nlz)
  # asphere: grad(z - sag(r))
  c0, kk, a4, a6, a8 = P
  r2 = lx * lx + ly * ly
  K1 = (1. + kk) * c0 * c0
  rootA = torch.sqrt(_fmax(1. - K1 * r2, 1e-12))
  opr = 1. + rootA
  g = (c0 * (_full(opr, 2.) / opr + K1 * r2 / (rootA * (opr * opr)))
       + 4. * a4 * r2 + 6. * a6 * r2 * r2 + 8. * a8 * (r2 * (r2 * r2)))
  inv = torch.rsqrt(g * g * r2 + 1. + 1e-20)
  isA = kind == GS.ASPHERE
  nlx = torch.where(isA, -g * lx * inv, nlx)
  nly = torch.where(isA, -g * ly * inv, nly)
  nlz = torch.where(isA, inv, nlz)
  # torus: away from the tube's centre circle
  scale = P[0] / tiny(torch.sqrt(lx * lx + ly * ly))
  n0, n1 = lx * (1. - scale), ly * (1. - scale)
  inv = torch.rsqrt(n0 * n0 + n1 * n1 + lz * lz + 1e-20)
  isR = kind == GS.TORUS
  nlx = torch.where(isR, n0 * inv, nlx)
  nly = torch.where(isR, n1 * inv, nly)
  nlz = torch.where(isR, lz * inv, nlz)
  return nlx, nly, nlz


def _ringCounters(key, segs, hitN, hitSlots):
  '''int64 (3,) tensor (segments, hits = filled ring slots, hitOverflow).'''
  return torch.stack([segs, (key >= 0).sum(),
                      torch.clamp(hitN - hitSlots, min=0).sum()])


def traceHistogramPlain(tables, histograms, columns, maxIntersections,
                        maxRayLength, distTol, powerTol, hitSlots,
                        scatterUniforms=None, triangleStats=None,
                        surfaceStats=None, cullStats=None):
  '''Plain version of the histogram kernel: `_bounceLoopPlain` + float32
  `index_add_` binning into a fresh zero delta, which is then added into
  `histograms` IN PLACE. Returns an int64 (3,) tensor (segments, hits,
  hitOverflow). `scatterUniforms`, `triangleStats`, `surfaceStats`,
  `cullStats`: see `_bounceLoopPlain`.'''
  (ringBin, ringW), segs, hitN = _bounceLoopPlain(
      tables, columns, maxIntersections, maxRayLength, distTol, powerTol,
      hitSlots, 'hist', scatterUniforms, triangleStats, surfaceStats,
      cullStats)
  delta = torch.zeros((2, histograms['power'].numel()), dtype=torch.float32,
                      device=ringW.device)
  for k in range(hitSlots):
    valid = ringBin[k] >= 0
    idx = ringBin[k].clamp(min=0)
    delta[0].index_add_(0, idx, torch.where(valid, ringW[k],
                                            torch.zeros_like(ringW[k])))
    delta[1].index_add_(0, idx, valid.to(torch.float32))
  _addDelta(histograms, delta)
  return _ringCounters(ringBin, segs, hitN, hitSlots)


def _addDelta(histograms, delta):
  '''Add one step's (2, ...) power / count delta into the run's float32
  `histograms` in place. The step's hits are binned into a zeroed delta
  first and the delta is added once, as the reference adds its kernel's
  per-step output, so a bin keeps growing past 2**24 (where float32 `+1`
  rounds back to the bin). One fused add for both histograms: on the card
  one launch beside the kernel, with the delta's memset two.'''
  torch._foreach_add_(
      [histograms['power'], histograms['counts']],
      [delta[0].view_as(histograms['power']),
       delta[1].view_as(histograms['counts'])])


def traceSweepPlain(sweepTables, histograms, raysPerVariant, maxIntersections,
                    maxRayLength, distTol, powerTol, hitSlots, uniforms=None,
                    columns=None, strata=None, strataTile=0,
                    scatterUniforms=None):
  '''Plain version of the sweep kernel: `traceHistogramPlain` variant by
  variant, every variant fed the SAME float32 `uniforms`
  (`uniformRows`, n) — through its own sampler block — or the same ray
  `columns` (8, n) with the same `scatterUniforms` for a scene with
  scatter. Adds into the (V, D, H, W) `histograms` IN PLACE and returns an
  int64 (V, 3) tensor of (segments, hits, hitOverflow) per variant. Where
  the variants share the draw (`sharedDraws`), the rays are drawn once in
  the source's frame and placed per variant, as the kernel draws them once
  per group. (A loop over the variants: it exists to be compared with,
  not to be fast.)'''
  counters = []
  local = None
  if columns is None and sweepTables.get('sharedDraws'):
    local = sampleLocalPlain(variantTables(sweepTables, 0), uniforms[0],
                             uniforms[1], strata, strataTile)
  for v in range(sweepTables['nVariants']):
    tables = variantTables(sweepTables, v)
    scatterU = scatterUniforms
    if columns is not None:
      cols = tuple(columns[k] for k in range(8))
    else:
      cols = (placeRaysPlain(tables, local) if local is not None
              else sampleRaysPlain(tables, uniforms[0], uniforms[1], strata,
                                   strataTile))
      scatterU = uniforms[2:] if tables['scatter'] else None
    counters.append(traceHistogramPlain(
        tables, dict(power=histograms['power'][v],
                     counts=histograms['counts'][v]), cols, maxIntersections,
        maxRayLength, distTol, powerTol, hitSlots, scatterU))
  return torch.stack(counters)


def traceBinsPlain(tables, columns, maxIntersections, maxRayLength, distTol,
                   powerTol, hitSlots, scatterUniforms=None):
  '''Plain version of the per-ray-bin kernel. Returns (ring, counters): ring
  a float32 (3, hitSlots, N) tensor — bin (-1 = empty), power, count.'''
  ring, segs, hitN = _bounceLoopPlain(
      tables, columns, maxIntersections, maxRayLength, distTol, powerTol,
      hitSlots, 'bins', scatterUniforms)
  return torch.stack(ring), _ringCounters(ring[0], segs, hitN, hitSlots)


def traceRawPlain(tables, columns, maxIntersections, maxRayLength, distTol,
                  powerTol, hitSlots, scatterUniforms=None):
  '''Plain version of the raw-record kernel. Returns (ring, counters): ring
  a float32 (9, hitSlots, N) tensor — element (-1 = empty), power,
  isEntering, hit point (3), incoming direction (3).'''
  ring, segs, hitN = _bounceLoopPlain(
      tables, columns, maxIntersections, maxRayLength, distTol, powerTol,
      hitSlots, 'raw', scatterUniforms)
  return torch.stack(ring), _ringCounters(ring[0], segs, hitN, hitSlots)


def binRing(histograms, ring):
  '''Add a per-ray (3, hitSlots, N) ring of (bin, power, count) into the
  float32 (D, H, W) `histograms` IN PLACE, accumulating in float64: the
  binning the reference leaves to XLA's scatter-add outside its kernel.
  Plain PyTorch on either device (`index_add_` on float64 copies of the
  histograms, cast back), so the sums do not depend on the order in which
  the adds land.'''
  shape = histograms['power'].shape
  power = histograms['power'].double().view(-1)
  counts = histograms['counts'].double().view(-1)
  for s in range(ring.shape[1]):
    valid = ring[0, s] >= 0
    idx = torch.where(valid, ring[0, s], 0.).to(torch.int64)
    power.index_add_(0, idx, torch.where(valid, ring[1, s], 0.).double())
    counts.index_add_(0, idx, torch.where(valid, ring[2, s], 0.).double())
  histograms['power'].copy_(power.view(shape))
  histograms['counts'].copy_(counts.view(shape))


# ------------------------------------------------------------------ wrappers

def _kernelFunction(name, tri):
  from .._build import buildKernels
  libs, _info = buildKernels()
  stem, symbol, nOut = _KERNELS[name]
  if tri:
    stem, symbol = stem + '_tri', symbol + 'Tri'
  fn = getattr(libs[stem], symbol)
  if fn.argtypes is None:
    # table, triangle table and its boxes, surface table and its boxes,
    # rayIn, the outputs, counters | ip, fp | stream
    fn.argtypes = [ctypes.c_void_p] * (7 + nOut) + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_float),
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
  return fn


# `_sweepPlan`'s answers by launch words (the seed left out) and device
_sweepPlans = {}


def _sweepPlan(ip, fp, group, dev):
  '''(dynamic shared bytes, blocks an SM with them, blocks an SM its
  instance allows alone) of the sweep launch of the words `ip` / `fp` with
  `group` variants a block, from the kernel library (csrc `planSweep`, the
  launcher's own shared-memory layout and instance). Sets the group word
  of `ip`.'''
  ip[len(ip) - 2] = group
  key = (dev.index, ip[0]) + tuple(ip[2:])
  if key not in _sweepPlans:
    from .._build import buildKernels
    libs, _info = buildKernels()
    fn = libs['trace_sweep_kernel'].odwSweepPlan
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong),
                   ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(dev):
      err = fn(ip, fp, out)
    if err != 0:
      raise KernelError(f'the sweep kernel refused a group of {group}: '
                        f'CUDA error {err}')
    _sweepPlans[key] = tuple(out)
  return _sweepPlans[key]


def _checkTensor(name, x, dev, shape, dtype=torch.float32):
  if not isinstance(x, torch.Tensor):
    raise TypeError(f'{name} must be a torch.Tensor')
  if x.dtype != dtype:
    raise TypeError(f'{name} must be {dtype}, got {x.dtype}')
  if x.device != dev:
    raise ValueError(f'{name} lies on {x.device}, expected {dev}')
  if tuple(x.shape) != tuple(shape):
    raise ValueError(f'{name} must have shape {tuple(shape)}, got '
                     f'{tuple(x.shape)}')
  if not x.is_contiguous():
    raise ValueError(f'{name} must be contiguous')


def _checkInputs(tables, nRays, maxIntersections, hitSlots, seed, uniforms,
                 columns, strataTile):
  '''Validation shared by the three wrappers. Returns (mode, rayIn, strata)
  of the kernel launch.'''
  dev = tables['table'].device
  scatter = tables.get('scatter', False)
  seedWithColumns = scatter and seed is not None and columns is not None \
      and uniforms is None
  if sum(x is not None for x in (seed, uniforms, columns)) != 1 \
      and not seedWithColumns:
    raise ValueError('give exactly one of seed, uniforms, columns (a scene '
                     'with scatter traced from columns adds a seed)')
  if scatter and columns is not None and seed is None:
    raise ValueError('a scene with scatter traced from ray columns needs a '
                     'seed: it keys the scatter draws')
  if not 1 <= hitSlots <= MAX_HIT_SLOTS:
    raise ValueError(f'hitSlots must be in [1, {MAX_HIT_SLOTS}]')
  if nRays <= 0 or maxIntersections <= 0:
    raise ValueError('nRays and maxIntersections must be positive')
  if columns is None and tables['samplerOff'] < 0:
    raise ValueError('seed / uniforms input needs tables built with a '
                     'sampler spec')
  # strata belong to the point sampler: the reference's surface branch
  # returns before them
  strata = None
  if columns is None and strataTile \
      and tables['samplerKind'] == SAMPLER_POINT:
    strata = tileStrata(nRays, int(strataTile))
  if uniforms is not None:
    _checkTensor('uniforms', uniforms, dev,
                 (uniformRows(tables, maxIntersections), nRays))
    return MODE_UNIFORMS, uniforms, strata
  if columns is not None:
    _checkTensor('columns', columns, dev, (8, nRays))
    return MODE_COLUMNS, columns, strata
  return MODE_SEED, None, strata


def _plainColumns(tables, nRays, seed, uniforms, columns, strata, strataTile,
                  maxIntersections):
  '''(the ray columns a plain version starts from, its scatter uniform rows
  or None) for CPU inputs in any of the three modes: `seed` seeds a
  torch.Generator that draws the uniform rows (`uniformRows`; with
  `columns`, the scatter rows only).'''
  dev = tables['table'].device
  scatter = tables.get('scatter', False)

  def draw(rows):
    generator = torch.Generator(device=dev)
    generator.manual_seed(int(seed))
    return torch.rand((rows, nRays), generator=generator, device=dev,
                      dtype=torch.float32)

  if columns is not None:
    return (tuple(columns[k] for k in range(8)),
            draw(tables['scatterRows'] * maxIntersections) if scatter
            else None)
  if uniforms is None:
    uniforms = draw(uniformRows(tables, maxIntersections))
  cols = samplerColumnsPlain(tables, uniforms, strata, strataTile)
  return cols, (uniforms[samplerUniforms(tables):] if scatter else None)


def traceHistogram(tables, histograms, nRays, maxIntersections, maxRayLength,
                   distTol, powerTol=1e-6, hitSlots=1, seed=None,
                   uniforms=None, columns=None, strataTile=0):
  '''Sample-or-read `nRays` rays, trace them, and ADD the detector hits
  into `histograms` (dict of float32 (D, H, W) `power` / `counts`) in place.
  Returns an int64 (3,) tensor (segments, hits, hitOverflow) on the tables'
  device — no host synchronisation.

  The kernel bins into a zeroed per-step delta, a (2, D, H, W) workspace
  kept on `tables` (`histDelta`, so a step allocates nothing), which is
  then added into `histograms` on the device: the reference's per-step
  delta, so a bin goes on counting past 2**24.

  Exactly one input mode: `seed` (int; rays drawn in the kernel),
  `uniforms` (float32 (`uniformRows(tables, maxIntersections)`, nRays): the
  sampler's draws — point source: first variable, phi; surface source:
  face, u, v, theta, phi — then a scene's scatter draws, bounce by bounce)
  or `columns` (float32 (8, nRays): ox, oy, oz, dx, dy, dz, pw, wl; on a
  scene with scatter together with a `seed`, which keys the scatter
  draws). In seed mode the scatter draws of bounce b are Philox calls with
  counter words 2 = 2 + b and 3 = 0 (the lobe) or 1 (MODIFY), apart from
  the sampler's words 0 and 1. `strataTile` > 0 stratifies the point sampler's quantiles by
  ray-index cell (see `tileStrata`; ignored for `columns` and for a surface
  sampler, whose reference returns before its strata).

  Tensors on a CUDA device go through the CUDA kernel, or this raises; the
  plain PyTorch version runs only for tensors on the CPU (there `seed` seeds
  a torch.Generator that draws the sampler's uniform rows).'''
  dev = tables['table'].device
  mode, rayIn, strata = _checkInputs(tables, nRays, maxIntersections,
                                     hitSlots, seed, uniforms, columns,
                                     strataTile)
  H, W = tables['bins']
  D = tables['nDet']
  if D * H * W >= 2 ** 31:
    raise ValueError('histogram too large for 32-bit bin indices')
  for name in ('power', 'counts'):
    _checkTensor(f"histograms['{name}']", histograms[name], dev, (D, H, W))
  if dev.type == 'cpu':
    cols, scatterU = _plainColumns(tables, nRays, seed, uniforms, columns,
                                   strata, strataTile, maxIntersections)
    return traceHistogramPlain(tables, histograms, cols, maxIntersections,
                               maxRayLength, distTol, powerTol, hitSlots,
                               scatterU)
  delta = tables.get('histDelta')
  if delta is None or tuple(delta.shape) != (2, D, H, W):
    delta = tables['histDelta'] = torch.empty((2, D, H, W),
                                              dtype=torch.float32, device=dev)
  delta.zero_()
  counters = _launchKernel('traceHistogram', tables, (delta[0], delta[1]),
                           nRays, mode, rayIn, int(seed or 0), strata,
                           strataTile, maxIntersections, maxRayLength,
                           distTol, powerTol, hitSlots)
  _addDelta(histograms, delta)
  return counters


def _traceRing(name, plain, nFields, tables, nRays, maxIntersections,
               maxRayLength, distTol, powerTol, hitSlots, seed, uniforms,
               columns, strataTile):
  '''Common part of `traceBins` and `traceRaw`: CPU tensors go through the
  plain version, CUDA tensors through the kernel, which writes every element
  of the (nFields, hitSlots, nRays) ring (allocated uninitialised).'''
  dev = tables['table'].device
  mode, rayIn, strata = _checkInputs(tables, nRays, maxIntersections,
                                     hitSlots, seed, uniforms, columns,
                                     strataTile)
  if dev.type == 'cpu':
    cols, scatterU = _plainColumns(tables, nRays, seed, uniforms, columns,
                                   strata, strataTile, maxIntersections)
    return plain(tables, cols, maxIntersections, maxRayLength, distTol,
                 powerTol, hitSlots, scatterU)
  ring = torch.empty((nFields, hitSlots, nRays), dtype=torch.float32,
                     device=dev)
  counters = _launchKernel(name, tables, (ring,), nRays, mode, rayIn,
                           int(seed or 0), strata, strataTile,
                           maxIntersections, maxRayLength, distTol, powerTol,
                           hitSlots)
  return ring, counters


def traceBins(tables, nRays, maxIntersections, maxRayLength, distTol,
              powerTol=1e-6, hitSlots=1, seed=None, uniforms=None,
              columns=None, strataTile=0):
  '''Sample-or-read `nRays` rays, trace them, and return the hit ring per
  ray instead of binning it: (ring, counters) with ring a float32
  (3, hitSlots, nRays) tensor — bin index into the flattened (D, H, W)
  histogram (-1 = empty slot), power, count — gated exactly as
  `traceHistogram` gates, and counters as there. `binRing` adds such a ring
  into histograms. Input modes, strata and the device rule as in
  `traceHistogram`.'''
  H, W = tables['bins']
  if tables['nDet'] * H * W > 2 ** 24:
    raise ValueError('histogram too large for bin indices carried as '
                     'float32 (more than 2**24 bins)')
  return _traceRing('traceBins', traceBinsPlain, 3, tables, nRays,
                    maxIntersections, maxRayLength, distTol, powerTol,
                    hitSlots, seed, uniforms, columns, strataTile)


def traceRaw(tables, nRays, maxIntersections, maxRayLength, distTol,
             powerTol=1e-6, hitSlots=1, seed=None, uniforms=None,
             columns=None, strataTile=0):
  '''Sample-or-read `nRays` rays, trace them, and return EVERY hit on a
  recording element (no histogram-bounds gate): (ring, counters) with ring
  a float32 (9, hitSlots, nRays) tensor, slot-major, rows element (-1 =
  empty slot), power (after Beer-Lambert along the segment, before the
  interaction), isEntering, world hit point x y z, INCOMING direction
  x y z; counters an int64 (3,) tensor (segments, hits = filled slots,
  hitOverflow = passes beyond `hitSlots`, each of which overwrote the last
  slot). Input modes, strata and the device rule as in `traceHistogram`.'''
  return _traceRing('traceRaw', traceRawPlain, 9, tables, nRays,
                    maxIntersections, maxRayLength, distTol, powerTol,
                    hitSlots, seed, uniforms, columns, strataTile)


def traceSweep(sweepTables, histograms, raysPerVariant, maxIntersections,
               maxRayLength, distTol, powerTol=1e-6, hitSlots=1, seed=None,
               uniforms=None, columns=None, strataTile=0):
  '''`traceHistogram` for every variant of `sweepTables`
  (`buildSweepTables`) in ONE kernel launch: sample-or-read `raysPerVariant`
  rays, trace them through each variant's scene, and ADD the detector hits
  into `histograms` (dict of float32 (V, D, H, W) `power` / `counts`) in
  place. Returns an int64 (V, 3) tensor (segments, hits, hitOverflow per
  variant) on the tables' device — no host synchronisation.

  The rays are the same in every variant (common random numbers): `seed`
  draws by the ray's index WITHIN its variant, `uniforms`
  (`uniformRows`, raysPerVariant) and `columns` (8, raysPerVariant; with a
  `seed` for the scatter draws of a scene with scatter) are shared, and `strataTile` stratifies
  by the within-variant index. Variant v of this call therefore gets what
  `traceHistogram` gives for nRays = raysPerVariant on variant v's table
  with the same inputs. `columns` are for sweeps whose source is the same in
  every variant. Where the tables say `sharedDraws` and the kernel samples,
  a block of the kernel traces its rays through a group of
  `sweepVariantGroup` variants, drawing each ray once for the group;
  `lastLaunch['traceSweep']` records the group.

  Tensors on a CUDA device go through the CUDA kernel, or this raises; the
  plain PyTorch version runs only for tensors on the CPU.'''
  dev = sweepTables['table'].device
  mode, rayIn, strata = _checkInputs(sweepTables, raysPerVariant,
                                     maxIntersections, hitSlots, seed,
                                     uniforms, columns, strataTile)
  V = sweepTables['nVariants']
  H, W = sweepTables['bins']
  D = sweepTables['nDet']
  if V * D * H * W >= 2 ** 31:
    raise ValueError('stacked histograms too large for 32-bit bin indices')
  if columns is not None and not sweepTables['sameSource']:
    raise ValueError('ray columns are shared by all variants, but the '
                     "source's placement or wavelength differs across them")
  _checkTensor('sweep table', sweepTables['table'], dev,
               (V, sweepTables['tableLen']))
  for name in ('power', 'counts'):
    _checkTensor(f"histograms['{name}']", histograms[name], dev,
                 (V, D, H, W))
  if dev.type == 'cpu':
    scatterU = None
    if mode == MODE_COLUMNS:
      _cols, scatterU = _plainColumns(
          variantTables(sweepTables, 0), raysPerVariant, seed, None, columns,
          strata, strataTile, maxIntersections)
    if mode == MODE_SEED:
      generator = torch.Generator(device=dev)
      generator.manual_seed(int(seed))
      uniforms = torch.rand((uniformRows(sweepTables, maxIntersections),
                             raysPerVariant), generator=generator,
                            device=dev, dtype=torch.float32)
    return traceSweepPlain(sweepTables, histograms, raysPerVariant,
                           maxIntersections, maxRayLength, distTol, powerTol,
                           hitSlots, uniforms=uniforms, columns=columns,
                           strata=strata, strataTile=strataTile,
                           scatterUniforms=scatterU)
  return _launchKernel('traceSweep', sweepTables,
                       (histograms['power'], histograms['counts']),
                       raysPerVariant, mode, rayIn, int(seed or 0), strata,
                       strataTile, maxIntersections, maxRayLength, distTol,
                       powerTol, hitSlots,
                       sweep=(V, D * H * W, sweepGroupsAllowed(sweepTables,
                                                               mode)))


def _launchKernel(name, tables, outs, nRays, mode, rayIn, seed, strata,
                  strataTile, maxIntersections, maxRayLength, distTol,
                  powerTol, hitSlots, sweep=None):
  '''Launch kernel `name` (a key of `_KERNELS`) on PyTorch's current stream
  with the output tensors `outs` (inputs already validated by the wrapper),
  and add one to its launch count. `sweep` = (variants, floats per variant's
  histogram, whether a block may trace a group of variants,
  `sweepGroupsAllowed`) for the sweep kernel, whose `tables` are stacked,
  whose `nRays` are per variant and whose counters come back per variant.
  CUDA tensors
  only: a CPU tensor's address means nothing to the card, so it is refused
  before anything is built.'''
  table = tables['table']
  dev = table.device
  glob = {k: tables.get(k) for k in ('triTable', 'surfTable') + tuple(
      _BOX_PACKS)}
  for t in (table, rayIn, *glob.values()) + tuple(outs):
    if t is not None and t.device.type != 'cuda':
      raise ValueError(f'the CUDA kernel takes CUDA tensors only, got a '
                       f'tensor on {t.device}')
  nTri, nChunks = tables.get('nTri', 0), tables.get('nTriChunks', 0)
  nGroups = tables.get('nTriGroups', 0) if nTri else 0
  nSurfT, nSurfChunks = (tables.get('nSurfTable', 0),
                         tables.get('nSurfChunks', 0))
  nSurfGroups = tables.get('nSurfGroups', 0)
  lead = tuple(table.shape[:-1])
  for key, n, cols in (('triTable', nTri, TRI_COLS),
                       ('triBoxPack', nGroups + nChunks
                        + triLeafCount(nTri, nChunks) if nTri else 0,
                        BOX_STRIDE),
                       ('surfTable', nSurfT, SURF_TABLE_COLS),
                       ('surfBoxPack', nSurfGroups + nSurfChunks
                        * (1 + _SURF_CHUNK // _SURF_LEAF), BOX_STRIDE)):
    if n:
      _checkTensor(key, glob[key], dev, lead + (n, cols))
  runs = surfaceRuns(tables.get('surfPlainRuns', ()),
                     tables.get('surfChunkRuns', ())) if nSurfT else []
  fn = _kernelFunction(name, nTri > 0 or nSurfT > 0)
  variants, histLen, groups = sweep if sweep is not None else (1, 0, False)
  sharedDraws = bool(tables.get('sharedDraws', False)) and sweep is not None
  counters = torch.zeros((3,) if sweep is None else (variants, 3),
                         dtype=torch.int64, device=dev)
  H, W = tables['bins']
  G1, G2 = strata if strata is not None else (0, 1)
  runWords = [x for run in runs for x in run]
  runWords += [0] * (MAX_SURF_RUNS * RUN_COLS - len(runWords))
  ip = (ctypes.c_longlong * (34 + MAX_SURF_RUNS * RUN_COLS))(
      int(nRays), seed & 0x7fffffffffffffff, int(table.numel()) // variants,
      tables['nSurf'], tables['nElem'], tables['samplerOff'], mode, H, W,
      int(maxIntersections), int(hitSlots), int(tables['anyMedium']),
      int(strataTile) if strata is not None else 1, G1, G2, variants,
      histLen, int(tables['hasGrating']), int(tables['nStages']),
      int(tables['gate']), int(tables['dispOff']),
      int(tables['samplerKind']), int(tables.get('scatter', False)),
      int(tables.get('geom', False)), nTri, nChunks, nSurfT, nSurfChunks,
      len(runs), *runWords, int(tables.get('cullOff', -1)), nGroups,
      nSurfGroups, 1, int(sharedDraws))
  fp = (ctypes.c_float * 7)(
      min(float(maxRayLength), 0.5 * _BIG), float(maxRayLength),
      float(distTol), 2 * float(distTol), float(powerTol),
      1.0 / max(G1, 1), 1.0 / G2)
  group, sharedBytes = 1, 4 * (int(table.numel()) // variants)
  if groups:
    plan = lambda vb: _sweepPlan(ip, fp, vb, dev)
    group = sweepVariantGroup(
        variants, nRays, plan,
        torch.cuda.get_device_properties(dev).multi_processor_count)
    sharedBytes = plan(group)[0]        # and the launch's group word
  if len(sweepGroups(variants, group)) > 65535:
    raise ValueError(f'{variants} variants in groups of {group}: more than '
                     f'the 65,535 block rows of a launch')
  ptr = lambda key, n: glob[key].data_ptr() if n else None
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(table.data_ptr(), ptr('triTable', nTri),
             ptr('triBoxPack', nTri and nChunks), ptr('surfTable', nSurfT),
             ptr('surfBoxPack', nSurfChunks),
             rayIn.data_ptr() if rayIn is not None else None,
             *(t.data_ptr() for t in outs), counters.data_ptr(), ip, fp,
             stream)
  if err != 0:
    raise KernelError(f'{name} kernel launch failed: CUDA error {err}')
  launchCounts[name] += 1
  record = dict(
      blocks=len(sweepGroups(variants, group))
      * (-(-int(nRays) // KERNEL_BLOCK)),
      sharedBytes=sharedBytes,
      histMode=HIST_MODE if name in ('traceHistogram', 'traceSweep')
      else None)
  if sweep is not None:
    record.update(variantGroup=group, sharedDraws=sharedDraws)
  lastLaunch[name] = record
  return counters


# --------------------------------------------------------------------- steps

_COLUMN_KEYS = ('ox', 'oy', 'oz', 'dx', 'dy', 'dz', 'pw', 'wl')


def _stepSetup(scene, histSpec, generator, raysPerStep, maxIntersections,
               hitSlots, sampler, strataTile, device, emissionBound):
  '''What the step factories share: the kernel tables (with the cull block
  of `emissionBound` over `maxIntersections` bounces), the resolved slot
  count and stratum size, and `inputsFor(seed)`, which turns a step's `seed`
  (python int or torch.Generator) into the wrapper's input keywords — a
  seed for the in-kernel sampler, or the eight ray columns drawn by
  `generator(torchGenerator, N)`.'''
  dev = resolveDevice(device)
  if sampler is None and generator is None:
    raise ValueError('need a sampler spec or a column generator')
  tables = buildTraceTables(scene, histSpec, samplerSpec=sampler, device=dev,
                            emissionBound=emissionBound,
                            maxIntersections=maxIntersections)
  if hitSlots == 'auto':
    hitSlots = autoHitSlots(scene, histSpec, maxIntersections)
  if strataTile == 'auto':
    strataTile = DEFAULT_STRATA_TILE
  if tables['samplerKind'] != SAMPLER_POINT or sampler is None \
      or tileStrata(raysPerStep, strataTile) is None:
    strataTile = 0

  def inputsFor(seed):
    gen = seed if isinstance(seed, torch.Generator) else None
    if sampler is not None:
      if gen is not None:
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=gen.device).item())
      return dict(seed=int(seed))
    if gen is None:
      gen = torch.Generator(device=dev)
      gen.manual_seed(int(seed))
    batch = generator(gen, raysPerStep)
    inputs = dict(columns=torch.stack([batch[k] for k in _COLUMN_KEYS])
                  .contiguous())
    if tables['scatter']:            # the key of the scatter draws
      inputs['seed'] = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                                         device=gen.device).item())
    return inputs

  return tables, hitSlots, strataTile, inputsFor


def makeTraceStep(scene, histSpec, generator, raysPerStep, maxIntersections,
                  maxRayLength, distTol, powerTol=1e-6, stratified=False,
                  histPrecision='default', hitSlots='auto', sampler=None,
                  strataTile='auto', emissionBound=None, device='cuda'):
  '''Build the fused sample + trace + histogram step
  `step(seed, histograms) -> (histograms, counters)`; the signature of the
  JAX package's `makePallasTraceStep` minus the TPU-only knobs (tile,
  innerSteps, jitWrap, interpret) and the uniform-input seam (here an input
  mode of `traceHistogram` itself), plus `device`, and with `strataTile` in
  place of `tileStratified`.

  emissionBound: the source's `emissionBound()` (None: no cull). With it
  each bounce sweeps only the surface rows some ray can reach there
  (`_cullSets`, ROADMAP B12); the result is the same as without.

  histPrecision: 'default' bins inside the kernel with float32 atomics (one
  launch, nothing ray-shaped in device memory); 'highest' runs the
  per-ray-bin kernel (`traceBins`) and bins its ring outside in float64
  (`binRing`), so a bin's power does not depend on the order of the adds.
  Counts are exact either way.

  `seed` is a python int (or a torch.Generator, from which one is drawn).
  With `sampler` (PointSource.samplerSpec()) rays are drawn inside the
  kernel from its own counter-based generator. Without a sampler, or with
  stratified=True, `generator(torchGenerator, N, stratified)` supplies the
  eight ray columns (PointSource.deviceColumnsGenerator).

  `histograms` are accumulated IN PLACE and returned (the JAX step relies
  on buffer donation instead); counters are 0-d int64 tensors on the
  device, so a step never synchronises with the host.

  Ray-index strata: the sampler's two quantiles are stratified by
  cell = rayIndex // strataTile ('auto': DEFAULT_STRATA_TILE rays, one
  thread block per cell; 0 switches strata off; a step that does not
  decompose into a G1 x G2 grid of cells runs without).'''
  if histPrecision not in ('default', 'highest'):
    raise ValueError(f"histPrecision must be 'default' or 'highest', got "
                     f'{histPrecision!r}')
  if stratified:
    sampler = None          # latin-hypercube draws come from the generator
  columnsOf = generator and (
      lambda gen, n: generator(gen, n, stratified=stratified))
  tables, hitSlots, strataTile, inputsFor = _stepSetup(
      scene, histSpec, columnsOf, raysPerStep, maxIntersections, hitSlots,
      sampler, strataTile, device, emissionBound)
  kw = dict(maxIntersections=maxIntersections, maxRayLength=maxRayLength,
            distTol=distTol, powerTol=powerTol, hitSlots=hitSlots,
            strataTile=strataTile)

  def step(seed, histograms):
    inputs = inputsFor(seed)
    if histPrecision == 'default':
      c = traceHistogram(tables, histograms, raysPerStep, **inputs, **kw)
    else:
      ring, c = traceBins(tables, raysPerStep, **inputs, **kw)
      binRing(histograms, ring)
    return histograms, dict(segments=c[0], hits=c[1], hitOverflow=c[2])

  step.tables = tables
  step.hitSlots = hitSlots
  step.strataTile = strataTile
  return step


def makeRawStep(scene, histSpec, generator, raysPerStep, maxIntersections,
                maxRayLength, distTol, hitSlots='auto', sampler=None,
                strataTile='auto', emissionBound=None, device='cuda'):
  '''Build `step(seed) -> (records, counters)`: RAW per-hit rows from the
  raw-record kernel's hit ring, in the reference's records form — the
  counterpart of the JAX package's `makePallasRawStep` minus tile /
  interpret / uniformProvider, plus `device` and `strataTile`. `records`
  is a dict of tensors on the device, slot-major: `recordHit` bool
  (hitSlots, N), `hitElem` int32, `power` float32, `isEntering` bool,
  `point` (hitSlots, N, 3), `direction` (hitSlots, N, 3) — EVERY
  recording-element hit (no histogram-bounds gate), the INCOMING
  direction, the pre-interaction power. `counters`: 0-d int64 tensors
  `segments`, `hits`, `hitOverflow` on the device. The output feeds
  simulation.runner.compactRecordsToHits -> SimulationResults.addHitBatch.

  `seed`, `sampler`, `generator(torchGenerator, N)`, the strata and
  `emissionBound` as in `makeTraceStep`; the power cut-off is the scene's
  `powerTol` (1e-6 when the scene dict has none).'''
  tables, hitSlots, strataTile, inputsFor = _stepSetup(
      scene, histSpec, generator, raysPerStep, maxIntersections, hitSlots,
      sampler, strataTile, device, emissionBound)
  kw = dict(maxIntersections=maxIntersections, maxRayLength=maxRayLength,
            distTol=distTol, powerTol=float(scene.get('powerTol', 1e-6)),
            hitSlots=hitSlots, strataTile=strataTile)

  def step(seed):
    ring, c = traceRaw(tables, raysPerStep, **inputsFor(seed), **kw)
    return recordsFromRing(ring), dict(segments=c[0], hits=c[1],
                                       hitOverflow=c[2])

  step.tables = tables
  step.hitSlots = hitSlots
  step.strataTile = strataTile
  return step


def makeSweepStep(hostScenes, histBounds, bins, samplerSpec, raysPerVariant,
                  maxIntersections, maxRayLength, distTol, powerTol=1e-6,
                  geomMode=False, device='cuda'):
  '''Batched parameter sweep through the sweep kernel; counterpart of the
  JAX package's `makePallasSweepStep` minus tile / interpret, plus `device`.

  hostScenes: [(sceneDict, info), ...] of `Scene.compile(device=None)`, one
  per variant, of one structure (`packSweepTables` says what that means) or
  SweepUnavailable raises. `samplerSpec` is the in-kernel sampler spec of
  the sweep's source; with geomMode the source's placement and wavelength
  differ per variant and ride `geomRows` (V, 13): R row-major (9), offset
  (3), wavelength.

  Returns (step, packTables):
    packTables(hostScenesNow, geomRows=None) -> float32 (V, tableLen) numpy
        table for the CURRENT variant values (structure checked again); a
        mesh's stacked triangle table, a surface table and their chunk
        and group boxes of these values go to `step.facts` (`triTable`,
        `triBoxes`, `surfTable`, `surfBoxes`, ..., on the device), which
        the next `step` call traces;
    step(seed, table) -> (power (V, D, H, W), counts (V, D, H, W),
        segments): ONE launch on fresh histograms. The two histograms are
        views of `step.histograms`, a (2, V, D, H, W) tensor, so a caller
        can fetch both in one copy; `step.counters` is the launch's int64
        (V, 3) tensor of (segments, hits, hitOverflow) per variant and
        `segments` its total, all on the device.

  Exactly `raysPerVariant` rays are traced per variant (the reference rounds
  up to whole tiles). Ring slots and ray-index strata are `makeTraceStep`'s
  'auto' (strata by the index within the variant); `step.hitSlots` and
  `step.strataTile` say what they came to.'''
  from ..tracing import fused
  dev = resolveDevice(device)
  V = len(hostScenes)
  if V < 2:
    raise SweepUnavailable('needs >= 2 variants')
  if samplerSpec is None or samplerSpec.get('type') == 'surface':
    raise SweepUnavailable('needs an in-kernel point-source sampler')
  host0, info0 = hostScenes[0]
  reason = ineligibleReason(host0)
  if reason is not None:
    raise SweepUnavailable(reason)
  histSpec = fused.makeHistogramSpec(host0, info0, bounds=histBounds,
                                     bins=bins)
  hitSlots = autoHitSlots(host0, histSpec, maxIntersections)
  strataTile = DEFAULT_STRATA_TILE
  if tileStrata(raysPerVariant, strataTile) is None:
    strataTile = 0

  def packTables(hostScenesNow, geomRows=None):
    if len(hostScenesNow) != V:
      raise SweepUnavailable(f'{len(hostScenesNow)} variants, the step was '
                             f'made for {V}')
    if geomMode == (geomRows is None):
      raise ValueError('geomRows go with geomMode, and only with it')
    specs = [samplerSpec] * V
    if geomMode:
      specs = [samplerSpecWithGeom(samplerSpec, r)
               for r in np.asarray(geomRows).reshape(V, 13)]
    table, facts = packSweepTables([h for h, _info in hostScenesNow],
                                   histSpec, specs)
    if any(facts[k] != step.facts[k] for k in _SWEEP_STRUCTURE):
      raise SweepUnavailable('scene structure differs from the variants the '
                             'step was made for')
    step.facts.update(_globalTensors(facts, dev),
                      sharedDraws=facts['sharedDraws'])
    return table

  def step(seed, table):
    hist = torch.zeros((2, V) + step.histShape, dtype=torch.float32,
                       device=dev)
    tables = dict(step.facts, table=torch.as_tensor(
        np.ascontiguousarray(table, np.float32), device=dev))
    c = traceSweep(tables, dict(power=hist[0], counts=hist[1]),
                   raysPerVariant, maxIntersections, maxRayLength, distTol,
                   powerTol=powerTol, hitSlots=hitSlots, seed=int(seed),
                   strataTile=strataTile)
    step.histograms, step.counters = hist, c
    return hist[0], hist[1], c[:, 0].sum()

  _table0, step.facts = packSweepTables(
      [h for h, _info in hostScenes], histSpec, [samplerSpec] * V)
  step.facts.update(_globalTensors(step.facts, dev))
  step.facts['sameSource'] = not geomMode
  step.histSpec = histSpec
  step.histShape = (step.facts['nDet'],) + step.facts['bins']
  step.hitSlots = hitSlots
  step.strataTile = strataTile
  step.histograms = step.counters = None
  return step, packTables


# the facts of `packSweepTables` that a step is made for
_SWEEP_STRUCTURE = ('nVariants', 'tableLen', 'nSurf', 'nElem', 'nTri',
                    'nTriChunks', 'nSurfTable', 'nSurfChunks',
                    'surfPlainRuns', 'surfChunkRuns', 'samplerOff',
                    'bins', 'nDet', 'anyMedium', 'hasGrating', 'gate',
                    'dispOff', 'geom', 'scatterConsts')


def recordsFromRing(ring):
  '''The records dict of `makeRawStep` from a (9, hitSlots, N) raw ring.'''
  return dict(recordHit=ring[0] >= 0,
              hitElem=ring[0].to(torch.int32),
              power=ring[1],
              isEntering=ring[2] > 0.5,
              point=torch.stack([ring[3], ring[4], ring[5]], dim=-1),
              direction=torch.stack([ring[6], ring[7], ring[8]], dim=-1))
