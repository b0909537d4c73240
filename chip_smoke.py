#!/usr/bin/env python3
'''Smoke run of the PyTorch / CUDA port on one NVIDIA GPU:

    python3 chip_smoke.py

builds the CUDA kernels from the sources in this checkout (one nvcc per
source, in parallel) and holds each against its plain PyTorch version on the
card: the in-kernel-histogram kernel in all three input modes, the
per-ray-bin and raw-record kernels in modes (b) and (c) on scenes with one,
two and four live ring slots and with a ring that overflows, the sweep
kernel on a surface sweep and a source-placement sweep and, in seed mode,
against one launch of the histogram kernel per variant, and again where its
variant groups (`cuda_trace.sweepVariantGroup`) leave a shorter last group
or hold more variants than the sweep has, and where it traces one variant a
block: too few rays for a group, variants that do not share the sampler's
draw, ray columns; then the same on
the scenes of gratings, dispersion, sequential mode and per-source masks
(a reflection and a transmission grating, a Cauchy lens, the sequential
ball lens, a source that ignores a mirror; the spectrometer at full width
and one examples/4 source at a raw iteration's 1 << 20 rays; 3-variant
sweeps of the spectrometer's wavelength, of the Cauchy lens's dispersion
and, under a source's mask, of a detector's distance). It then drives the
port's paths at full width:

  * the fused step (`benchmarks.makeBenchStep()`: 1 << 22 rays, 6 bounces,
    128 x 128 bins) for a few timed steps, with in-kernel binning and with
    histPrecision='highest' (per-ray-bin kernel + float64 binning outside);
  * the recording run: `makeRawStep` at 1 << 22 rays with its compaction
    and fetch, `simulation.runSimulation(scene, 'true')` with raw recording
    (4 iterations of 1 << 20 rays, hits written and read back) and with
    histogram-first recording (32 iterations of 1 << 22 rays);
  * the parameter sweep on the examples/3 lens scene:
    `ParameterSweeper.evaluateBatched` at 11 radii x 200,000 rays and at
    64 radii x 1 << 20 rays (one launch of the sweep kernel per call, beside
    the same work as one histogram-kernel launch per variant), and
    `optimize` through `runSimulation` and `RawFolder.loadHits`;
  * the grating spectrometer (examples/4): the fused step on
    `benchmarks.buildSpectrometerScene()` (1 << 22 rays, 3 intersections,
    128 x 128 bins over +-80 mm) with both binnings; `runSimulation` on
    examples/4's scene with one source each at 450, 550 and 650 nm, raw
    (4 iterations of 1 << 20 rays per source) and histogram-first (8 of
    1 << 22); a wavelength calibration through `evaluateBatched` (64
    wavelengths from 400 to 700 nm x 1 << 20 rays, one sweep-kernel launch
    per call); and one step at 2000 lines/mm and 650 nm, whose first order
    is evanescent;
  * the surface source (`benchmarks.buildSurfaceSourceScene()`, the
    reference's surface-source scene: a cos^2 disc emitter, a fold mirror,
    a detector; 4 intersections, 128 x 128 bins over +-120 mm): the fused
    step with both binnings (1 << 22 rays), `runSimulation` raw (4
    iterations of 1 << 20 rays) and histogram-first (8 of 1 << 22), the
    detected share and mean detected power against the JAX package's;

  * triangle meshes (phase 10): the kernels against their plain versions on
    the reference's dishes of 200 to 12800 triangles, its collimated dish,
    a mesh lens and a tie between two equal table rows, K3 on 11 detector
    heights under the 1800-triangle dish; every dish's fused step (both
    binnings) and raw step at 1 << 22 rays timed beside its bound, the
    kernels' three-level sweep with the shrinking cap, each ray alone, and
    beside the one-level, two-level and warp counts (`tableWork`); that
    dish loaded from an STL file through `runSimulation` raw (4 x 1 << 20)
    and histogram-first (8 x 1 << 22) and through `evaluateBatched` over
    its detector height, its share and r^2 against the JAX package's;
  * the surface table (phase 11): the kernels against their plain versions
    on the reference's walls of 522 and 5,071 analytic surfaces and on the
    check scenes of the table (a slab array for its medium rule, every
    table kind, ties, a dish beside a surface table), K3 on 11 detector
    heights under the 522-surface wall; both walls' fused step (both
    binnings) and raw step at 1 << 22 rays timed beside their bounds (both
    counts, as the dishes'); the
    522-surface wall through `runSimulation` raw (4 x 1 << 20) and
    histogram-first (8 x 1 << 22) and through `evaluateBatched` over its
    detector height, its share and r^2 against the JAX package's;
  * the per-bounce surface culls (phase 12, B12): K1, K2 and K4 with the
    source's emission bound against their plain versions and against the
    same kernels without it (0 rays moved) on the decoy scene
    (`benchmarks.buildCullDecoyScene`: a fold beside 32 aspheres and tori
    no ray reaches) and the JAX suite's fold, reflect-back and ball-lens
    cull scenes; the decoy scene through `makeBenchStep` (both binnings)
    and `makeRawStep`, each kernel timed with and without the culls beside
    its bound. Every other check builds its tables with the source's bound
    too, as the port's steps do;
  * the record tracer (phase 13, `tracing/tracer.trace`, plain PyTorch):
    its ms per bounce and rays per second on the lens-and-mirror at
    1 << 18 rays with segment records, its hit rows against the raw-record
    kernel's (columns input mode) on the same columns, ray by ray; then
    examples/1 (`examples/torch_1_source_and_detector.py`: the Monte-Carlo
    run storing the four StoreHit* fan columns and the fan run, both
    through the raw-record kernel in its columns mode, 5 launches) and
    examples/5 (`examples/torch_5_visualization.py`: the draw run through
    the record tracer, no kernel launch, its drawn segments equal to the
    traced records' `totalSegments`, and the PLY export);
  * the fused step's twin and differentiable design (phase 14,
    `tracing/fused.makeFusedStep` and `tracing/diff.py`, plain PyTorch):
    the twin against the histogram kernel on the lens-and-mirror at
    1 << 20 rays on the same columns (the kernels' gates), its ms per step
    and segments per second; histogram-first `runSimulation` of the
    1800-triangle dish under sequential mode (which the kernels refuse) at
    4 x 1 << 18 rays, no kernel launch, the snapshot's counts equal to the
    run's hits and its share and r^2 against the JAX package's;
    `evaluateBatched` of 11 variants x 100,000 rays of a scene whose
    dispersive index the kernels refuse, through the twin; examples/6
    (`examples/torch_6_gradient_optimization.py`: Adam on the screen's
    distance through autograd of the record tracer), its spot shrinking
    10x, its best distance beside the CPU run's, its gradient at the start
    against central differences;
  * project files (phase 15, `models.loadFCStd` and the command line): the
    lens-and-mirror scene and the slotted-plate mirror written as FCStd
    projects (`tests/fcstd_fixtures.py`: the lens a BRep solid, the plate a
    BRep face with a slot), `loadFCStd`'s host ms for each; on the ingested
    lens-and-mirror K1 at 1 << 22 rays and K2 / K4 at 1 << 20 against their
    plain versions (the gates of phase 2), on the slotted plate (a GEOM
    instance with trim primitives) all three at 1 << 20 with 0 rays moved,
    as phase 9; K1 and K4 timed on the ingested and the built scene beside
    their bounds; K4's rows on the ingested scene against its rows on
    `buildLensMirrorScene` on the same 1 << 20 columns, point by point
    within 1e-3 mm but for the rays that meet a cylinder the two scenes
    draw differently (the lens barrel, the thin mirror's edge), which are
    counted; and `python -m optics_design_workbench_tpu_torch run <project>
    true --recording histogram` in a process of its own at the project's 4
    iterations of 1 << 22 rays, through the kernel route;

(the first three on the lens-and-mirror scene) and checks the physics of
what comes out. Before those paths it holds the histogram, per-ray-bin and
raw-record kernels against their plain versions on the surface-source
scenes (the throughput scene at full width, an emitter of four face kinds
under two placements), the surface sampler's own draws against the
source's `deviceColumnsGenerator` by distribution, and one histogram step
onto bins that already hold 2**24 (they must go on counting), and K1 and
K3 where the rays pile up (B11: a warp's lanes that land in one bin add
once): the pile-up scene of every ray in one bin at 1 << 22 rays (K3 over
four placements) at 64 x 64 bins and at 128 x 128, and the spectrometer's
lines, against their plain versions. Every failing phase raises, so the exit code is non-zero and no result line is printed. Needs one CUDA device;
exits non-zero without one. Prints one JSON object per phase; the last line
is `{"ok": true, "device": {...}}`.
'''

import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, 'tests'))
sys.path.insert(0, os.path.join(HERE, 'examples'))

import torch_port_helpers as helpers          # the check scenes (imports no jax)
import fcstd_fixtures                         # project files (imports neither package)
import torch_1_source_and_detector as example1   # examples/1 on the port
import torch_4_spectrometer as example4       # examples/4 on the port
import torch_5_visualization as example5      # examples/5 on the port
import torch_6_gradient_optimization as example6  # examples/6 on the port
import torch_mesh_dish as meshExample        # the STL-loaded dish
from optics_design_workbench_tpu_torch import (_build, benchmarks, hostArray,
                                               simulation)
from optics_design_workbench_tpu_torch.geometry.surfaces import (
    PACKED_ELEM, PACKED_OFF, PACKED_ROT)
from optics_design_workbench_tpu_torch.jupyter_utils import (
    RawFolder, parameter_sweeper)
from optics_design_workbench_tpu_torch.models import loadFCStd
from optics_design_workbench_tpu_torch.ops import cuda_trace
from optics_design_workbench_tpu_torch.simulation import results_store, runner
from optics_design_workbench_tpu_torch.tracing import batch_tracer, fused, tracer

DEV = torch.device('cuda')
N_MAIN = 1 << 22
N_SMALL = 1 << 18
N_RAW_ITERATION = 1 << 20   # rays per iteration of the raw recording run
RAW_ITERATIONS = 4
HIST_ITERATIONS = 32
BINS = (128, 128)
WARM_STEPS, TIMED_STEPS = 3, 20
COUNT_BUDGET = 2          # rays allowed to cross a bin edge (ulp-level)
POWER_RTOL = 1e-4         # float32 atomics add in a run-to-run order
MARGINAL_L1 = 0.02        # mode (a): independent draws, 4M rays
RAW_ATOL = 1e-4           # mm / unit power: the reference's own raw-row test
# the parameter sweep: the reference's own configuration of it (11 lens
# radii x 200,000 rays) and the size of a design study on this card
SWEEPS = ((11, 200_000), (64, 1 << 20))
SWEEP_BINS = (64, 64)
SWEEP_BOUNDS = (-40., 40., -40., 40.)
SWEEP_MAX_INTERSECTIONS = 6
# the spectrometer: the reference's throughput scene of examples/4 and its
# recording run at the sizes of a measurement on this card
SPECTRO_BOUNDS = (-80., 80., -80., 80.)
SPECTRO_MAX_INTERSECTIONS = 3
SPECTRO_WAVELENGTHS = (450., 550., 650.)
SPECTRO_RAW_ITERATIONS = 4
SPECTRO_HIST_ITERATIONS = 8
SPECTRO_SWEEP = (64, 1 << 20)            # wavelengths x rays per wavelength
LINE_TOL_MM = 0.15                       # the JAX suite's own bound
BIN_MM = (SPECTRO_BOUNDS[1] - SPECTRO_BOUNDS[0]) / BINS[1]
# the surface source: the reference's surface-source throughput scene
# (tools/scene_throughput.sceneSurfaceSource) and its recording run
SURFACE_BOUNDS = (-120., 120., -120., 120.)
SURFACE_MAX_INTERSECTIONS = 4
SURFACE_HIST_ITERATIONS = 8
# the JAX package on that scene: detected share and mean detected power of
# its fused step at 65,536 rays, seed 0 (tests/test_torch_surface_source.py
# computes them and holds them equal to these)
REF_SURFACE_SHARE = 0.68133544921875
REF_SURFACE_POWER = 0.9838300736950235
REF_SURFACE_RAYS = 1 << 16

# stochastic scatter (phase 8): the reference's three scatter throughput
# scenes (4 intersections, 128 x 128 bins over +-100 mm), the diffuser's
# height sweep (11 heights x 1 << 20 rays), the recording runs
SCATTER_SCENES = (('diffuse', 'buildDiffuseScatterScene'),
                  ('dirac', 'buildConditionedDiracScene'),
                  ('coupled', 'buildCoupledScatterScene'))
SCATTER_BOUNDS = (-100., 100., -100., 100.)
SCATTER_MAX_INTERSECTIONS = 4
SCATTER_HEIGHTS = tuple(np.linspace(40., 60., 11))
SCATTER_SWEEP_RAYS = 1 << 20
SCATTER_RAW_ITERATIONS = 4       # of N_RAW_ITERATION rays
SCATTER_HIST_ITERATIONS = 8      # of N_MAIN rays
# The JAX package's fused step on each scatter scene at 65,536 rays, seed 0
# (tests/test_torch_scatter_stats.py computes them and holds them equal to
# these): the share of rays binned on the detector, the mean binned power,
# and the first two moments of r^2 = x^2 + y^2 (mm^2, bin centres) over the
# binned hits.
REF_SCATTER_RAYS = 1 << 16
REF_SCATTER = {
    'diffuse': dict(share=1.0, power=1.0, r2=36.43222153186798,
                    r4=34684.1870850767),
    'dirac': dict(share=0.9994354248046875, power=1.0, r2=71.26806608569406,
                  r4=44136.73619874265),
    'coupled': dict(share=1.0, power=1.0, r2=35.05237400531769,
                    r4=34770.715683407616),
}

# the other surface kinds and trims (phase 9, B2 / B3): the reference's
# torus-mirror and mesh-fold throughput scenes, the two slotted mirrors of
# its trim tests, the kinds scene and the emitter of those kinds; name ->
# (benchmarks scene function, intersections, histogram bounds); the torus's
# height sweep; a 30-stage sequential scene (ROADMAP C.2)
GEOM_SCENES = {
    'torus': ('buildTorusMirrorScene', 3, (-200., 200., -200., 200.)),
    'meshFold': ('buildMeshFoldScene', 3, (-300., 300., -300., 300.)),
    'bitmapSlot': ('buildBitmapSlotScene', 4, (-300., 300., -300., 300.)),
    'primSlot': ('buildPrimSlotScene', 4, (-300., 300., -300., 300.)),
    'kinds': ('buildKindsScene', 8, (-300., 300., -300., 300.)),
    'emitter': ('buildEmitterKindsScene', 4, (-200., 200., -200., 200.)),
}
TORUS_HEIGHTS = tuple(np.linspace(70., 90., 11))
TORUS_SWEEP_RAYS = 1 << 20
TORUS_RAW_ITERATIONS = 4          # of N_RAW_ITERATION rays
TORUS_HIST_ITERATIONS = 8         # of N_MAIN rays
MANY_STAGES = 30
# The JAX package's fused step on the torus-mirror scene at 65,536 rays,
# seed 0 (tests/test_torch_torus_mesh.py computes them and holds them equal
# to these): the share of rays binned on the detector, the mean binned
# power, and the first two moments of r^2 over the binned hits.
REF_TORUS_RAYS = 1 << 16
REF_TORUS = dict(share=0.57965087890625, power=1.0, r2=6995.6086050200065,
                 r4=154135922.72938535)

# triangle meshes (phase 10, B7): the reference's dish scenes (triangles ->
# rings nQ of `benchmarks.buildMeshDishScene`), its collimated dish, and the
# check scenes of a closed mesh lens and a tie between two equal rows. The
# kernels are held against their plain versions at the fused step's
# 1 << 22 rays where a run of the plain version takes under ~10 s; the
# plain version sweeps every triangle for every ray (0.16 / 1.2 / 3.3 / 8.6
# s per run of 1 << 20 rays on 200 / 1800 / 5000 / 12800 triangles), so the
# 5000- and 12800-triangle dishes are held at 1 << 20, and so are the check
# scenes, to keep the card gate in its time (the timed dishes of 200 and
# 1800 triangles stay at 1 << 22).
MESH_BOUNDS = (-200., 200., -200., 200.)
MESH_MAX_INTERSECTIONS = 3
MESH_DISHES = {200: 10, 1800: 30, 5000: 50, 12800: 80}
MESH_CHECK_RAYS = {'dish200': N_MAIN, 'dish1800': N_MAIN,
                   'dish5000': 1 << 20, 'dish12800': 1 << 20,
                   'collimated': 1 << 20, 'meshLens': 1 << 20,
                   'tie': 1 << 20}
MESH_HEIGHTS = tuple(np.linspace(-20., 0., 11))   # the detector's z
MESH_SWEEP_RAYS = 1 << 20
MESH_RAW_ITERATIONS = 4           # of N_RAW_ITERATION rays
MESH_HIST_ITERATIONS = 8          # of N_MAIN rays
# The JAX package's fused step on the 1800-triangle dish at 65,536 rays,
# seed 0 (tests/test_torch_mesh.py computes them and holds them equal to
# these): every ray is binned, at power 1, with these r^2 moments.
REF_DISH_RAYS = 1 << 16
REF_DISH = dict(share=1.0, power=1.0, r2=3966.9451117515564,
                r4=35904789.590858854)

# the surface table (phase 11, B8): the reference's walls of 522 and 5,071
# analytic surfaces (`benchmarks.buildSurfWallScene`, `buildSurfWall5kScene`)
# and the check scenes of the surface table (tests/torch_port_helpers.py
# SURFACE_TABLE_SCENES: a slab array for the table's medium rule, every
# table kind, ties, both tables at once). The kernels are held against
# their plain versions at the fused step's 1 << 22 rays on the timed
# 522-surface wall; the plain version sweeps every table row for every ray,
# so the 5,071-surface wall is held at 1 << 20, and so are the check scenes,
# to keep the card gate in its time.
WALL_BOUNDS = (-300., 300., -300., 300.)
WALL_MAX_INTERSECTIONS = 3
WALLS = {'wall522': 'buildSurfWallScene', 'wall5071': 'buildSurfWall5kScene'}
WALL_CHECK_RAYS = {'wall522': N_MAIN}      # 1 << 20 for the others
WALL_HEIGHTS = tuple(np.linspace(-20., 0., 11))   # the detector's z
WALL_SWEEP_RAYS = 1 << 20
WALL_RAW_ITERATIONS = 4           # of N_RAW_ITERATION rays
WALL_HIST_ITERATIONS = 8          # of N_MAIN rays
# The JAX package's fused step on the 522-surface wall at 65,536 rays, seed
# 0 (tests/test_torch_surface_table.py computes them and holds them equal to
# these).
REF_WALL_RAYS = 1 << 16
REF_WALL = dict(share=0.8999786376953125, power=1.0, r2=8371.303931728278,
                r4=139473323.46917462)
# the record tracer (phase 13): its own times on the lens-and-mirror, held
# against the raw-record kernel on the same columns; examples/1 and /5
RECORD_RAYS = 1 << 18
RECORD_REPS = 3
EXAMPLE1_RAW_LAUNCHES = 5     # 4 Monte-Carlo iterations + the fan run

# the fused step's twin (phase 14): against K1 on the lens-and-mirror, the
# 1800-triangle dish under sequential mode histogram-first, the sweep of a
# dispersive index the kernels refuse; examples/6 on the card against its
# best screen offset on the CPU (`python3
# examples/torch_6_gradient_optimization.py --cpu`: +118.49 mm)
TWIN_RAYS = 1 << 20
TWIN_REPS = 3
TWIN_DISH_RAYS = 1 << 18
TWIN_DISH_ITERATIONS = 4
TWIN_SWEEP = (11, 100_000)
EXAMPLE6_CPU_DZ = 118.49
EXAMPLE6_DZ_TOL = 5.
# project files (phase 15): the lens-and-mirror and slotted-plate projects
# of tests/fcstd_fixtures.py; the command line's histogram-first run of the
# lens project; the rows of K4 held point by point
PROJECT_BOUNDS = (-60., 60., -60., 60.)
SLOT_BOUNDS = (-300., 300., -300., 300.)
PROJECT_CLI_ITERATIONS = 4
PROJECT_ROWS_ATOL = 1e-3
PROJECT_REPS = 5
# the in-kernel histograms (B11): the pile-up scene (every ray in one bin)
# per K3 variant, and its placements in bins of the grid
PILEUP_SWEEP_RAYS = 1 << 20
PILEUP_BINS_OFF = (0, 4, -8, 16)
# registers of the instances without B2 / B3 (output mode, sweep, B4,
# surface sampler, scatter) -> count: as built before B2 / B3 (PERF.md §6),
# but for the histogram kernel's B4 instances, whose stage gate reads the
# stage words of ROADMAP C.2 (58 before), and for five per-ray instances
# that B12's row test moved (PERF.md §6): K2 without B4 42 -> 40 and
# 44 -> 40 (surface sampler), K4 with B4 54 -> 56 (both samplers), K4 with
# scatter 79 -> 64 (12 spill bytes); the K3 instances here are those that
# trace one variant a block
OLD_REGISTERS = {
    (0, 0, 0, 0, 0): 40, (1, 0, 0, 0, 0): 40, (2, 0, 0, 0, 0): 40,
    (0, 1, 0, 0, 0): 40, (0, 0, 0, 1, 0): 40, (1, 0, 0, 1, 0): 40,
    (2, 0, 0, 1, 0): 40,
    (0, 0, 1, 0, 0): 56, (1, 0, 1, 0, 0): 57, (2, 0, 1, 0, 0): 56,
    (0, 1, 1, 0, 0): 56, (0, 0, 1, 1, 0): 56, (1, 0, 1, 1, 0): 57,
    (2, 0, 1, 1, 0): 56,
    (0, 0, 1, 0, 1): 79, (0, 0, 1, 1, 1): 64, (1, 0, 1, 0, 1): 64,
    (1, 0, 1, 1, 1): 64, (2, 0, 1, 0, 1): 64, (2, 0, 1, 1, 1): 64,
    (0, 1, 1, 0, 1): 64,
}
# the two K3 instances that trace groups of variants (GROUPED, PR 14:
# the variant loop around the bounce loop), without B4 and with it
GROUPED_REGISTERS = {(0, 1, 0, 0, 0): 48, (0, 1, 1, 0, 0): 62}

# Peak rates of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, device memory.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# float32 operations per call of the kernel's pieces, counted from
# csrc/trace_kernel.cu (a multiply, add, compare, select, sqrt, divide or
# rsqrt counts as one): ray into the surface frame 33, then per kind the
# root / trim tests; 6 for the two argmin trackers.
FLOPS_INTERSECT = {0: 33 + 12 + 6, 1: 33 + 42 + 6, 2: 33 + 35 + 6,
                   # B2, counted the same way from `intersectGeom`: the
                   # asphere's sphere seed (31), 16 Newton steps (54 each)
                   # and its final test (31); Moeller-Trumbore; the cone's
                   # and the quadric's quadratic with their root tests; the
                   # torus's set-up (67), depressed coefficients (22), 28
                   # steps of the resolvent cubic (20 each), the two
                   # quadratics (36) and per candidate 3 polish steps (21
                   # each) and the residual / tube-angle test (48, the
                   # polynomial atan2 included)
                   3: 33 + 31 + 16 * 54 + 31 + 6, 4: 33 + 53 + 6,
                   5: 33 + 62 + 6, 6: 33 + 78 + 6,
                   7: 33 + 67 + 22 + 28 * 20 + 36 + 4 * (3 * 21 + 48) + 6}
# B3 per root tested: a bitmap trim's pixel lookup, and on a charted kind
# (not a plane) the polynomial atan2 of its azimuth; one hole primitive. The
# roots a kind tests its trim on: a plane's one, a quadratic's two, the
# asphere's one, the torus's four candidates; a triangle has no trim.
FLOPS_PIXEL = 12
FLOPS_CHART_ATAN2 = 25
FLOPS_PRIM = 10
TRIM_ROOTS = {0: 1, 1: 2, 2: 2, 3: 1, 4: 0, 5: 2, 6: 2, 7: 4}
# the surface sampler's faces of B2: the closed form of a cone face, an
# asphere's marginal (~80) and sag / slope, a torus's marginal and cos / sin
FLOPS_GEOM_FACE = {3: 80 + 45, 4: 12, 5: 20, 7: 80 + 10}
FLOPS_WINNER = 52         # hit point, local point, normal, world normal
FLOPS_PHYSICS = 80        # Beer-Lambert, mirror, Snell / TIR, record, update
FLOPS_SAMPLER = 160       # Philox rounds, two marginals, sin / cos, placement
# the surface-source sampler, counted the same way: two Philox calls (200),
# five uniforms, the face's closed form and placement, three
# normalisations, the tangent, the theta marginal (~80), two Rodrigues
# rotations; plus FLOPS_FACE_SCAN per emitting face (the window test)
FLOPS_SURFACE_SAMPLER = 430
FLOPS_FACE_SCAN = 3
# the parts of the body behind header flags, counted the same way from
# csrc/trace_common.cuh: a ray's pass through a grating (frame, Ludwig
# quadratic, diffracted direction, medium / power / stage updates); the
# stage gate per surface tested (stage clamp, shift, mask, compare); n(lambda)
# per segment of a dispersive scene (two Horner evaluations of up to 13
# coefficients)
FLOPS_GRATING = 107
FLOPS_STAGE_GATE = 3
FLOPS_DISPERSION = 2 * (3 + 2 * 12)
# the scatter section (csrc/trace_common.cuh `scatterBounce`), counted the
# same way with a sin or cos as one: per segment of a scene with scatter the
# second normalisation (9); per scatter pass the entry scan (3 an entry),
# the incidence angle where an entry is conditioned (clamps, 12 Horner
# steps, sqrt: 29), the draw (`scatterEntryFlops`), the lobe axis (20) and
# two Rodrigues rotations (29 each, sin and cos included) with the lobe
# normal's sign (3)
# the triangle table (B7), counted the same way from `sweepTriangles`: a
# chunk box's slab test (three inverse-direction products per face pair,
# the min / max tree, the cap) and the Moeller-Trumbore of one triangle
# (three crosses, three dots, three divides, the tests and the select)
FLOPS_CHUNK_TEST = 30
FLOPS_TRIANGLE = 40
# the surface table (B8), counted the same way from `tableRow`: per row the
# ray into its frame (33), per kind its root and trim tests (a plane's
# window or annulus; the quadratic of a sphere, cylinder, cone or quadric
# with its two band tests, the cone's nappe test, the quadric's linear
# case) and the winner test (3); a chunk box's slab test is
# FLOPS_CHUNK_TEST
FLOPS_TABLE_ROW = {0: 33 + 20 + 3, 1: 33 + 60 + 3, 2: 33 + 54 + 3,
                   5: 33 + 68 + 3, 6: 33 + 86 + 3}
FLOPS_SCATTER_RENORM = 9
FLOPS_SCATTER_SCAN = 3
FLOPS_ACOS = 29
FLOPS_SCATTER_TURN = 20 + 2 * 29 + 3


def fnFlops(spec):
  '''Operations of one 1-D function of a scatter entry.'''
  if spec[0] == 'const':
    return 0
  if spec[0] == 'poly1d':
    return 2 + 2 * (len(spec[3]) - 1)
  return 2 + 4 + 12 * (len(spec[2]) - 1)         # Fourier: sin, cos, terms


def specFlops(spec):
  '''Operations of one marginal spec of a scatter entry (a pwpoly2d
  evaluates its selected rectangle only, after scanning the others).'''
  if spec[0] == 'pwpoly':
    return sum(3 + 2 * (len(seg[4]) - 1) for seg in spec[1]) + 2
  if spec[0] == 'pwpoly2d':
    rects = spec[1]
    nU, nC = len(rects[0][8]), len(rects[0][8][0])
    return 4 * (len(rects) - 1) + 6 + nU * 2 * (nC - 1) + 2 * (nU - 1) + 2
  return sum(specFlops(a) + fnFlops(b) + 2 for a, b in spec[1]) + 2


def scatterEntryFlops(entry):
  '''Operations of one draw of a scatter entry: its phi and theta specs
  and its discrete events.'''
  _e, _k, phiSpec, thetaSpec, phiDisc, thetaDisc = entry
  events = sum(fnFlops(c) + fnFlops(v) + 2 for c, v in phiDisc + thetaDisc)
  return specFlops(phiSpec) + specFlops(thetaSpec) + events


def scatterPassFlops(tables):
  '''Operations of one scatter pass of the tables' scene: the costliest
  lobe entry and the costliest MODIFY entry, with the fixed parts.'''
  consts = tables['scatterConsts']
  lobe = [c for c in consts if c[1] != 3]
  mods = [c for c in consts if c[1] == 3]
  cond = any(c[2][0] != 'pwpoly' or c[3][0] != 'pwpoly' or c[4] or c[5]
             for c in consts)
  flops = FLOPS_SCATTER_SCAN * len(consts) + (FLOPS_ACOS if cond else 0)
  for group in (lobe, mods):
    if group:
      flops += max(scatterEntryFlops(c) for c in group) + FLOPS_SCATTER_TURN
  return flops


def emit(obj):
  print(json.dumps(obj), flush=True)


def cudaMs(fn, reps):
  '''Mean milliseconds of fn() over `reps` calls, by CUDA events.'''
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  start.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / reps


_COMPILED = {}


def compiled(scene):
  '''`scene.compile(device=None)`, once per scene object (a scene with a
  density conditioned on theta_in costs tens of seconds of sympy).'''
  if id(scene) not in _COMPILED:
    _COMPILED[id(scene)] = (scene, scene.compile(device=None))
  return _COMPILED[id(scene)][1]


def buildTables(scene, bounds, bins, maxI, tent=False, source=0, cull=True):
  '''Kernel tables of a scene as the runner traces light source `source`
  (with its surface mask and, unless cull=False, the per-bounce culls of
  its emission bound over `maxI` bounces); tent=True swaps the sampler's
  first marginal for the source's 257-knot tent table (the kernel's third
  marginal kind, which no source's own spec selects).'''
  sceneNp, info = compiled(scene)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds, bins=bins)
  src = scene.lightSources()[source]
  if src.Label in info['surfaceMasks']:
    sceneNp = dict(sceneNp, surfMask=info['surfaceMasks'][src.Label])
  spec = src.samplerSpec()
  assert spec is not None, 'scene source has no in-kernel sampler spec'
  if tent:
    drawTables = src._getDeviceTables()
    knots = drawTables['tables'][drawTables['order'][0]]['invCdfSmall']
    spec = dict(spec, first=('table', tuple(float(v) for v in knots)))
  tables = cuda_trace.buildTraceTables(
      sceneNp, histSpec, samplerSpec=spec, device=DEV,
      emissionBound=src.emissionBound() if cull else None,
      maxIntersections=maxI)
  return sceneNp, histSpec, tables


def rayColumns(tables, cols):
  '''The eight ray columns of mode (c): the sampler's seven and its
  wavelength.'''
  wl = torch.full_like(cols[0], cuda_trace.samplerWavelength(tables))
  return torch.stack(list(cols) + [wl]).contiguous()


def samplerInputs(tables, n, seed, maxI):
  '''The inputs of modes (b) and (c) for the tables' in-kernel sampler:
  (uniforms, one row per draw of the sampler and, on a scene with scatter,
  of every bounce's scatter draws (`uniformRows`), from a torch generator
  seeded `seed`; the strata tile; the seven ray columns its plain version
  draws from them, stratified where the sampler is the point source's; the
  scatter rows, or None).'''
  gen = torch.Generator(device=DEV)
  gen.manual_seed(seed)
  us = torch.rand((cuda_trace.uniformRows(tables, maxI), n), generator=gen,
                  device=DEV, dtype=torch.float32)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  cols = cuda_trace.samplerColumnsPlain(
      tables, us, cuda_trace.tileStrata(n, strataTile), strataTile)
  scatterU = (us[cuda_trace.samplerUniforms(tables):] if tables['scatter']
              else None)
  return us, strataTile, cols, scatterU


def inputModes(tables, us, strataTile, colsT):
  '''The input modes a kernel is held against its plain version in: (b)
  and (c); (b) alone on a scene with scatter, whose draws from ray columns
  come from the kernel's own Philox stream (phase 8 holds that mode by
  distribution).'''
  modes = [('b', dict(uniforms=us, strataTile=strataTile))]
  if not tables['scatter']:
    modes.append(('c', dict(columns=colsT)))
  return modes


def compareWithPlain(label, scene, bounds, maxI, n, bins, hitSlots=None,
                     tent=False, source=0, budget=COUNT_BUDGET,
                     triangleStats=None, surfaceStats=None):
  '''Kernel vs plain version on the card, modes (b) and (c), same inputs:
  counters equal, count bins within `budget` rays, power POWER_RTOL. Dicts
  `triangleStats` / `surfaceStats` are added what the cull leaves to a
  mesh's / a surface table's sweep in the plain version's run.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins, maxI,
                                          tent=tent, source=source)
  if hitSlots is None:
    hitSlots = cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=hitSlots)
  us, strataTile, cols, scatterU = samplerInputs(tables, n, 1234, maxI)
  colsT = rayColumns(tables, cols)
  worst = 0.
  # both modes trace the same rays: one run of the plain version serves both
  hP = fused.initHistograms(histSpec, device=DEV)
  cP = cuda_trace.traceHistogramPlain(tables, hP, cols, **kw,
                                      scatterUniforms=scatterU,
                                      triangleStats=triangleStats,
                                      surfaceStats=surfaceStats)
  for mode, inputs in inputModes(tables, us, strataTile, colsT):
    hK = fused.initHistograms(histSpec, device=DEV)
    cK = cuda_trace.traceHistogram(tables, hK, n, **inputs, **kw)
    torch.cuda.synchronize()
    if cK.tolist() != cP.tolist():
      raise AssertionError(f'{label} mode ({mode}): counters differ: kernel '
                           f'{cK.tolist()} plain {cP.tolist()}')
    moved = float((hK['counts'] - hP['counts']).abs().sum())
    if moved > 2 * budget:
      raise AssertionError(f'{label} mode ({mode}): {moved / 2} rays changed '
                           f'bins (budget {budget})')
    same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
    pK, pP = hK['power'][same], hP['power'][same]
    if not torch.allclose(pK, pP, rtol=POWER_RTOL, atol=0.):
      raise AssertionError(f'{label} mode ({mode}): power differs beyond '
                           f'rtol {POWER_RTOL}: '
                           f'{float(((pK - pP).abs() / pP).max())}')
    if int(cK[1]) <= 0:
      raise AssertionError(f'{label} mode ({mode}): no hits recorded')
    err = float((pK - pP).abs().max())
    worst = max(worst, err)
    emit(dict(phase='kernel-vs-plain', scene=label, mode=mode, rays=n,
              counters=cK.tolist(), movedRays=moved / 2, maxAbsErrPower=err,
              hitSlots=hitSlots))
  return worst


def compareRingsWithPlain(label, scene, bounds, maxI, n, bins, hitSlots=None,
                          source=0, budget=COUNT_BUDGET, rawAtol=RAW_ATOL):
  '''The per-ray kernels vs their plain versions on the card, modes (b) and
  (c), same inputs. traceRaw: counters, element, isEntering (hence
  recordHit) equal element for element; power, point, direction within
  `rawAtol`. traceBins: counters equal, at most `budget` rays in another
  bin, power and count equal where the bin is. Then traceBins + float64
  binning against traceHistogram on the same uniforms: counts equal bin for
  bin, power POWER_RTOL. Returns the worst absolute error per kernel.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins, maxI,
                                          source=source)
  if hitSlots is None:
    hitSlots = cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=hitSlots)
  us, strataTile, cols, scatterU = samplerInputs(tables, n, 4321, maxI)
  colsT = rayColumns(tables, cols)
  rawP, cRawP = cuda_trace.traceRawPlain(tables, cols, **kw,
                                         scatterUniforms=scatterU)
  binsP, cBinsP = cuda_trace.traceBinsPlain(tables, cols, **kw,
                                           scatterUniforms=scatterU)
  worst = dict(traceRaw=0., traceBins=0.)
  for mode, inputs in inputModes(tables, us, strataTile, colsT):
    rawK, cRawK = cuda_trace.traceRaw(tables, n, **inputs, **kw)
    binsK, cBinsK = cuda_trace.traceBins(tables, n, **inputs, **kw)
    torch.cuda.synchronize()
    for name, cK, cP in (('traceRaw', cRawK, cRawP),
                         ('traceBins', cBinsK, cBinsP)):
      if cK.tolist() != cP.tolist():
        raise AssertionError(f'{label} {name} mode ({mode}): counters '
                             f'differ: kernel {cK.tolist()} plain '
                             f'{cP.tolist()}')
    if int(cRawK[1]) <= 0 or int(cBinsK[1]) <= 0:
      raise AssertionError(f'{label} mode ({mode}): no hits recorded')
    for row, what in ((0, 'element'), (2, 'isEntering')):
      if not torch.equal(rawK[row], rawP[row]):
        raise AssertionError(f'{label} traceRaw mode ({mode}): {what} '
                             f'differs from the plain version')
    errRaw = float((rawK - rawP).abs().max())
    if not errRaw <= rawAtol:
      raise AssertionError(f'{label} traceRaw mode ({mode}): records differ '
                           f'by {errRaw} (atol {rawAtol})')
    sameBin = binsK[0] == binsP[0]
    moved = int((~sameBin).sum())
    if moved > budget:
      raise AssertionError(f'{label} traceBins mode ({mode}): {moved} rays '
                           f'in another bin (budget {budget})')
    errBins = float(((binsK[1:] - binsP[1:]).abs() * sameBin).max())
    if errBins != 0.:
      raise AssertionError(f'{label} traceBins mode ({mode}): power / count '
                           f'differ by {errBins} in equal bins')
    worst['traceRaw'] = max(worst['traceRaw'], errRaw)
    worst['traceBins'] = max(worst['traceBins'], errBins)
    emit(dict(phase='ring-kernels-vs-plain', scene=label, mode=mode, rays=n,
              hitSlots=hitSlots, rawCounters=cRawK.tolist(),
              binsCounters=cBinsK.tolist(), maxAbsErrRaw=errRaw,
              movedRays=moved, maxAbsErrBins=errBins))
  binsAgainstHistogram(label, tables, histSpec, n, us, strataTile, kw)
  return worst


def binsAgainstHistogram(label, tables, histSpec, n, us, strataTile, kw):
  '''Per-ray bins + float64 binning outside (`traceBins` + `binRing`)
  against the in-kernel histogram (`traceHistogram`) on the same uniforms:
  counters and counts equal bin for bin, power POWER_RTOL.'''
  h1 = fused.initHistograms(histSpec, device=DEV)
  c1 = cuda_trace.traceHistogram(tables, h1, n, uniforms=us,
                                 strataTile=strataTile, **kw)
  h2 = fused.initHistograms(histSpec, device=DEV)
  ring, c2 = cuda_trace.traceBins(tables, n, uniforms=us,
                                  strataTile=strataTile, **kw)
  cuda_trace.binRing(h2, ring)
  torch.cuda.synchronize()
  if c1.tolist() != c2.tolist() or not torch.equal(h1['counts'],
                                                   h2['counts']):
    raise AssertionError(f'{label}: traceBins + binRing counts differ from '
                         f'traceHistogram ({c1.tolist()} / {c2.tolist()})')
  if not torch.allclose(h1['power'], h2['power'], rtol=POWER_RTOL, atol=0.):
    raise AssertionError(f'{label}: traceBins + binRing power differs from '
                         f'traceHistogram beyond rtol {POWER_RTOL}')
  emit(dict(phase='bins-vs-histogram', scene=label, rays=n,
            counters=c2.tolist(),
            maxAbsErrPower=float((h1['power'] - h2['power']).abs().max())))


def compareSeedMode(scene, bounds, maxI, n, bins):
  '''Mode (a): the kernel's own Philox draws vs the plain version fed torch
  uniforms — independent numbers, so compared by histogram marginals.'''
  sceneNp, histSpec, tables = buildTables(scene, bounds, bins, maxI)
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6, hitSlots=1)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  hK = fused.initHistograms(histSpec, device=DEV)
  cK = cuda_trace.traceHistogram(tables, hK, n, seed=20261016,
                                 strataTile=strataTile, **kw)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(99)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1],
                                    cuda_trace.tileStrata(n, strataTile),
                                    strataTile)
  hP = fused.initHistograms(histSpec, device=DEV)
  cP = cuda_trace.traceHistogramPlain(tables, hP, cols, **kw)
  torch.cuda.synchronize()
  a, b = hK['counts'][0].cpu().numpy(), hP['counts'][0].cpu().numpy()
  dists = []
  for axis in (0, 1):
    ma, mb = a.sum(axis=axis), b.sum(axis=axis)
    dists.append(float(np.abs(ma / ma.sum() - mb / mb.sum()).sum()))
  relHits = abs(int(cK[1]) - int(cP[1])) / max(int(cP[1]), 1)
  relSegs = abs(int(cK[0]) - int(cP[0])) / max(int(cP[0]), 1)
  emit(dict(phase='kernel-vs-plain', scene='lensMirror', mode='a', rays=n,
            counters=cK.tolist(), plainCounters=cP.tolist(),
            marginalL1=dists))
  if max(dists) > MARGINAL_L1 or relHits > 5e-3 or relSegs > 5e-3:
    raise AssertionError(f'mode (a): marginals {dists}, hits {relHits}, '
                         f'segments {relSegs} off the plain version')


def resetLaunchCounts():
  for name in cuda_trace.launchCounts:
    cuda_trace.launchCounts[name] = 0


def onlyLaunches(**counts):
  '''The launch counts of a run that launched these kernels and no other.'''
  return {**{name: 0 for name in cuda_trace.launchCounts}, **counts}


def boundMs(tables, segmentsPerStep, nRays, outputBytes, gratingPasses=0,
            scatterPasses=0, inputBytes=0, trianglesPerSegment=0.,
            tableRowsPerSegment=None, cullStats=None, levels=None):
  '''Least time the card could take for one step: (ms by operations, ms by
  bytes), from this run's segment count, its passes through a grating and
  through a scattering element, the bytes the kernel must move (table, a
  mesh's triangle table and boxes, counters and `inputBytes` in,
  `outputBytes` out) and, for a mesh, per segment the slab test of every
  chunk box and Moeller-Trumbore on `trianglesPerSegment` triangles (the
  mean over ray-bounces of the triangles in the boxes the ray's capped
  segment enters, as the plain version counts them: what the cull cannot
  skip) and, for a surface table, per segment the slab test of every chunk
  box and the rows of `tableRowsPerSegment` ({kind: the mean over
  ray-bounces of the rows of that kind in the plain runs and in the boxes
  the ray's capped segment enters}). Per segment the surface rows it
  sweeps: every row, or on tables with a cull block (B12) the rows of each
  bounce's set weighted by the segments that bounce traces (`cullStats` of
  a plain run of the same rays, `_bounceLoopPlain`). The tables' part is
  counted again for each sweep of `levels` ({level of LEVELS: per segment
  the group, chunk and leaf boxes a ray tests, `boxTests`, and what it
  sweeps, `triangles` or `rows` by kind, as the plain version counts them,
  `levelWork`}), whose operations and bound the returned dict gives as
  `flopsPerSegment<Level>` and `boundOps<Level>Ms` (`TwoLevel`,
  `ThreeLevel`, `Warp`), beside the one-level count above.'''
  rows = tables['surfRows']
  if 'nVariants' in tables:            # a sweep: every variant, one structure
    rows = rows[0]

  def rowFlops(r):                     # its test, the trims of B3 per root
    roots = TRIM_ROOTS[r['kind']]
    flops = FLOPS_INTERSECT[r['kind']]
    if r['trim0'] == 2.:
      flops += roots * (FLOPS_PIXEL if r['kind'] == 0
                        else FLOPS_CHART_ATAN2 + FLOPS_PIXEL)
    flops += roots * FLOPS_PRIM * len(r.get('holePrims', ()))
    return flops + (FLOPS_STAGE_GATE if tables['gate'] else 0)

  everyRow = sum(rowFlops(r) for r in rows)
  if tables.get('cullOff', -1) >= 0:
    segs, sets = cullStats['segmentsByBounce'], cullStats['sets']
    swept = sum(n * (everyRow if ss is None
                     else sum(rowFlops(rows[s]) for s in ss))
                for n, ss in zip(segs, sets)) / max(sum(segs), 1)
  else:
    swept = everyRow
  flopsPerSegment = swept + FLOPS_WINNER + FLOPS_PHYSICS
  if tables['dispOff'] >= 0:
    flopsPerSegment += FLOPS_DISPERSION
  if tables['scatter']:
    flopsPerSegment += FLOPS_SCATTER_RENORM
  rowFlopsOf = lambda rows: sum(FLOPS_TABLE_ROW[k] * n
                                for k, n in rows.items())
  levels = {capitalised(level): work
            for level, work in (levels or {}).items()}
  levelFlops = dict.fromkeys(levels, flopsPerSegment)
  packBytes = lambda key: 0 if tables[key] is None else tables[key].numel()
  if tables.get('nTri'):
    flopsPerSegment += (FLOPS_CHUNK_TEST * tables['nTriChunks']
                        + FLOPS_TRIANGLE * trianglesPerSegment)
    for name, work in levels.items():
      levelFlops[name] += (FLOPS_CHUNK_TEST * work['boxTests']
                           + FLOPS_TRIANGLE * work['triangles'])
    inputBytes += 4 * (tables['triTable'].numel() + packBytes('triBoxPack'))
  if tables.get('nSurfTable'):
    flopsPerSegment += (FLOPS_CHUNK_TEST * tables['nSurfChunks']
                        + rowFlopsOf(tableRowsPerSegment))
    for name, work in levels.items():
      levelFlops[name] += (FLOPS_CHUNK_TEST * work['boxTests']
                           + rowFlopsOf(work['rows']))
    inputBytes += 4 * (tables['surfTable'].numel()
                       + packBytes('surfBoxPack'))
  sampler = FLOPS_SAMPLER
  if tables.get('samplerKind') == cuda_trace.SAMPLER_SURFACE:
    faces = tables['samplerSpec']['faces']
    sampler = (FLOPS_SURFACE_SAMPLER + FLOPS_FACE_SCAN * len(faces)
               + max(FLOPS_GEOM_FACE.get(f['kind'], 0) for f in faces))
  rest = nRays * sampler + gratingPasses * FLOPS_GRATING
  if scatterPasses:
    rest += scatterPasses * scatterPassFlops(tables)
  flops = segmentsPerStep * flopsPerSegment + rest
  nbytes = (outputBytes + inputBytes + tables['table'].numel() * 4
            + 3 * 8)
  extra = {}
  for name, f in levelFlops.items():
    extra[f'flopsPerSegment{name}'] = f
    extra[f'boundOps{name}Ms'] = ((segmentsPerStep * f + rest)
                                  / PEAK_F32_FLOPS * 1e3)
  return (flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3,
          dict(flopsPerSegment=flopsPerSegment, flopsPerStep=flops,
               bytesPerStep=nbytes, **extra))


def kernelEntry(name, source, replaces, launches, err, ms, plainMs, bounds,
                spectro, surface=None, scatter=None, geom=None, mesh=None,
                wall=None, cull=None):
  '''One entry of the `kernels` line: the main-path numbers (lens-and-mirror
  scene; the examples/3 sweep for the sweep kernel) and, beside them, the
  kernel on the spectrometer (`spectro`: its launches on that path, ms and
  bound) and the worst error over the scenes of gratings, dispersion,
  sequential mode and masks, and on the surface-source scene (`surface`:
  launches, ms, bound and the worst error over the surface scenes; None
  for the sweep kernel, which samples point sources only), and on the
  scatter scenes (`scatter`: launches on the scatter path, ms and bound on
  the diffuse scene, per-scene ms, and the worst error over the scatter
  scenes and the scene of many surfaces), and on the scenes of the other
  surface kinds and trims (`geom`: launches on the torus-mirror path, ms
  and bound on the torus scene, per-scene ms, the worst error over phase
  9's checks), and on the triangle meshes (`mesh`: launches on the
  1800-triangle dish's path, ms and bound there, ms by dish, the worst
  error over phase 10's checks, `b7_max_abs_err`), and on the walls of the
  surface table (`wall`: launches on the 522-surface wall's path, ms and
  bound there, ms by wall, the worst error over phase 11's checks,
  `b8_max_abs_err`); on both, the bound is that of the kernels'
  three-level sweep with the shrinking cap, each ray alone
  (`tableBound`), the least the table sweep needs, with the one-level
  count's beside it (`..._one_level_bound_ms`: every chunk box, the rows of
  each entered chunk) and, by dish and by wall, the operations a segment
  and the bound of every count (`tableWork`), and on the decoy scene of the per-bounce culls
  (`cull`: launches on its path, ms with and without the culls, bounds
  with and without them, the worst error of the b12 phase,
  `b12_max_abs_err`; None for the sweep kernel, which never culls).
  `max_abs_err` is the worst of all. `hist_mode`: how the histogram
  kernels bin (B11), None for the per-ray kernels.'''
  boundOps, boundBytes, _ = bounds
  spOps, spBytes, _ = spectro['bounds']
  surf = dict(surface_launches=None, surface_ms=None, surface_bound_ms=None,
              surface_max_abs_err=None)
  if surface is not None:
    sOps, sBytes, _ = surface['bounds']
    surf = dict(surface_launches=surface['launches'],
                surface_ms=surface['ms'],
                surface_bound_ms=max(sOps, sBytes),
                surface_max_abs_err=surface['err'])
  sOps, sBytes, _ = scatter['bounds']
  scat = dict(scatter_launches=scatter['launches'],
              scatter_ms=scatter['ms'],
              scatter_bound_ms=max(sOps, sBytes),
              scatter_bound_by='operations' if sOps >= sBytes else 'bytes',
              scatter_ms_by_scene=scatter.get('byScene'),
              scatter_max_abs_err=scatter['err'])
  gOps, gBytes, _ = geom['bounds']
  geo = dict(geom_launches=geom['launches'], geom_ms=geom['ms'],
             geom_bound_ms=max(gOps, gBytes),
             geom_bound_by='operations' if gOps >= gBytes else 'bytes',
             geom_ms_by_scene=geom.get('byScene'),
             geom_max_abs_err=geom['err'])
  mBound, mBy, mOneLevel = tableBound(mesh['bounds'])
  tri = dict(mesh_launches=mesh['launches'], mesh_ms=mesh['ms'],
             mesh_bound_ms=mBound, mesh_bound_by=mBy,
             mesh_one_level_bound_ms=mOneLevel,
             mesh_ms_by_scene=mesh.get('byScene'),
             mesh_bound_ms_by_scene=mesh.get('boundByScene'),
             mesh_one_level_bound_ms_by_scene=mesh.get('oneLevelByScene'),
             mesh_work_by_scene=mesh.get('workByScene'),
             b7_max_abs_err=mesh['err'])
  wBound, wBy, wOneLevel = tableBound(wall['bounds'])
  tab = dict(wall_launches=wall['launches'], wall_ms=wall['ms'],
             wall_bound_ms=wBound, wall_bound_by=wBy,
             wall_one_level_bound_ms=wOneLevel,
             wall_ms_by_scene=wall.get('byScene'),
             wall_bound_ms_by_scene=wall.get('boundByScene'),
             wall_one_level_bound_ms_by_scene=wall.get('oneLevelByScene'),
             wall_work_by_scene=wall.get('workByScene'),
             b8_max_abs_err=wall['err'])
  b12 = dict(b12_launches=None, b12_ms=None, b12_unculled_ms=None,
             b12_bound_ms=None, b12_unculled_bound_ms=None,
             b12_max_abs_err=None)
  if cull is not None:
    b12 = dict(b12_launches=cull['launches'], b12_ms=cull['ms'],
               b12_unculled_ms=cull['unculledMs'],
               b12_bound_ms=max(cull['bounds'][:2]),
               b12_unculled_bound_ms=max(cull['unculledBounds'][:2]),
               b12_max_abs_err=cull['err'])
  return dict(name=name, route='cuda',
              source=f'optics_design_workbench_tpu_torch/csrc/{source}',
              replaces=f'optics_design_workbench_tpu/ops/pallas_trace.py:'
                       f'{replaces}',
              launches=launches,
              max_abs_err=max(err, spectro['err'],
                              surf['surface_max_abs_err'] or 0.,
                              scatter['err'], geom['err'], mesh['err'],
                              wall['err'], b12['b12_max_abs_err'] or 0.),
              ms=ms,
              plain_ms=plainMs, bound_ms=max(boundOps, boundBytes),
              bound_by='operations' if boundOps >= boundBytes else 'bytes',
              library_ms=None, hist_mode=cuda_trace.HIST_MODE if name in (
                  'traceHistogram', 'traceSweep') else None,
              lens_mirror_max_abs_err=err,
              b4_max_abs_err=spectro['err'],
              spectrometer_launches=spectro['launches'],
              spectrometer_ms=spectro['ms'],
              spectrometer_bound_ms=max(spOps, spBytes), **surf, **scat,
              **geo, **tri, **tab, **b12)


def timeBenchStep(histPrecision, maxI, **benchKw):
  '''A `benchmarks.makeBenchStep` step at full width: a few warm steps,
  TIMED_STEPS timed ones into zeroed histograms with the launch counts read
  around them, then the kernel alone by CUDA events. Returns a dict of the
  step, its histograms, meta, and what was measured.'''
  wrapper = 'traceHistogram' if histPrecision == 'default' else 'traceBins'
  step, hist, meta = benchmarks.makeBenchStep(
      raysPerStep=N_MAIN, maxIntersections=maxI, bins=BINS,
      histPrecision=histPrecision, **benchKw)
  assert meta['backend'] == 'cuda'
  for s in range(WARM_STEPS):
    hist, counters = step(s, hist)
  torch.cuda.synchronize()
  hist['power'].zero_()
  hist['counts'].zero_()
  resetLaunchCounts()
  t0 = time.perf_counter()
  allCounters = []
  for s in range(TIMED_STEPS):
    hist, counters = step(1000 + s, hist)
    allCounters.append(counters)
  torch.cuda.synchronize()
  stepMs = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
  launches = dict(cuda_trace.launchCounts)
  if launches != onlyLaunches(**{wrapper: TIMED_STEPS}):
    raise AssertionError(f'{launches} kernel launches for {TIMED_STEPS} '
                         f'steps of histPrecision={histPrecision!r}')
  kw = dict(maxIntersections=maxI,
            maxRayLength=meta['scene'].activeSimulationSettings()
            .maxRayLength(), distTol=1e-4, powerTol=1e-6,
            hitSlots=step.hitSlots)
  seeds = iter(range(5000, 5000 + 10 ** 6))
  scratch = fused.initHistograms(meta['histSpec'], device=DEV)
  if histPrecision == 'default':
    kernelMs = cudaMs(lambda: step(next(seeds), scratch), TIMED_STEPS)
  else:
    kernelMs = cudaMs(lambda: cuda_trace.traceBins(
        step.tables, N_MAIN, seed=next(seeds), strataTile=step.strataTile,
        **kw), TIMED_STEPS)
  return dict(step=step, hist=hist, meta=meta, kw=kw, wrapper=wrapper,
              stepMs=stepMs, kernelMs=kernelMs, launches=launches[wrapper],
              segments=sum(int(c['segments']) for c in allCounters),
              hits=sum(int(c['hits']) for c in allCounters),
              overflow=sum(int(c['hitOverflow']) for c in allCounters))


def fusedStepPhase(histPrecision):
  '''The fused step through `benchmarks.makeBenchStep` at full width
  (`timeBenchStep`), the plain version at the same size, and the physics of
  the accumulated histogram.'''
  t = timeBenchStep(histPrecision, 6)
  step, hist, meta, kw = t['step'], t['hist'], t['meta'], t['kw']
  stepMs, kernelMs = t['stepMs'], t['kernelMs']
  segments, hits, overflow = t['segments'], t['hits'], t['overflow']
  tables = step.tables
  scratch = fused.initHistograms(meta['histSpec'], device=DEV)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(7)
  strata = cuda_trace.tileStrata(N_MAIN, step.strataTile)

  def plainStep():
    us = torch.rand((2, N_MAIN), generator=gen, device=DEV,
                    dtype=torch.float32)
    cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata,
                                      step.strataTile)
    if histPrecision == 'default':
      cuda_trace.traceHistogramPlain(tables, scratch, cols, **kw)
    else:
      cuda_trace.traceBinsPlain(tables, cols, **kw)

  plainStep()
  plainMs = cudaMs(plainStep, 2)

  segsPerStep = segments / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(tables, segsPerStep, N_MAIN, outBytes)
  emit(dict(phase='main-path', histPrecision=histPrecision, rays=N_MAIN,
            maxIntersections=6, bins=BINS, steps=TIMED_STEPS, stepMs=stepMs,
            kernelMs=kernelMs, plainMs=plainMs,
            raySegmentsPerSec=segsPerStep / (stepMs * 1e-3),
            segmentsPerRay=segsPerStep / N_MAIN, hits=hits,
            hitOverflow=overflow, launches=t['launches'],
            boundMs=max(bounds[:2]), strataTile=step.strataTile,
            **bounds[2]))

  # physics of the result
  nRays = N_MAIN * TIMED_STEPS
  totalPower = float(hist['power'].double().sum())
  totalCounts = float(hist['counts'].double().sum())
  hitShare = hits / nRays
  segsPerRay = segments / nRays
  meanPower = totalPower / max(totalCounts, 1.)
  emit(dict(phase='physics', histPrecision=histPrecision, hitShare=hitShare,
            segmentsPerRay=segsPerRay, meanDetectedPower=meanPower,
            histCounts=totalCounts))
  if not torch.isfinite(hist['power']).all():
    raise AssertionError('non-finite histogram power')
  if tuple(hist['power'].shape) != (1,) + BINS:
    raise AssertionError(f'histogram shape {tuple(hist["power"].shape)}')
  if totalCounts != hits:
    raise AssertionError(f'histogram counts {totalCounts} != hits {hits}')
  if hitShare < 0.9 or abs(segsPerRay - 4.) > 0.1 or overflow != 0:
    raise AssertionError(f'hit share {hitShare}, segments/ray {segsPerRay}, '
                         f'overflow {overflow}')
  if abs(meanPower - 0.98) > 1e-3:
    raise AssertionError(f'mean detected power {meanPower}, expected the '
                         f"fold mirror's reflectivity 0.98")
  return dict(launches=t['launches'], kernelMs=kernelMs, plainMs=plainMs,
              bounds=bounds)


def timedRun(scene, **kwargs):
  '''runSimulation with the host clock read at start, at every progress
  callback and at the end. Returns (runPath, progress dicts, seconds of
  set-up + first pass, of the later passes, of the clean-up).'''
  progress, stamps = [], []

  def onProgress(p):
    torch.cuda.synchronize()
    progress.append(p)
    stamps.append(time.perf_counter())

  t0 = time.perf_counter()
  runPath = simulation.runSimulation(scene, 'true', seed=20261016,
                                     progressCallback=onProgress, **kwargs)
  t1 = time.perf_counter()
  return runPath, progress, (stamps[0] - t0, stamps[-1] - stamps[0],
                             t1 - stamps[-1])


def recordingRunPhases(tmp):
  '''The recording run at full width on the lens-and-mirror scene.'''
  # ---- (i) the raw step alone: kernel, then kernel + compaction + fetch
  scene = benchmarks.buildLensMirrorScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  sceneNp, info = scene.compile(device=None)
  sceneNp['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  src = scene.lightSources()[0]
  out = {}
  for n in (N_MAIN, N_RAW_ITERATION):
    step = cuda_trace.makeRawStep(
        sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
        raysPerStep=n, maxIntersections=6,
        maxRayLength=settings.maxRayLength(), distTol=1e-4,
        sampler=src.samplerSpec(), emissionBound=src.emissionBound())
    seeds = iter(range(10 ** 6))
    records, counters = step(next(seeds))
    kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
        step.tables, n, 6, settings.maxRayLength(), 1e-4,
        hitSlots=step.hitSlots, seed=next(seeds),
        strataTile=step.strataTile), TIMED_STEPS)
    stepOnlyMs = cudaMs(lambda: step(next(seeds)), TIMED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
      records, counters = step(next(seeds))
      hits = runner.compactRecordsToHits(records, {}, info['elementLabels'])
    wholeMs = (time.perf_counter() - t0) * 1e3 / 3
    rows = sum(len(c['points']) for c in hits.values())
    if rows != int(counters['hits']) or list(hits) != ['Detector']:
      raise AssertionError(f'compaction kept {rows} rows of '
                           f'{int(counters["hits"])} hits in {list(hits)}')
    out[n] = dict(kernelMs=kernelMs, segments=int(counters['segments']),
                  hitSlots=step.hitSlots, tables=step.tables)
    emit(dict(phase='raw-step', rays=n, hitSlots=step.hitSlots,
              kernelMs=kernelMs, stepWithRecordsMs=stepOnlyMs,
              kernelCompactFetchMs=wholeMs,
              compactFetchMs=wholeMs - stepOnlyMs, hitRows=rows,
              bytesFetched=rows * 36))

  # ---- (ii) runSimulation with raw recording, hits written and read back
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Detector')
  rows = len(hits['points'])
  traced = last['totalTracedRays']
  meanPower = float(hits['powers'].astype(np.float64).mean())
  fileBytes = sum(os.path.getsize(f) for f in glob.glob(
      os.path.join(runPath, 'source-*', 'object-*', '*')))
  lc = simulation.Lifecycle(scene.resultsFolderPath())
  perIterationMs = later / (RAW_ITERATIONS - 1) * 1e3
  emit(dict(phase='run-raw', raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, meanPower=meanPower, launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup, perIterationMs=perIterationMs,
            traceMsPerIteration=out[N_RAW_ITERATION]['kernelMs'],
            raysPerSecStoredLoop=N_RAW_ITERATION / (perIterationMs * 1e-3),
            raysPerSecStoredWithFlush=traced / (first + later + cleanup),
            fileBytes=fileBytes))
  if launches != onlyLaunches(traceRaw=RAW_ITERATIONS):
    raise AssertionError(f'raw run launched {launches}')
  if traced != N_RAW_ITERATION * RAW_ITERATIONS \
      or rows != last['totalRecordedHits'] or rows < 0.9 * traced:
    raise AssertionError(f'{rows} rows stored, {last}')
  if set(hits) - {'source', 'obj'} != {'points', 'directions', 'powers',
                                       'isEntering'}:
    raise AssertionError(f'stored columns {sorted(hits)}')
  if not np.isfinite(hits['points']).all() \
      or np.abs(hits['points'][:, 0] + 100.).max() > 1e-3:
    raise AssertionError('stored points off the detector plane x = -100')
  if abs(meanPower - 0.98) > 1e-3:
    raise AssertionError(f'mean stored power {meanPower}')
  if lc.isRunning() or lc.isCanceled() or not lc.isFinished():
    raise AssertionError('lifecycle flags not cleared after the raw run')
  rawLaunches = launches['traceRaw']

  # ---- (iii) runSimulation with histogram-first recording
  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS,
      histBounds=(-60., 60., -60., 60.))
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Source']['Detector']
  counts = float(snap['counts'].astype(np.float64).sum())
  sample = RawFolder(runPath).loadHits('Detector')
  sampleSteps = sum(1 for p in range(1, len(progress) + 1) if p % 8 == 1)
  emit(dict(phase='run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], passes=len(progress),
            tracedRays=last['totalTracedRays'], histCounts=counts,
            recordedHits=last['totalRecordedHits'],
            rawSampleRows=len(sample['points']), launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=last['totalTracedRays'] / (first + later + cleanup)))
  if last['totalIterations'] != HIST_ITERATIONS \
      or last['totalTracedRays'] != HIST_ITERATIONS * N_MAIN:
    raise AssertionError(f'histogram run ended at {last}')
  if counts != last['totalRecordedHits'] or counts < 0.9 * HIST_ITERATIONS \
      * N_MAIN:
    raise AssertionError(f'snapshot counts {counts}, run counted '
                         f'{last["totalRecordedHits"]}')
  if not 0 < len(sample['points']) <= 8192 * sampleSteps:
    raise AssertionError(f'raw sample holds {len(sample["points"])} rows')
  if launches != onlyLaunches(traceHistogram=HIST_ITERATIONS,
                              traceRaw=sampleSteps):
    raise AssertionError(f'histogram run launched {launches}, expected '
                         f'{HIST_ITERATIONS} steps + {sampleSteps} samples')
  return rawLaunches, out[N_MAIN]


def sweepTablesFor(scenes, bounds, source=0, bins=SWEEP_BINS):
  '''(stacked sweep tables, host scenes, histogram spec) of these variants
  as light source `source` of each is traced (with its surface mask).'''
  host, specs = [], []
  for sc in scenes:
    sceneNp, info = compiled(sc)
    src = sc.lightSources()[source]
    if src.Label in info['surfaceMasks']:
      sceneNp = dict(sceneNp, surfMask=info['surfaceMasks'][src.Label])
    host.append((sceneNp, info))
    specs.append(src.samplerSpec())
  histSpec = fused.makeHistogramSpec(*host[0], bounds=bounds, bins=bins)
  tables = cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                       device=DEV)
  return tables, host, histSpec, specs


def compareSweepWithPlain(label, scenes, bounds, maxI, n, columnsToo,
                          source=0, budget=COUNT_BUDGET, bins=SWEEP_BINS,
                          launches=None):
  '''The sweep kernel vs its plain version on the card, same uniforms (and,
  where the source is the same in every variant, the same ray columns):
  per-variant counters equal, at most COUNT_BUDGET rays per variant in
  another bin, power POWER_RTOL. `launches` (a dict) gets each mode's
  launch record. Returns the worst absolute power error.'''
  tables, host, histSpec, _specs = sweepTablesFor(scenes, bounds, source,
                                                  bins)
  hitSlots = cuda_trace.autoHitSlots(host[0][0], histSpec, maxI)
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=hitSlots)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(2468)
  us = torch.rand((cuda_trace.uniformRows(tables, maxI), n), generator=gen,
                  device=DEV, dtype=torch.float32)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(n, strataTile)
  modes = [('b', dict(uniforms=us, strataTile=strataTile),
            dict(uniforms=us, strata=strata, strataTile=strataTile))]
  if columnsToo:
    tables0 = cuda_trace.variantTables(tables, 0)
    cols = cuda_trace.sampleRaysPlain(tables0, us[0], us[1], strata,
                                      strataTile)
    colsT = rayColumns(tables0, cols)
    modes.append(('c', dict(columns=colsT), dict(columns=colsT)))
  # both modes trace the same rays: one run of the plain version serves both
  plain, worst = {}, 0.
  for mode, inputs, plainInputs in modes:
    worst = max(worst, holdSweepAgainstPlain(label, mode, tables, n, inputs,
                                             plainInputs, kw, budget,
                                             plain)[0])
    if launches is not None:
      launches[mode] = dict(cuda_trace.lastLaunch['traceSweep'])
  return worst


def holdSweepAgainstPlain(label, mode, tables, n, inputs, plainInputs, kw,
                          budget=COUNT_BUDGET, plain=None):
  '''One launch of the sweep kernel and one run of its plain version on the
  same inputs, each into fresh histograms; raises where they disagree.
  `plain` (a dict) keeps the plain version's run for a later call on the
  same rays. Returns (worst absolute power error, the plain version's
  ms).'''
  V = tables['nVariants']
  shape = (V, tables['nDet']) + tuple(tables['bins'])
  hK = dict(power=torch.zeros(shape, device=DEV),
            counts=torch.zeros(shape, device=DEV))
  cK = cuda_trace.traceSweep(tables, hK, n, **inputs, **kw)
  torch.cuda.synchronize()
  if plain is None or not plain:
    hP = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
    t0 = time.perf_counter()
    cP = cuda_trace.traceSweepPlain(tables, hP, n, **plainInputs, **kw)
    torch.cuda.synchronize()
    plainMs = (time.perf_counter() - t0) * 1e3
    if plain is not None:
      plain.update(hP=hP, cP=cP, plainMs=plainMs)
  else:
    hP, cP, plainMs = plain['hP'], plain['cP'], plain['plainMs']
  if cK.tolist() != cP.tolist():
    raise AssertionError(f'{label} sweep mode ({mode}): counters differ: '
                         f'kernel {cK.tolist()} plain {cP.tolist()}')
  moved = (hK['counts'] - hP['counts']).abs().sum(dim=(1, 2, 3)) / 2
  if float(moved.max()) > budget:
    raise AssertionError(f'{label} sweep mode ({mode}): {moved.tolist()} '
                         f'rays per variant changed bins (budget '
                         f'{budget})')
  same = (hK['counts'] == hP['counts']) & (hP['counts'] > 0)
  pK, pP = hK['power'][same], hP['power'][same]
  if not torch.allclose(pK, pP, rtol=POWER_RTOL, atol=0.):
    raise AssertionError(f'{label} sweep mode ({mode}): power differs '
                         f'beyond rtol {POWER_RTOL}')
  if int(cK[:, 1].min()) <= 0:
    raise AssertionError(f'{label} sweep mode ({mode}): a variant recorded '
                         f'no hits')
  if torch.equal(hK['counts'][0], hK['counts'][1]):
    raise AssertionError(f'{label} sweep mode ({mode}): variants 0 and 1 '
                         f'gave the same histogram')
  err = float((pK - pP).abs().max())
  emit(dict(phase='sweep-vs-plain', sweep=label, mode=mode, variants=V,
            raysPerVariant=n, counterTotals=cK.sum(dim=0).tolist(),
            movedRaysMax=float(moved.max()), maxAbsErrPower=err,
            plainMs=plainMs))
  return err, plainMs


def sweepScenes(radii):
  return [benchmarks.buildSweepLensScene(float(r)) for r in radii]


def sweepStepFor(radii, n):
  '''(step, table, host scenes, sampler spec) of the lens-radius sweep.'''
  scenes = sweepScenes(radii)
  host = [sc.compile(device=None) for sc in scenes]
  spec = scenes[0].lightSources()[0].samplerSpec()
  step, pack = cuda_trace.makeSweepStep(
      host, SWEEP_BOUNDS, SWEEP_BINS, spec, n, SWEEP_MAX_INTERSECTIONS,
      1000., 1e-4, device=DEV)
  return step, pack(host), host, spec


def holdSweepAgainstSingles(label, power, counts, counters, singles,
                            histSpec, n, kw, seed):
  '''A seed-mode launch of the sweep kernel (its per-variant `power`,
  `counts`, `counters`) against one launch of the histogram kernel per
  variant with the same seed on that variant's own table (`singles`): the
  same rays, so counters equal, counts equal bin for bin, power POWER_RTOL
  (the atomics land in another order).'''
  torch.cuda.synchronize()
  counters = counters.tolist()
  worst = 0.
  for v, tables in enumerate(singles):
    hist = fused.initHistograms(histSpec, device=DEV)
    c = cuda_trace.traceHistogram(tables, hist, n, seed=seed, **kw)
    torch.cuda.synchronize()
    if c.tolist() != counters[v]:
      raise AssertionError(f'{label} sweep variant {v}: counters '
                           f'{counters[v]}, the single-scene kernel '
                           f'{c.tolist()}')
    if not torch.equal(hist['counts'], counts[v]):
      raise AssertionError(f'{label} sweep variant {v}: counts differ from '
                           f'the single-scene kernel')
    if not torch.allclose(hist['power'], power[v], rtol=POWER_RTOL, atol=0.):
      raise AssertionError(f'{label} sweep variant {v}: power differs from '
                           f'the single-scene kernel beyond rtol '
                           f'{POWER_RTOL}')
    worst = max(worst, float((hist['power'] - power[v]).abs().max()))
  emit(dict(phase='sweep-vs-single', sweep=label, variants=len(singles),
            raysPerVariant=n, seed=seed, strataTile=kw['strataTile'],
            segments=sum(c[0] for c in counters),
            hits=sum(c[1] for c in counters), maxAbsErrPower=worst))


def compareSweepWithSingle(V, n, seed=31):
  '''The path's sweep step (`makeSweepStep`) in seed mode against V
  launches of the histogram kernel (`holdSweepAgainstSingles`).'''
  step, table, host, spec = sweepStepFor(np.linspace(45., 95., V), n)
  power, counts, segments = step(seed, table)
  if int(segments) != int(step.counters[:, 0].sum()):
    raise AssertionError('the step\'s segment total is not the counters\'')
  singles = [cuda_trace.buildTraceTables(h, step.histSpec, spec, device=DEV)
             for h, _i in host]
  holdSweepAgainstSingles(
      'radius', power, counts, step.counters, singles, step.histSpec, n,
      dict(maxIntersections=SWEEP_MAX_INTERSECTIONS, maxRayLength=1000.,
           distTol=1e-4, hitSlots=step.hitSlots, strataTile=step.strataTile),
      seed)


def sweepPathPhase(V, n):
  '''`evaluateBatched` on the lens-radius sweep, three calls with shifted
  radii (nothing can be cached by value): wall time cold and steady, the
  sweep kernel alone by CUDA events, and the same work as one launch of the
  histogram kernel per variant, timed the same way.'''
  sweeper, holder = benchmarks.makeSweepLensSweeper()
  radii = np.linspace(45., 95., V)
  totals = []

  def metric(power, counts):
    totals.append(float(counts.sum()))
    return helpers.spotMetric(power, counts)

  def call(k, route):
    sets = [dict(R=float(r + 0.3 * k)) for r in radii]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # 'loop' is the sweeper's per-variant route: the same host work with V
    # launches, V table uploads and V fetches
    hists = sweeper._batchedHistograms(
        sets, lambda: holder['scene'], n, SWEEP_MAX_INTERSECTIONS,
        SWEEP_BINS, SWEEP_BOUNDS, k, sweepKernel=(route == 'sweep'))
    m = np.array([metric(p, c) for p, c in hists])
    torch.cuda.synchronize()
    return m, time.perf_counter() - t0

  resetLaunchCounts()
  metrics, coldS = call(0, 'sweep')
  steady = [call(k, 'sweep')[1] for k in (1, 2)]
  launches = dict(cuda_trace.launchCounts)
  if sweeper.lastBatchedRoute != 'sweep' \
      or launches != onlyLaunches(traceSweep=3):
    raise AssertionError(f'{launches} launches for 3 evaluateBatched calls '
                         f'(route {sweeper.lastBatchedRoute})')
  best = float(radii[int(np.argmin(metrics))])
  gridStep = 50. / 10                      # of the 11-radius sweep
  if abs(best - 60.) > gridStep + 1e-9:
    raise AssertionError(f'argmin radius {best}, paraxial optimum 60 mm')
  if min(totals) <= 0.9 * n or not np.all(np.isfinite(metrics)):
    raise AssertionError(f'a variant counted {min(totals)} of {n} rays')
  loopMetrics, _ = call(0, 'loop')
  loop = [call(k, 'loop')[1] for k in (1, 2)]
  if sweeper.lastBatchedRoute != 'perVariant' \
      or dict(cuda_trace.launchCounts) != onlyLaunches(traceSweep=3,
                                                       traceHistogram=3 * V):
    raise AssertionError(f'{dict(cuda_trace.launchCounts)} launches after '
                         f'3 per-variant calls')
  if not np.array_equal(loopMetrics, metrics):
    raise AssertionError('one launch per variant gave other metrics than '
                         'the sweep kernel on the same seed')

  # the kernels alone, by events, on prebuilt tables
  step, table, host, spec = sweepStepFor(radii, n)
  tables = dict(step.facts, table=torch.as_tensor(table, device=DEV))
  shape = (V,) + step.histShape
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=SWEEP_MAX_INTERSECTIONS, maxRayLength=1000.,
            distTol=1e-4, powerTol=1e-6, hitSlots=step.hitSlots,
            strataTile=step.strataTile)
  seeds = iter(range(7000, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds), **kw)
  segments = int(counters[:, 0].sum())
  launch = dict(cuda_trace.lastLaunch['traceSweep'])
  reps = 20 if V * n < 1 << 24 else 5
  sweepMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), reps)
  singles = [cuda_trace.buildTraceTables(h, step.histSpec, spec, device=DEV)
             for h, _i in host]
  hists1 = [fused.initHistograms(step.histSpec, device=DEV) for _ in singles]

  def k1Loop():
    seed = next(seeds)
    for t, h in zip(singles, hists1):
      cuda_trace.traceHistogram(t, h, n, seed=seed, **kw)

  k1Loop()
  loopMs = cudaMs(k1Loop, reps)
  sweepMs2 = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), reps)
  steadyS, loopS = min(steady), min(loop)
  emit(dict(phase='sweep-path', variants=V, raysPerVariant=n,
            coldS=coldS, steadyS=steadyS, steadyCalls=steady,
            raysPerSec=V * n / steadyS, sweepKernelMs=sweepMs,
            sweepKernelMsAgain=sweepMs2,
            hostShare=1. - sweepMs * 1e-3 / steadyS,
            launchesPerCall=launches['traceSweep'] / 3,
            segmentsPerCall=segments,
            raySegmentsPerSecKernel=segments / (sweepMs * 1e-3),
            bestRadius=best, minCountShare=min(totals) / n,
            perVariantLoopSteadyS=loopS, perVariantLoopCalls=loop,
            perVariantLoopKernelsMs=loopMs,
            sweepOverLoopKernels=sweepMs / loopMs,
            sweepOverLoopWall=steadyS / loopS,
            variantGroup=launch['variantGroup'],
            sharedDraws=launch['sharedDraws'], blocks=launch['blocks'],
            sharedBytes=launch['sharedBytes']))

  # the kernel against its plain version at this shape, same uniforms
  gen = torch.Generator(device=DEV)
  gen.manual_seed(9)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  inputs = dict(uniforms=us, strataTile=step.strataTile)
  err, plainMs = holdSweepAgainstPlain(
      f'path-{V}x{n}', 'b', tables, n, inputs,
      dict(inputs, strata=cuda_trace.tileStrata(n, step.strataTile)),
      {k: v for k, v in kw.items() if k != 'strataTile'})
  return dict(launches=launches['traceSweep'], ms=sweepMs, plainMs=plainMs,
              maxAbsErr=err, tables=tables, segments=segments,
              histBytes=2 * hist['power'].numel() * 4, launch=launch)


def sweepOptimizePhase(tmp):
  '''The reference-style loop on the card: `optimize` -> `runSimulation`
  (raw recording, 20,000 rays) -> `RawFolder.loadHits` -> penalty.'''
  sweeper, holder = benchmarks.makeSweepLensSweeper(
      path=os.path.join(tmp, 'example3'))
  runs = []

  def spotSize(raw):
    runs.append(raw)
    return helpers.spotSize(raw)

  resetLaunchCounts()
  t0 = time.perf_counter()
  result = sweeper.optimize(spotSize, ['R'], method='Nelder-Mead',
                            maxIterations=10, seed=1)
  seconds = time.perf_counter() - t0
  launches = dict(cuda_trace.launchCounts)
  history = sweeper.history
  rows = [len(raw.loadHits('Detector')) for raw in runs]
  emit(dict(phase='sweep-optimize', evaluations=len(history),
            seconds=seconds, msPerEvaluation=seconds * 1e3 / len(history),
            firstPenalty=history[0]['penalty'],
            bestPenalty=result.bestPenalty, bestRadius=result.bestParams['R'],
            launches=launches, rowsPerRun=[min(rows), max(rows)]))
  if len(history) < 5 or len(runs) != len(history):
    raise AssertionError(f'{len(history)} evaluations, {len(runs)} runs')
  if any(h['penalty'] >= parameter_sweeper.PENALTY for h in history):
    raise AssertionError('an evaluation failed and was scored as a penalty')
  if not result.bestPenalty <= history[0]['penalty'] \
      or result.bestPenalty >= 1e98:
    raise AssertionError(f'best penalty {result.bestPenalty}, first '
                         f'{history[0]["penalty"]}')
  if min(rows) < 0.9 * 20000 or not all(raw.uid() for raw in runs):
    raise AssertionError(f'run folders hold {rows} rows')
  if launches != onlyLaunches(traceRaw=len(history)):
    raise AssertionError(f'optimize launched {launches}')


def lineCentroidMm(counts):
  '''Distance (mm) of the count centroid of a (1, H, W) detector histogram
  over SPECTRO_BOUNDS from the axis: where the spectral line lies.'''
  H = counts[0].double()
  n = float(H.sum())
  ys = torch.arange(H.shape[0], dtype=torch.float64, device=H.device)
  xs = torch.arange(H.shape[1], dtype=torch.float64, device=H.device)
  x = SPECTRO_BOUNDS[0] + (float((H.sum(0) * xs).sum()) / n + 0.5) * BIN_MM
  y = SPECTRO_BOUNDS[2] + (float((H.sum(1) * ys).sum()) / n + 0.5) * BIN_MM
  return float(np.hypot(x, y))


def compareSweepWithSingles(label, scenes, bounds, maxI, n, seed, source=0):
  '''The sweep kernel in seed mode on these variants against one launch of
  the histogram kernel per variant (`holdSweepAgainstSingles`).'''
  tables, host, histSpec, specs = sweepTablesFor(scenes, bounds, source)
  shape = (len(scenes), tables['nDet']) + SWEEP_BINS
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6,
            hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec, maxI),
            strataTile=cuda_trace.DEFAULT_STRATA_TILE)
  counters = cuda_trace.traceSweep(tables, hist, n, seed=seed, **kw)
  singles = [cuda_trace.buildTraceTables(h, histSpec, spec, device=DEV)
             for (h, _i), spec in zip(host, specs)]
  holdSweepAgainstSingles(label, hist['power'], hist['counts'], counters,
                          singles, histSpec, n, kw, seed)


def beamWidthScenes(widths=(50., 20., 35.)):
  '''examples/3's lens at R = 60 mm under Gaussian beams of these widths
  (exp(-r^2 / w)): the sources' radius marginals differ, so the variants
  do not share the sampler's draw.'''
  scenes = []
  for w in widths:
    scene = benchmarks.buildSweepLensScene(60.)
    scene.lightSources()[0].PowerDensity = f'exp(-r^2/{w:g})'
    scenes.append(scene)
  return scenes


def variantGroupChecks():
  '''K3's variant groups (`cuda_trace.sweepVariantGroup`): the sweep kernel
  against its plain version (uniforms; and ray columns, which take one
  variant a block) and, in seed mode, against one launch of the histogram
  kernel per variant, on the examples/3 lens where the last group is
  shorter (11 radii x 1 << 18 rays), where the group holds more variants
  than the sweep (3 radii x 1 << 20), and where the kernel traces one
  variant a block: too few rays for a group (4 radii x 100,000, the
  sweeper's default rays) and variants whose beams differ, so that they do
  not share the draw (3 widths x 1 << 20). Each launch's group is checked
  to be the case named. Returns the worst absolute power error.'''
  t0 = time.perf_counter()
  worst = 0.
  cases = (('groups-shorter-last', sweepScenes(np.linspace(45., 95., 11)),
            1 << 18, True, lambda V, g, shared: V % g != 0 and shared),
           ('groups-larger-than-sweep', sweepScenes((50., 60., 70.)),
            1 << 20, True, lambda V, g, shared: g > V and shared),
           ('one-a-block-few-rays', sweepScenes((50., 60., 70., 80.)),
            100_000, True, lambda V, g, shared: g == 1 and shared),
           ('one-a-block-own-draws', beamWidthScenes(), 1 << 20, False,
            lambda V, g, shared: g == 1 and not shared))
  records = {}
  for label, scenes, n, columnsToo, wanted in cases:
    launches = {}
    worst = max(worst, compareSweepWithPlain(
        label, scenes, SWEEP_BOUNDS, SWEEP_MAX_INTERSECTIONS, n, columnsToo,
        launches=launches))
    compareSweepWithSingles(label, scenes, SWEEP_BOUNDS,
                            SWEEP_MAX_INTERSECTIONS, n, seed=41)
    launches['a'] = dict(cuda_trace.lastLaunch['traceSweep'])
    for mode, record in launches.items():
      ok = (record['variantGroup'] == 1 if mode == 'c'
            else wanted(len(scenes), record['variantGroup'],
                        record['sharedDraws']))
      if not ok:
        raise AssertionError(f'{label}: launch {record} in mode ({mode}) is '
                             f'not the case this check is for')
    records[label] = dict(variants=len(scenes), rays=n, launches=launches)
  emit(dict(phase='variant-groups', seconds=time.perf_counter() - t0,
            cases=records, maxAbsErrPower=worst))
  return worst


def b4KernelChecks():
  '''Each kernel against its plain version on the scenes of gratings,
  dispersion, sequential mode and per-source masks (modes (b) and (c),
  the gates of phase 2); the histogram and per-ray kernels at the shapes the
  spectrometer's path gives them (the throughput scene at full width, one
  examples/4 source at a raw iteration's 1 << 20 rays); and the sweep
  kernel on three 3-variant sweeps — the spectrometer's wavelength, the
  Cauchy lens's dispersion (each variant its own n(lambda) polynomial) and,
  under a source's surface mask, the back detector's distance (the stage
  gate) — against its plain version, and in seed mode against one launch
  of the histogram kernel per variant. Returns the worst error per
  kernel.'''
  ns = helpers.torchNs()
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0., traceSweep=0.)

  def rings(*args, **kw):
    w = compareRingsWithPlain(*args, **kw)
    for name in ('traceRaw', 'traceBins'):
      worst[name] = max(worst[name], w[name])

  for name, (build, source) in helpers.B4_SCENES.items():
    scene, bounds, maxI = build(ns)
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        name, scene, bounds, maxI, N_SMALL, BINS, source=source))
    rings(name, scene, bounds, maxI, N_SMALL, BINS, source=source)
  spectrometer = benchmarks.buildSpectrometerScene()
  worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
      'spectrometer', spectrometer, SPECTRO_BOUNDS, SPECTRO_MAX_INTERSECTIONS,
      N_MAIN, BINS))
  rings('spectrometer', spectrometer, SPECTRO_BOUNDS,
        SPECTRO_MAX_INTERSECTIONS, N_MAIN, BINS)
  rings('example4-550nm', example4.buildScene(wavelengths=SPECTRO_WAVELENGTHS),
        SPECTRO_BOUNDS, SPECTRO_MAX_INTERSECTIONS, N_RAW_ITERATION, BINS,
        source=1)

  def cauchy(b):
    scene, bounds, maxI = helpers.buildDispersiveLensMirrorScene(ns)
    scene.getObject('Lens').RefractiveIndex = f'1.5046 + {b}/wavelength^2'
    return scene, bounds, maxI

  def backAt(z):
    scene, bounds, maxI = helpers.buildMaskedSourcesScene(ns)
    scene.getObject('Back').placements = [ns.T.translation(0, 0, z)]
    return scene, bounds, maxI

  sweeps = (
      ('wavelength', [(benchmarks.buildSpectrometerScene(wavelength=w),
                       SPECTRO_BOUNDS, SPECTRO_MAX_INTERSECTIONS)
                      for w in SPECTRO_WAVELENGTHS], 0, False),
      ('cauchyB', [cauchy(b) for b in (4200., 3000., 6000.)], 0, True),
      ('maskedBack', [backAt(z) for z in (120., 100., 140.)], 1, True))
  for label, variants, source, columnsToo in sweeps:
    scenes = [sc for sc, _b, _m in variants]
    _s, bounds, maxI = variants[0]
    worst['traceSweep'] = max(worst['traceSweep'], compareSweepWithPlain(
        label, scenes, bounds, maxI, N_SMALL, columnsToo, source=source))
    compareSweepWithSingles(label, scenes, bounds, maxI, N_SMALL, seed=41,
                            source=source)
  return worst


def spectroStepPhase(histPrecision):
  '''The fused step on the spectrometer at full width (`timeBenchStep`):
  every ray meets the grating and the detector, the line lies where the
  grating equation puts it, nothing is lost on the way.'''
  t = timeBenchStep(histPrecision, SPECTRO_MAX_INTERSECTIONS,
                    scene=benchmarks.buildSpectrometerScene(),
                    histBounds=SPECTRO_BOUNDS)
  step, hist = t['step'], t['hist']
  nRays = N_MAIN * TIMED_STEPS
  segsPerStep = t['segments'] / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(step.tables, segsPerStep, N_MAIN, outBytes,
                   gratingPasses=N_MAIN)
  centroid = lineCentroidMm(hist['counts'])
  expected = example4.expectedPosition(532.)
  meanPower = float(hist['power'].double().sum()
                    / hist['counts'].double().sum())
  emit(dict(phase='spectrometer-step', histPrecision=histPrecision,
            rays=N_MAIN, maxIntersections=SPECTRO_MAX_INTERSECTIONS,
            bins=BINS, steps=TIMED_STEPS, stepMs=t['stepMs'],
            kernelMs=t['kernelMs'],
            raySegmentsPerSec=segsPerStep / (t['stepMs'] * 1e-3),
            segmentsPerRay=segsPerStep / N_MAIN, hits=t['hits'],
            hitOverflow=t['overflow'], launches=t['launches'],
            boundMs=max(bounds[:2]), lineCentroidMm=centroid,
            expectedMm=expected, meanDetectedPower=meanPower,
            peakBinShare=float(hist['counts'].max() / hist['counts'].sum()),
            **bounds[2]))
  # every ray: source -> grating -> detector (one pass through the grating)
  if t['hits'] != nRays or t['segments'] != 2 * nRays or t['overflow']:
    raise AssertionError(f'spectrometer: {t["hits"]} hits, {t["segments"]} '
                         f'segments for {nRays} rays')
  if float(hist['counts'].double().sum()) != t['hits']:
    raise AssertionError('spectrometer histogram counts != hits')
  if abs(centroid - expected) > BIN_MM or abs(meanPower - 1.) > 1e-6:
    raise AssertionError(f'spectral line at {centroid} mm (expected '
                         f'{expected}), mean power {meanPower}')
  return dict(launches=t['launches'], ms=t['kernelMs'], bounds=bounds)


def evanescentPhase():
  '''At 2000 lines/mm and 650 nm the first order is evanescent at normal
  incidence: the grating absorbs every ray, the detector records nothing.'''
  step, hist, _meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildSpectrometerScene(linesPerMm=2000.,
                                              wavelength=650.),
      raysPerStep=N_MAIN, maxIntersections=SPECTRO_MAX_INTERSECTIONS,
      bins=BINS, histBounds=SPECTRO_BOUNDS)
  hist, counters = step(3, hist)
  power = float(hist['power'].double().sum())
  emit(dict(phase='spectrometer-evanescent', rays=N_MAIN,
            hits=int(counters['hits']), segments=int(counters['segments']),
            detectedPower=power))
  if int(counters['hits']) != 0 or power != 0. \
      or int(counters['segments']) != N_MAIN:
    raise AssertionError('the evanescent order reached the detector')


def spectroRunPhases(tmp):
  '''`runSimulation` on examples/4's scene, one source each at 450, 550 and
  650 nm: raw recording, each line from the stored hits within LINE_TOL_MM
  of the grating equation; then histogram-first recording. Returns the raw
  kernel's launches, its time on one source's 1 << 20-ray step and its
  bound.'''
  scene = example4.buildScene(path=os.path.join(tmp, 'example4'),
                              wavelengths=SPECTRO_WAVELENGTHS)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = SPECTRO_RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  nSrc = len(SPECTRO_WAVELENGTHS)
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  raw = RawFolder(runPath)
  positions, rows = {}, 0
  for wl in SPECTRO_WAVELENGTHS:
    pts = raw.loadHits('Detector', source=f'Source{int(wl)}').points()
    rows += len(pts)
    positions[wl] = float(np.hypot(pts[:, 0], pts[:, 1]).mean())
  traced = last['totalTracedRays']
  perIterationMs = later / (SPECTRO_RAW_ITERATIONS - 1) * 1e3
  emit(dict(phase='spectrometer-run-raw', sources=nSrc,
            raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, launches=launches,
            linePositionsMm={str(int(k)): v for k, v in positions.items()},
            expectedMm={str(int(k)): example4.expectedPosition(k)
                        for k in SPECTRO_WAVELENGTHS},
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup, perIterationMs=perIterationMs,
            raysPerSecStoredLoop=nSrc * N_RAW_ITERATION
            / (perIterationMs * 1e-3),
            raysPerSecStoredWithFlush=traced / (first + later + cleanup)))
  if launches != onlyLaunches(traceRaw=nSrc * SPECTRO_RAW_ITERATIONS):
    raise AssertionError(f'spectrometer raw run launched {launches}')
  if traced != nSrc * N_RAW_ITERATION * SPECTRO_RAW_ITERATIONS \
      or rows != last['totalRecordedHits'] or rows != traced:
    raise AssertionError(f'{rows} rows stored, {last}')
  for wl, pos in positions.items():
    if abs(pos - example4.expectedPosition(wl)) > LINE_TOL_MM:
      raise AssertionError(f'{wl} nm line at {pos} mm, expected '
                           f'{example4.expectedPosition(wl)}')
  if not positions[450.] < positions[550.] < positions[650.]:
    raise AssertionError(f'line positions not increasing: {positions}')
  rawLaunches = launches['traceRaw']

  # the raw kernel alone on one source's step, and its bound
  sceneNp, info = scene.compile(device=None)
  sceneNp['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  src = scene.lightSources()[1]
  step = cuda_trace.makeRawStep(
      sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
      raysPerStep=N_RAW_ITERATION, maxIntersections=SPECTRO_MAX_INTERSECTIONS,
      maxRayLength=settings.maxRayLength(), distTol=1e-4,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound())
  seeds = iter(range(10 ** 6))
  _records, counters = step(next(seeds))
  kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
      step.tables, N_RAW_ITERATION, SPECTRO_MAX_INTERSECTIONS,
      settings.maxRayLength(), 1e-4, hitSlots=step.hitSlots,
      seed=next(seeds), strataTile=step.strataTile), TIMED_STEPS)
  rawBounds = boundMs(step.tables, int(counters['segments']), N_RAW_ITERATION,
                      9 * step.hitSlots * N_RAW_ITERATION * 4,
                      gratingPasses=N_RAW_ITERATION)

  # histogram-first recording
  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = SPECTRO_HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS, histBounds=SPECTRO_BOUNDS)
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snaps = results_store.loadHistogramSnapshots(runPath)
  centroids, counts = {}, 0.
  for wl in SPECTRO_WAVELENGTHS:
    snap = snaps[f'Source{int(wl)}']['Detector']
    c = torch.as_tensor(snap['counts']).reshape((1,) + BINS)
    counts += float(c.double().sum())
    centroids[wl] = lineCentroidMm(c)
  sampleSteps = sum(1 for p in range(1, len(progress) + 1) if p % 8 == 1)
  emit(dict(phase='spectrometer-run-histogram', sources=nSrc,
            raysPerIteration=N_MAIN, iterations=last['totalIterations'],
            passes=len(progress), tracedRays=last['totalTracedRays'],
            histCounts=counts, recordedHits=last['totalRecordedHits'],
            lineCentroidsMm={str(int(k)): v for k, v in centroids.items()},
            launches=launches, setupAndFirstPassS=first,
            laterPassesS=later, cleanupFlushS=cleanup,
            raysPerSec=last['totalTracedRays'] / (first + later + cleanup)))
  if last['totalTracedRays'] != nSrc * SPECTRO_HIST_ITERATIONS * N_MAIN \
      or counts != last['totalRecordedHits'] \
      or counts != last['totalTracedRays']:
    raise AssertionError(f'spectrometer histogram run: counts {counts}, '
                         f'{last}')
  for wl, pos in centroids.items():
    if abs(pos - example4.expectedPosition(wl)) > BIN_MM:
      raise AssertionError(f'{wl} nm histogram line at {pos} mm')
  if launches != onlyLaunches(traceHistogram=nSrc * SPECTRO_HIST_ITERATIONS,
                              traceRaw=nSrc * sampleSteps):
    raise AssertionError(f'spectrometer histogram run launched {launches}')
  return dict(launches=rawLaunches, ms=kernelMs, bounds=rawBounds)


def spectroSweepPhase():
  '''A wavelength calibration of the spectrometer through `evaluateBatched`
  (geometry mode: the source's wavelength is the swept parameter), three
  calls with shifted wavelengths: one sweep-kernel launch per call, each
  line's centroid within one bin of the grating equation; the sweep kernel
  alone by CUDA events and against its plain version at this shape.'''
  V, n = SPECTRO_SWEEP
  scene = benchmarks.buildSpectrometerScene()
  sweeper = parameter_sweeper.ParameterSweeper(
      lambda sc: dict(wl=(sc.lightSources()[0], 'Wavelength')),
      scene=scene, device=DEV)
  wavelengths = np.linspace(400., 700., V)
  worstMm, walls = 0., []
  resetLaunchCounts()
  for k in range(3):
    wls = wavelengths + 0.5 * k
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    centroids = sweeper.evaluateBatched(
        [dict(wl=float(w)) for w in wls],
        lambda power, counts: lineCentroidMm(torch.as_tensor(counts)),
        raysPerScene=n, maxIntersections=SPECTRO_MAX_INTERSECTIONS,
        bins=BINS, histBounds=SPECTRO_BOUNDS, seed=k)
    walls.append(time.perf_counter() - t0)
    expected = np.array([example4.expectedPosition(w) for w in wls])
    worstMm = max(worstMm, float(np.abs(centroids - expected).max()))
  launches = dict(cuda_trace.launchCounts)
  if sweeper.lastBatchedRoute != 'sweep' \
      or launches != onlyLaunches(traceSweep=3):
    raise AssertionError(f'{launches} launches for 3 evaluateBatched calls '
                         f'(route {sweeper.lastBatchedRoute})')
  if worstMm > BIN_MM:
    raise AssertionError(f'a centroid lies {worstMm} mm off the grating '
                         f'equation')

  # the kernel alone, by events, and against its plain version
  scenes = [benchmarks.buildSpectrometerScene(wavelength=float(w))
            for w in wavelengths]
  host = [sc.compile(device=None) for sc in scenes]
  histSpec = fused.makeHistogramSpec(*host[0], bounds=SPECTRO_BOUNDS,
                                     bins=BINS)
  specs = [sc.lightSources()[0].samplerSpec() for sc in scenes]
  tables = cuda_trace.buildSweepTables([h for h, _i in host], histSpec, specs,
                                       device=DEV)
  shape = (V, 1) + BINS
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  tile = cuda_trace.DEFAULT_STRATA_TILE
  kw = dict(maxIntersections=SPECTRO_MAX_INTERSECTIONS, maxRayLength=1000.,
            distTol=1e-4, powerTol=1e-6, hitSlots=1)
  seeds = iter(range(7000, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds),
                                   strataTile=tile, **kw)
  segments = int(counters[:, 0].sum())
  launch = dict(cuda_trace.lastLaunch['traceSweep'])
  sweepMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), strataTile=tile, **kw), 5)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(10)
  us = torch.rand((2, n), generator=gen, device=DEV, dtype=torch.float32)
  err, plainMs = holdSweepAgainstPlain(
      f'spectrometer-{V}x{n}', 'b', tables, n,
      dict(uniforms=us, strataTile=tile),
      dict(uniforms=us, strata=cuda_trace.tileStrata(n, tile),
           strataTile=tile), kw)
  steady = min(walls[1:])
  bounds = boundMs(tables, segments, V * n, 2 * 2 * hist['power'].numel() * 4,
                   gratingPasses=V * n)
  emit(dict(phase='spectrometer-sweep', variants=V, raysPerVariant=n,
            coldS=walls[0], steadyS=steady, calls=walls,
            raysPerSec=V * n / steady, sweepKernelMs=sweepMs,
            hostShare=1. - sweepMs * 1e-3 / steady,
            launchesPerCall=launches['traceSweep'] / 3,
            segmentsPerCall=segments,
            raySegmentsPerSecKernel=segments / (sweepMs * 1e-3),
            worstCentroidOffMm=worstMm, binMm=BIN_MM, plainMs=plainMs,
            maxAbsErrPower=err, variantGroup=launch['variantGroup'],
            sharedDraws=launch['sharedDraws'], boundMs=max(bounds[:2]),
            **bounds[2]))
  return dict(launches=launches['traceSweep'], ms=sweepMs, err=err,
              bounds=bounds, launch=launch)


def sensorStatistics(records, n):
  '''What the sensor scene's records say of the sampler (each ray's one
  record: its emission direction and, to 0.01 tan(theta) mm, its emission
  point): the share of rays per face (x < 0: the rectangle, x > 0: the
  annulus) and normalised histograms of theta, phi and of x and y.'''
  m = records['recordHit'][0]
  p, d = records['point'][0][m], records['direction'][0][m]
  theta = torch.acos(torch.clamp(d[:, 2], -1., 1.))
  phi = torch.atan2(d[:, 1], d[:, 0])
  rows = int(m.sum())

  def hist(x, lo, hi, bins):
    return (torch.histc(x.double(), bins, lo, hi) / rows).cpu().numpy()

  return rows, dict(
      face=np.array([float((p[:, 0] < 0).sum()) / rows,
                     float((p[:, 0] > 0).sum()) / rows]),
      theta=hist(theta, 0., np.pi / 2, 32), phi=hist(phi, -np.pi, np.pi, 32),
      x=hist(p[:, 0], -45., 45., 90), y=hist(p[:, 1], -10., 10., 40))


def surfaceSeedPhase(n):
  '''Mode (a) of the surface-source sampler by distribution: the raw
  kernel's own Philox draws (five uniforms a ray, two Philox calls) on the
  sensor scene against the same kernel fed ray columns from the source's
  `deviceColumnsGenerator` (torch's generator): face fractions, theta,
  phi and position marginals within L1 MARGINAL_L1, rows within 5e-3.'''
  scene, bounds, maxI = helpers.buildSurfaceSensorScene(helpers.torchNs())
  sceneNp, histSpec, tables = buildTables(scene, bounds, BINS, maxI)
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=1)
  ringK, cK = cuda_trace.traceRaw(tables, n, seed=20261017, **kw)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(77)
  cols = scene.lightSources()[0].deviceColumnsGenerator(device=DEV)(gen, n)
  colsT = torch.stack([cols[k] for k in ('ox', 'oy', 'oz', 'dx', 'dy', 'dz',
                                         'pw', 'wl')]).contiguous()
  ringC, cC = cuda_trace.traceRaw(tables, n, columns=colsT, **kw)
  rowsK, statK = sensorStatistics(cuda_trace.recordsFromRing(ringK), n)
  rowsC, statC = sensorStatistics(cuda_trace.recordsFromRing(ringC), n)
  faces = scene.lightSources()[0].samplerSpec()['faces']
  areaShare = np.array([f['cumHi'] - f['cumLo'] for f in faces])
  dists = {k: float(np.abs(statK[k] - statC[k]).sum()) for k in statK}
  emit(dict(phase='surface-seed-mode', scene='surfaceSensor', rays=n,
            rowsKernel=rowsK, rowsColumns=rowsC, counters=cK.tolist(),
            faceShareKernel=statK['face'].tolist(),
            faceShareColumns=statC['face'].tolist(),
            areaShare=areaShare.tolist(), marginalL1=dists))
  if max(dists.values()) > MARGINAL_L1 \
      or abs(rowsK - rowsC) > 5e-3 * rowsC or rowsK < 0.99 * n:
    raise AssertionError(f'surface sampler mode (a): marginals {dists}, '
                         f'rows {rowsK} / {rowsC}')


def surfaceKernelChecks():
  '''K1, K2 and K4 against their plain versions on the surface-source
  scenes, modes (b) (five uniforms a ray) and (c): the reference's
  throughput scene at full width and the four-kind emitter at N_SMALL.
  Returns the worst error per kernel.'''
  ns = helpers.torchNs()
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0.)
  for name, n in (('surfaceBench', N_MAIN), ('surfaceEmitter', N_SMALL)):
    scene, bounds, maxI = helpers.SURFACE_SCENES[name](ns)
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        name, scene, bounds, maxI, n, BINS))
    w = compareRingsWithPlain(name, scene, bounds, maxI, n, BINS)
    for k in ('traceRaw', 'traceBins'):
      worst[k] = max(worst[k], w[k])
  return worst


def manySurfacesPhase():
  '''ROADMAP C.2 on the card: K1, K2 and K4 against their plain versions
  on a scene of 72 surfaces and 22 elements (past the 64 surfaces and 16
  elements the kernels held before); then K1 on the same inputs with its
  table padded past the 48 KB of shared memory a launch gets by default
  (the launcher raises the limit for such a table): the same counters and
  histograms bit for bit. Returns the worst error per kernel.'''
  scene, bounds, maxI = helpers.buildManySurfacesScene(helpers.torchNs())
  worst = dict(traceHistogram=compareWithPlain(
      'many-surfaces', scene, bounds, maxI, N_SMALL, BINS))
  worst.update(compareRingsWithPlain('many-surfaces', scene, bounds, maxI,
                                     N_SMALL, BINS))
  sceneNp, histSpec, tables = buildTables(scene, bounds, BINS, maxI)
  us, strataTile, _cols, _scatterU = samplerInputs(tables, N_SMALL, 99, maxI)
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=1, uniforms=us, strataTile=strataTile)
  padFloats = 100 * 1024 // 4
  padded = dict(tables, table=torch.cat([
      tables['table'], torch.zeros(padFloats, device=DEV)]))
  out = []
  for t in (tables, padded):
    hist = fused.initHistograms(histSpec, device=DEV)
    out.append((cuda_trace.traceHistogram(t, hist, N_SMALL, **kw), hist))
  torch.cuda.synchronize()
  (c0, h0), (c1, h1) = out
  emit(dict(phase='large-table', surfaces=tables['nSurf'],
            elements=tables['nElem'], tableBytes=tables['table'].numel() * 4,
            paddedBytes=padded['table'].numel() * 4, counters=c1.tolist()))
  if c0.tolist() != c1.tolist() or not torch.equal(h0['counts'], h1['counts']):
    raise AssertionError('a table past 48 KB gave other counters or counts')
  return worst


def fullBinsPhase():
  '''ROADMAP C.1 on the card: one K1 step at full width onto spectrometer
  histograms whose every bin holds 2**24. The step bins into a zeroed delta
  and adds it once, so each bin grows by the step's own delta, rounded once
  (the same seed into fresh histograms gives that delta), and the total by
  the step's hits to within that rounding.'''
  full = float(2 ** 24)
  step, fresh, _meta = benchmarks.makeBenchStep(
      scene=benchmarks.buildSpectrometerScene(), raysPerStep=N_MAIN,
      maxIntersections=SPECTRO_MAX_INTERSECTIONS, bins=BINS,
      histBounds=SPECTRO_BOUNDS)
  fresh, c0 = step(11, fresh)
  hist = {k: torch.full_like(v, full) for k, v in fresh.items()}
  hist, c = step(11, hist)
  torch.cuda.synchronize()
  hits = int(c['hits'])
  want = (torch.full_like(fresh['counts'], full) + fresh['counts'])
  grown = float((hist['counts'].double() - full).sum())
  touched = int((fresh['counts'] > 0).sum())
  emit(dict(phase='full-bins', rays=N_MAIN, hits=hits,
            countsGrown=grown, binsTouched=touched,
            powerGrown=float((hist['power'].double() - full).sum()),
            freshPower=float(fresh['power'].double().sum())))
  if int(c0['hits']) != hits or not torch.equal(hist['counts'], want) \
      or abs(grown - hits) > touched or grown < 0.99 * hits:
    raise AssertionError(f'bins at 2**24 grew by {grown} for {hits} hits '
                         f'({touched} bins touched)')


def surfaceStepPhase(histPrecision):
  '''The fused step on the reference's surface-source scene at full width
  (`timeBenchStep`): the detected share and the mean detected power within
  3 sigma of the JAX package's values on this scene.'''
  scene = benchmarks.buildSurfaceSourceScene()
  t = timeBenchStep(histPrecision, SURFACE_MAX_INTERSECTIONS, scene=scene,
                    histBounds=SURFACE_BOUNDS)
  step, hist = t['step'], t['hist']
  nRays = N_MAIN * TIMED_STEPS
  segsPerStep = t['segments'] / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(step.tables, segsPerStep, N_MAIN, outBytes)
  share = t['hits'] / nRays
  meanPower = float(hist['power'].double().sum()
                    / hist['counts'].double().sum())
  emit(dict(phase='surface-step', histPrecision=histPrecision, rays=N_MAIN,
            maxIntersections=SURFACE_MAX_INTERSECTIONS, bins=BINS,
            steps=TIMED_STEPS, stepMs=t['stepMs'], kernelMs=t['kernelMs'],
            raySegmentsPerSec=segsPerStep / (t['stepMs'] * 1e-3),
            segmentsPerRay=segsPerStep / N_MAIN, hits=t['hits'],
            hitOverflow=t['overflow'], launches=t['launches'],
            boundMs=max(bounds[:2]), detectedShare=share,
            meanDetectedPower=meanPower, referenceShare=REF_SURFACE_SHARE,
            referenceMeanPower=REF_SURFACE_POWER, **bounds[2]))
  checkSurfacePhysics('surface step', share, meanPower, nRays)
  if float(hist['counts'].double().sum()) != t['hits'] or t['overflow']:
    raise AssertionError('surface step: histogram counts != hits, or the '
                         'ring overflowed')
  return dict(launches=t['launches'], ms=t['kernelMs'], bounds=bounds)


def checkSurfacePhysics(label, share, meanPower, nRays):
  '''The detected share and mean detected power of the surface-source
  scene against the JAX package's (65,536 rays) within 3 sigma of the two
  samples: the power is 0.98 (met the mirror) or 1 (came straight).'''
  p, n0 = REF_SURFACE_SHARE, REF_SURFACE_RAYS
  sigma = np.sqrt(p * (1 - p) / n0 + p * (1 - p) / nRays)
  q = (1. - REF_SURFACE_POWER) / 0.02
  sigmaP = 0.02 * np.sqrt(q * (1 - q) / (p * n0) + q * (1 - q)
                          / (share * nRays))
  if abs(share - p) > 3 * sigma or abs(meanPower - REF_SURFACE_POWER) \
      > 3 * sigmaP:
    raise AssertionError(f'{label}: detected share {share}, mean power '
                         f'{meanPower}; the JAX package: {p}, '
                         f'{REF_SURFACE_POWER}')


def surfaceRunPhases(tmp):
  '''`runSimulation` on the surface-source scene: raw recording (the raw
  kernel, rows read back == the run's hits) and histogram-first recording
  (the histogram kernel, snapshot counts == the run's hits), the physics
  against the JAX package's; then the raw kernel alone on one raw
  iteration's step, and its bound.'''
  scene = benchmarks.buildSurfaceSourceScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Detector')
  rows = len(hits['points'])
  traced = last['totalTracedRays']
  meanPower = float(hits['powers'].astype(np.float64).mean())
  perIterationMs = later / (RAW_ITERATIONS - 1) * 1e3
  emit(dict(phase='surface-run-raw', raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, detectedShare=rows / traced,
            meanPower=meanPower, launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup, perIterationMs=perIterationMs,
            raysPerSecStoredLoop=N_RAW_ITERATION / (perIterationMs * 1e-3),
            raysPerSecStoredWithFlush=traced / (first + later + cleanup)))
  if launches != onlyLaunches(traceRaw=RAW_ITERATIONS):
    raise AssertionError(f'surface raw run launched {launches}')
  if traced != N_RAW_ITERATION * RAW_ITERATIONS \
      or rows != last['totalRecordedHits']:
    raise AssertionError(f'surface raw run: {rows} rows stored, {last}')
  if not np.isfinite(hits['points']).all() \
      or np.abs(hits['points'][:, 0] + 100.).max() > 1e-3:
    raise AssertionError('surface raw run: points off the detector plane')
  checkSurfacePhysics('surface raw run', rows / traced, meanPower, traced)

  # the raw kernel alone on one iteration's step, and its bound
  sceneNp, info = scene.compile(device=None)
  sceneNp['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  src = scene.lightSources()[0]
  step = cuda_trace.makeRawStep(
      sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
      raysPerStep=N_RAW_ITERATION, maxIntersections=SURFACE_MAX_INTERSECTIONS,
      maxRayLength=settings.maxRayLength(), distTol=1e-4,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound())
  seeds = iter(range(10 ** 6))
  _records, counters = step(next(seeds))
  kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
      step.tables, N_RAW_ITERATION, SURFACE_MAX_INTERSECTIONS,
      settings.maxRayLength(), 1e-4, hitSlots=step.hitSlots,
      seed=next(seeds)), TIMED_STEPS)
  rawBounds = boundMs(step.tables, int(counters['segments']),
                      N_RAW_ITERATION,
                      9 * step.hitSlots * N_RAW_ITERATION * 4)

  # histogram-first recording
  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = SURFACE_HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS, histBounds=SURFACE_BOUNDS)
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Source']['Detector']
  counts = float(snap['counts'].astype(np.float64).sum())
  power = float(snap['power'].astype(np.float64).sum())
  sampleSteps = sum(1 for p in range(1, len(progress) + 1) if p % 8 == 1)
  emit(dict(phase='surface-run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], passes=len(progress),
            tracedRays=last['totalTracedRays'], histCounts=counts,
            recordedHits=last['totalRecordedHits'],
            detectedShare=counts / last['totalTracedRays'],
            meanDetectedPower=power / counts, launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=last['totalTracedRays'] / (first + later + cleanup)))
  if last['totalTracedRays'] != SURFACE_HIST_ITERATIONS * N_MAIN \
      or counts != last['totalRecordedHits']:
    raise AssertionError(f'surface histogram run: counts {counts}, {last}')
  checkSurfacePhysics('surface histogram run',
                      counts / last['totalTracedRays'], power / counts,
                      last['totalTracedRays'])
  if launches != onlyLaunches(traceHistogram=SURFACE_HIST_ITERATIONS,
                              traceRaw=sampleSteps):
    raise AssertionError(f'surface histogram run launched {launches}')
  return dict(rawLaunches=RAW_ITERATIONS,
              raw=dict(ms=kernelMs, bounds=rawBounds))


def scatterScenes():
  '''The three scatter scenes of phase 8, each built and compiled once
  (the host's sympy and fits: the compile is cached per scene object, the
  scatter tables per density).'''
  scenes = {}
  for name, builder in SCATTER_SCENES:
    t0 = time.perf_counter()
    scene = getattr(benchmarks, builder)()
    sceneNp, _info = compiled(scene)
    t1 = time.perf_counter()
    consts = cuda_trace.scatterConstantsOf(sceneNp)
    emit(dict(phase='scatter-compile', scene=name, compileS=t1 - t0,
              constantsS=time.perf_counter() - t1,
              entries=[dict(element=c[0], kind=c[1], phi=c[2][0],
                            theta=c[3][0], thetaParts=len(c[3][1]),
                            phiEvents=len(c[4]), thetaEvents=len(c[5]))
                       for c in consts]))
    scenes[name] = scene
  return scenes


def scatterKernelChecks(scenes):
  '''Phase 8's kernel checks: K1, K2 and K4 against their plain versions
  on each scatter scene at full width, in the uniform mode (the same rows
  to both); the scatter kinds no reference scene reaches (a lens's entry
  and exit lobes, a mirror's MODIFY); K3 on the diffuser's height sweep
  against its plain version on the same uniforms and, in seed mode,
  against one K1 launch per variant. Returns the worst error per
  kernel.'''
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0., traceSweep=0.)
  checks = [(f'scatter-{name}', scene, SCATTER_BOUNDS,
             SCATTER_MAX_INTERSECTIONS, N_MAIN)
            for name, scene in scenes.items()]
  checks.append(('scatter-kinds',)
                + helpers.buildScatterKindsScene(helpers.torchNs())
                + (N_SMALL,))
  for label, scene, bounds, maxI, n in checks:
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        label, scene, bounds, maxI, n, BINS))
    w = compareRingsWithPlain(label, scene, bounds, maxI, n, BINS)
    for k in ('traceRaw', 'traceBins'):
      worst[k] = max(worst[k], w[k])
  variants = [benchmarks.buildDiffuseScatterScene(diffuserZ=z)
              for z in SCATTER_HEIGHTS]
  worst['traceSweep'] = compareSweepWithPlain(
      'scatter-height', variants, SCATTER_BOUNDS, SCATTER_MAX_INTERSECTIONS,
      SCATTER_SWEEP_RAYS, columnsToo=False)
  compareSweepWithSingles('scatter-height', variants, SCATTER_BOUNDS,
                          SCATTER_MAX_INTERSECTIONS, SCATTER_SWEEP_RAYS,
                          seed=41)
  return worst


def checkScatterStats(label, name, stats, nRays):
  '''`helpers.scatterStats` of a run of `nRays` against the JAX
  package's on the same scene (REF_SCATTER, 65,536 rays), by
  `helpers.scatterStatsGate`: the share and the mean r^2 within 3 sigma of
  the two samples, the mean power within 1e-6.'''
  ref = REF_SCATTER[name]
  ok, sigmas = helpers.scatterStatsGate(stats, ref, nRays, REF_SCATTER_RAYS)
  emit(dict(phase='scatter-statistics', run=label, scene=name, rays=nRays,
            share=stats['share'], refShare=ref['share'],
            meanPower=stats['power'], refMeanPower=ref['power'],
            r2=stats['r2'], refR2=ref['r2'], **sigmas))
  if not ok:
    raise AssertionError(f'{label} on {name}: {stats} against the JAX '
                         f'package\'s {ref}')


def scatterStepPhase(name, scene, histPrecision):
  '''The fused step (`benchmarks.makeBenchStep`, seed mode: the kernel's
  own Philox draws) on a scatter scene at full width: timed
  (`timeBenchStep`), its bound, and its statistics against the JAX
  package's.'''
  t = timeBenchStep(histPrecision, SCATTER_MAX_INTERSECTIONS, scene=scene,
                    histBounds=SCATTER_BOUNDS)
  step, hist = t['step'], t['hist']
  nRays = N_MAIN * TIMED_STEPS
  segsPerStep = t['segments'] / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  # a ray meets the diffuser at most once, on its first segment, and its
  # last segment ends it: its scatter passes are its segments less one
  bounds = boundMs(step.tables, segsPerStep, N_MAIN, outBytes,
                   scatterPasses=segsPerStep - N_MAIN)
  emit(dict(phase='scatter-step', scene=name, histPrecision=histPrecision,
            rays=N_MAIN, steps=TIMED_STEPS, stepMs=t['stepMs'],
            kernelMs=t['kernelMs'], segmentsPerRay=segsPerStep / N_MAIN,
            hits=t['hits'], hitOverflow=t['overflow'],
            launches=t['launches'], boundMs=max(bounds[:2]), **bounds[2]))
  if not torch.isfinite(hist['power']).all() \
      or float(hist['counts'].double().sum()) != t['hits'] or t['overflow']:
    raise AssertionError(f'scatter step on {name}: histogram counts != '
                         f'hits, a non-finite bin, or an overflow')
  checkScatterStats(f'step-{histPrecision}', name,
                    helpers.scatterStats(hist, t['hits'], nRays), nRays)
  return dict(launches=t['launches'], ms=t['kernelMs'], bounds=bounds)


def scatterRunPhases(tmp):
  '''`runSimulation` on the diffuse scatter scene: raw recording (the raw
  kernel; rows read back == the run's hits, on the detector plane, the
  share within the histogram bounds against the JAX package's) and
  histogram-first recording (the histogram kernel; snapshot counts == the
  run's hits, the statistics against the JAX package's); then the raw
  kernel alone on one raw iteration's step, and its bound.'''
  scene = benchmarks.buildDiffuseScatterScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = SCATTER_RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Det')
  pts = hits['points']
  traced = last['totalTracedRays']
  x0, x1, y0, y1 = SCATTER_BOUNDS
  inside = ((pts[:, 0] >= x0) & (pts[:, 0] < x1) & (pts[:, 1] >= y0)
            & (pts[:, 1] < y1))
  share = float(inside.sum()) / traced
  ref = REF_SCATTER['diffuse']
  sigma = max(np.sqrt(ref['share'] * (1 - ref['share'])
                      * (1 / REF_SCATTER_RAYS + 1 / traced)),
              1 / REF_SCATTER_RAYS)
  emit(dict(phase='scatter-run-raw', raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=len(pts), shareInBounds=share,
            refShare=ref['share'], launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup))
  if launches != onlyLaunches(traceRaw=SCATTER_RAW_ITERATIONS):
    raise AssertionError(f'scatter raw run launched {launches}')
  if traced != N_RAW_ITERATION * SCATTER_RAW_ITERATIONS \
      or len(pts) != last['totalRecordedHits']:
    raise AssertionError(f'scatter raw run: {len(pts)} rows stored, {last}')
  if not np.isfinite(pts).all() or np.abs(pts[:, 2]).max() > 1e-3 \
      or abs(share - ref['share']) > 3 * sigma:
    raise AssertionError(f'scatter raw run: points off the detector plane, '
                         f'or a share of {share} in the bounds against the '
                         f'JAX package\'s {ref["share"]}')

  # the raw kernel alone on one iteration's step, and its bound
  sceneNp, info = scene.compile(device=None)
  sceneNp['powerTol'] = 1e-6
  histSpec = fused.makeHistogramSpec(sceneNp, info)
  src = scene.lightSources()[0]
  step = cuda_trace.makeRawStep(
      sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
      raysPerStep=N_RAW_ITERATION, maxIntersections=SCATTER_MAX_INTERSECTIONS,
      maxRayLength=settings.maxRayLength(), distTol=1e-4,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound())
  seeds = iter(range(10 ** 6))
  _records, counters = step(next(seeds))
  kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
      step.tables, N_RAW_ITERATION, SCATTER_MAX_INTERSECTIONS,
      settings.maxRayLength(), 1e-4, hitSlots=step.hitSlots,
      seed=next(seeds), strataTile=step.strataTile), TIMED_STEPS)
  segments = int(counters['segments'])
  rawBounds = boundMs(step.tables, segments, N_RAW_ITERATION,
                      9 * step.hitSlots * N_RAW_ITERATION * 4,
                      scatterPasses=segments - N_RAW_ITERATION)

  # histogram-first recording
  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = SCATTER_HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS, histBounds=SCATTER_BOUNDS)
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']
  counts = float(snap['counts'].astype(np.float64).sum())
  sampleSteps = sum(1 for p in range(1, len(progress) + 1) if p % 8 == 1)
  traced = last['totalTracedRays']
  emit(dict(phase='scatter-run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], passes=len(progress),
            tracedRays=traced, histCounts=counts,
            recordedHits=last['totalRecordedHits'], launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=traced / (first + later + cleanup)))
  if traced != SCATTER_HIST_ITERATIONS * N_MAIN \
      or counts != last['totalRecordedHits']:
    raise AssertionError(f'scatter histogram run: counts {counts}, {last}')
  if launches != onlyLaunches(traceHistogram=SCATTER_HIST_ITERATIONS,
                              traceRaw=sampleSteps):
    raise AssertionError(f'scatter histogram run launched {launches}')
  hist = {k: torch.as_tensor(snap[k].astype(np.float32)).reshape(
      (1,) + BINS) for k in ('power', 'counts')}
  checkScatterStats('run-histogram', 'diffuse',
                    helpers.scatterStats(hist, counts, traced), traced)
  return dict(launches=SCATTER_RAW_ITERATIONS, ms=kernelMs, bounds=rawBounds)


def scatterSweepPhase():
  '''`ParameterSweeper.evaluateBatched` on the diffuser's height (11
  heights x 1 << 20 rays): one launch of the sweep kernel per call; timed
  by CUDA events alone, with its bound.'''
  from optics_design_workbench_tpu_torch.jupyter_utils import (
      Parameter, ParameterSweeper)
  holder = dict(z=50., scene=benchmarks.buildDiffuseScatterScene())

  def setZ(z):
    holder['z'] = float(z)
    holder['scene'] = benchmarks.buildDiffuseScatterScene(diffuserZ=z)
    sweeper.scene = holder['scene']

  sweeper = ParameterSweeper(
      lambda sc: dict(z=Parameter(getter=lambda: holder['z'], setter=setZ,
                                  bounds=(40., 60.))),
      scene=holder['scene'], device=DEV)
  values = []

  def metric(power, counts):
    stats = helpers.scatterStats(dict(power=power, counts=counts), 0., 1.)
    values.append(stats['r2'])
    return stats['r2']

  resetLaunchCounts()
  t0 = time.perf_counter()
  sweeper.evaluateBatched([dict(z=z) for z in SCATTER_HEIGHTS], metric,
                          sceneFactory=lambda: holder['scene'],
                          raysPerScene=SCATTER_SWEEP_RAYS,
                          maxIntersections=SCATTER_MAX_INTERSECTIONS,
                          histBounds=SCATTER_BOUNDS, bins=BINS)
  torch.cuda.synchronize()
  wallS = time.perf_counter() - t0
  launches = dict(cuda_trace.launchCounts)
  route = sweeper.lastBatchedRoute
  emit(dict(phase='scatter-sweep', variants=len(SCATTER_HEIGHTS),
            raysPerVariant=SCATTER_SWEEP_RAYS, route=route,
            launches=launches, wallS=wallS, r2ByHeight=values))
  if route != 'sweep' or launches != onlyLaunches(traceSweep=1):
    raise AssertionError(f'scatter sweep: route {route}, launches '
                         f'{launches}')
  if not np.all(np.isfinite(values)) or not values[0] < values[-1]:
    raise AssertionError(f'scatter sweep: r^2 by height {values} does not '
                         f'grow with the height')

  # the sweep kernel alone on these variants, by CUDA events, and its bound
  variants = [benchmarks.buildDiffuseScatterScene(diffuserZ=z)
              for z in SCATTER_HEIGHTS]
  tables, host, histSpec, _specs = sweepTablesFor(variants, SCATTER_BOUNDS)
  V, n = len(variants), SCATTER_SWEEP_RAYS
  shape = (V, tables['nDet']) + SWEEP_BINS
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=SCATTER_MAX_INTERSECTIONS, maxRayLength=1000.,
            distTol=1e-4, powerTol=1e-6,
            hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec,
                                             SCATTER_MAX_INTERSECTIONS),
            strataTile=cuda_trace.DEFAULT_STRATA_TILE)
  seeds = iter(range(77, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds), **kw)
  segments = int(counters[:, 0].sum())
  kernelMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), TIMED_STEPS)
  bounds = boundMs(tables, segments, V * n, 2 * hist['power'].numel() * 4 * 2,
                   scatterPasses=segments - V * n)
  emit(dict(phase='scatter-sweep-kernel', variants=V, raysPerVariant=n,
            kernelMs=kernelMs, boundMs=max(bounds[:2]), **bounds[2]))
  return dict(launches=launches['traceSweep'], ms=kernelMs, bounds=bounds)



def registerCounts(log):
  '''ptxas's registers and spill bytes per instance of the kernel template,
  from the build log: {(output mode, sweep, B4, surface sampler, scatter,
  GEOM, TRI, STAB, GROUPED): (registers, spill store bytes)}.'''
  import re
  out, current = {}, None
  for line in log.splitlines():
    m = re.search(r'traceKernelILi(\d)E((?:Lb[01]E)+)', line)
    if 'Compiling entry function' in line and m:
      flags = tuple(int(x) for x in re.findall(r'Lb([01])E', m.group(2)))
      current = (int(m.group(1)),) + flags
      continue
    m = re.search(r'(\d+) bytes spill stores', line)
    if m and current is not None:
      out[current] = (out.get(current, (0, 0))[0], int(m.group(1)))
    m = re.search(r'Used (\d+) registers', line)
    if m and current is not None:
      out[current] = (int(m.group(1)), out.get(current, (0, 0))[1])
      current = None
  return out


def registerPhase(log):
  '''The registers of every instance (phase 9's first gate): the instances
  without B2 / B3 keep OLD_REGISTERS, the grouped K3 instances
  GROUPED_REGISTERS; the instances with a table in device memory (TRI,
  STAB) listed apart (`tools/torch_kernel_probe.py table ROOT` prints a
  parent checkout's).'''
  regs = registerCounts(log)
  name = lambda k: ','.join(map(str, k))
  emit(dict(phase='registers', instances=len(regs), byInstance={
      name(k): v for k, v in sorted(regs.items())}, tableInstances={
          name(k): v for k, v in sorted(regs.items()) if k[6]}))
  for grouped, counts in ((0, OLD_REGISTERS), (1, GROUPED_REGISTERS)):
    for key, want in counts.items():
      got = regs.get(key + (0, 0, 0, grouped), (None, None))[0]
      if got != want:
        raise AssertionError(f'instance {key} (grouped {grouped}) uses '
                             f'{got} registers, {want} before B2 / B3')
  return regs


def geomScenes():
  '''The scenes of phase 9, built once.'''
  return {name: getattr(benchmarks, make)()
          for name, (make, _m, _b) in GEOM_SCENES.items()}


def geomKernelChecks(scenes):
  '''Phase 9's kernel checks: K1, K2 and K4 against their plain versions
  on every scene of the other kinds and trims at the fused step's 1 << 22
  rays (modes (b) and (c)) with no ray moved and every ring value equal; the
  30-stage sequential scene (ROADMAP C.2) likewise; K3 on the torus-height
  sweep's 11 heights x 1 << 20 rays against its plain version and, in seed
  mode, against one K1 launch per variant. Returns the worst error per
  kernel.'''
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0., traceSweep=0.)
  for name, scene in scenes.items():
    _make, maxI, bounds = GEOM_SCENES[name]
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        f'geom-{name}', scene, bounds, maxI, N_MAIN, BINS, budget=0))
    w = compareRingsWithPlain(f'geom-{name}', scene, bounds, maxI, N_MAIN,
                              BINS, budget=0, rawAtol=0.)
    for k in ('traceRaw', 'traceBins'):
      worst[k] = max(worst[k], w[k])
  stages, bounds, maxI = helpers.buildManyStagesScene(helpers.torchNs(),
                                                      MANY_STAGES)
  worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
      f'stages-{MANY_STAGES}', stages, bounds, maxI, N_SMALL, BINS,
      budget=0))
  _make, maxI, bounds = GEOM_SCENES['torus']
  variants = [benchmarks.buildTorusMirrorScene(height=z)
              for z in TORUS_HEIGHTS]
  worst['traceSweep'] = compareSweepWithPlain(
      'torus-height', variants, bounds, maxI, TORUS_SWEEP_RAYS,
      columnsToo=True, budget=0)
  compareSweepWithSingles('torus-height', variants, bounds, maxI,
                          TORUS_SWEEP_RAYS, seed=43)
  return worst


def slotCrossings(records, zPlane=50., rMax=18.):
  '''Of a slotted-mirror scene's raw records (`makeRawStep`): the hits on
  the detector beyond the mirror plane whose ray crossed the plane inside
  the mirror's disc (r < rMax: through the slot), and those before it (the
  mirror folded them back).'''
  hit = records['recordHit']
  p, d = records['point'][hit], records['direction'][hit]
  far = p[:, 2] > zPlane
  s = (p[:, 2] - zPlane) / d[:, 2]
  cx, cy = p[:, 0] - s * d[:, 0], p[:, 1] - s * d[:, 1]
  through = far & (cx * cx + cy * cy < rMax * rMax)
  return int(through.sum()), int((~far).sum())


def geomStepPhase(name, scene, histPrecision):
  '''The fused step (`benchmarks.makeBenchStep`, seed mode) on a scene of
  phase 9 at full width: timed (`timeBenchStep`) with its bound; the
  histogram holds every counted hit.'''
  _make, maxI, bounds = GEOM_SCENES[name]
  t = timeBenchStep(histPrecision, maxI, scene=scene, histBounds=bounds)
  step, hist = t['step'], t['hist']
  segsPerStep = t['segments'] / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(step.tables, segsPerStep, N_MAIN, outBytes)
  emit(dict(phase='geom-step', scene=name, histPrecision=histPrecision,
            rays=N_MAIN, steps=TIMED_STEPS, stepMs=t['stepMs'],
            kernelMs=t['kernelMs'], segmentsPerRay=segsPerStep / N_MAIN,
            hits=t['hits'], hitOverflow=t['overflow'],
            launches=t['launches'], boundMs=max(bounds[:2]), **bounds[2]))
  binned = float(hist['counts'].double().sum())
  if not torch.isfinite(hist['power']).all() or t['hits'] <= 0 \
      or binned > t['hits']:
    raise AssertionError(f'geometry step on {name}: {binned} binned of '
                         f'{t["hits"]} hits, or a non-finite bin')
  if name == 'torus':
    nRays = N_MAIN * TIMED_STEPS
    stats = helpers.scatterStats(hist, binned, nRays, bounds=GEOM_SCENES[
        'torus'][2])
    ok, sigmas = helpers.scatterStatsGate(stats, REF_TORUS, nRays,
                                          REF_TORUS_RAYS)
    emit(dict(phase='torus-statistics', run=f'step-{histPrecision}',
              rays=nRays, **stats, ref=REF_TORUS, **sigmas))
    if not ok:
      raise AssertionError(f'torus step: {stats} against the JAX '
                           f"package's {REF_TORUS}")
  return dict(launches=t['launches'], ms=t['kernelMs'], bounds=bounds)


def geomRawIteration(name, scene):
  '''One raw iteration (`makeRawStep`, 1 << 20 rays) on a scene of phase
  9: its records, the raw kernel alone by CUDA events, and its bound; on
  the slotted mirrors, rays must pass the slot and rays must fold back.'''
  _make, maxI, bounds = GEOM_SCENES[name]
  sceneNp, info = compiled(scene)
  sceneNp = dict(sceneNp, powerTol=1e-6)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds, bins=BINS)
  src = scene.lightSources()[0]
  settings = scene.activeSimulationSettings()
  resetLaunchCounts()
  step = cuda_trace.makeRawStep(
      sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
      raysPerStep=N_RAW_ITERATION, maxIntersections=maxI,
      maxRayLength=settings.maxRayLength(), distTol=1e-4,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound())
  records, counters = step(11)
  torch.cuda.synchronize()
  launches = dict(cuda_trace.launchCounts)
  if launches != onlyLaunches(traceRaw=1):
    raise AssertionError(f'raw iteration on {name} launched {launches}')
  seeds = iter(range(100, 10 ** 6))
  kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
      step.tables, N_RAW_ITERATION, maxI, settings.maxRayLength(), 1e-4,
      hitSlots=step.hitSlots, seed=next(seeds)), TIMED_STEPS)
  bounds = boundMs(step.tables, int(counters['segments']), N_RAW_ITERATION,
                   9 * step.hitSlots * N_RAW_ITERATION * 4)
  out = dict(phase='geom-raw-iteration', scene=name, rays=N_RAW_ITERATION,
             hits=int(counters['hits']), segments=int(counters['segments']),
             kernelMs=kernelMs, boundMs=max(bounds[:2]), **bounds[2])
  if int(counters['hits']) <= 0 or not bool(torch.isfinite(
      records['point'][records['recordHit']]).all()):
    raise AssertionError(f'raw iteration on {name}: no hits, or a '
                         f'non-finite point')
  if name in ('bitmapSlot', 'primSlot'):
    through, back = slotCrossings(records)
    out.update(throughSlot=through, foldedBack=back)
    if through <= 0 or back <= 0:
      raise AssertionError(f'{name}: {through} rays through the slot, '
                           f'{back} folded back')
  emit(out)
  return dict(launches=1, ms=kernelMs, bounds=bounds)


def torusRunPhases(tmp):
  '''`runSimulation` on the torus-mirror scene: raw recording (4 x 1 << 20,
  the raw kernel; rows read back == the run's hits) and histogram-first
  recording (8 x 1 << 22, the histogram kernel; snapshot counts == the
  run's hits); the detected share against the JAX package's.'''
  scene = benchmarks.buildTorusMirrorScene(tmpdir=tmp)
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = TORUS_RAW_ITERATIONS
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Det')
  rows = len(hits['points'])
  traced = last['totalTracedRays']
  emit(dict(phase='torus-run-raw', raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, detectedShare=rows / traced, launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup))
  if launches != onlyLaunches(traceRaw=TORUS_RAW_ITERATIONS) \
      or traced != N_RAW_ITERATION * TORUS_RAW_ITERATIONS \
      or rows != last['totalRecordedHits'] or rows <= 0:
    raise AssertionError(f'torus raw run: {rows} rows, {launches}, {last}')
  if not np.isfinite(hits['points']).all() \
      or np.abs(hits['points'][:, 2]).max() > 1e-3:
    raise AssertionError('torus raw run: points off the detector plane')

  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = TORUS_HIST_ITERATIONS
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS,
      histBounds=GEOM_SCENES['torus'][2])
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']
  counts = float(snap['counts'].astype(np.float64).sum())
  nRays = last['totalTracedRays']
  emit(dict(phase='torus-run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], tracedRays=nRays,
            histCounts=counts, recordedHits=last['totalRecordedHits'],
            detectedShare=counts / nRays, launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=nRays / (first + later + cleanup)))
  if nRays != TORUS_HIST_ITERATIONS * N_MAIN \
      or counts != last['totalRecordedHits'] \
      or launches.get('traceHistogram') != TORUS_HIST_ITERATIONS:
    raise AssertionError(f'torus histogram run: counts {counts}, '
                         f'{launches}, {last}')
  p = REF_TORUS['share']
  sigma = np.sqrt(p * (1 - p) / REF_TORUS_RAYS + p * (1 - p) / nRays)
  if abs(counts / nRays - p) > 3 * sigma:
    raise AssertionError(f'torus histogram run: detected share '
                         f'{counts / nRays}, the JAX package {p}')


def torusSweepPhase():
  '''`ParameterSweeper.evaluateBatched` on the torus's height (11 heights
  x 1 << 20 rays): one launch of the sweep kernel per call; the kernel
  alone by CUDA events, with its bound.'''
  from optics_design_workbench_tpu_torch.jupyter_utils import (
      Parameter, ParameterSweeper)
  _make, maxI, tBounds = GEOM_SCENES['torus']
  holder = dict(z=80., scene=benchmarks.buildTorusMirrorScene())

  def setZ(z):
    holder['z'] = float(z)
    holder['scene'] = benchmarks.buildTorusMirrorScene(height=z)
    sweeper.scene = holder['scene']

  sweeper = ParameterSweeper(
      lambda sc: dict(z=Parameter(getter=lambda: holder['z'], setter=setZ,
                                  bounds=(70., 90.))),
      scene=holder['scene'], device=DEV)
  shares = []

  def metric(power, counts):
    shares.append(float(counts.sum()) / TORUS_SWEEP_RAYS)
    return shares[-1]

  resetLaunchCounts()
  t0 = time.perf_counter()
  sweeper.evaluateBatched([dict(z=z) for z in TORUS_HEIGHTS], metric,
                          sceneFactory=lambda: holder['scene'],
                          raysPerScene=TORUS_SWEEP_RAYS,
                          maxIntersections=maxI, histBounds=tBounds,
                          bins=BINS)
  torch.cuda.synchronize()
  wallS = time.perf_counter() - t0
  launches = dict(cuda_trace.launchCounts)
  route = sweeper.lastBatchedRoute
  emit(dict(phase='torus-sweep', variants=len(TORUS_HEIGHTS),
            raysPerVariant=TORUS_SWEEP_RAYS, route=route, launches=launches,
            wallS=wallS, detectedShareByHeight=shares))
  if route != 'sweep' or launches != onlyLaunches(traceSweep=1):
    raise AssertionError(f'torus sweep: route {route}, launches {launches}')
  if not all(0. < x < 1. for x in shares):
    raise AssertionError(f'torus sweep: detected shares {shares}')

  variants = [benchmarks.buildTorusMirrorScene(height=z)
              for z in TORUS_HEIGHTS]
  tables, host, histSpec, _specs = sweepTablesFor(variants, tBounds)
  V, n = len(variants), TORUS_SWEEP_RAYS
  shape = (V, tables['nDet']) + SWEEP_BINS
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6,
            hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec, maxI),
            strataTile=cuda_trace.DEFAULT_STRATA_TILE)
  seeds = iter(range(77, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds), **kw)
  segments = int(counters[:, 0].sum())
  kernelMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), TIMED_STEPS)
  bounds = boundMs(tables, segments, V * n, 2 * hist['power'].numel() * 4 * 2)
  emit(dict(phase='torus-sweep-kernel', variants=V, raysPerVariant=n,
            kernelMs=kernelMs, boundMs=max(bounds[:2]), **bounds[2]))
  return dict(launches=launches['traceSweep'], ms=kernelMs, bounds=bounds)


def geomPhase(tmp, log):
  '''Phase 9, the other surface kinds (B2) and trims (B3) after the
  24-stage cap (C.2): registers, kernel checks, then each scene's path
  through the port's entry points at full width. Returns, per wrapper, its
  launches, ms and bound on the torus scene, ms by scene, and its worst
  error.'''
  t9 = time.perf_counter()
  registerPhase(log)
  scenes = geomScenes()
  worst = geomKernelChecks(scenes)
  out = {}
  for wrapper, precision in (('traceHistogram', 'default'),
                             ('traceBins', 'highest')):
    byScene = {name: geomStepPhase(name, scene, precision)
               for name, scene in scenes.items()}
    out[wrapper] = dict(byScene['torus'], byScene={
        name: r['ms'] for name, r in byScene.items()})
  rawByScene = {name: geomRawIteration(name, scene)
                for name, scene in scenes.items()}
  torusRunPhases(tmp)
  out['traceRaw'] = dict(rawByScene['torus'], launches=TORUS_RAW_ITERATIONS,
                         byScene={n: r['ms'] for n, r in rawByScene.items()})
  out['traceSweep'] = torusSweepPhase()
  for name, entry in out.items():
    entry['err'] = worst[name]
  emit(dict(phase='geom-total', seconds=time.perf_counter() - t9))
  return out

def meshScenes():
  '''The scenes of phase 10, built once: name -> (scene, histogram bounds,
  intersections).'''
  ns = helpers.torchNs()
  out = {f'dish{n}': (benchmarks.buildMeshDishScene(nQ), MESH_BOUNDS,
                      MESH_MAX_INTERSECTIONS)
         for n, nQ in MESH_DISHES.items()}
  out['collimated'] = (benchmarks.buildMeshDishCollimatedScene(),
                       MESH_BOUNDS, MESH_MAX_INTERSECTIONS)
  out['meshLens'] = helpers.buildMeshLensScene(ns)
  out['tie'] = helpers.buildTieMeshScene(ns)
  return out


def meshKernelChecks(scenes):
  '''Phase 10's kernel checks: K1, K2 and K4 against their plain versions
  on every mesh scene (modes (b) and (c), the gates of phase 2) at
  MESH_CHECK_RAYS, and K1 against K2 + `binRing` at 1 << 22 rays on every
  dish; K3 on the 1800-triangle dish's 11 detector heights x 1 << 20 rays
  against its plain version and, in seed mode, against one K1 launch per
  variant. Returns (the worst error per kernel, per scene the triangles a
  segment must test as the plain version counted them).'''
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0., traceSweep=0.)
  perSegment = {}
  for name, (scene, bounds, maxI) in scenes.items():
    n = MESH_CHECK_RAYS[name]
    stats = {}
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        f'mesh-{name}', scene, bounds, maxI, n, BINS, triangleStats=stats))
    rb = stats['rayBounces']
    perSegment[name] = dict(
        chunks=stats['chunks'] / rb, triangles=stats['triangles'] / rb,
        levels=levelWork(stats, 'capTriangles', 'triangles'))
    w = compareRingsWithPlain(f'mesh-{name}', scene, bounds, maxI, n, BINS)
    for k in ('traceRaw', 'traceBins'):
      worst[k] = max(worst[k], w[k])
    if n < N_MAIN:
      sceneNp, histSpec, tables = buildTables(scene, bounds, BINS, maxI)
      us, strataTile, _cols, _scat = samplerInputs(tables, N_MAIN, 97, maxI)
      binsAgainstHistogram(f'mesh-{name}', tables, histSpec, N_MAIN, us,
                           strataTile, dict(
          maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
          powerTol=1e-6,
          hitSlots=cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)))
    emit(dict(phase='mesh-plain-triangles', scene=name, rays=n,
              nTri=cuda_trace.tableTriangles(compiled(scene)[0]),
              chunksPerSegment=perSegment[name]['chunks'],
              trianglesPerSegment=perSegment[name]['triangles'],
              **{f'{level}PerSegment': work
                 for level, work in perSegment[name]['levels'].items()}))
  variants = [benchmarks.buildMeshDishScene(MESH_DISHES[1800], detectorZ=z)
              for z in MESH_HEIGHTS]
  worst['traceSweep'] = compareSweepWithPlain(
      'dish-heights', variants, MESH_BOUNDS, MESH_MAX_INTERSECTIONS,
      MESH_SWEEP_RAYS, columnsToo=True)
  compareSweepWithSingles('dish-heights', variants, MESH_BOUNDS,
                          MESH_MAX_INTERSECTIONS, MESH_SWEEP_RAYS, seed=47)
  return worst, perSegment


# what phases 10 and 11 drive their paths with: the prefix of their phase
# names, the histogram bounds and intersections, the scene whose share and
# r^2 are held to the JAX package's (3 sigma) and those numbers, the
# recording run's iterations, the detector heights of the sweep
MESH_PATH = dict(prefix='mesh', stats='dish-statistics', bounds=MESH_BOUNDS,
                 maxI=MESH_MAX_INTERSECTIONS, refScene='dish1800',
                 ref=REF_DISH, refRays=REF_DISH_RAYS,
                 rawIterations=MESH_RAW_ITERATIONS,
                 histIterations=MESH_HIST_ITERATIONS, heights=MESH_HEIGHTS,
                 sweepRays=MESH_SWEEP_RAYS)
WALL_PATH = dict(prefix='wall', stats='wall-statistics', bounds=WALL_BOUNDS,
                 maxI=WALL_MAX_INTERSECTIONS, refScene='wall522',
                 ref=REF_WALL, refRays=REF_WALL_RAYS,
                 rawIterations=WALL_RAW_ITERATIONS,
                 histIterations=WALL_HIST_ITERATIONS, heights=WALL_HEIGHTS,
                 sweepRays=WALL_SWEEP_RAYS)


def checkPathStats(path, label, stats, nRays):
  '''The path's scene's detected share and r^2 against the JAX package's
  (`path['ref']`, 3 sigma).'''
  ok, sigmas = helpers.scatterStatsGate(stats, path['ref'], nRays,
                                        path['refRays'])
  emit(dict(phase=path['stats'], run=label, rays=nRays, **stats,
            ref=path['ref'], **sigmas))
  if not ok:
    raise AssertionError(f"{path['refScene']} {label}: {stats} against the "
                         f"JAX package's {path['ref']}")


def pathStepPhase(path, name, scene, histPrecision, boundKw):
  '''The fused step (`benchmarks.makeBenchStep`, seed mode) on a scene of
  the path at full width: timed (`timeBenchStep`) with its bound
  (`boundMs(..., **boundKw)`); on the path's reference scene its
  statistics against the JAX package's.'''
  t = timeBenchStep(histPrecision, path['maxI'], scene=scene,
                    histBounds=path['bounds'])
  step, hist = t['step'], t['hist']
  segsPerStep = t['segments'] / TIMED_STEPS
  outBytes = (2 * hist['power'].numel() * 4 * 2 if histPrecision == 'default'
              else 3 * step.hitSlots * N_MAIN * 4)
  bounds = boundMs(step.tables, segsPerStep, N_MAIN, outBytes, **boundKw)
  emit(dict(phase=f"{path['prefix']}-step", scene=name,
            histPrecision=histPrecision, rays=N_MAIN, steps=TIMED_STEPS,
            stepMs=t['stepMs'], kernelMs=t['kernelMs'],
            segmentsPerRay=segsPerStep / N_MAIN, hits=t['hits'],
            launches=t['launches'], nTri=step.tables['nTri'],
            nSurfTable=step.tables['nSurfTable'], boundMs=max(bounds[:2]),
            **bounds[2]))
  binned = float(hist['counts'].double().sum())
  if not torch.isfinite(hist['power']).all() or t['hits'] <= 0 \
      or binned > t['hits']:
    raise AssertionError(f'step on {name}: {binned} binned of '
                         f'{t["hits"]} hits, or a non-finite bin')
  if name == path['refScene']:
    nRays = N_MAIN * TIMED_STEPS
    checkPathStats(path, f'step-{histPrecision}', helpers.scatterStats(
        hist, binned, nRays, bounds=path['bounds']), nRays)
  return dict(launches=t['launches'], ms=t['kernelMs'], bounds=bounds)


def pathRawStepPhase(path, name, scene, boundKw):
  '''`makeRawStep` on a scene of the path at 1 << 22 rays: one launch of
  the raw kernel, its records, then the kernel alone by CUDA events with
  its bound.'''
  sceneNp, info = compiled(scene)
  sceneNp = dict(sceneNp, powerTol=1e-6)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=path['bounds'],
                                     bins=BINS)
  src = scene.lightSources()[0]
  resetLaunchCounts()
  step = cuda_trace.makeRawStep(
      sceneNp, histSpec, src.deviceColumnsGenerator(device=DEV),
      raysPerStep=N_MAIN, maxIntersections=path['maxI'], maxRayLength=1000.,
      distTol=1e-4, sampler=src.samplerSpec(),
      emissionBound=src.emissionBound())
  records, counters = step(11)
  torch.cuda.synchronize()
  launches = dict(cuda_trace.launchCounts)
  if launches != onlyLaunches(traceRaw=1):
    raise AssertionError(f'raw step on {name} launched {launches}')
  if int(counters['hits']) <= 0 or not bool(torch.isfinite(
      records['point'][records['recordHit']]).all()):
    raise AssertionError(f'raw step on {name}: no hits, or a non-finite '
                         f'point')
  seeds = iter(range(100, 10 ** 6))
  kernelMs = cudaMs(lambda: cuda_trace.traceRaw(
      step.tables, N_MAIN, path['maxI'], 1000., 1e-4,
      hitSlots=step.hitSlots, seed=next(seeds), strataTile=step.strataTile),
      TIMED_STEPS)
  bounds = boundMs(step.tables, int(counters['segments']), N_MAIN,
                   9 * step.hitSlots * N_MAIN * 4, **boundKw)
  emit(dict(phase=f"{path['prefix']}-raw-step", scene=name, rays=N_MAIN,
            hits=int(counters['hits']), segments=int(counters['segments']),
            kernelMs=kernelMs, boundMs=max(bounds[:2]), **bounds[2]))
  return dict(launches=1, ms=kernelMs, bounds=bounds)


def pathRunPhases(path, scene, **extra):
  '''`runSimulation` on the path's reference scene (its detector
  'Det' at z = 0, its source 'Src'): raw recording (`rawIterations` x
  1 << 20, the raw kernel; rows read back == the run's hits, every point on
  the detector plane) and histogram-first recording (`histIterations` x
  1 << 22, the histogram kernel; snapshot counts == the run's hits); the
  detected share and r^2 against the JAX package's. `extra` goes into the
  raw run's line.'''
  prefix, rawIterations = path['prefix'], path['rawIterations']
  settings = scene.activeSimulationSettings()
  settings.RaysPerIteration = N_RAW_ITERATION
  settings.EndAfterIterations = rawIterations
  settings.EndAfterRays = 'inf'
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(scene,
                                                        recording='raw')
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  hits = RawFolder(runPath).loadHits('Det')
  rows = len(hits['points'])
  traced = last['totalTracedRays']
  emit(dict(phase=f'{prefix}-run-raw', **extra,
            raysPerIteration=N_RAW_ITERATION,
            iterations=last['totalIterations'], tracedRays=traced,
            storedHits=rows, detectedShare=rows / traced, launches=launches,
            setupAndFirstIterationS=first, laterIterationsS=later,
            cleanupFlushS=cleanup))
  if launches != onlyLaunches(traceRaw=rawIterations) \
      or traced != N_RAW_ITERATION * rawIterations \
      or rows != last['totalRecordedHits'] or rows <= 0:
    raise AssertionError(f'{prefix} raw run: {rows} rows, {launches}, '
                         f'{last}')
  if not np.isfinite(hits['points']).all() \
      or np.abs(hits['points'][:, 2]).max() > 1e-3:
    raise AssertionError(f'{prefix} raw run: points off the detector plane')

  settings.RaysPerIteration = N_MAIN
  settings.EndAfterIterations = path['histIterations']
  resetLaunchCounts()
  runPath, progress, (first, later, cleanup) = timedRun(
      scene, recording='histogram', histBins=BINS, histBounds=path['bounds'])
  launches = dict(cuda_trace.launchCounts)
  last = progress[-1]
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']
  counts = float(snap['counts'].astype(np.float64).sum())
  nRays = last['totalTracedRays']
  emit(dict(phase=f'{prefix}-run-histogram', raysPerIteration=N_MAIN,
            iterations=last['totalIterations'], tracedRays=nRays,
            histCounts=counts, recordedHits=last['totalRecordedHits'],
            detectedShare=counts / nRays, launches=launches,
            setupAndFirstPassS=first, laterPassesS=later,
            cleanupFlushS=cleanup,
            raysPerSec=nRays / (first + later + cleanup)))
  # (the run's raw sample of 1 << 13 rays every 8 passes is one raw launch)
  if nRays != path['histIterations'] * N_MAIN \
      or counts != last['totalRecordedHits'] \
      or launches.get('traceHistogram') != path['histIterations']:
    raise AssertionError(f'{prefix} histogram run: counts {counts}, '
                         f'{launches}, {last}')
  checkPathStats(path, 'run-histogram', helpers.scatterStats(
      dict(power=torch.as_tensor(snap['power'])[None],
           counts=torch.as_tensor(snap['counts'])[None]), counts, nRays,
      bounds=path['bounds']), nRays)
  return dict(launches=path['histIterations'])


def pathSweepPhase(path, make, boundKw, variants=None):
  '''`ParameterSweeper.evaluateBatched` on the detector height of the
  scene `make(z)` builds (`path['heights']` x `path['sweepRays']` rays):
  one launch of the sweep kernel per call; then the kernel alone on those
  heights (`variants`, where the checks compiled them) by CUDA events, with
  its bound.'''
  from optics_design_workbench_tpu_torch.jupyter_utils import (
      Parameter, ParameterSweeper)
  prefix, heights, n = path['prefix'], path['heights'], path['sweepRays']
  holder = dict(z=0., scene=make(0.))

  def setZ(z):
    holder['z'] = float(z)
    holder['scene'] = make(z)
    sweeper.scene = holder['scene']

  sweeper = ParameterSweeper(
      lambda sc: dict(z=Parameter(getter=lambda: holder['z'], setter=setZ,
                                  bounds=(min(heights), max(heights)))),
      scene=holder['scene'], device=DEV)
  r2 = []

  def metric(power, counts):
    r2.append(helpers.scatterStats(dict(power=power, counts=counts),
                                   float(counts.sum()), n,
                                   bounds=path['bounds'])['r2'])
    return r2[-1]

  resetLaunchCounts()
  t0 = time.perf_counter()
  sweeper.evaluateBatched([dict(z=z) for z in heights], metric,
                          sceneFactory=lambda: holder['scene'],
                          raysPerScene=n, maxIntersections=path['maxI'],
                          histBounds=path['bounds'], bins=BINS)
  torch.cuda.synchronize()
  wallS = time.perf_counter() - t0
  launches = dict(cuda_trace.launchCounts)
  route = sweeper.lastBatchedRoute
  emit(dict(phase=f'{prefix}-sweep', variants=len(heights),
            raysPerVariant=n, route=route, launches=launches, wallS=wallS,
            meanR2ByHeight=r2))
  if route != 'sweep' or launches != onlyLaunches(traceSweep=1):
    raise AssertionError(f'{prefix} sweep: route {route}, launches '
                         f'{launches}')
  if not all(np.isfinite(r2)) or r2[0] == r2[-1]:
    raise AssertionError(f'{prefix} sweep: mean r^2 by height {r2}')

  if variants is None:
    variants = [make(z) for z in heights]
  tables, host, histSpec, _specs = sweepTablesFor(variants, path['bounds'])
  V = len(variants)
  shape = (V, tables['nDet']) + SWEEP_BINS
  hist = dict(power=torch.zeros(shape, device=DEV),
              counts=torch.zeros(shape, device=DEV))
  kw = dict(maxIntersections=path['maxI'], maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6,
            hitSlots=cuda_trace.autoHitSlots(host[0][0], histSpec,
                                             path['maxI']),
            strataTile=cuda_trace.DEFAULT_STRATA_TILE)
  seeds = iter(range(77, 10 ** 6))
  counters = cuda_trace.traceSweep(tables, hist, n, seed=next(seeds), **kw)
  segments = int(counters[:, 0].sum())
  kernelMs = cudaMs(lambda: cuda_trace.traceSweep(
      tables, hist, n, seed=next(seeds), **kw), TIMED_STEPS)
  bounds = boundMs(tables, segments, V * n, 2 * hist['power'].numel() * 4 * 2,
                   **boundKw)
  emit(dict(phase=f'{prefix}-sweep-kernel', variants=V, raysPerVariant=n,
            kernelMs=kernelMs, boundMs=max(bounds[:2]), **bounds[2]))
  return dict(launches=launches['traceSweep'], ms=kernelMs, bounds=bounds)


def pathTimings(path, scenes, names, boundKwOf):
  '''K1 and K2 (the fused step, both binnings) and K4 (the raw step) on
  the path's scenes `names`, each with its bound: per wrapper, the
  reference scene's numbers with ms and bound by scene.'''
  out = {}
  for wrapper, precision in (('traceHistogram', 'default'),
                             ('traceBins', 'highest')):
    byScene = {name: pathStepPhase(path, name, scenes[name][0], precision,
                                   boundKwOf(name)) for name in names}
    out[wrapper] = byScene
  out['traceRaw'] = {name: pathRawStepPhase(path, name, scenes[name][0],
                                            boundKwOf(name))
                     for name in names}
  return {w: dict(byScene[path['refScene']],
                  byScene={n: r['ms'] for n, r in byScene.items()},
                  boundByScene={n: tableBound(r['bounds'])[0]
                                for n, r in byScene.items()},
                  oneLevelByScene={n: max(r['bounds'][:2])
                                   for n, r in byScene.items()},
                  workByScene={n: tableWork(r['bounds'], boundKwOf(n))
                               for n, r in byScene.items()})
          for w, byScene in out.items()}


def tableBound(bounds):
  '''(bound ms, what bounds it, the one-level count's bound ms) of a step
  on a table scene: the bound of the kernels' three-level sweep with the
  shrinking cap, each ray alone (`boundMs`'s `boundOpsThreeLevelMs`, the
  least table work the kernels can reach), and that of the one-level
  count.'''
  ops, nbytes, info = bounds
  three = info['boundOpsThreeLevelMs']
  return (max(three, nbytes), 'operations' if three >= nbytes else 'bytes',
          max(ops, nbytes))


def tableWork(bounds, boundKw):
  '''The operations a segment and the bound of a step on a table scene, as
  `boundMs` counts them for the one-level sweep (every chunk box, the rows
  of the boxes entered at the entry cap), for the two-level sweep with the
  shrinking cap, for the kernels' three-level sweep, each ray alone, and
  for the three-level sweep as a warp runs it (`LEVELS`), with
  the rows (triangles, or table rows by kind) a segment sweeps in each
  (`boundKw`, the plain version's counts).'''
  ops, nbytes, info = bounds
  rowsOf = lambda work: work.get('triangles', work.get('rows'))
  out = dict(flopsPerSegment=info['flopsPerSegment'],
             boundMs=max(ops, nbytes),
             rowsPerSegment=boundKw.get('trianglesPerSegment',
                                        boundKw.get('tableRowsPerSegment')))
  for level, work in boundKw['levels'].items():
    name = capitalised(level)
    out[f'flopsPerSegment{name}'] = info[f'flopsPerSegment{name}']
    out[f'bound{name}Ms'] = max(info[f'boundOps{name}Ms'], nbytes)
    out[f'rowsPerSegment{name}'] = rowsOf(work)
  return out


# the sweeps whose table work the plain version counts (`levelWork`)
LEVELS = ('twoLevel', 'threeLevel', 'warp')


def capitalised(level):
  return level[0].upper() + level[1:]


def levelWork(stats, rowsKey, rowsName):
  '''Per segment, by sweep of LEVELS, the boxes a ray tests (`boxTests`:
  groups, chunks and leaves) and the rows it sweeps (`rowsName`: triangles,
  or table rows by kind), from the plain version's counts `stats`
  (`cuda_trace._CapCount`; the two-level sweep in its own keys).'''
  rb = stats['rayBounces']
  out = {}
  for level in LEVELS:
    s = stats if level == 'twoLevel' else stats.get(level, {})
    rows = s.get(rowsKey, stats.get(rowsKey, stats[rowsName]))
    out[level] = {
        'boxTests': sum(s.get(k, 0) for k in ('groupTests', 'chunkTests',
                                              'leafTests')) / rb,
        rowsName: ({k: v / rb for k, v in rows.items()}
                   if isinstance(rows, dict) else rows / rb)}
  return out


def meshPhase(tmp):
  '''Phase 10, triangle meshes (B7): kernel checks, then the dishes'
  paths through the port's entry points at full width. Returns, per
  wrapper, its launches on the 1800-triangle dish's path, ms and bound
  there, ms and bound by dish, and its worst error.'''
  t10 = time.perf_counter()
  scenes = meshScenes()
  worst, perSegment = meshKernelChecks(scenes)
  boundKwOf = lambda name: dict(
      trianglesPerSegment=perSegment[name]['triangles'],
      levels=perSegment[name]['levels'])
  out = pathTimings(MESH_PATH, scenes, [f'dish{n}' for n in MESH_DISHES],
                    boundKwOf)
  out['traceRaw']['launches'] = MESH_RAW_ITERATIONS
  scene, path = meshExample.buildDishFromSTL(tmp, MESH_DISHES[1800])
  out['traceHistogram']['launches'] = pathRunPhases(
      MESH_PATH, scene, stl=os.path.basename(path))['launches']
  out['traceSweep'] = pathSweepPhase(
      MESH_PATH, lambda z: benchmarks.buildMeshDishScene(MESH_DISHES[1800],
                                                         detectorZ=z),
      boundKwOf('dish1800'))
  for name, entry in out.items():
    entry['err'] = worst[name]
  emit(dict(phase='mesh-total', seconds=time.perf_counter() - t10))
  return out


def wallScenes():
  '''The scenes of phase 11, built once: name -> (scene, histogram bounds,
  intersections).'''
  out = {name: (getattr(benchmarks, make)(), WALL_BOUNDS,
                WALL_MAX_INTERSECTIONS) for name, make in WALLS.items()}
  ns = helpers.torchNs()
  for name, build in helpers.SURFACE_TABLE_SCENES.items():
    if name != 'wall':
      out[name] = build(ns)
  return out


def wallKernelChecks(scenes):
  '''Phase 11's kernel checks: K1, K2 and K4 against their plain versions
  on both walls and every check scene of the surface table (modes (b) and
  (c)) with no ray moved and every ring value equal, at WALL_CHECK_RAYS
  (1 << 20 but for the 522-surface wall), and K1 against K2 + `binRing` at
  1 << 22 rays on the scenes checked at fewer; K3 on the 522-surface wall's 11 detector heights x
  1 << 20 rays against its plain version and, in seed mode, against one K1
  launch per variant. Returns (the worst error per kernel, per scene the
  table rows a segment must test, by kind, as the plain version counted
  them, the 11 height variants).'''
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0., traceSweep=0.)
  perSegment = {}
  for name, (scene, bounds, maxI) in scenes.items():
    n = WALL_CHECK_RAYS.get(name, 1 << 20)
    stats = {}
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        f'table-{name}', scene, bounds, maxI, n, BINS, budget=0,
        surfaceStats=stats))
    rb = stats['rayBounces']
    perSegment[name] = dict(
        rows={k: v / rb for k, v in stats['rows'].items()},
        levels=levelWork(stats, 'capRows', 'rows'))
    w = compareRingsWithPlain(f'table-{name}', scene, bounds, maxI, n, BINS,
                              budget=0, rawAtol=0.)
    for k in ('traceRaw', 'traceBins'):
      worst[k] = max(worst[k], w[k])
    if n < N_MAIN:
      sceneNp, histSpec, tables = buildTables(scene, bounds, BINS, maxI)
      us, strataTile, _cols, _scat = samplerInputs(tables, N_MAIN, 97, maxI)
      binsAgainstHistogram(f'table-{name}', tables, histSpec, N_MAIN, us,
                           strataTile, dict(
          maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
          powerTol=1e-6,
          hitSlots=cuda_trace.autoHitSlots(sceneNp, histSpec, maxI)))
    emit(dict(phase='table-plain-rows', scene=name, rays=n,
              nSurfTable=int(cuda_trace.tableSurfaces(
                  compiled(scene)[0]).sum()),
              chunksPerSegment=stats['chunks'] / stats['rayBounces'],
              rowsPerSegmentByKind=perSegment[name]['rows'],
              **{f'{level}PerSegment': work
                 for level, work in perSegment[name]['levels'].items()}))
  variants = [benchmarks.buildSurfWallScene(detectorZ=z)
              for z in WALL_HEIGHTS]
  worst['traceSweep'] = compareSweepWithPlain(
      'wall-heights', variants, WALL_BOUNDS, WALL_MAX_INTERSECTIONS,
      WALL_SWEEP_RAYS, columnsToo=True, budget=0)
  compareSweepWithSingles('wall-heights', variants, WALL_BOUNDS,
                          WALL_MAX_INTERSECTIONS, WALL_SWEEP_RAYS, seed=53)
  return worst, perSegment, variants


def wallPhase(tmp):
  '''Phase 11, the surface table (B8): kernel checks, then the walls'
  paths through the port's entry points at full width. Returns, per
  wrapper, its launches on the 522-surface wall's path, ms and bound there,
  ms and bound by wall, and its worst error.'''
  t11 = time.perf_counter()
  scenes = wallScenes()
  worst, perSegment, variants = wallKernelChecks(scenes)
  boundKwOf = lambda name: dict(
      tableRowsPerSegment=perSegment[name]['rows'],
      levels=perSegment[name]['levels'])
  out = pathTimings(WALL_PATH, scenes, list(WALLS), boundKwOf)
  out['traceRaw']['launches'] = WALL_RAW_ITERATIONS
  out['traceHistogram']['launches'] = pathRunPhases(
      WALL_PATH, benchmarks.buildSurfWallScene(tmpdir=tmp))['launches']
  out['traceSweep'] = pathSweepPhase(
      WALL_PATH, lambda z: benchmarks.buildSurfWallScene(detectorZ=z),
      boundKwOf('wall522'), variants)
  for name, entry in out.items():
    entry['err'] = worst[name]
  emit(dict(phase='wall-total', seconds=time.perf_counter() - t11))
  return out

T0 = time.perf_counter()


def b11Phase():
  '''B11 on the card: K1 and K3 against their plain versions (the gates of
  phase 2) where the rays pile up: the pile-up scene (every ray in one bin;
  K3 over four placements) at 64 x 64 and 128 x 128 bins, and the
  spectrometer's focused lines. Returns the worst error per kernel.'''
  t0 = time.perf_counter()
  ns = helpers.torchNs()
  worst = dict(traceHistogram=0., traceSweep=0.)
  width = helpers.PILEUP_BOUNDS[1] - helpers.PILEUP_BOUNDS[0]
  for bins in (SWEEP_BINS, BINS):
    half = width / bins[1] / 2
    scene, bounds, maxI = helpers.buildPileUpScene(ns, half)
    label = f'pileUp-{bins[0]}'
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        label, scene, bounds, maxI, N_MAIN, bins))
    scenes = [helpers.buildPileUpScene(ns, half * (1 + 2 * k))[0]
              for k in PILEUP_BINS_OFF]
    worst['traceSweep'] = max(worst['traceSweep'], compareSweepWithPlain(
        label, scenes, bounds, maxI, PILEUP_SWEEP_RAYS, columnsToo=False,
        bins=bins))
  worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
      'spectrometer-lines', benchmarks.buildSpectrometerScene(),
      SPECTRO_BOUNDS, SPECTRO_MAX_INTERSECTIONS, N_MAIN, BINS))
  emit(dict(phase='b11', seconds=time.perf_counter() - t0,
            maxAbsErr=worst))
  return worst


B12_SCENES = ('decoy', 'fold', 'reflectBack', 'ballLens')
B12_DECOY_BOUNDS = (-300., 300., -300., 300.)
B12_DECOY_MAX_INTERSECTIONS = 4
B12_TIMED_TURNS = 2          # culled, unculled, ... of TIMED_STEPS each


def cullAgainstUnculled(label, scene, bounds, maxI):
  '''B12 on one scene, mode (b): K2 at 1 << 22 rays and K4 at 1 << 20
  with the source's per-bounce culls against their plain versions (which
  sweep the same sets) and against the same kernels on tables without the
  culls, equal bit for bit; K1 with the culls against K1 without them:
  counters and counts equal, power within POWER_RTOL (the atomics add in a
  run-to-run order).'''
  sceneNp, histSpec, culled = buildTables(scene, bounds, BINS, maxI)
  full = buildTables(scene, bounds, BINS, maxI, cull=False)[2]
  settings = scene.activeSimulationSettings()
  kw = dict(maxIntersections=maxI, maxRayLength=settings.maxRayLength(),
            distTol=1e-4, powerTol=1e-6,
            hitSlots=cuda_trace.autoHitSlots(sceneNp, histSpec, maxI))
  us, strataTile, cols, _scat = samplerInputs(culled, N_MAIN, 2468, maxI)
  hists = []
  for tables in (culled, full):
    hists.append(fused.initHistograms(histSpec, device=DEV))
    hists[-1]['counters'] = cuda_trace.traceHistogram(
        tables, hists[-1], N_MAIN, uniforms=us, strataTile=strataTile, **kw)
  binsC, c2C = cuda_trace.traceBins(culled, N_MAIN, uniforms=us,
                                    strataTile=strataTile, **kw)
  binsF, c2F = cuda_trace.traceBins(full, N_MAIN, uniforms=us,
                                    strataTile=strataTile, **kw)
  binsP, c2P = cuda_trace.traceBinsPlain(culled, cols, **kw)
  usR, _t, colsR, _s = samplerInputs(culled, N_RAW_ITERATION, 1357, maxI)
  rawC, c4C = cuda_trace.traceRaw(culled, N_RAW_ITERATION, uniforms=usR,
                                  strataTile=strataTile, **kw)
  rawF, c4F = cuda_trace.traceRaw(full, N_RAW_ITERATION, uniforms=usR,
                                  strataTile=strataTile, **kw)
  rawP, c4P = cuda_trace.traceRawPlain(culled, colsR, **kw)
  torch.cuda.synchronize()
  hC, hF = hists
  if hC['counters'].tolist() != hF['counters'].tolist() \
      or not torch.equal(hC['counts'], hF['counts']):
    raise AssertionError(f'b12 {label}: K1 with the culls counts '
                         f'{hC["counters"].tolist()}, without '
                         f'{hF["counters"].tolist()}, or its bins differ')
  if not torch.allclose(hC['power'], hF['power'], rtol=POWER_RTOL, atol=0.):
    raise AssertionError(f'b12 {label}: K1 power with and without the '
                         f'culls beyond rtol {POWER_RTOL}')
  for name, k, f, p, ck, cf, cp in (
      ('traceBins', binsC, binsF, binsP, c2C, c2F, c2P),
      ('traceRaw', rawC, rawF, rawP, c4C, c4F, c4P)):
    if not ck.tolist() == cf.tolist() == cp.tolist() or int(ck[1]) <= 0:
      raise AssertionError(f'b12 {label} {name}: counters culled '
                           f'{ck.tolist()}, unculled {cf.tolist()}, plain '
                           f'{cp.tolist()}')
    if not torch.equal(k, f) or not torch.equal(k, p):
      raise AssertionError(f'b12 {label} {name}: the culled ring differs '
                           f'from the unculled kernel\'s or the plain '
                           f'version\'s')
  emit(dict(phase='b12-vs-unculled', scene=label, rays=N_MAIN,
            rawRays=N_RAW_ITERATION, cullOff=culled['cullOff'],
            sets=cuda_trace.tableCullSets(culled, maxI),
            counters=hC['counters'].tolist(), rawCounters=c4C.tolist(),
            movedRays=0, maxAbsErrBins=0., maxAbsErrRaw=0.,
            maxAbsErrPowerVsUnculled=float(
                (hC['power'] - hF['power']).abs().max())))


def decoyPathPhase():
  '''The decoy scene (`benchmarks.buildCullDecoyScene`) through the
  port's entry points with its source's bound: the sets on the host first
  (no decoy in any), then the fused step with both binnings (1 << 22 rays,
  `makeBenchStep`; launches == steps) and a raw step (`makeRawStep`,
  1 << 20 rays, one launch), each kernel then timed by CUDA events with
  and without the culls in turns (B12_TIMED_TURNS x TIMED_STEPS calls
  each), beside its bound with and without them. Returns, per wrapper, the
  launches, ms, unculled ms and bounds.'''
  scene = benchmarks.buildCullDecoyScene()
  maxI, bounds = B12_DECOY_MAX_INTERSECTIONS, B12_DECOY_BOUNDS
  sceneNp, info = compiled(scene)
  histSpec = fused.makeHistogramSpec(sceneNp, info, bounds=bounds, bins=BINS)
  src = scene.lightSources()[0]
  full = cuda_trace.buildTraceTables(sceneNp, histSpec,
                                     samplerSpec=src.samplerSpec(),
                                     device=DEV)
  decoys = info['elementLabels'].index('Decoys')
  out = {}
  for precision, wrapper in (('default', 'traceHistogram'),
                             ('highest', 'traceBins')):
    t = timeBenchStep(precision, maxI, scene=scene, histBounds=bounds)
    out[wrapper] = dict(launches=t['launches'], tables=t['step'].tables,
                        segments=t['segments'] / TIMED_STEPS, kw=t['kw'],
                        strataTile=t['step'].strataTile, n=N_MAIN,
                        hits=t['hits'] / TIMED_STEPS)
  culled = out['traceHistogram']['tables']
  sets = cuda_trace.tableCullSets(culled, maxI)
  rows = culled['surfRows']
  if any(ss is None or any(rows[s]['elemF'] == decoys for s in ss)
         for ss in sets) or full['cullOff'] != -1:
    raise AssertionError(f'decoy scene: sets {sets} hold a decoy or a '
                         f'full sweep')
  resetLaunchCounts()
  rawStep = cuda_trace.makeRawStep(
      dict(sceneNp, powerTol=1e-6), histSpec,
      src.deviceColumnsGenerator(device=DEV), raysPerStep=N_RAW_ITERATION,
      maxIntersections=maxI, maxRayLength=1000., distTol=1e-4,
      sampler=src.samplerSpec(), emissionBound=src.emissionBound())
  records, counters = rawStep(11)
  torch.cuda.synchronize()
  if dict(cuda_trace.launchCounts) != onlyLaunches(traceRaw=1) \
      or int(counters['hits']) < 0.9 * N_RAW_ITERATION:
    raise AssertionError(f'decoy raw step: {cuda_trace.launchCounts}, '
                         f'{int(counters["hits"])} hits')
  out['traceRaw'] = dict(launches=1, tables=rawStep.tables,
                         segments=int(counters['segments']),
                         kw=dict(out['traceHistogram']['kw'],
                                 hitSlots=rawStep.hitSlots),
                         strataTile=rawStep.strataTile, n=N_RAW_ITERATION,
                         hits=int(counters['hits']))
  # the segments each bounce traces, for the culled bound
  stats = {}
  gen = torch.Generator(device=DEV)
  gen.manual_seed(3)
  us = torch.rand((2, N_MAIN), generator=gen, device=DEV)
  st = out['traceHistogram']['strataTile']
  cols = cuda_trace.sampleRaysPlain(culled, us[0], us[1],
                                    cuda_trace.tileStrata(N_MAIN, st), st)
  cuda_trace.traceHistogramPlain(culled, fused.initHistograms(
      histSpec, device=DEV), cols, cullStats=stats,
      **out['traceHistogram']['kw'])
  scratch = fused.initHistograms(histSpec, device=DEV)
  seeds = iter(range(7000, 10 ** 6))
  for wrapper, r in out.items():
    n, kw = r['n'], dict(r['kw'], strataTile=r['strataTile'])
    if wrapper == 'traceHistogram':
      call = lambda tb: cuda_trace.traceHistogram(tb, scratch, n,
                                                  seed=next(seeds), **kw)
      outBytes = 2 * scratch['power'].numel() * 4 * 2
    else:
      fn = getattr(cuda_trace, wrapper)
      call = lambda tb, fn=fn: fn(tb, n, seed=next(seeds), **kw)
      outBytes = (3 if wrapper == 'traceBins' else 9) * kw['hitSlots'] \
          * n * 4
    times = dict(culled=[], unculled=[])
    for _turn in range(B12_TIMED_TURNS):
      for which, tb in (('culled', r['tables']), ('unculled', full)):
        call(tb)
        times[which].append(cudaMs(lambda: call(tb), TIMED_STEPS))
    r['ms'] = float(np.mean(times['culled']))
    r['unculledMs'] = float(np.mean(times['unculled']))
    segs = r['segments']
    r['bounds'] = boundMs(r['tables'], segs, n, outBytes, cullStats=stats)
    r['unculledBounds'] = boundMs(full, segs, n, outBytes)
    emit(dict(phase='b12-decoy', wrapper=wrapper, rays=n, sets=sets,
              launches=r['launches'], hits=r['hits'], segments=segs,
              segmentsByBounce=stats['segmentsByBounce'],
              culledMs=times['culled'], unculledMs=times['unculled'],
              speedUp=r['unculledMs'] / r['ms'],
              boundMs=max(r['bounds'][:2]),
              unculledBoundMs=max(r['unculledBounds'][:2]),
              flopsPerSegment=r['bounds'][2]['flopsPerSegment'],
              unculledFlopsPerSegment=r['unculledBounds'][2][
                  'flopsPerSegment']))
  return out


def b12Phase():
  '''B12, the per-bounce surface culls, on the card: K1 against its plain
  version (the gates of phase 2, 0 rays moved) and K1, K2 and K4 against
  the same kernels without the culls (`cullAgainstUnculled`) on the decoy,
  fold, reflect-back and ball-lens scenes, then the decoy scene's path
  (`decoyPathPhase`). Returns (the worst error per kernel, the decoy
  path's numbers).'''
  t0 = time.perf_counter()
  ns = helpers.torchNs()
  worst = dict(traceHistogram=0., traceBins=0., traceRaw=0.)
  for name in B12_SCENES:
    scene, bounds, maxI = helpers.CULL_SCENES[name](ns)
    worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
        f'b12-{name}', scene, bounds, maxI, N_MAIN, BINS, budget=0))
    cullAgainstUnculled(name, scene, bounds, maxI)   # K2 / K4 equal: 0.0
  decoy = decoyPathPhase()
  for wrapper, r in decoy.items():
    r['err'] = worst[wrapper]
  emit(dict(phase='b12', seconds=time.perf_counter() - t0,
            maxAbsErr=worst))
  return decoy


def hitRowsByRay(records):
  '''The recorded hits of slot- or bounce-major records, ray-major: (ray
  index of each row, the rows' element, entering flag, point, direction,
  power), as numpy.'''
  order = torch.nonzero(records['recordHit'].T)          # (ray, slot)
  sel = (order[:, 1], order[:, 0])
  return (order[:, 0].cpu().numpy(),) + tuple(
      records[k][sel].cpu().numpy() for k in ('hitElem', 'isEntering',
                                              'point', 'direction', 'power'))


def recordTracerPhase():
  '''The record tracer (tracing/tracer.trace, plain PyTorch on the card)
  on the lens-and-mirror at RECORD_RAYS rays with segment records: ms per
  bounce and rays per second by CUDA events; its hit rows against the
  raw-record kernel's (columns input mode) on the same columns, ray by
  ray, to RAW_ATOL.'''
  t0 = time.perf_counter()
  scene = benchmarks.buildLensMirrorScene()
  host, info = scene.compile(device=None)
  host['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  gen = torch.Generator(device=DEV)
  gen.manual_seed(16)
  cols, _meta = src.deviceGenerator(device=DEV)(gen, RECORD_RAYS)
  columns = torch.stack([cols[k] for k in cuda_trace._COLUMN_KEYS])
  maxI, maxL, distTol = 6, 1000., 1e-4
  prepared = batch_tracer.prepareScene(host, DEV)
  out = {}

  def run():
    out['records'] = tracer.trace(
        prepared, columns[0:3].T, columns[3:6].T, columns[6], columns[7],
        maxI, maxL, distTol)[1]

  run()
  ms = cudaMs(run, RECORD_REPS)
  records = out['records']
  bounces = int(records['segValid'].any(dim=1).sum())
  segments = tracer.totalSegments(records)
  histSpec = fused.makeHistogramSpec(host, info)
  tables = cuda_trace.buildTraceTables(host, histSpec, device=DEV)
  slots = cuda_trace.autoHitSlots(host, histSpec, maxI)
  resetLaunchCounts()
  ring, _c = cuda_trace.traceRaw(tables, RECORD_RAYS, maxI, maxL, distTol,
                                 hitSlots=slots, columns=columns)
  assert cuda_trace.launchCounts == onlyLaunches(traceRaw=1)
  a = hitRowsByRay(cuda_trace.recordsFromRing(ring))
  b = hitRowsByRay(records)
  assert len(a[0]) > 0.9 * RECORD_RAYS, len(a[0])
  # rays whose hit rows differ (in number, element, entering flag, or by
  # more than RAW_ATOL): an ulp at a trim edge may move COUNT_BUDGET
  nA = np.bincount(a[0], minlength=RECORD_RAYS)
  nB = np.bincount(b[0], minlength=RECORD_RAYS)
  same, rowsB = (nA == nB)[a[0]], (nA == nB)[b[0]]   # rows align by ray
  diff = np.zeros(int(same.sum()), bool)
  for x, y in zip(a[1:], b[1:]):
    d = np.abs(x[same].astype(float) - y[rowsB].astype(float))
    d = d.reshape(len(d), -1).max(axis=1)
    diff |= d > (RAW_ATOL if x.dtype.kind == 'f' else 0)
  moved = int((nA != nB).sum()) + len(np.unique(a[0][same][diff]))
  err = max((float(np.abs(x[same][~diff] - y[rowsB][~diff]).max(initial=0.))
             for x, y in zip(a[3:], b[3:])), default=0.)
  assert moved <= COUNT_BUDGET, (moved, err)
  emit(dict(phase='record-tracer', scene='lensMirror', rays=RECORD_RAYS,
            maxIntersections=maxI, bounces=bounces, segments=segments,
            ms=ms, msPerBounce=ms / bounces,
            raysPerSecond=RECORD_RAYS / (ms / 1e3),
            segmentsPerSecond=segments / (ms / 1e3),
            hitRows=len(a[0]), raysMovedVsRawKernel=moved,
            maxAbsErrVsRawKernel=err,
            seconds=time.perf_counter() - t0))
  return err


def example1Phase(tmp):
  '''examples/1 on the card (`examples/torch_1_source_and_detector.py`):
  the Monte-Carlo run storing the four StoreHit* fan columns, then the fan
  run; both through the raw-record kernel in its columns input mode, which
  the launch counts show.'''
  resetLaunchCounts()
  got = example1.main(device='cuda', path=os.path.join(tmp, 'example1'))
  launches = dict(cuda_trace.launchCounts)
  assert launches == onlyLaunches(traceRaw=EXAMPLE1_RAW_LAUNCHES), launches
  assert got['hits'] > 0.99 * 2e5, got
  assert 9.5 < got['rms'] < 11., got
  assert got['fanKeys'] == ['fanIndex', 'rayIndex', 'totalFanCount',
                            'totalRaysInFan'], got
  assert got['fans'] == [0.0, 1.0] and got['fanHits'] > 30, got
  emit(dict(phase='example1', launches=launches['traceRaw'], **got))
  return launches['traceRaw']


def example5Phase(tmp):
  '''examples/5 on the card (`examples/torch_5_visualization.py`): the
  draw run through the record tracer (no kernel launch), its drawn segments
  equal to the traced records' `totalSegments`, and the PLY export.'''
  segments = []
  trace = runner.tracer.trace

  def counted(*args, **kwargs):
    state, records = trace(*args, **kwargs)
    segments.append(tracer.totalSegments(records))
    return state, records

  resetLaunchCounts()
  runner.tracer.trace = counted
  try:
    drawn, ply, seconds = example5.main(device='cuda',
                                        out=os.path.join(tmp, 'example5'))
  finally:
    runner.tracer.trace = trace
  assert cuda_trace.launchCounts == onlyLaunches(), cuda_trace.launchCounts
  assert drawn.rayCount == 300 and segments == [drawn.segmentCount], \
      (drawn.rayCount, segments, drawn.segmentCount)
  emit(dict(phase='example5', rays=drawn.rayCount,
            segments=drawn.segmentCount, runSeconds=seconds,
            plyBytes=os.path.getsize(ply)))


def kernelHitBins(records, host, histSpec, atol):
  '''The recorded detector hits of raw records (a plane detector's one
  surface row), ray by ray, binned at their local (x, y) in float64:
  (ray, flat bin or -1 outside the bounds, near) numpy, near where the hit
  lies within `atol` of a bin edge (the bounds' edges too), where two
  traces that agree to `atol` may bin it apart.'''
  packed = hostArray(host['surfaces']['packed'])
  H, W = histSpec['bins']
  order = torch.nonzero(records['recordHit'].T)          # (ray, slot)
  sel = (order[:, 1], order[:, 0])
  ray = order[:, 0].cpu().numpy()
  hitElem = records['hitElem'][sel].cpu().numpy()
  points = records['point'][sel].cpu().numpy().astype(np.float64)
  flat = np.full(len(ray), -1, np.int64)
  near = np.zeros(len(ray), bool)
  for e, d in enumerate(histSpec['elemToDet']):
    m = hitElem == e
    if d < 0 or not m.any():
      continue
    rows = np.nonzero(packed[:, PACKED_ELEM] == e)[0]
    assert len(rows) == 1, 'a detector of one surface row'
    R = packed[rows[0], PACKED_ROT:PACKED_ROT + 9].reshape(3, 3)
    local = points[m] @ R.T + packed[rows[0], PACKED_OFF:PACKED_OFF + 3]
    x0, x1, y0, y1 = histSpec['bounds'][d]
    idx, close = [], np.zeros(int(m.sum()), bool)
    for axis, lo, hi, n in ((0, x0, x1, W), (1, y0, y1, H)):
      f = (local[:, axis] - lo) / (hi - lo) * n
      close |= np.abs(f - np.round(f)) * (hi - lo) / n < atol
      idx.append(np.where((f >= 0) & (f < n), np.floor(f), -1))
    ix, iy = idx
    flat[m] = np.where((ix >= 0) & (iy >= 0), (d * H + iy) * W + ix, -1)
    near[m] = close
  return ray, flat, near


def raysBinnedApart(a, b):
  '''The rays whose multisets of binned hits differ between two
  (ray, flat bin) lists (hits outside the bounds, bin -1, left out).'''
  keys = [r[f >= 0].astype(np.int64) * (1 << 32) + f[f >= 0]
          for r, f in (a, b)]
  sign = np.concatenate([np.ones(len(keys[0]), np.int64),
                         -np.ones(len(keys[1]), np.int64)])
  uniq, inv = np.unique(np.concatenate(keys), return_inverse=True)
  net = np.zeros(len(uniq), np.int64)
  np.add.at(net, inv.reshape(-1), sign)
  return np.unique(uniq[net != 0] >> 32)


def twinPhase():
  '''The fused step's twin (`fused.makeFusedStep`, plain PyTorch) against
  the kernels on the lens-and-mirror at TWIN_RAYS rays on the same columns,
  ray by ray: each hit the twin binned (its own run's bins, read at every
  bounce) against the raw-record kernel's rows binned in float64. A ray
  whose bins differ must have a hit within RAW_ATOL of a bin edge (the twin
  and the kernels trace with other float32 formulas, the record tracer's
  and the kernels', which agree ray by ray to RAW_ATOL: phase 13); at most
  COUNT_BUDGET rays that are not may change bins. Against K1's histograms:
  counters equal, power rtol POWER_RTOL where the counts agree, and no more
  rays changing bins than the twin's rays binned apart from the kernel's
  plus COUNT_BUDGET. Then its ms per step with its own draws, by CUDA
  events, and its segments per second.'''
  t0 = time.perf_counter()
  scene = benchmarks.buildLensMirrorScene()
  host, info = scene.compile(device=None)
  host['powerTol'] = 1e-6
  src = scene.lightSources()[0]
  maxI, maxL, distTol = 6, 1000., 1e-4
  histSpec = fused.makeHistogramSpec(host, info, bounds=(-60., 60., -60., 60.),
                                     bins=BINS)
  gen = torch.Generator(device=DEV)
  gen.manual_seed(17)
  cols = src.deviceColumnsGenerator(device=DEV)(gen, TWIN_RAYS)
  columns = torch.stack([cols[k] for k in cuda_trace._COLUMN_KEYS]) \
      .contiguous()
  tables = cuda_trace.buildTraceTables(host, histSpec, device=DEV)
  kernel = fused.initHistograms(histSpec, device=DEV)
  c1 = cuda_trace.traceHistogram(
      tables, kernel, TWIN_RAYS, maxI, maxL, distTol, columns=columns,
      hitSlots=cuda_trace.autoHitSlots(host, histSpec, maxI)).tolist()
  same = fused.makeFusedStep(host, lambda g, n, stratified=False: cols,
                             histSpec, TWIN_RAYS, maxI, maxL, distTol,
                             device=DEV)
  assert same.chunks == 1, same.chunks
  # the twin's own bins, ray by ray, read at each bounce of its run
  elemToDet, bounds = fused._binTensors(histSpec, DEV)
  bounce, twinHits = batch_tracer.bounceBatch, []

  def binned(*args, **kwargs):
    state, rec = bounce(*args, **kwargs)
    inside, flat = fused.hitBins(rec, elemToDet, bounds, histSpec['bins'])
    ray = torch.nonzero(inside)[:, 0]
    twinHits.append((ray, flat[ray]))
    return state, rec

  batch_tracer.bounceBatch = binned
  try:
    twin, c2 = same(0, fused.initHistograms(histSpec, device=DEV))
  finally:
    batch_tracer.bounceBatch = bounce
  twinRay, twinFlat = (torch.cat(x).cpu().numpy() for x in zip(*twinHits))
  slots = cuda_trace.autoHitSlots(host, histSpec, maxI)
  ring, _c = cuda_trace.traceRaw(tables, TWIN_RAYS, maxI, maxL, distTol,
                                 hitSlots=slots, columns=columns)
  kRay, kFlat, kNear = kernelHitBins(cuda_trace.recordsFromRing(ring), host,
                                     histSpec, RAW_ATOL)
  apart = raysBinnedApart((twinRay, twinFlat), (kRay, kFlat))
  nearRays = np.unique(kRay[kNear])
  far = np.setdiff1d(apart, nearRays)
  a, b = kernel['counts'].cpu().numpy(), twin['counts'].cpu().numpy()
  moved = int(np.abs(a - b).sum()) // 2
  eq = a == b
  pa, pb = kernel['power'].cpu().numpy()[eq], twin['power'].cpu().numpy()[eq]
  err = float(np.abs(pa - pb).max())
  gate = dict(hitsVsK1=c1[1], raysMovedVsK1=moved,
              raysBinnedApartFromRawKernel=len(apart),
              ofThemNearBinEdges=len(apart) - len(far),
              hitsNearBinEdges=int(kNear.sum()), maxAbsPowerErrVsK1=err)
  emit(dict(phase='fused-twin-gate', **gate))
  assert np.array_equal(np.bincount(twinFlat, minlength=b.size),
                        b.reshape(-1)), 'the per-ray bins are the twin\'s'
  assert c1[:2] == [int(c2['segments']), int(c2['hits'])], (c1, c2)
  assert len(far) <= COUNT_BUDGET, (far[:10], gate)
  assert moved <= len(apart) + COUNT_BUDGET, gate
  assert np.allclose(pb, pa, rtol=POWER_RTOL, atol=1e-6), err
  step = fused.makeFusedStep(host, src.deviceGenerator(device=DEV), histSpec,
                             TWIN_RAYS, maxI, maxL, distTol, device=DEV)
  hist = fused.initHistograms(histSpec, device=DEV)
  out = {}

  def run():
    out['c'] = step(gen, hist)[1]

  run()
  ms = cudaMs(run, TWIN_REPS)
  segments = int(out['c']['segments'])
  emit(dict(phase='fused-twin', scene='lensMirror', rays=TWIN_RAYS,
            maxIntersections=maxI, segments=segments, ms=ms,
            segmentsPerSecond=segments / (ms / 1e3),
            raysPerSecond=TWIN_RAYS / (ms / 1e3), **gate,
            seconds=time.perf_counter() - t0))
  return ms


def twinDishRunPhase(tmp):
  '''Histogram-first `runSimulation` of the 1800-triangle dish under
  sequential mode (stages [Dish], [Det]; `ineligibleReason` refuses it):
  the twin's route, no kernel launch, the snapshot's counts equal to the
  run's recorded hits, the share and r^2 against the JAX package's
  (`REF_DISH`: the same rays reach the dish first either way).'''
  scene = benchmarks.buildMeshDishScene(MESH_DISHES[1800],
                                        tmpdir=os.path.join(tmp, 'twin'))
  settings = scene.activeSimulationSettings()
  settings.SequentialMode = True
  settings.SequentialModeElements = [['Dish'], ['Det']]
  settings.RaysPerIteration = TWIN_DISH_RAYS
  settings.EndAfterIterations = TWIN_DISH_ITERATIONS
  settings.EndAfterRays = 'inf'
  reason = cuda_trace.ineligibleReason(scene.compile(device=None)[0])
  assert reason is not None
  progress = []
  resetLaunchCounts()
  t0 = time.perf_counter()
  runPath = simulation.runSimulation(
      scene, 'true', seed=14, recording='histogram', histBounds=MESH_BOUNDS,
      histBins=BINS, progressCallback=progress.append, device=DEV)
  seconds = time.perf_counter() - t0
  assert cuda_trace.launchCounts == onlyLaunches(), cuda_trace.launchCounts
  snap = results_store.loadHistogramSnapshots(runPath)['Src']['Det']
  hits = progress[-1]['totalRecordedHits']
  assert snap['counts'].sum() == hits > 0, (snap['counts'].sum(), hits)
  nRays = progress[-1]['totalTracedRays']
  assert nRays == TWIN_DISH_RAYS * TWIN_DISH_ITERATIONS, nRays
  stats = helpers.scatterStats(dict(counts=snap['counts'][None],
                                    power=snap['power'][None]), hits, nRays,
                               bounds=MESH_BOUNDS)
  checkPathStats(MESH_PATH, 'twin-histogram', stats, nRays)
  emit(dict(phase='twin-dish-run', triangles=1800, refused=reason,
            raysPerIteration=TWIN_DISH_RAYS,
            iterations=TWIN_DISH_ITERATIONS, hits=hits, seconds=seconds,
            raysPerSecond=nRays / seconds))


def twinSweepPhase(tmp):
  '''`evaluateBatched` of TWIN_SWEEP variants (the lens's index) of the
  analysis scene with a dispersive detector index no in-kernel polynomial
  fits: every variant through the twin, no kernel launch; two calls, the
  first with the sources' compile.'''
  V, n = TWIN_SWEEP
  scene = helpers.buildDocScene(helpers.torchNs(), os.path.join(tmp, 'doc'))
  scene.getObject('Detector').RefractiveIndex = \
      '1.5 + 0.01*sin(wavelength/10)'
  sweeper = parameter_sweeper.ParameterSweeper(
      lambda sc: dict(n=(sc.getObject('Lens'), 'RefractiveIndex')),
      scene=scene, device=DEV)
  sets = [dict(n=float(v)) for v in np.linspace(1.4, 1.6, V)]
  resetLaunchCounts()
  walls = []
  for _ in range(2):
    t0 = time.perf_counter()
    m = sweeper.evaluateBatched(sets, helpers.spotMetric, raysPerScene=n)
    walls.append(time.perf_counter() - t0)
  assert cuda_trace.launchCounts == onlyLaunches(), cuda_trace.launchCounts
  assert sweeper.lastBatchedRoute == 'perVariantTracer', \
      sweeper.lastBatchedRoute
  assert m.shape == (V,) and np.isfinite(m).all() and m.max() < 1e9, m
  emit(dict(phase='twin-sweep', variants=V, raysPerVariant=n,
            route=sweeper.lastBatchedRoute, firstCallSeconds=walls[0],
            steadyCallSeconds=walls[1], argmin=int(np.argmin(m)),
            metrics=m.tolist()))


def example6Phase():
  '''examples/6 on the card (`examples/torch_6_gradient_optimization.py`):
  no kernel launch; the rms spot shrinks at least 10x; the best screen
  offset within EXAMPLE6_DZ_TOL of the CPU run's; the gradient at the start
  within 2 % of central differences (step 1e-3 mm).'''
  resetLaunchCounts()
  got = example6.main(device='cuda')
  assert cuda_trace.launchCounts == onlyLaunches(), cuda_trace.launchCounts
  assert got['vBest'] * 10 <= got['v0'], got
  assert abs(got['dz'] - EXAMPLE6_CPU_DZ) <= EXAMPLE6_DZ_TOL, got['dz']
  lossGrad, _batch = example6.makeLoss('cuda')
  eps = 1e-3
  value = lambda p: float(lossGrad(torch.tensor([p]))[0])
  fd = (value(eps) - value(-eps)) / (2 * eps)
  grad = float(lossGrad(torch.zeros(1))[1][0])
  assert abs(fd - grad) <= 2e-2 * abs(fd), (fd, grad)
  emit(dict(phase='example6', v0=got['v0'], vBest=got['vBest'],
            dz=got['dz'], cpuDz=EXAMPLE6_CPU_DZ, grad0=grad, fd0=fd,
            seconds=got['seconds']))


def phase14(tmp):
  '''The fused step's twin and differentiable design (see the module
  docstring); returns the twin's ms per step.'''
  t14 = time.perf_counter()
  ms = twinPhase()
  twinDishRunPhase(tmp)
  twinSweepPhase(tmp)
  example6Phase()
  emit(dict(phase='twin-total', seconds=time.perf_counter() - t14))
  return ms


def cylinderRays(ray, elem, point, n):
  """Which of `n` rays have a K4 row on a cylinder of the lens-and-mirror
  projects: the lens barrel (element 0 at r = the aperture) or, of the
  project's thin Part::Cylinder mirror, its edge band and back disc
  (element 1 off the plane of its front disc)."""
  r = np.hypot(point[:, 0], point[:, 1])
  barrel = (elem == 0) & (np.abs(r - fcstd_fixtures.LENS_APERTURE) < 1e-3)
  inv = np.linalg.inv(fcstd_fixtures.MIRROR_AT)
  edge = (elem == 1) & (np.abs(point @ inv[2, :3] + inv[2, 3]) > 1e-3)
  out = np.zeros(n, bool)
  out[ray[barrel]] = True
  out[ray[edge]] = True
  return out, np.unique(ray[barrel]).size, np.unique(ray[edge]).size


def projectRowsPhase(ingested, built, n, seed=15):
  """K4's rows (every element recording: the scenes' groups are switched
  to RecordHits) on the ingested lens-and-mirror project against its rows
  on `buildLensMirrorScene` on the same `n` columns of the project's
  source: per ray the same elements, every hit point within
  PROJECT_ROWS_ATOL, but for the rays that meet a cylinder the scenes draw
  differently (counted) and COUNT_BUDGET others."""
  src = ingested.lightSources()[0]
  gen = torch.Generator(device=DEV)
  gen.manual_seed(seed)
  cols, _meta = src.deviceGenerator(device=DEV)(gen, n)
  columns = torch.stack([cols[k] for k in cuda_trace._COLUMN_KEYS])
  rows = []
  for scene in (ingested, built):
    for group in scene.opticalObjects():
      group.RecordHits = True
    host, info = scene.compile(device=None)
    histSpec = fused.makeHistogramSpec(host, info)
    tables = cuda_trace.buildTraceTables(host, histSpec, device=DEV)
    slots = cuda_trace.autoHitSlots(host, histSpec, 6)
    ring, _c = cuda_trace.traceRaw(tables, n, 6, 1000., 1e-4,
                                   hitSlots=slots, columns=columns)
    ray, elem, _ent, point, _d, _p = hitRowsByRay(
        cuda_trace.recordsFromRing(ring))
    rows.append((ray, elem, point.astype(np.float64)))
  (rA, eA, pA), (rB, eB, pB) = rows
  nA, nB = np.bincount(rA, minlength=n), np.bincount(rB, minlength=n)
  same = nA == nB
  sA, sB = same[rA], same[rB]
  d = np.abs(pA[sA] - pB[sB]).max(axis=1)
  bad = (eA[sA] != eB[sB]) | (d > PROJECT_ROWS_ATOL)
  apart = ~same
  apart[rA[sA][bad]] = True
  cylA, barrelA, edgeA = cylinderRays(rA, eA, pA, n)
  cylB, barrelB, _edgeB = cylinderRays(rB, eB, pB, n)
  others = apart & ~(cylA | cylB)
  kept = ~apart[rA[sA]]
  err = float(d[kept].max(initial=0.))
  detected = int(np.unique(rA[eA == 2]).size)
  out = dict(rays=n, detectedRays=detected, rowsIngested=len(rA),
             rowsBuilt=len(rB), raysApart=int(apart.sum()),
             barrelRaysIngested=barrelA, barrelRaysBuilt=barrelB,
             mirrorEdgeRays=edgeA, othersApart=int(others.sum()),
             maxAbsErrMm=err)
  emit(dict(phase='project-rows', **out))
  if int(others.sum()) > COUNT_BUDGET or not err <= PROJECT_ROWS_ATOL \
      or detected < 0.9 * n:
    raise AssertionError(f'ingested lens project against the built scene: '
                         f'{out}')
  return out


def projectTimings(scenes):
  """K1 at N_MAIN and K4 at N_RAW_ITERATION rays (seed mode) on each of
  `scenes` ({label: scene}) by CUDA events, with the segments of a launch
  and their bound (`boundMs`)."""
  out = {}
  for label, scene in scenes.items():
    sceneNp, histSpec, tables = buildTables(scene, PROJECT_BOUNDS, BINS, 6)
    slots = cuda_trace.autoHitSlots(sceneNp, histSpec, 6)
    kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4,
              powerTol=1e-6, hitSlots=slots,
              strataTile=cuda_trace.DEFAULT_STRATA_TILE)
    hist = fused.initHistograms(histSpec, device=DEV)
    seeds = iter(range(100, 10 ** 6))
    k1 = lambda: cuda_trace.traceHistogram(tables, hist, N_MAIN,
                                           seed=next(seeds), **kw)
    k4 = lambda: cuda_trace.traceRaw(tables, N_RAW_ITERATION,
                                     seed=next(seeds), **kw)
    c1, (_ring, c4) = k1(), k4()
    k1Ms, k4Ms = cudaMs(k1, PROJECT_REPS), cudaMs(k4, PROJECT_REPS)
    stats = None
    if tables.get('cullOff', -1) >= 0:
      # the segments each bounce traces, for the culled bound (a plain run)
      stats = {}
      us, strataTile, cols, _s = samplerInputs(tables, N_RAW_ITERATION, 9, 6)
      cuda_trace.traceHistogramPlain(
          tables, fused.initHistograms(histSpec, device=DEV), cols,
          cullStats=stats, **{k: v for k, v in kw.items()
                              if k != 'strataTile'})
    b1 = boundMs(tables, int(c1[0]), N_MAIN, 2 * hist['power'].numel() * 8,
                 cullStats=stats)
    b4 = boundMs(tables, int(c4[0]), N_RAW_ITERATION,
                 9 * slots * N_RAW_ITERATION * 4, cullStats=stats)
    out[label] = dict(surfaces=int(tables['nSurf']),
                      culled=stats is not None, k1Ms=k1Ms,
                      k1BoundMs=max(b1[:2]), k1Segments=int(c1[0]),
                      k4Ms=k4Ms, k4BoundMs=max(b4[:2]),
                      k4Segments=int(c4[0]))
  emit(dict(phase='project-kernels', rays=dict(k1=N_MAIN,
                                               k4=N_RAW_ITERATION), **out))
  return out


def projectCliPhase(path):
  """`python -m optics_design_workbench_tpu_torch run <project> true
  --recording histogram` in a process of its own (verbose, so that it
  names the route it takes): exit code 0, the kernel route, the project's
  PROJECT_CLI_ITERATIONS iterations of N_MAIN rays traced, the snapshot's
  counts equal to the run's recorded hits."""
  t0 = time.perf_counter()
  env = dict(os.environ, OPTICS_TPU_VERBOSE='1',
             PYTHONPATH=os.pathsep.join(
                 [HERE] + [p for p in os.environ.get('PYTHONPATH', '')
                           .split(os.pathsep) if p]))
  out = subprocess.run(
      [sys.executable, '-m', 'optics_design_workbench_tpu_torch', 'run',
       path, 'true', '--recording', 'histogram', '--seed', '4'],
      capture_output=True, text=True, env=env, timeout=600)
  seconds = time.perf_counter() - t0
  if out.returncode != 0:
    raise AssertionError(f'the command line failed ({out.returncode}): '
                         f'{out.stderr[-3000:]}')
  runPath = out.stdout.strip().splitlines()[-1]
  route = 'Source: taking the kernel route' in out.stderr
  last = RawFolder(runPath).progress()
  snap = results_store.loadHistogramSnapshots(runPath)['Source']['Detector']
  counts = float(snap['counts'].astype(np.float64).sum())
  got = dict(seconds=seconds, kernelRoute=route,
             iterations=last['totalIterations'],
             tracedRays=last['totalTracedRays'], histCounts=counts,
             recordedHits=last['totalRecordedHits'])
  emit(dict(phase='project-cli', **got))
  if not route or last['totalTracedRays'] != PROJECT_CLI_ITERATIONS * N_MAIN \
      or counts != last['totalRecordedHits'] \
      or counts < 0.9 * PROJECT_CLI_ITERATIONS * N_MAIN:
    raise AssertionError(f'the command line\'s run: {got}')
  return got


def phase15(tmp):
  """Project files: ingest, the kernels on ingested scenes, the command
  line (see the module docstring)."""
  t15 = time.perf_counter()
  folder = os.path.join(tmp, 'projects')
  os.makedirs(folder)
  lensPath = fcstd_fixtures.lensMirrorProject(
      folder, raysPerIteration=N_MAIN,
      endAfterIterations=str(PROJECT_CLI_ITERATIONS))
  slotPath = fcstd_fixtures.slotPlateProject(folder)
  scenes, loadMs = {}, {}
  for label, path in (('lens', lensPath), ('slot', slotPath)):
    t0 = time.perf_counter()
    scenes[label] = loadFCStd(path)
    loadMs[label] = (time.perf_counter() - t0) * 1e3
  emit(dict(phase='project-load', loadFCStdMs=loadMs,
            surfaces={k: sum(len(g.surfaces) for g in s.opticalObjects())
                      for k, s in scenes.items()}))
  lens, slot = scenes['lens'], scenes['slot']
  worst = dict(traceHistogram=compareWithPlain(
      'project-lens', lens, PROJECT_BOUNDS, 6, N_MAIN, BINS))
  w = compareRingsWithPlain('project-lens', lens, PROJECT_BOUNDS, 6,
                            N_RAW_ITERATION, BINS)
  _sceneNp, _h, slotTables = buildTables(slot, SLOT_BOUNDS, BINS, 4)
  if not slotTables['geom'] or not any(r.get('holePrims')
                                       for r in slotTables['surfRows']):
    raise AssertionError('the slotted plate left the GEOM instance or its '
                         'trim primitives')
  worst['traceHistogram'] = max(worst['traceHistogram'], compareWithPlain(
      'project-slot', slot, SLOT_BOUNDS, 4, N_RAW_ITERATION, BINS, budget=0))
  ws = compareRingsWithPlain('project-slot', slot, SLOT_BOUNDS, 4,
                             N_RAW_ITERATION, BINS, budget=0, rawAtol=0.)
  worst.update({k: max(w[k], ws[k]) for k in w})
  built = benchmarks.buildLensMirrorScene()
  timings = projectTimings({'ingested': lens, 'built': built})
  rows = projectRowsPhase(lens, built, N_RAW_ITERATION)
  cli = projectCliPhase(lensPath)
  emit(dict(phase='project-total', seconds=time.perf_counter() - t15,
            loadFCStdMs=loadMs, maxAbsErr=worst,
            rowsMaxAbsErrMm=rows['maxAbsErrMm'], cliSeconds=cli['seconds'],
            kernels=timings))


def main():
  if not torch.cuda.is_available():
    sys.exit('chip_smoke.py needs a CUDA device: torch.cuda.is_available() '
             'is False')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip() \
      .splitlines()[0]

  # ---- phase 1: the card and the build ----
  _libs, info = _build.buildKernels()
  emit(dict(phase='card', nvidiaSmi=smi, torch=torch.__version__,
            cuda=torch.version.cuda, buildSeconds=info['seconds'],
            buildCached=info['cached'],
            instances=len(registerCounts(info['log']))))

  # ---- phase 2: each kernel against its plain version on the card ----
  ns = helpers.torchNs()
  lens, lensBounds, lensMaxI = helpers.buildBench(ns, 'lensMirror')
  worst = compareWithPlain('lensMirror', lens, lensBounds, lensMaxI, N_MAIN,
                           BINS)
  for name in ('tir', 'absorbing', 'collimated'):
    scene, bounds, maxI = helpers.SCENES_BY_NAME[name](ns)
    worst = max(worst, compareWithPlain(name, scene, bounds, maxI, N_SMALL,
                                        BINS))
  # the ring's overflow rule: one slot where two passes happen
  scene, bounds, maxI = helpers.buildAbsorbingScene(ns)
  worst = max(worst, compareWithPlain('absorbing-1slot', scene, bounds, maxI,
                                      N_SMALL, BINS, hitSlots=1))
  # the tent-table marginal of the sampler
  scene, bounds, maxI = helpers.buildBench(ns, 'sourceDetector')
  worst = max(worst, compareWithPlain('sourceDetector-tent', scene, bounds,
                                      maxI, N_SMALL, BINS, tent=True))
  compareSeedMode(lens, lensBounds, lensMaxI, N_MAIN, BINS)

  # the per-ray kernels: one slot at full width, then two slots, one slot
  # that overflows, and four live slots
  worstRing = compareRingsWithPlain('lensMirror', lens, lensBounds, lensMaxI,
                                    N_MAIN, BINS)
  for label, name, slots in (('absorbing', 'absorbing', None),
                             ('absorbing-1slot', 'absorbing', 1),
                             ('stacked', 'stacked', None)):
    scene, bounds, maxI = helpers.SCENES_BY_NAME[name](ns)
    w = compareRingsWithPlain(label, scene, bounds, maxI, N_SMALL, BINS,
                              hitSlots=slots)
    worstRing = {k: max(v, w[k]) for k, v in worstRing.items()}

  # the sweep kernel: a surface sweep and a source-placement sweep against
  # the plain version, then seed mode against the histogram kernel
  scenes, bounds, maxI = helpers.sweepVariants(ns, 'radius')
  worstSweep = compareSweepWithPlain('radius', scenes, bounds, maxI, N_SMALL,
                                     columnsToo=True)
  scenes, bounds, maxI = helpers.sweepVariants(ns, 'placement')
  worstSweep = max(worstSweep, compareSweepWithPlain(
      'placement', scenes, bounds, maxI, N_SMALL, columnsToo=False))
  compareSweepWithSingle(*SWEEPS[0])
  # ... and where the variant groups meet a shorter last group, more room
  # than variants, variants with draws of their own and ray columns
  worstSweep = max(worstSweep, variantGroupChecks())

  # the same gates on the scenes of gratings, dispersion, sequential mode
  # and per-source masks, and on the spectrometer
  worstB4 = b4KernelChecks()
  # ... on the surface-source scenes; the surface sampler's own draws by
  # distribution; and bins that already hold 2**24 (ROADMAP C.1)
  worstSurface = surfaceKernelChecks()
  surfaceSeedPhase(N_MAIN)
  fullBinsPhase()
  # ... and where the rays pile up (B11)
  worstB11 = b11Phase()
  worst = max(worst, worstB11['traceHistogram'])
  worstSweep = max(worstSweep, worstB11['traceSweep'])

  # ---- phase 3: the fused step, binned in the kernel and outside it ----
  k1 = fusedStepPhase('default')
  k2 = fusedStepPhase('highest')

  # ---- phase 4: the recording run ----
  tmp = tempfile.mkdtemp(prefix='odw_chip_smoke_')
  try:
    rawLaunches, raw = recordingRunPhases(tmp)
    # ---- phase 5: the parameter sweep ----
    for V, n in SWEEPS:
      sweep = sweepPathPhase(V, n)
      worstSweep = max(worstSweep, sweep['maxAbsErr'])
    sweepOptimizePhase(tmp)
    # ---- phase 6: the grating spectrometer ----
    spectro = dict(traceHistogram=spectroStepPhase('default'),
                   traceBins=spectroStepPhase('highest'))
    evanescentPhase()
    spectro['traceRaw'] = spectroRunPhases(tmp)
    spectro['traceSweep'] = spectroSweepPhase()
    # ---- phase 7: the surface source ----
    surface = dict(traceHistogram=surfaceStepPhase('default'),
                   traceBins=surfaceStepPhase('highest'))
    surfRun = surfaceRunPhases(tmp)
    surface['traceRaw'] = dict(surfRun['raw'],
                               launches=surfRun['rawLaunches'])
    # ---- phase 8: stochastic scatter ----
    t8 = time.perf_counter()
    scenes = scatterScenes()
    worstScatter = scatterKernelChecks(scenes)
    worstMany = manySurfacesPhase()
    scatter = {}
    for wrapper, precision in (('traceHistogram', 'default'),
                               ('traceBins', 'highest')):
      byScene = {name: scatterStepPhase(name, scene, precision)
                 for name, scene in scenes.items()}
      scatter[wrapper] = dict(byScene['diffuse'], byScene={
          name: r['ms'] for name, r in byScene.items()})
    scatter['traceRaw'] = scatterRunPhases(tmp)
    scatter['traceSweep'] = scatterSweepPhase()
    emit(dict(phase='scatter-total', seconds=time.perf_counter() - t8))
    # ---- phase 9: the other surface kinds and trims ----
    geom = geomPhase(tmp, info['log'])
    # ---- phase 10: triangle meshes ----
    mesh = meshPhase(tmp)
    # ---- phase 11: the surface table ----
    wall = wallPhase(tmp)
    # ---- phase 12: the per-bounce surface culls ----
    cull = b12Phase()
    # ---- phase 13: the record tracer, examples/1 and examples/5 ----
    t13 = time.perf_counter()
    recordErr = recordTracerPhase()
    example1Launches = example1Phase(tmp)
    example5Phase(tmp)
    emit(dict(phase='record-total', seconds=time.perf_counter() - t13))
    # ---- phase 14: the fused step's twin and differentiable design ----
    phase14(tmp)
    # ---- phase 15: project files ----
    phase15(tmp)
  finally:
    shutil.rmtree(tmp, ignore_errors=True)

  # the sweep kernel's bound at the design-study size
  V, n = SWEEPS[-1]
  plainSweepMs = sweep['plainMs']
  sweepBounds = boundMs(sweep['tables'], sweep['segments'], V * n,
                        2 * sweep['histBytes'])
  emit(dict(phase='sweep-kernel-bound', variants=V, raysPerVariant=n,
            variantGroup=sweep['launch']['variantGroup'],
            sharedDraws=sweep['launch']['sharedDraws'],
            kernelMs=sweep['ms'], plainMs=plainSweepMs,
            boundOpsMs=sweepBounds[0], boundBytesMs=sweepBounds[1],
            **sweepBounds[2]))

  # the raw kernel's plain version and bound at the full-width step
  tables = raw['tables']
  gen = torch.Generator(device=DEV)
  gen.manual_seed(8)
  strataTile = cuda_trace.DEFAULT_STRATA_TILE
  strata = cuda_trace.tileStrata(N_MAIN, strataTile)
  kw = dict(maxIntersections=6, maxRayLength=1000., distTol=1e-4,
            powerTol=1e-6, hitSlots=raw['hitSlots'])

  def plainRaw():
    us = torch.rand((2, N_MAIN), generator=gen, device=DEV,
                    dtype=torch.float32)
    cols = cuda_trace.sampleRaysPlain(tables, us[0], us[1], strata,
                                      strataTile)
    cuda_trace.traceRawPlain(tables, cols, **kw)

  plainRaw()
  plainRawMs = cudaMs(plainRaw, 2)
  rawBounds = boundMs(tables, raw['segments'], N_MAIN,
                      9 * raw['hitSlots'] * N_MAIN * 4)
  emit(dict(phase='raw-kernel-bound', rays=N_MAIN, kernelMs=raw['kernelMs'],
            plainMs=plainRawMs, boundOpsMs=rawBounds[0],
            boundBytesMs=rawBounds[1], **rawBounds[2]))

  for name, entry in spectro.items():
    entry['err'] = max(entry.get('err', 0.), worstB4[name])
  for name, entry in surface.items():
    entry['err'] = worstSurface[name]
  for name, entry in scatter.items():
    entry['err'] = max(worstScatter[name], worstMany.get(name, 0.))
  emit(dict(phase='total', seconds=time.perf_counter() - T0))
  emit(dict(kernels=[
      kernelEntry('traceHistogram', 'trace_kernel.cu', 2776, k1['launches'],
                  worst, k1['kernelMs'], k1['plainMs'], k1['bounds'],
                  spectro['traceHistogram'], surface['traceHistogram'],
                  scatter['traceHistogram'], geom['traceHistogram'],
                  mesh['traceHistogram'], wall['traceHistogram'],
                  cull['traceHistogram']),
      dict(kernelEntry('traceRaw', 'trace_raw_kernel.cu', 3226, rawLaunches,
                       worstRing['traceRaw'], raw['kernelMs'], plainRawMs,
                       rawBounds,
                       spectro['traceRaw'], surface['traceRaw'],
                       scatter['traceRaw'], geom['traceRaw'],
                       mesh['traceRaw'], wall['traceRaw'],
                       cull['traceRaw']),
           example1_launches=example1Launches,
           record_tracer_max_abs_err=recordErr),
      kernelEntry('traceBins', 'trace_bins_kernel.cu', 2789, k2['launches'],
                  worstRing['traceBins'], k2['kernelMs'], k2['plainMs'],
                  k2['bounds'], spectro['traceBins'], surface['traceBins'],
                  scatter['traceBins'], geom['traceBins'],
                  mesh['traceBins'], wall['traceBins'], cull['traceBins']),
      dict(kernelEntry('traceSweep', 'trace_sweep_kernel.cu', 3067,
                       sweep['launches'], worstSweep, sweep['ms'],
                       plainSweepMs, sweepBounds, spectro['traceSweep'],
                       None, scatter['traceSweep'], geom['traceSweep'],
                       mesh['traceSweep'], wall['traceSweep']),
           variant_group=sweep['launch']['variantGroup'],
           shared_draws=sweep['launch']['sharedDraws'],
           spectrometer_variant_group=spectro['traceSweep']['launch'][
               'variantGroup'])]))
  print(smi, flush=True)
  print(json.dumps(dict(ok=True, device=dict(
      platform='gpu', kind=torch.cuda.get_device_name(0),
      count=torch.cuda.device_count()))), flush=True)


if __name__ == '__main__':
  main()
