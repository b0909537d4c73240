'''
Parameter sweeps and geometry optimization (counterpart of the JAX package's
jupyter_utils/parameter_sweeper.py; line numbers below are the reference's
jupyter_utils/parameter_sweeper.py):

  * `ParameterSweeper(getParametersFunc)` mapping names to parameter nodes,
    `set()` with bounds clamping and read-back verification (:382-452),
    `MetaParameter` derived-parameter families (:170-226),
  * `sweep(parameterValues, minimizeFunc)`: one simulation per combination,
  * `optimize(minimizeFunc, parameters, ...)`: normalize bounded parameters
    to [0,1], run scipy minimize / dual_annealing / differential_evolution,
    exceptions become penalty 1e99 so the minimizer routes around failures,
    history ring buffer + periodic dumps, best parameters restored at exit
    (:757-918),
  * `optimizeStrategyStep([...])`: several optimize configs with arg-dict
    inheritance, run one after the other in-process with the global best
    surviving into each next strategy,
  * `evaluateBatched`: an extra leading scene-parameter axis — N geometry
    variants compiled host-side into stacked kernel tables and traced in ONE
    launch of the sweep kernel (ops/cuda_trace.traceSweep), the same rays in
    every variant; the examples/3 lens-radius sweep runs all candidates in
    one launch and one fetch.

The sweeper takes `device=` (default 'cuda'; 'cpu' runs the kernels' plain
PyTorch versions) and hands it to `runSimulation` and to the sweep step.

Not ported, and refused by name: `optimizeStrategyStep(parallel=True)` — the
reference's concurrent OS worker processes need the command line and
parallel/multiprocess.py (ROADMAP A.10); `parallel='auto'` runs the
strategies in-process.
'''

import math
import pickle
import time

import numpy as np

from .. import KernelError, resolveDevice, simulation
from ..models.point_source import PointSource
from ..ops import cuda_trace
from ..tracing import fused
from ..utils import io
from .document import RawFolder, saveScene
from .retries import retryOnError

PENALTY = 1e99
# what `optimize` never scores as a penalty
_NOT_A_DESIGN_FAULT = (KernelError, NotImplementedError)


def _sourceSignature(src, mode):
  '''Byte signature of a source for the batched-sweep sampler cache.
  mode='full' covers everything (identical sources -> one sampler spec as it
  is); mode='geom' excludes placement and wavelength (identical SAMPLING,
  per-variant geometry -> one spec whose placement and wavelength are
  replaced variant by variant). The read-only compile-mode echo
  `RandomNumberGeneratorMode` is left out: it changes when the source first
  compiles, which says nothing about what it emits.'''
  d = dict(src.propertiesDict())
  d.pop('RandomNumberGeneratorMode', None)
  if mode == 'geom':
    d.pop('Wavelength', None)
  placement = (None if mode == 'geom'
               else np.asarray(src.placement, float).tobytes())
  payload = (type(src).__module__ + '.' + type(src).__qualname__,
             sorted(d.items()), placement)
  return pickle.dumps(payload, protocol=2)


def _sourceGeomRow(src):
  '''(13,) float32 row [R row-major (9), offset (3), wavelength]: the part
  of a point source's sampler block that a 'geom' sweep replaces per
  variant (`cuda_trace.makeSweepStep`, `geomRows`).'''
  P = np.asarray(src.placement, float)
  return np.concatenate([P[:3, :3].reshape(9), P[:3, 3],
                         [float(src.Wavelength)]]).astype(np.float32)


def _hostHistSpec(hostScene, info, bounds, bins):
  '''(elemToDet, bounds) of `tracing.fused.makeHistogramSpec` as numpy: what
  must be equal across the variants of a batched sweep.'''
  spec = fused.makeHistogramSpec(hostScene, info, bounds=bounds, bins=bins)
  return spec['elemToDet'], spec['bounds']


class Parameter:
  '''A settable scene parameter: either (obj, attributeName) or explicit
  getter/setter callables. Optional bounds clamp set().'''

  def __init__(self, obj=None, attr=None, getter=None, setter=None,
               bounds=None):
    if obj is not None and attr is not None:
      self._get = lambda: getattr(obj, attr)
      self._set = lambda v: setattr(obj, attr, v)
    elif getter is not None and setter is not None:
      self._get, self._set = getter, setter
    else:
      raise ValueError('pass (obj, attr) or (getter, setter)')
    self.bounds = bounds

  def get(self):
    return self._get()

  def set(self, value):
    if self.bounds is not None:
      lo, hi = self.bounds
      value = min(max(value, lo), hi)
    self._set(value)
    return value


class MetaParameter:
  '''A family of derived parameters applied only once ALL siblings have
  been assigned (reference: parameter_sweeper.py:170-226). `apply` receives
  the dict of sibling values.'''

  def __init__(self, names, apply):
    self.names = list(names)
    self.apply = apply
    self._pending = {}

  def set(self, name, value):
    self._pending[name] = value
    if set(self._pending) >= set(self.names):
      self.apply(dict(self._pending))
      self._pending = {}
      return True
    return False


def _asParameter(node):
  if isinstance(node, Parameter):
    return node
  if isinstance(node, tuple) and len(node) == 2 and callable(node[0]):
    return Parameter(getter=node[0], setter=node[1])
  if isinstance(node, tuple) and len(node) == 2:
    return Parameter(obj=node[0], attr=node[1])
  raise TypeError(f'cannot interpret parameter node {node!r}')


class ParameterSweeper:

  def __init__(self, getParametersFunc=None, doc=None, scene=None,
               device='cuda'):
    self.doc = doc
    self.scene = scene if scene is not None else (doc.scene if doc else None)
    self.device = device
    self._getParametersFunc = getParametersFunc
    self._parameters = None
    self._metaParameters = {}
    self.history = []
    self._bestPenalty = math.inf
    self._bestParams = None
    # evaluateBatched: sampler specs by source signature, sweep steps by
    # sweep shape, and the route the last call took ('sweep': one launch of
    # the sweep kernel; 'perVariant': one launch of the single-scene
    # histogram kernel per variant)
    self._ebSamplerCache = {}
    self._ebStepCache = {}
    self.lastBatchedRoute = None

  # ------------------------------------------------------------- parameters

  def parameters(self):
    if self._parameters is None:
      if self._getParametersFunc is None:
        raise ValueError('no getParametersFunc given')
      raw = self._getParametersFunc(self.doc if self.doc is not None
                                    else self.scene)
      self._parameters = {}
      for name, node in raw.items():
        if isinstance(node, MetaParameter):
          self._metaParameters[name] = node
        else:
          self._parameters[name] = _asParameter(node)
    return self._parameters

  def parameterNames(self):
    return list(self.parameters().keys()) + list(self._metaParameters)

  def get(self, name):
    return self.parameters()[name].get()

  def set(self, _verify=True, **kwargs):
    '''Set parameters with bounds clamping and read-back verification
    (reference: parameter_sweeper.py:382-432).'''
    params = self.parameters()
    applied = {}
    for name, value in kwargs.items():
      if name in self._metaParameters:
        self._metaParameters[name].set(name, value)
        applied[name] = value
        continue
      p = params[name]
      clamped = p.set(value)
      if _verify:
        back = p.get()
        try:
          if not np.isclose(float(back), float(clamped), rtol=1e-9,
                            atol=1e-12):
            io.warn(f'read-back of parameter {name} gives {back}, expected '
                    f'{clamped}')
        except (TypeError, ValueError):
          pass
      applied[name] = clamped
    return applied

  def setBounds(self, **kwargs):
    params = self.parameters()
    for name, bounds in kwargs.items():
      params[name].bounds = tuple(bounds)

  def bounds(self, name=None):
    params = self.parameters()
    if name is not None:
      return params[name].bounds
    return {n: p.bounds for n, p in params.items()}

  # --------------------------------------------------------------- sweeping

  def _simulate(self, simulationMode, seed, runKwargs):
    runKwargs = dict(runKwargs)
    runKwargs.setdefault('device', self.device)
    return simulation.runSimulation(self.scene, simulationMode, seed=seed,
                                    **runKwargs)

  def sweep(self, parameterValues, minimizeFunc, simulationMode='true',
            seed=None, prepareSimulation=None, **runKwargs):
    '''Grid sweep: set each parameter combination, simulate, evaluate.
    `parameterValues` is {name: listOfValues}; all lists must have equal
    length (zipped, not cartesian). Returns list of (paramsDict, penalty,
    runPath).'''
    names = list(parameterValues)
    lists = [list(parameterValues[n]) for n in names]
    if len({len(l) for l in lists}) != 1:
      raise ValueError('all parameter value lists must have equal length')
    results = []
    for i in range(len(lists[0])):
      params = {n: l[i] for n, l in zip(names, lists)}
      self.set(**params)
      if prepareSimulation is not None:
        prepareSimulation()
      runPath = self._simulate(simulationMode, seed, runKwargs)
      penalty = minimizeFunc(RawFolder(runPath))
      results.append((params, penalty, runPath))
      self._recordHistory(params, penalty)
    return results

  # ------------------------------------------------------------ optimization

  def _recordHistory(self, params, penalty):
    self.history.append(dict(params=dict(params), penalty=float(penalty),
                             time=time.time()))
    if penalty < self._bestPenalty:
      self._bestPenalty = penalty
      self._bestParams = dict(params)

  def optimize(self, minimizeFunc, parameters, simulationMode='true',
               method='Nelder-Mead', maxIterations=100, seed=None,
               prepareSimulation=None, retries=2, historyDumpPath=None,
               restoreBestAtExit=True, autosaveBestTo=None, **runKwargs):
    '''Minimize `minimizeFunc(rawFolder)` over the named parameters
    (reference: parameter_sweeper.py:757-918). Bounded parameters are
    normalized to [0, 1] for the optimizer; failures score PENALTY so the
    minimizer routes around crashes; the best parameters are restored (and
    optionally autosaved) at exit. A kernel that does not build or launch
    (KernelError) and a scene that is not ported (NotImplementedError) are
    no design's fault: they raise.'''
    import scipy.optimize
    params = self.parameters()
    names = list(parameters)
    boundsList = []
    for n in names:
      b = params[n].bounds
      if b is None:
        raise ValueError(f'parameter {n} needs bounds for optimization '
                         f'(call setBounds)')
      boundsList.append(tuple(b))

    def denorm(x):
      return {n: lo + xi * (hi - lo)
              for n, xi, (lo, hi) in zip(names, x, boundsList)}

    @retryOnError(subject='simulate+evaluate', maxRetries=retries,
                  fatal=_NOT_A_DESIGN_FAULT)
    def _simulateAndEvaluate(paramDict):
      if prepareSimulation is not None:
        prepareSimulation()
      self.set(**paramDict)
      runPath = self._simulate(simulationMode, seed, runKwargs)
      return float(minimizeFunc(RawFolder(runPath)))

    def objective(x):
      paramDict = denorm(np.clip(np.asarray(x, float), 0, 1))
      try:
        penalty = _simulateAndEvaluate(paramDict)
      except _NOT_A_DESIGN_FAULT:
        raise
      except Exception as e:
        io.warn(f'optimization step failed, assigning penalty {PENALTY:g}: '
                f'{e}')
        penalty = PENALTY
      self._recordHistory(paramDict, penalty)
      if historyDumpPath:
        try:
          io.atomicWrite(historyDumpPath, pickle.dumps(self.history))
        except Exception:
          pass
      return penalty

    x0 = []
    for n, (lo, hi) in zip(names, boundsList):
      cur = float(self.get(n)) if not isinstance(self.get(n), str) \
          else float(eval(str(self.get(n))))
      x0.append(np.clip((cur - lo) / (hi - lo) if hi > lo else 0.5, 0, 1))

    try:
      if method == 'dual_annealing':
        result = scipy.optimize.dual_annealing(
            objective, bounds=[(0, 1)] * len(names),
            maxiter=int(maxIterations), x0=np.asarray(x0))
      elif method == 'differential_evolution':
        result = scipy.optimize.differential_evolution(
            objective, bounds=[(0, 1)] * len(names),
            maxiter=int(maxIterations))
      else:
        result = scipy.optimize.minimize(
            objective, np.asarray(x0), method=method,
            bounds=[(0, 1)] * len(names),
            options=dict(maxiter=int(maxIterations)))
    finally:
      if restoreBestAtExit and self._bestParams is not None:
        self.set(**self._bestParams)
        if autosaveBestTo:
          saveScene(self.scene, autosaveBestTo)
    result.bestParams = dict(self._bestParams or {})
    result.bestPenalty = self._bestPenalty
    return result

  def optimizeStrategyStep(self, strategies, parallel='auto',
                           **commonKwargs):
    '''Run several optimize() configurations, each inheriting unset keys
    from the first (reference: parameter_sweeper.py:454-746), one after the
    other in-process, the global best surviving into each next strategy —
    the reference's own path when the job does not pickle or with
    parallel=False. Returns one optimize() result (or None for a strategy
    that failed) per strategy; KernelError and NotImplementedError raise.

    parallel=True (concurrent OS worker processes with global-best
    tracking, revival and laggard quitting) is not ported and raises
    NotImplementedError; 'auto' and False run in-process.'''
    if parallel is True:
      raise NotImplementedError(
          'optimizeStrategyStep(parallel=True) (_optimizeStrategyParallel: '
          'concurrent worker processes) is not ported to the PyTorch package '
          'yet: ROADMAP item A.10 (parallel/multiprocess.py and the command '
          "line); parallel='auto' runs the strategies in-process")
    if not strategies:
      return []
    base = dict(strategies[0])
    configs = [{**commonKwargs, **base, **s} for s in strategies]
    results = []
    for i, cfg in enumerate(configs):
      io.info(f'optimize strategy {i + 1}/{len(configs)}: '
              f'{cfg.get("method", "Nelder-Mead")}')
      try:
        results.append(self.optimize(**cfg))
      except _NOT_A_DESIGN_FAULT:
        raise
      except Exception as e:
        io.warn(f'strategy {i + 1} failed: {e}')
        results.append(None)
    if self._bestParams is not None:
      self.set(**self._bestParams)
    return results

  # ------------------------------------------------------- batched evaluation

  def _compileVariants(self, parameterSets, sceneFactory):
    '''Apply each parameter set and compile its scene host-side. Returns one
    dict per variant: `host`, `info` (the compiled scene), `sources` (its
    light sources) and, of the first source AS IT IS NOW — a later parameter
    set may change the same object — `sigFull`, `sigGeom` and, for a point
    source, `geomRow`. A scene the kernels do not cover raises
    NotImplementedError naming its ROADMAP item.'''
    variants = []
    for ps in parameterSets:
      self.set(**ps)
      scene = sceneFactory() if sceneFactory is not None else self.scene
      srcs = scene.lightSources()
      if not srcs:
        raise ValueError('evaluateBatched needs a scene with a light source')
      src = srcs[0]
      if not src.supportsDeviceSampling():
        raise NotImplementedError(
            f'source {src.Label} without device sampling: sweeping it is '
            f'not ported to the PyTorch package yet: ROADMAP item A.4b '
            f'(histograms from the record tracer)')
      host, info = scene.compile(device=None)
      reason = cuda_trace.ineligibleReason(host)
      if reason is not None:
        raise NotImplementedError(
            f'sweeping this scene ({reason}) is not ported to the PyTorch '
            f'package yet: ROADMAP item A.4b (histograms from the record '
            f'tracer)')
      host['powerTol'] = 1e-6
      variants.append(dict(
          host=host, info=info, sources=srcs,
          sigFull=_sourceSignature(src, 'full'),
          sigGeom=_sourceSignature(src, 'geom'),
          geomRow=(_sourceGeomRow(src) if type(src) is PointSource
                   else None)))
    return variants

  def _samplerSpec(self, variant):
    '''The in-kernel sampler spec of a variant's first source, with the
    placement and wavelength the source had when the variant was compiled.
    The sampling part is built once per 'geom' signature (the sympy compile
    and the fit are seconds on a cold host, and a sceneFactory may build a
    new source object for every variant). None when the source has no
    in-kernel sampler.'''
    src, row = variant['sources'][0], variant['geomRow']
    key = variant['sigGeom'] if row is not None else variant['sigFull']
    if key not in self._ebSamplerCache:
      self._ebSamplerCache[key] = src.samplerSpec()
    spec = self._ebSamplerCache[key]
    if spec is None or row is None:
      return spec
    return cuda_trace.samplerSpecWithGeom(spec, row)

  def _sweepRoute(self, variants, raysPerScene, maxIntersections,
                  maxRayLength, distTol, bins, histBounds):
    '''(step, table) of the sweep kernel for these variants, or raise
    SweepUnavailable. Identical sources ('full') share one sampler spec as
    it is; point sources that differ only in placement and wavelength
    ('geom') share its sampling part and bring one geometry row each.'''
    if any(len(v['sources']) != 1 for v in variants):
      raise cuda_trace.SweepUnavailable('needs exactly one light source')
    first = variants[0]
    if all(v['sigFull'] == first['sigFull'] for v in variants):
      mode, sig = 'full', first['sigFull']
    elif first['geomRow'] is not None \
        and all(v['sigGeom'] == first['sigGeom'] for v in variants):
      mode, sig = 'geom', first['sigGeom']
    else:
      raise cuda_trace.SweepUnavailable(
          'sources differ beyond placement/wavelength across variants')
    spec0 = _hostHistSpec(first['host'], first['info'], histBounds, bins)
    for v in variants[1:]:
      spec = _hostHistSpec(v['host'], v['info'], histBounds, bins)
      if not all(np.array_equal(a, b) for a, b in zip(spec0, spec)):
        raise cuda_trace.SweepUnavailable(
            'the histogram spec (recording elements or bounds) differs '
            'across variants')
    hostScenes = [(v['host'], v['info']) for v in variants]
    stepKey = (mode, sig, len(variants), int(raysPerScene),
               int(maxIntersections), maxRayLength, distTol, tuple(bins),
               repr(histBounds), str(resolveDevice(self.device)))
    cached = self._ebStepCache.get(stepKey)
    if cached is None:
      spec = self._samplerSpec(first)
      if spec is None:
        raise cuda_trace.SweepUnavailable('no in-kernel sampler spec')
      cached = cuda_trace.makeSweepStep(
          hostScenes, histBounds, bins, spec, int(raysPerScene),
          int(maxIntersections), maxRayLength, distTol,
          geomMode=(mode == 'geom'), device=self.device)
      self._ebStepCache[stepKey] = cached
    step, packTables = cached
    geomRows = (np.stack([v['geomRow'] for v in variants])
                if mode == 'geom' else None)
    return step, packTables(hostScenes, geomRows)

  def _perVariantRoute(self, variants, raysPerScene, maxIntersections,
                       maxRayLength, distTol, bins, histBounds, seed):
    '''One launch of the single-scene histogram kernel per variant, each
    with its own sampler; one fetch per variant (histogram shapes may differ
    across variants). Like the reference's per-variant path it traces a
    variant's FIRST light source. Returns [(power, counts)] as numpy.'''
    out = []
    for variant in variants:
      srcs = variant['sources']
      if len(srcs) > 1:
        io.warn(f'evaluateBatched traces the first light source only '
                f'({srcs[0].Label}); {len(srcs) - 1} more are ignored')
      spec = self._samplerSpec(variant)
      if spec is None:
        raise NotImplementedError(
            f'source {srcs[0].Label} has no in-kernel sampler spec; sweeping '
            f'it is not ported to the PyTorch package yet: ROADMAP item A.4b '
            f'(histograms from the record tracer)')
      histSpec = fused.makeHistogramSpec(variant['host'], variant['info'],
                                         bounds=histBounds, bins=bins)
      step = cuda_trace.makeTraceStep(
          variant['host'], histSpec, None, int(raysPerScene),
          int(maxIntersections), maxRayLength, distTol, sampler=spec,
          device=self.device)
      hist, _counters = step(int(seed), fused.initHistograms(
          histSpec, device=self.device))
      out.append((hist['power'].cpu().numpy(), hist['counts'].cpu().numpy()))
    return out

  def evaluateBatched(self, parameterSets, metric, sceneFactory=None,
                      raysPerScene=100_000, maxIntersections=8, bins=(64, 64),
                      histBounds=(-50., 50., -50., 50.), seed=0):
    '''
    Evaluate MANY geometry variants in one launch. `parameterSets` is a list
    of parameter dicts; each is applied (via set()) before compiling one
    scene variant host-side. `metric(histPower, histCounts)` maps each
    variant's (D, H, W) detector histograms to a scalar. Returns an (N,)
    numpy array of metric values.

    Variants of one structure (same surfaces and elements, values free to
    differ; one point source, the same in every variant or differing only in
    placement and wavelength) ride ONE launch of the sweep kernel on one
    stacked table, and their histograms come back in ONE fetch. Every
    variant traces exactly `raysPerScene` rays, and the SAME rays (common
    random numbers): metric differences between variants are geometry, not
    noise. Other sweeps of eligible scenes — structure or source sampling
    changing across variants — go through one launch of the single-scene
    histogram kernel per variant, each with its own sampler.
    `lastBatchedRoute` says which route ran ('sweep' or 'perVariant'). A
    scene the kernels do not cover raises NotImplementedError.
    '''
    hists = self._batchedHistograms(parameterSets, sceneFactory, raysPerScene,
                                    maxIntersections, bins, histBounds, seed)
    return np.array([metric(power, counts) for power, counts in hists])

  def _batchedHistograms(self, parameterSets, sceneFactory, raysPerScene,
                         maxIntersections, bins, histBounds, seed,
                         sweepKernel=True):
    '''The [(power, counts)] numpy histograms of `evaluateBatched`, one per
    variant. `sweepKernel=False` skips the sweep kernel and takes the
    per-variant route whatever the variants allow: the yardstick the sweep
    kernel is timed against.'''
    variants = self._compileVariants(parameterSets, sceneFactory)
    settings = self.scene.activeSimulationSettings()
    maxRayLength = float(settings.maxRayLength())
    distTol = float(max(settings.distanceTolerance(), 1e-4))
    args = (variants, raysPerScene, maxIntersections, maxRayLength, distTol,
            tuple(bins), histBounds)
    step = None
    if sweepKernel:
      try:
        step, table = self._sweepRoute(*args)
      except cuda_trace.SweepUnavailable as e:
        io.verb(f'sweep kernel unavailable ({e}); tracing the variants one '
                f'launch each')
    if step is None:
      self.lastBatchedRoute = 'perVariant'
      return self._perVariantRoute(*args, seed)
    self.lastBatchedRoute = 'sweep'
    step(int(seed), table)
    both = step.histograms.cpu().numpy()        # ONE device->host fetch
    return list(zip(both[0], both[1]))
