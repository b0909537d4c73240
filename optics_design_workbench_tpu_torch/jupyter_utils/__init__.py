'''
Notebook-facing API (counterpart of the JAX package's jupyter_utils;
reference: jupyter_utils/__init__.py:11-16): Document (a.k.a.
FreecadDocument), ParameterSweeper, rawFolders/latestRawFolder, Hits,
Histogram, setupProgressTracker, DrawnRays (simulation/draw.py), plotScene
/ writeScenePLY (geometry/tessellate.py), and the differentiable-design
helpers applyParams / makeSpotLoss / optimizeGradient (tracing/diff.py).
'''

from .document import (Document, FreecadDocument, RawFolder, RawFolderRange,
                       rawFolders, rawFolderByIndex, latestRawFolder,
                       updateResultEntry, saveScene, loadScene)
from .hits import Hits
from .histogram import Histogram
from .parameter_sweeper import ParameterSweeper, Parameter, MetaParameter
from .progress import ProgressTracker, setupProgressTracker
from .retries import retryOnError
from .transforms import applyTransformation
from ..simulation.draw import DrawnRays
from ..geometry.tessellate import plotScene, writeScenePLY
from ..tracing.diff import applyParams, makeSpotLoss, optimizeGradient
