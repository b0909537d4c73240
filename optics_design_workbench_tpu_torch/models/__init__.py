from .scene import Scene
from .settings import SimulationSettings, STORE_HIT_KEYS
from .optical_group import OpticalGroup, OPTICAL_TYPES
from .generic_source import GenericSource
from .point_source import PointSource
from .surface_source import SurfaceSource
from .replay_source import ReplaySource
from .fcstd_ingest import loadFCStd
from . import common
