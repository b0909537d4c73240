from . import io
from . import timing
