from . import transforms
from . import surfaces
