from . import transforms
from . import surfaces
from . import mesh
