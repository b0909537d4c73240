from .tracer import (trace, bounceOne, totalSegments, snell, mirrorDirection,
                     gratingDirection, refractiveIndex,
                     MIRROR, LENS, GRATING, ABSORBER, VACUUM, VACUUM_MEDIUM,
                     OPTICAL_TYPES)
from .element_table import element, buildElementTable
