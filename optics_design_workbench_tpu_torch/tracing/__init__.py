from .element_table import (element, buildElementTable, MIRROR, LENS,
                            GRATING, ABSORBER, VACUUM, VACUUM_MEDIUM,
                            OPTICAL_TYPES)
