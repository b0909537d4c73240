from .random_variables import (VectorRandomVariable, ScalarRandomVariable,
                               SampledVectorRandomVariable, setGlobalSeed)
from . import points_by_density
from .device_sampler import buildDeviceTables, deviceDraw
