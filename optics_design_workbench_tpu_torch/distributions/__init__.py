from .random_variables import (VectorRandomVariable, ScalarRandomVariable,
                               setGlobalSeed)
from .device_sampler import buildDeviceTables, deviceDraw
