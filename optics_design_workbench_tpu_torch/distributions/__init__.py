from .random_variables import VectorRandomVariable, setGlobalSeed
from .device_sampler import buildDeviceTables, deviceDraw
