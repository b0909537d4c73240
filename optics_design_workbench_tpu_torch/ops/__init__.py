from . import cuda_trace
