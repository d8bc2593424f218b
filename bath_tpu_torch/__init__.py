"""bath_tpu_torch: translated profile-HMM homology search on an NVIDIA
GPU, in PyTorch with hand-written CUDA kernels.

A port of ``bath_tpu`` (the JAX package beside it, which stays the
reference).  Host code that imports no JAX -- the model layer, the
native filters, the pipeline, domain definition and output -- is
shared with ``bath_tpu``; the device stages are this package's own.
This package never imports JAX.
"""

__version__ = "0.1.0"
