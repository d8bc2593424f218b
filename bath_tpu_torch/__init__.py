"""bath_tpu_torch: translated profile-HMM homology search on an NVIDIA
GPU, in PyTorch with hand-written CUDA kernels.

A port of ``bath_tpu`` (the JAX package beside it, which stays the
reference).  The package stands on its own: it imports neither JAX nor
``bath_tpu``.  Host code that never touched JAX -- the model layer, the
native filters, the pipeline, domain definition and output -- is a
copy of the reference's under the same module names (only imports and
lines naming the other package differ; ``tests/test_torch_selfcontained.py``
checks it); the device stages are this package's own.
"""

__version__ = "0.1.0"
