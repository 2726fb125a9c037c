"""odr_audioenc_tpu_torch: the batched DAB MP2 encoder in PyTorch, for CUDA.

A port of the JAX package `odr_audioenc_tpu` (which stays the reference):
same layout (`mp2/` module names), same tables (`odr_audioenc_tpu.tables`),
same host packers (`odr_audioenc_tpu.host`).  The psy-1 tonal walk runs as
a hand-written CUDA kernel (`csrc/tonal_walk.cu`) on CUDA tensors.
"""
from . import device  # noqa: F401  (pins TF32 off on import)

__version__ = "0.1.0"
