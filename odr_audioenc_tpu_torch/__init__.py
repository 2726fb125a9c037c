"""odr_audioenc_tpu_torch: the batched DAB MP2 and DAB+ AAC-LC encoders in
PyTorch, for CUDA.

A port of the JAX package `odr_audioenc_tpu` (which stays the reference):
same layout (`mp2/` and `dabplus/` module names).  It imports nothing of
the JAX package: it carries its own copies of the standard's tables
(`tables.py`, `dabplus/tables.py`, `data/*.npz`), of the host packers and
validators (`host/`), of the RS code (`fec/`) and of the C++ packers
(`native/`, built at first use by `host/native.py`).
On CUDA tensors the psy-1 tonal walk runs as a hand-written CUDA kernel
(`csrc/tonal_walk.cu`), or fused with the noise labelling
(`csrc/tonal_noise.cu`).  DAB+ covers AAC-LC with block switching, TNS,
PNS, M/S and the rate loop, packed on the host; HE-AAC (SBR, PS) and the
device AU/superframe pack are not ported yet.
"""
from . import device  # noqa: F401  (pins TF32 off on import)

__version__ = "0.1.0"
