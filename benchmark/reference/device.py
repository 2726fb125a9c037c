"""Device and dtype policy of the port, and the per-device constant cache.

Two paths, as in the JAX package:
  * the exact path runs in float64 and reproduces the reference bit for bit
    (the CPU validation path; it also runs on CUDA);
  * the fast path runs in float32 with the vectorised psy-1 and the
    hand-written tonal-walk kernel (the CUDA throughput path).

The f32 polyphase (K=1632) and DFT (K=1024) matmuls must not run in TF32,
which keeps only 10 mantissa bits; both switches are pinned here, once, when
the package is imported.
"""
import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device():
    """The card: the port's entry points run on CUDA unless the caller
    passes device="cpu".  Raises where there is no card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device=\"cpu\" to run the port on the CPU")
    return torch.device("cuda")


def default_dtype(device):
    """float64 (exact path) on the CPU, float32 (fast path) on CUDA."""
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


_CONST = {}


def const(arr, device, dtype=None):
    """A module-level numpy constant as a tensor on `device`, made once per
    (array, device, dtype).  Only for arrays that live as long as the
    process (the standard's tables, lru-cached table functions): the key
    is the array's identity, and the entry keeps the array alive."""
    device = torch.device(device)
    key = (id(arr), device, dtype)
    hit = _CONST.get(key)
    if hit is None:
        t = torch.as_tensor(np.asarray(arr), device=device)
        if dtype is not None:
            t = t.to(dtype)
        hit = _CONST[key] = (arr, t)
    return hit[1]
