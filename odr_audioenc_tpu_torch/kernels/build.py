"""Build the port's CUDA kernels from the sources in the checkout, at first use.

Each `csrc/<name>.cu` has a plain C interface; it is compiled with
`nvcc -shared` for sm_90a (Hopper) into `kernels/build/<name>-<hash>.so` and
loaded with ctypes.  The hash is that of the source and the flags, so an
edited kernel is rebuilt and an unchanged one is loaded as it is.  Nothing
here runs at import time: the package imports on a machine without nvcc.

Flags: -O3, no --use_fast_math (the psy-1 masks compare exact 10^(0.1x) and
log10 values, which the fast intrinsics would move), and --fmad=false so
that no a*b+c is contracted into an FMA the plain version does not make.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LOADED = {}


def nvcc_path():
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                           "built from csrc/ at first use")
    return found


def library_path(name):
    src = SRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def load(name):
    """The ctypes library of csrc/<name>.cu, built if needed."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    so = library_path(name)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
    lib = _LOADED[name] = ctypes.CDLL(str(so))
    return lib
