"""Build the port's CUDA kernels from the sources in the checkout, at first use.

Each `csrc/<name>.cu` has a plain C interface; it is compiled with
`nvcc -shared` for sm_90a (Hopper) into `kernels/build/<name>-<hash>.so` and
loaded with ctypes.  The hash is that of the source, of every `csrc/*.cuh`
header it includes (`#include "x.cuh"`, followed through the headers), and
of the flags, so an edited kernel or shared header is rebuilt and an
unchanged one is loaded as it is.  Nothing here runs at import time: the
package imports on a machine without nvcc.

Flags: -O3, no --use_fast_math (the psy-1 masks compare exact 10^(0.1x) and
log10 values, which the fast intrinsics would move), and --fmad=false so
that no a*b+c is contracted into an FMA the plain version does not make.
ptxas reports each kernel's registers, shared memory and spills (-v); the
report is kept beside the library as `<name>-<hash>.log`.
"""
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "build"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name):
    """csrc/<name>.cu and the local headers it includes, in include order."""
    out, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [SRC_DIR / m.decode() for m in _INCLUDE.findall(path.read_bytes())]
    return out


def library_path(name):
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


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
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    lib = _LOADED[name] = ctypes.CDLL(str(so))
    return lib


def on_device(device):
    """The device context a launch on `device` needs: none when it is the
    current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
