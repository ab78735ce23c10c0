"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources have a plain C interface: one ``nvcc`` per source compiles
them in parallel, and one more links the objects into a shared library,
which ``ctypes`` loads.  The build runs at first use on a machine with
the CUDA toolkit and an sm_90a (Hopper) card, and writes to
``or_cdchomp_tpu_torch/build/``.  The library file name holds
a hash of the sources and flags, so a stale library is never loaded.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_SOURCES = ("obstacle.cu", "selfcol.cu", "draw.cu")
# -fmad=false: the obstacle kernel must round every product and sum the
# way the plain PyTorch version does, or a query sitting on a cell
# centre picks the other one-sided neighbour (csrc/obstacle.cu).  The
# self-collision kernel writes its fused multiply-adds out (__fmaf_rn).
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
          "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # data, F, mx, my, mz, sub, nbr, Q, out, stream
    "cdx_sdf_cell_lookup": (_P, _I, _I, _I, _I, _P, _P, _I, _P, _P),
    # x, vel, acc, m, S, B, data, F, mx, my, mz, sizes, lengths,
    # pose_gsdf_world, pose_world_gsdf, field_enabled, radii, epsilon,
    # obs_factor, cost, wgrad, dirs, grid, threads, per, smem, stream
    "cdx_obstacle": (_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P, _P,
                     _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # threads, smem, info (3 ints out)
    "cdx_obstacle_launch_info": (_I, _I, _P),
    # F, mx, my, mz
    "cdx_obstacle_smem_bytes": (_I, _I, _I, _I),
    # xi, vel, xo, m, Sa, SI, B, pair_i, pair_j, rsum, P, eps_self,
    # obs_self, net, cost, scratch, stream
    "cdx_selfcol": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                    _P, _P, _P, _P),
    # Sa, SI, info (6 ints out)
    "cdx_selfcol_launch_info": (_I, _I, _P),
    # seed, iteration, B, m*n, dtype code, z, u, words, stream
    "cdx_hmc_draw": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
}

_lib = None
BUILD_LOG = ""   # nvcc/ptxas output of the build this process ran


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on the machine with the card")


def build():
    """Compile csrc/*.cu into build/ unless this exact build exists: one
    ``nvcc -c`` per source, all started together, then one link.
    Returns the library path.  Raises on a compiler error."""
    global BUILD_LOG
    srcs = [_CSRC / s for s in _SOURCES]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in srcs:
        h.update(s.read_bytes())
    lib = _BUILD / f"libcdx_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    _BUILD.mkdir(parents=True, exist_ok=True)
    stem = f"{lib.stem}.{os.getpid()}"
    objs = [_BUILD / f"{stem}.{s.stem}.o" for s in srcs]
    procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    BUILD_LOG = "".join(logs)
    failed = [p.returncode for p in procs if p.returncode != 0]
    tmp = lib.with_name(f"{stem}.tmp")
    if not failed:
        res = subprocess.run([_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        BUILD_LOG += res.stdout + res.stderr
        failed = [res.returncode] if res.returncode != 0 else []
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{BUILD_LOG}")
    os.replace(tmp, lib)
    return lib


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def require(t, name, dtype, shape, device):
    """Validate a tensor handed to a kernel: device, dtype, shape and
    contiguity (the kernels index raw memory)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
