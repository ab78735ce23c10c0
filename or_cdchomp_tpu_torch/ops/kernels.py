"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources have a plain C interface: one ``nvcc`` per source compiles
them in parallel, and one more links the objects into a shared library,
which ``ctypes`` loads.  The build runs at first use on a machine with
the CUDA toolkit and an sm_90a (Hopper) card, and writes to
``or_cdchomp_tpu_torch/build/``.  The library file name holds
a hash of the sources and flags, so a stale library is never loaded.

Every launch runs on its tensors' card (:func:`launch`): the C entry
points launch on, read the attributes of and set the shared-memory limit
of the CUDA runtime's current device, so the wrapper makes that card
current for the call.  Nothing here runs at import time: the CPU tests
import every module.

Launches are counted through :func:`count`: each wrapper's count is a
module global (``sdf_lookup.LAUNCHES`` and the like).  While a CUDA
graph captures (:func:`recording`), nothing launches, so nothing is
counted: the graph keeps what it captured, and each replay counts it
again (:func:`replay_counts`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "build"
_SOURCES = ("obstacle.cu", "selfcol.cu", "draw.cu", "limits.cu",
            "capture.cu", "fk.cu", "jtmap.cu")
# -fmad=false: the obstacle kernel must round every product and sum the
# way the plain PyTorch version does, or a query sitting on a cell
# centre picks the other one-sided neighbour (csrc/obstacle.cu).  The
# self-collision kernel writes its fused multiply-adds out (__fmaf_rn).
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
          "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
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
    # obs_self, net, cost, layout masks, partners and rs, stream
    "cdx_selfcol": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                    _P, _P, _P, _P, _P, _P),
    # pair_i, pair_j, rsum, P, Sa, So, masks, partners, rs, stream
    "cdx_selfcol_layout": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    # Sa, SI, info (6 ints out)
    "cdx_selfcol_launch_info": (_I, _I, _P),
    # seed, iteration, B, m*n, dtype code, z, u, words, stream
    "cdx_hmc_draw": (_P, _P, _I, _I, _I, _P, _P, _P, _P),
    # t_in, lo, hi, ainv, dt², B, m, n, max_rounds, t_out, idx, val, stats,
    # stream
    "cdx_limit_repair": (_P, _P, _P, _P, _D, _I, _I, _I, _I, _P, _P, _P, _P,
                         _P),
    # q, q strides (3), base pointers (7), base strides (14), table,
    # words, E, S, D, n_points, B, out, stream
    "cdx_fk_soa": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    # input pointers (5), their strides (20), table, words, D, m, B, G,
    # totals (or null), stream
    "cdx_jtmap": (_P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    # stream, kinds (or null), cap, count (out)
    "cdx_capture_nodes": (_P, _P, ctypes.c_longlong, _P),
}
# the float64 twins (suffix _f64) take the same arguments, with double
# pointers in place of float ones
_SIGNATURES.update({f"{name}_f64": _SIGNATURES[name] for name in (
    "cdx_sdf_cell_lookup", "cdx_obstacle", "cdx_obstacle_launch_info",
    "cdx_obstacle_smem_bytes", "cdx_selfcol", "cdx_selfcol_layout",
    "cdx_selfcol_launch_info", "cdx_limit_repair", "cdx_fk_soa",
    "cdx_jtmap")})

# the kernels' scalar types: the suffix of each one's entry points
_SUFFIX = {"float32": "", "float64": "_f64"}

_lib = None
BUILD_LOG = ""   # nvcc/ptxas output of the build this process ran

_capture = threading.local()


def count(owner, attr):
    """One launch of a kernel, counted in ``owner.attr``; recorded instead
    while this thread captures a graph."""
    rec = getattr(_capture, "records", None)
    if rec is not None:
        rec.append((owner, attr))
        return
    setattr(owner, attr, getattr(owner, attr) + 1)


@contextmanager
def recording():
    """While entered (around a CUDA graph's capture), :func:`count` adds
    to the list this yields and to no count."""
    saved = getattr(_capture, "records", None)
    _capture.records = records = []
    try:
        yield records
    finally:
        _capture.records = saved


def replay_counts(records):
    """Count the launches a graph recorded: once per replay."""
    for owner, attr in records:
        count(owner, attr)


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


def check_dtype(dtype, name):
    """``dtype`` if the kernels are built for it (float32, float64), else
    ValueError."""
    if str(dtype).removeprefix("torch.") not in _SUFFIX:
        raise ValueError(f"{name}: dtype {dtype}; the kernel takes float32 "
                         f"or float64")
    return dtype


def entry(name, dtype):
    """The library's entry point ``name`` for the kernel in ``dtype``."""
    check_dtype(dtype, name)
    return getattr(library(),
                   name + _SUFFIX[str(dtype).removeprefix("torch.")])


def check(err, name):
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t):
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def capture_nodes(stream, kinds=False):
    """The nodes of the CUDA graph that ``stream`` (a torch.cuda.Stream)
    is capturing: their number, or with ``kinds`` one letter a node in the
    order a replay runs them, "k" kernel, "c" memcpy, "s" memset, "-"
    another kind (csrc/capture.cu).  Raises if the stream is not
    capturing, or if the nodes are not one chain in that order."""
    fn = library().cdx_capture_nodes
    n = ctypes.c_longlong(0)
    err = fn(stream.cuda_stream, None, 0, ctypes.byref(n))
    buf = None
    if kinds and err == 0:
        buf = ctypes.create_string_buffer(max(n.value, 1))
        err = fn(stream.cuda_stream, buf, n.value, ctypes.byref(n))
    if err == -1:
        raise RuntimeError("cdx_capture_nodes: the stream is not capturing")
    if err == -2:
        raise RuntimeError("cdx_capture_nodes: the captured nodes are not "
                           "one chain in creation order")
    check(err, "cdx_capture_nodes")
    return buf.raw[:n.value].decode() if kinds else n.value


def launch(t, name, fn, *args):
    """Call the entry point ``fn(*args, stream)`` on ``t``'s card: that
    card current for the call, the stream PyTorch's current one there.
    Raises if the call returned a CUDA error code."""
    import torch

    with torch.cuda.device(t.device):
        check(fn(*args, stream_ptr(t)), name)


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
