"""The joint-limit repair of a problem batch (csrc/limits.cu).

The step's repair (chomp.c:608-655; JAX ``ChompEngine.
_limit_repair_batched``, a ``lax.while_loop`` on the device): each round,
each problem of T (B, m, n) repairs its own worst violation of its limits
lo, hi (B, n),

    Gj = where(T < lo, lo − T, 0) + where(T > hi, hi − T, 0)
    a = argmax |Gj| over the row-major (m·n) row (the first on ties)
    GjA = A⁻¹·Gj,  scale = 1.01·Gj[a] / (GjA[a], or 1 where it is 0)
    T ← T + scale·GjA   (where |Gj[a]| > 0)

for at most ``_MAX_LIMIT_FIXES`` = 1000 rounds.  ``metric`` is the dense
metric's A⁻¹ (m, m), or the step dt (a float) of the semiseparable
metric (chomp/metric.py).

:func:`limit_repair` dispatches on the device of ``T``: a CPU tensor goes
to the plain version :func:`limit_repair_ref` (a Python loop of rounds
with one host read per round, as the port ran the repair before the
kernel), a CUDA tensor to the kernel (one launch for the batch, each
problem's block looping on the device until its row is clean, so the
step makes no host sync) or an error.  There is no fallback.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import sys

import torch

from or_cdchomp_tpu_torch.chomp import metric as metric_mod
from or_cdchomp_tpu_torch.ops import kernels

_THIS = sys.modules[__name__]

LAUNCHES = 0
_MAX_LIMIT_FIXES = 1000   # chomp.c:608


def _solve(metric):
    """A⁻¹·G for G (B, m, n) under ``metric``."""
    if isinstance(metric, torch.Tensor):
        return lambda G: torch.matmul(metric, G)
    return lambda G: metric_mod.sep_solve(G, float(metric))


def limit_repair_ref(T, lo, hi, metric, want_stats=False):
    """Plain version of :func:`limit_repair` (same contract): rounds while
    any problem still violates (one host read of that test per round);
    a problem that has stopped violating is kept as it is.  With
    ``want_stats`` also the (B, 2) int32 stats of the kernel: rounds
    applied per problem, and the violations summed over them."""
    B = T.shape[0]
    solve = _solve(metric)
    lo = lo[:, None, :]
    hi = hi[:, None, :]
    stats = (torch.zeros((B, 2), dtype=torch.int64, device=T.device)
             if want_stats else None)
    for _ in range(_MAX_LIMIT_FIXES):
        Gj = torch.where(T < lo, lo - T, 0.0) + \
            torch.where(T > hi, hi - T, 0.0)
        Gf = Gj.reshape(B, -1)
        amax = torch.argmax(torch.abs(Gf), dim=1, keepdim=True)   # (B, 1)
        gmax = torch.gather(Gf, 1, amax)[:, 0]
        pred = torch.abs(gmax) > 0.0
        if not bool(pred.any()):   # such a round would change nothing
            break
        GjA = solve(Gj)
        denom = torch.gather(GjA.reshape(B, -1), 1, amax)[:, 0]
        scale = 1.01 * gmax / torch.where(denom == 0.0, 1.0, denom)
        T_new = T + scale[:, None, None] * GjA
        T = torch.where(pred[:, None, None], T_new, T)
        if stats is not None:
            stats[:, 0] += pred
            stats[:, 1] += torch.where(pred, (Gf != 0).sum(1), 0)
    return (T, stats.to(torch.int32)) if want_stats else T


def limit_repair(T, lo, hi, metric, want_stats=False):
    """Joint-limit repair of T (B, m, n) against lo, hi (B, n) under
    ``metric`` (A⁻¹ (m, m), or the semiseparable metric's dt): returns
    the repaired T', and with ``want_stats`` also (B, 2) int32 (rounds
    applied, violations summed over them) per problem.  T, lo, hi and a
    dense A⁻¹ share one dtype (float32 or float64 on the card) and
    device; T is not changed."""
    if T.device.type == "cpu":
        return limit_repair_ref(T, lo, hi, metric, want_stats)
    if T.device.type != "cuda":
        raise ValueError(f"limit_repair: unsupported device {T.device}")
    B, m, n = T.shape
    dev = T.device
    dt = kernels.check_dtype(T.dtype, "limit_repair")
    T, lo, hi = T.contiguous(), lo.contiguous(), hi.contiguous()
    kernels.require(lo, "lo", dt, (B, n), dev)
    kernels.require(hi, "hi", dt, (B, n), dev)
    if isinstance(metric, torch.Tensor):
        ainv = metric.contiguous()
        kernels.require(ainv, "ainv", dt, (m, m), dev)
        ainv_ptr, dt2 = ainv.data_ptr(), 0.0
    else:
        ainv_ptr, dt2 = None, float(metric) * float(metric)
    out = torch.empty_like(T)
    idx = torch.empty((B, m * n), dtype=torch.int32, device=dev)
    val = torch.empty((B, m * n), dtype=dt, device=dev)
    stats = (torch.empty((B, 2), dtype=torch.int32, device=dev)
             if want_stats else None)
    kernels.launch(T, "limit_repair", kernels.entry("cdx_limit_repair", dt),
                   T.data_ptr(), lo.data_ptr(), hi.data_ptr(), ainv_ptr,
                   dt2, B, m, n, _MAX_LIMIT_FIXES, out.data_ptr(),
                   idx.data_ptr(), val.data_ptr(),
                   None if stats is None else stats.data_ptr())
    kernels.count(_THIS, "LAUNCHES")
    return (out, stats) if want_stats else out


def traffic_bytes(B, m, n, itemsize):
    """Bytes one call must move: T read and T' written, the limits
    read."""
    return (2 * B * m * n + 2 * B * n) * itemsize


def flops(m, n, stats):
    """Operations the call's data needs, from its (B, 2) stats: per
    applied round, the violation test (4 per entry), the update
    (2 per entry) and 2·m per violation for A⁻¹·Gj; one test more for
    each problem's last, clean round."""
    rounds = int(stats[:, 0].sum())
    entries = int(stats[:, 1].sum())
    tests = rounds + int(stats.shape[0])
    return 4 * m * n * tests + 2 * m * n * rounds + 2 * m * entries
