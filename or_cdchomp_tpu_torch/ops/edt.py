"""Exact squared Euclidean distance transforms and signed distance fields
(counterpart of or_cdchomp_tpu/ops/edt.py).

The per-axis 1-d transform ``dt[q] = min_p (q-p)^2 res^2 + f[p]`` is
evaluated by its definition, a broadcast minimum over an (n × n) cost
matrix, and applied per axis in sequence — the same result as the
reference's lower-envelope sweep (grid.c:269-329, 462-569).
"""

from __future__ import annotations

import torch

from or_cdchomp_tpu_torch.ops.grid import Grid3D

_CHUNK = 1024  # scan lines per broadcast minimum


def _edt_lines(f, res2):
    """1-d squared EDT over batched lines: f (L, n) → (L, n)."""
    n = f.shape[-1]
    q = torch.arange(n, dtype=f.dtype, device=f.device)
    cost = (q[:, None] - q[None, :]) ** 2 * res2        # (n_out, n_in)
    return torch.cat([torch.amin(fc[:, None, :] + cost[None], dim=-1)
                      for fc in torch.split(f, _CHUNK)])


def edt_sq(func, lengths):
    """Exact 3-d squared EDT of a sampled function grid (0 at sites, +inf
    elsewhere); ``lengths`` scales each axis (grid.c:509-535)."""
    g = func
    shape = func.shape
    lengths = torch.as_tensor(lengths, dtype=func.dtype, device=func.device)
    for axis in range(3):
        n = shape[axis]
        res2 = (lengths[axis] / n) ** 2
        moved = torch.movedim(g, axis, -1)
        out = _edt_lines(moved.reshape(-1, n), res2)
        g = torch.movedim(out.reshape(moved.shape), -1, axis)
    return g


def signed_edt(occupied, lengths):
    """sqrt(sedt_obs) - sqrt(sedt_free) from a boolean occupancy grid:
    positive in free space, negative inside obstacles; +inf everywhere
    when nothing is occupied (grid.c:637-687)."""
    occupied = occupied.to(torch.bool)
    zero = torch.zeros(occupied.shape, dtype=torch.float32,
                       device=occupied.device)
    inf = torch.full_like(zero, float("inf"))
    d_obs = edt_sq(torch.where(occupied, zero, inf), lengths)
    d_free = edt_sq(torch.where(occupied, inf, zero), lengths)
    return torch.sqrt(d_obs) - torch.sqrt(d_free)


def sdf_grid_from_occupancy(occupied, lengths) -> Grid3D:
    """Boolean occupancy grid → signed-distance Grid3D on its device."""
    data = signed_edt(occupied, lengths)
    return Grid3D(data=data, lengths=torch.as_tensor(
        lengths, dtype=data.dtype, device=data.device))
