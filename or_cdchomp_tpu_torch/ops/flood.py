"""Flood fill over 3-d grids (counterpart of or_cdchomp_tpu/ops/flood.py).

The reference marks exterior free space with a 6-connected flood fill
from the corner cell (grid_flood.c:30-111, seeded at
orcdchomp_mod.cpp:540-543); unreached free cells become obstacle
interior (orcdchomp_mod.cpp:545-548).  Here the reachable set grows by
masked 6-neighbourhood dilation until a fixed point.
"""

from __future__ import annotations

import torch

_STRIDE = 8  # dilations per fixed-point test


def _dilate6(mask):
    """One 6-connected binary dilation (no wraparound)."""
    out = mask.clone()
    for axis in range(3):
        n = mask.shape[axis]
        out.narrow(axis, 1, n - 1).logical_or_(mask.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, n - 1).logical_or_(mask.narrow(axis, 1, n - 1))
    return out


def flood_reachable(free, seed_index=(0, 0, 0)):
    """Cells 6-connected-reachable from ``seed_index`` through ``free``
    (False everywhere if the seed itself is not free)."""
    free = free.to(torch.bool)
    reach = torch.zeros_like(free)
    reach[tuple(seed_index)] = True
    reach &= free
    while True:
        new = reach
        for _ in range(_STRIDE):
            new = _dilate6(new) & free
        if torch.equal(new, reach):
            return reach
        reach = new


def exterior_free_mask(occupied, seed_index=(0, 0, 0)):
    """Final obstacle mask: occupied cells plus enclosed free pockets
    (free cells are only those reachable from the grid corner)."""
    return ~flood_reachable(~occupied.to(torch.bool), seed_index)
