"""3-d value grids (counterpart of or_cdchomp_tpu/ops/grid.py).

A grid stores row-major cell data over the box ``[0, lengths]`` with
cell centres at ``(0.5 + sub) / size * length`` (libcd grid.c:160-209).
The lookups themselves live in ops/sdf_lookup.py (kernel K1).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Grid3D:
    """A single 3-d grid. ``data`` has shape (nx, ny, nz)."""

    data: torch.Tensor      # (nx, ny, nz)
    lengths: torch.Tensor   # (3,) side lengths in the grid frame

    @classmethod
    def create(cls, sizes, lengths, dtype=torch.float32, device="cuda"):
        data = torch.zeros(tuple(int(s) for s in sizes), dtype=dtype,
                           device=device)
        return cls(data=data, lengths=torch.as_tensor(
            lengths, dtype=dtype, device=device))

    def center_of_index(self, subs):
        """Grid-frame cell centre(s) of integer subscripts (..., 3)
        (grid.c:160-190)."""
        sizes = torch.tensor(self.data.shape, dtype=self.lengths.dtype,
                             device=self.lengths.device)
        return (subs.to(self.lengths.dtype) + 0.5) / sizes * self.lengths

    def all_centers(self):
        """Grid-frame centres of every cell, (nx, ny, nz, 3)."""
        dev = self.data.device
        axes = [torch.arange(n, device=dev) for n in self.data.shape]
        subs = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        return self.center_of_index(subs)


@dataclasses.dataclass
class FieldStack:
    """Padded stack of registered SDF grids (an engine constant)."""

    data: torch.Tensor      # (F, mx, my, mz), +inf padding
    sizes: torch.Tensor     # (F, 3) int32 true sizes
    lengths: torch.Tensor   # (F, 3)


def pad_stack_grids(grids, device="cuda", dtype=torch.float32):
    """Stack variable-size grids into one padded FieldStack.

    Padding cells are +inf, so they can never win a min-select, and the
    true ``sizes`` keep the index arithmetic exact (grid.py:145-162)."""
    F = len(grids)
    shapes = torch.tensor([tuple(g.data.shape) for g in grids],
                          dtype=torch.int32).reshape(F, 3)
    mx, my, mz = (int(v) for v in shapes.max(dim=0).values)
    data = torch.full((F, mx, my, mz), float("inf"), dtype=torch.float32)
    lengths = torch.zeros((F, 3), dtype=torch.float32)
    for i, g in enumerate(grids):
        sx, sy, sz = g.data.shape
        data[i, :sx, :sy, :sz] = g.data.to("cpu", torch.float32)
        lengths[i] = g.lengths.to("cpu", torch.float32)
    return FieldStack(data=data.to(device, dtype),
                      sizes=shapes.to(device),
                      lengths=lengths.to(device, dtype))
