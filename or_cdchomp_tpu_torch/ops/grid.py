"""3-d value grids with libcd's lookup, interp and gradient (counterpart
of or_cdchomp_tpu/ops/grid.py).

A grid stores row-major cell data over the box ``[0, lengths]`` with
cell centres at ``(0.5 + sub) / size * length`` (libcd grid.c:160-209).
Per axis the gradient is one-sided: the next cell where the point lies
at or past the centre, the previous one otherwise, edge cells forced
inward; the value is the centre's plus that gradient times the offset
from the centre (grid.c:331-454).  A query out of the box, or touching
an infinite cell, reads value +inf and gradient 0: "the field does not
contain the point" (HUGE_VAL, orcdchomp_mod.cpp:1179-1182).

``multigrid_interp_grad`` reads its four cells per (field, query) through
``sdf_lookup.sdf_cell_lookup``: K1's raw CUDA kernel on a CUDA tensor,
its plain version on a CPU one.  The solver's own lookups are fused into
K1's obstacle kernel (ops/sdf_lookup.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import sdf_lookup

# a cell value at or beyond this magnitude counts as infinite, as the
# JAX package's BIG/2 (grid.py:183): a stack padded with +inf, or with
# that package's ±1e30 stand-in, reads alike
_BIG_HALF = float(np.float32(1e30)) / 2

# lookup backends of the JAX signature; every one takes the device's one
# path here (the one-hot variants are not ported, by decision)
METHODS = ("auto", "pallas", "pallas_interpret", "onehot", "onehot2",
           "gather")


@dataclasses.dataclass
class Grid3D:
    """A single 3-d grid. ``data`` has shape (nx, ny, nz)."""

    data: torch.Tensor      # (nx, ny, nz)
    lengths: torch.Tensor   # (3,) side lengths in the grid frame

    @property
    def sizes(self):
        return tuple(self.data.shape)

    @classmethod
    def create(cls, sizes, lengths, dtype=torch.float32, device="cuda"):
        data = torch.zeros(tuple(int(s) for s in sizes), dtype=dtype,
                           device=device)
        return cls(data=data, lengths=torch.as_tensor(
            lengths, dtype=dtype, device=device))

    def _sizes_like_lengths(self):
        return torch.tensor(self.data.shape, dtype=self.lengths.dtype,
                            device=self.lengths.device)

    def cell_extents(self):
        """Per-axis cell side length."""
        return self.lengths / self._sizes_like_lengths()

    def center_of_index(self, subs):
        """Grid-frame cell centre(s) of integer subscripts (..., 3)
        (grid.c:160-190)."""
        return ((subs.to(self.lengths.dtype) + 0.5)
                / self._sizes_like_lengths() * self.lengths)

    def all_centers(self):
        """Grid-frame centres of every cell, (nx, ny, nz, 3)."""
        dev = self.data.device
        axes = [torch.arange(n, device=dev) for n in self.data.shape]
        subs = torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
        return self.center_of_index(subs)


def _interp(p, lengths, in_bounds, center, use_next, sizes_f, v0, vn3,
            bad_cells):
    """Value and one-sided gradient from the centre cell v0 (...,) and
    the chosen neighbours vn3 (..., 3); +inf and 0 where out of the box
    or ``bad_cells`` (grid.c:405-439)."""
    sign = torch.where(use_next, 1.0, -1.0).to(p.dtype)
    grad = sign * (vn3 - v0[..., None]) * (sizes_f / lengths)
    value = v0 + torch.sum(grad * (p - center), dim=-1)
    bad = ~in_bounds | bad_cells
    value = torch.where(bad, float("inf"), value)
    grad = torch.where(bad[..., None], 0.0, grad)
    return value, grad


def grid_interp_grad(data, lengths, p):
    """libcd's interp and gradient at grid-frame point(s) of one grid.

    data: (nx, ny, nz); lengths: (3,); p: (..., 3).  Returns (value
    (...,), grad (..., 3) in the grid frame, in_bounds (...,) bool);
    out-of-bounds queries and queries touching an infinite cell read
    value +inf and gradient 0.  Plain tensor gathers on any device.
    """
    sizes = torch.tensor(data.shape, dtype=torch.int32, device=p.device)
    in_bounds, sub, center, use_next, sizes_f = sdf_lookup.lookup_geometry(
        p, sizes, lengths)
    flat = data.reshape(-1)
    _, sy, sz = data.shape

    def at(s):   # the flat index clipped, as jnp.take(mode="clip")
        idx = ((s[..., 0].long() * sy + s[..., 1]) * sz + s[..., 2])
        return flat[torch.clamp(idx, 0, flat.numel() - 1)]

    v0 = at(sub)
    offs = torch.where(use_next, 1, -1).to(torch.int32)
    eye = torch.eye(3, dtype=torch.int32, device=p.device)
    vn3 = torch.stack([at(sub + offs[..., i:i + 1] * eye[i])
                       for i in range(3)], dim=-1)
    bad_cells = torch.isinf(v0) | torch.isinf(vn3).any(dim=-1)
    value, grad = _interp(p, lengths, in_bounds, center, use_next, sizes_f,
                          v0, vn3, bad_cells)
    return value, grad, in_bounds


def grid_interp(data, lengths, p):
    """Interp only (the semantics of :func:`grid_interp_grad`); returns
    (value, in_bounds)."""
    value, _, in_bounds = grid_interp_grad(data, lengths, p)
    return value, in_bounds


def multigrid_interp_grad(data, sizes, lengths, p, method="auto"):
    """Interp and gradient across F padded grids at per-field points.

    data: (F, mx, my, mz) padded stack; sizes: (F, 3) int32 true sizes;
    lengths: (F, 3); p: (..., F, 3) per-field points, each in its grid's
    frame.  Returns (value (..., F), grad (..., F, 3), in_bounds
    (..., F)) with :func:`grid_interp_grad`'s semantics; a cell at or
    beyond 5e29 in magnitude counts as infinite, as in the JAX package.

    The four cells of each (field, query) come from
    ``sdf_lookup.sdf_cell_lookup``: on CUDA tensors K1's raw kernel, in
    float32 only (another dtype raises ValueError), one launch per
    call; on CPU tensors its plain version, in any float dtype.
    ``method`` is accepted for the JAX signature: "auto", "pallas",
    "pallas_interpret", "onehot", "onehot2" and "gather" all take that
    one path, and another name raises ValueError.
    """
    if method not in METHODS:
        raise ValueError(f"multigrid_interp_grad: unknown method "
                         f"{method!r}; one of {METHODS}")
    if p.device.type == "cuda":
        for name, t in (("data", data), ("lengths", lengths), ("p", p)):
            if t.dtype != torch.float32:
                raise ValueError(
                    f"multigrid_interp_grad on CUDA runs K1's lookup in "
                    f"float32; {name} is {t.dtype}")
    F = data.shape[0]
    in_bounds, sub, center, use_next, sizes_f = sdf_lookup.lookup_geometry(
        p, sizes, lengths)
    nbr = sub + torch.where(use_next, 1, -1).to(torch.int32)
    lead = p.shape[:-2]

    def fq(t):                 # (..., F, 3) → (F, Q, 3)
        return t.movedim(-2, 0).reshape(F, -1, 3).contiguous()

    cells = sdf_lookup.sdf_cell_lookup(data, fq(sub), fq(nbr))
    # (F, Q) each → (..., F); the cells stay in data's dtype, as in JAX
    v0, *vns = (c.reshape((F,) + lead).movedim(0, -1) for c in cells)
    vn3 = torch.stack(vns, dim=-1)
    bad_cells = ((torch.abs(v0) >= _BIG_HALF)
                 | torch.any(torch.abs(vn3) >= _BIG_HALF, dim=-1))
    value, grad = _interp(p, lengths, in_bounds, center, use_next, sizes_f,
                          v0, vn3, bad_cells)
    return value, grad, in_bounds


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
