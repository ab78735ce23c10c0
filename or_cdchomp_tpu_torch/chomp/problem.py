"""Problem state and static solver configuration (counterpart of
or_cdchomp_tpu/chomp/problem.py).

A problem is a dataclass of tensors.  A single problem (``create``) has
the leaf shapes listed below; a batch (``problem_batch_from_grid``) adds
a leading problem axis B to every leaf.  Quantities shared across the
batch (A, A⁻¹, the SDF stack, the robot) live on the engine.  The HMC
state of the JAX package's ``HmcState`` is carried as two flat leaves,
``resample_iter`` and ``leapfrog_first``; its PRNG key has no
counterpart here, since the random draws come from a draw source
(chomp/solver.py ``HmcDraw``): a module run's own (``api.Run.draw``), or
the engine's for a batch.  A batch built with per-problem seeds
(``problem_batch_from_grid(..., seeds=...)``) carries them in the
optional leaf ``hmc_seed`` and draws with ``SeededDraw``; elsewhere the
leaf is None and :meth:`ChompProblem.leaves` leaves it out.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


class ChompSpec(NamedTuple):
    """Static problem shape and flags."""

    n_points: int          # trajectory points incl. endpoints
    n: int                 # config dimension (7 + n_adof if floating)
    m: int                 # moving points (n_points-2, +1 with start_tsr)
    D: int = 1             # smoothness derivative order
    floating_base: bool = False
    use_momentum: bool = False
    use_hmc: bool = False
    start_tsr: bool = False
    n_fields: int = 0      # registered SDF fields
    n_spheres_active: int = 0
    n_spheres_total: int = 0

    @property
    def dt(self):
        # orcdchomp_mod.cpp:2567: dt = 1/(n_points-1)
        return 1.0 / (self.n_points - 1)


@dataclasses.dataclass
class ChompProblem:
    """Per-problem dynamic state (leaf shapes of one problem)."""

    traj: torch.Tensor             # (n_points, n) incl. endpoints
    robot_pose: torch.Tensor       # (7,) fixed base pose
    AG: torch.Tensor               # (m, n) Ainv-spread gradient
    B: torch.Tensor                # (m, n) metric affine term
    Evels: torch.Tensor            # (m, n) velocity-operator affine term
    trC: torch.Tensor              # () smoothness cost constant
    jlimit_lower: torch.Tensor     # (n,)
    jlimit_upper: torch.Tensor     # (n,)
    epsilon: torch.Tensor          # ()
    epsilon_self: torch.Tensor     # ()
    obs_factor: torch.Tensor       # ()
    obs_factor_self: torch.Tensor  # ()
    lambda_: torch.Tensor          # ()
    hmc_resample_lambda: torch.Tensor  # ()
    pose_world_gsdf: torch.Tensor  # (F, 7) rooted SDF placements
    pose_gsdf_world: torch.Tensor  # (F, 7)
    field_enabled: torch.Tensor    # (F,) bool
    inactive_pos: torch.Tensor     # (S_inact, 3) fixed inactive spheres
    tsr_T0w_inv: torch.Tensor      # (C, 7)
    tsr_Twe_inv: torch.Tensor      # (C, 7)
    resample_iter: torch.Tensor    # () int32 next HMC resample iteration
    leapfrog_first: torch.Tensor   # () bool: next momentum step is a half step
    iteration: torch.Tensor        # () int32
    hmc_seed: Optional[torch.Tensor] = None   # () int64 per-problem HMC seed

    def to(self, device=None, dtype=None):
        """Move every leaf to ``device``; floating leaves also to
        ``dtype`` (bool and integer leaves keep theirs)."""
        def conv(t):
            if dtype is not None and t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device=device)

        return ChompProblem(**{k: conv(v) for k, v in self.leaves().items()})

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def leaves(self):
        """{name: tensor} of every leaf that is not None."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None}


def as_batch(problem: ChompProblem) -> ChompProblem:
    """One problem as a batch of one (views)."""
    return ChompProblem(**{k: v[None] for k, v in problem.leaves().items()})


def first(probs: ChompProblem) -> ChompProblem:
    """Problem 0 of a batch, unbatched (views)."""
    return ChompProblem(**{k: v[0] for k, v in probs.leaves().items()})
