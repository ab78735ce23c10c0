"""Batched CHOMP solves on one device (counterpart of
or_cdchomp_tpu/parallel/batch.py).

``problem_batch_from_grid`` broadcasts a template problem to a (P,)
batch with per-problem straight-line trajectories and metric affine
terms; ``BatchSolver.iterate`` runs the batch-native step on it.
"""

from __future__ import annotations

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem


def problem_batch_from_grid(problem: ChompProblem, starts, goals, engine):
    """(P,)-batched problem on the engine's device and dtype: the
    template supplies fields, limits and weights; each row gets the
    straight line from starts[p] to goals[p] ((P, n) arrays) and its own
    metric affine terms.  Every leaf is a contiguous tensor."""
    starts = np.asarray(starts, dtype=np.float64)
    goals = np.asarray(goals, dtype=np.float64)
    P_, n = starts.shape
    npts = engine.spec.n_points
    a = np.linspace(0.0, 1.0, npts)[None, :, None]
    trajs = (1 - a) * starts[:, None, :] + a * goals[:, None, :]
    B, trC, Ev = engine.build_affine_batch(trajs[:, 0], trajs[:, -1], n)

    dev, dtype = engine.device, engine.dtype
    tmpl = problem.to(dev, dtype)
    batched = {k: v.expand((P_,) + tuple(v.shape)).contiguous()
               for k, v in tmpl.leaves().items()}

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    batched.update(
        traj=t(trajs), B=t(B), trC=t(trC), Evels=t(Ev),
        AG=torch.zeros((P_, engine.spec.m, n), dtype=dtype, device=dev),
        iteration=torch.zeros(P_, dtype=torch.int32, device=dev))
    return ChompProblem(**batched)


class BatchSolver:
    """Runs batched solves for one ChompEngine on one device.  The whole
    batch runs as one SoA step: the TPU build's problem-axis chunking
    (sized for its 128-lane vector tiles) has no counterpart here."""

    def __init__(self, engine):
        self.engine = engine

    def iterate(self, probs: ChompProblem, n_iter: int):
        """n_iter batched steps.  Returns (problems, costs (n_iter, P, 3))."""
        probs, costs = self.engine.iterate_batched(probs, n_iter)
        return probs, costs.transpose(0, 1)
