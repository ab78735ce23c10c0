"""Batched CHOMP solves, on one device or split across ranks
(counterpart of or_cdchomp_tpu/parallel/batch.py).

``problem_batch_from_grid`` broadcasts a template problem to a (P,)
batch with per-problem straight-line trajectories and metric affine
terms (``stack_problems`` stacks given problems, ``pad_problems`` pads a
batch to a multiple); ``BatchSolver`` runs the batch-native step on it:
a fixed number of steps (``iterate``, ``iterate_masked``), a
convergence-checked chunk (``iterate_until``) or a chunked solve
(``solve``).  With a ``DeviceMesh`` it holds one rank's rows of a global
batch (parallel/multihost.py).  ``best_of_batch`` picks the lowest-cost
problem of a batch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem
from or_cdchomp_tpu_torch.parallel import multihost


def stack_problems(problems) -> ChompProblem:
    """Stack a list of problems (equal leaf sets and shapes) into one
    batch along a new leading axis."""
    leaves = [p.leaves() for p in problems]
    return ChompProblem(**{k: torch.stack([d[k] for d in leaves])
                           for k in leaves[0]})


def pad_problems(probs: ChompProblem, multiple: int):
    """Pad the problem axis to a multiple (repeating the last row) so a
    ragged batch splits evenly; returns (padded, original P).  Slice
    results back with ``v[:P]`` on each leaf."""
    P_ = int(probs.traj.shape[0])
    pad = (-P_) % multiple
    if pad == 0:
        return probs, P_
    return ChompProblem(**{
        k: torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])
        for k, v in probs.leaves().items()}), P_


def problem_batch_from_grid(problem: ChompProblem, starts, goals, engine,
                            metric_ops=None, seeds=None):
    """(P,)-batched problem on the engine's device and dtype: the
    template supplies fields, limits and weights; each row gets the
    straight line from starts[p] to goals[p] ((P, n) arrays), its own
    metric affine terms and a fresh HMC state (resample at iteration 0,
    leapfrog half step first).  Every leaf is a contiguous tensor.  Under
    start_tsr the start is a moving point: it seeds the line and adds no
    affine term.

    The JAX package's signature: ``metric_ops`` is accepted and unused
    there too (the engine's metric builds the affine terms).  ``seeds``
    ((P,) integers) gives each problem its own HMC stream: they are kept
    as the int64 leaf ``hmc_seed``, and the step then draws with
    ``SeededDraw``, so a problem's draws do not depend on its batch.
    With ``seeds=None`` (the JAX package then keys problem p with p,
    ``arange(P)``) the leaf stays None and the batch draws from the
    engine's draw source as one, as before; the JAX keys' numbers are
    not reproduced either way.
    """
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
        resample_iter=torch.zeros(P_, dtype=torch.int32, device=dev),
        leapfrog_first=torch.ones(P_, dtype=torch.bool, device=dev),
        iteration=torch.zeros(P_, dtype=torch.int32, device=dev))
    batched.pop("hmc_seed", None)      # a template's own seed is not kept
    if seeds is not None:
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        if seeds.shape != (P_,):
            raise ValueError(f"seeds must have one entry per problem "
                             f"({P_}), not {seeds.shape[0]}")
        batched["hmc_seed"] = torch.as_tensor(seeds, device=dev)
    return ChompProblem(**batched)


class BatchSolver:
    """Runs batched solves for one ChompEngine.  The whole batch runs as
    one SoA step: the TPU build's problem-axis chunking (sized for its
    128-lane vector tiles) has no counterpart here.

    ``mesh`` (a ``torch.distributed.device_mesh.DeviceMesh``, or None for
    one process) splits a global batch across ranks along ``axis`` (a
    name, or a tuple of every name of the mesh): this solver then holds
    this rank's rows (:meth:`shard`, or ``multihost.make_global_problems``)
    and steps them exchanging nothing, since each problem's step, its
    joint-limit repair included, depends on its own row alone.  The only
    collective is ``iterate_until``'s: one 4-byte all-reduce (MIN) of the
    converged flag per chunk, so every rank stops at the same chunk."""

    def __init__(self, engine, mesh=None, axis="dp"):
        self.engine = engine
        self.mesh = mesh
        self.group = None if mesh is None else _mesh_group(mesh, axis)

    def shard(self, probs: ChompProblem) -> ChompProblem:
        """The batch on the engine's device; with a mesh, this rank's
        ``host_local_batch`` rows of the global batch ``probs``.  ``solve``
        takes the rows it is given and does not call this."""
        if self.mesh is not None:
            start, size = multihost.host_local_batch(
                int(probs.traj.shape[0]), self.group)
            probs = ChompProblem(**{k: v[start:start + size]
                                    for k, v in probs.leaves().items()})
        return probs.to(self.engine.device)

    def iterate(self, probs: ChompProblem, n_iter: int):
        """n_iter batched steps.  Returns (problems, costs (n_iter, P, 3))."""
        probs, costs = self.engine.iterate_batched(probs, n_iter)
        return probs, costs.transpose(0, 1)

    def iterate_masked(self, probs: ChompProblem, valid, chunk_size: int):
        """``chunk_size`` batched steps with the first ``valid`` applied.
        Returns (problems, costs (chunk_size, P, 3)); rows ≥ valid are
        unspecified.  Eager PyTorch needs no fixed-length executable, so
        only the ``valid`` steps run (rows ≥ valid are zeros)."""
        valid = min(max(int(valid), 0), chunk_size)
        probs, costs = self.iterate(probs, valid)
        if valid < chunk_size:
            pad = costs.new_zeros((chunk_size - valid,) + costs.shape[1:])
            costs = torch.cat([costs, pad])
        return probs, costs

    def iterate_until(self, probs: ChompProblem, valid, chunk_size: int,
                      tol=0.0):
        """One convergence-checked chunk: ``valid`` (≥ 1) of
        ``chunk_size`` steps.  Returns (problems, last costs (P, 3),
        converged) where converged, a 0-d bool tensor, says every problem's
        total cost fell by less than ``tol`` from the chunk's first step
        to its last; on one process it stays on the device, with a mesh it
        is all-reduced over the mesh's ranks."""
        if int(valid) < 1:
            raise ValueError("iterate_until needs valid >= 1")
        probs, costs = self.iterate_masked(probs, valid, chunk_size)
        last = costs[min(int(valid), chunk_size) - 1]
        converged = torch.all(costs[0, :, 0] - last[:, 0] < tol)
        if self.mesh is not None:
            flag = multihost.comm_tensor(converged.to(torch.int32),
                                         self.group)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
            converged = flag.to(converged.device) > 0
        return probs, last, converged

    def solve(self, probs: ChompProblem, n_iter: int, chunk: int = 10,
              tol: Optional[float] = None):
        """Up to n_iter steps in chunks of ``chunk``; with ``tol``, stops
        after the first chunk in which every problem converged (one host
        sync per chunk for that test, none without ``tol``; with a mesh,
        every problem of every rank).  Returns
        (problems, final costs (P, 3) from :meth:`ChompEngine.
        final_costs_batch`, steps done)."""
        done = 0
        while done < n_iter:
            todo = min(chunk, n_iter - done)
            if tol is None:
                probs, _ = self.iterate(probs, todo)
                done += todo
                continue
            probs, _, conv = self.iterate_until(probs, todo, chunk, tol)
            done += todo
            if bool(conv):
                break
        finals = torch.stack(self.engine.final_costs_batch(probs), dim=-1)
        return probs, finals, done


def _mesh_group(mesh, axis):
    """The process group of ``mesh`` along ``axis``: one dimension's, or
    for a tuple of every dimension's name a group of all its ranks."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"axis {axis} must be one dimension of the mesh "
                         f"or all of {mesh.mesh_dim_names} in order")
    return dist.new_group(ranks=mesh.mesh.flatten().tolist())


def best_of_batch(probs: ChompProblem, final_costs):
    """The lowest-total-cost problem of the batch — the best-of-HMC-
    restarts reduction (BASELINE config 3).  Returns (problem, index):
    the first index on ties, and the first NaN row if any total is NaN
    (as ``jnp.argmin``)."""
    idx = torch.argmin(final_costs[..., 0])
    best = ChompProblem(**{k: v[idx] for k, v in probs.leaves().items()})
    return best, idx
