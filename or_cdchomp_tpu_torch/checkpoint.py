"""Checkpoint and resume of solver state (counterpart of
or_cdchomp_tpu/checkpoint.py).

The reference has two persistence mechanisms (SURVEY.md §5): the SDF
binary cache (computedistancefield's ``cache_filename``, api.py) and a
de-facto optimizer resume (iterate is re-entrant on a run handle; a run
can be seeded from a prior trajectory via starttraj).  This module saves
and restores a problem — one or a batch — so a long sweep can stop and
resume across jobs:

 - ``save_problem(path, problem, draw=None)`` writes every leaf as a CPU
   tensor with ``torch.save``, beside a format tag, and the state of an
   ``HmcDraw`` when one is given.  A module run's HMC draws come from
   ``Run.draw`` and a batch's from ``ChompEngine.draw``, not from the
   problem (the JAX package keeps a key in the problem), so a bit-exact
   resume of such a run needs its draw saved with it.  A batch built
   with per-problem seeds needs nothing more: its draws depend on the
   leaves ``hmc_seed`` and ``iteration`` alone (ops/draw.py).
 - ``load_problem(path, template=None, device=None, draw=None)`` reads it
   back, or the JAX package's portable ``.npz`` (``leaf_i`` arrays in
   ``jax.tree.flatten`` order of its ``ChompProblem``; its PRNG key is
   dropped).  The JAX package's orbax directories are not read: the
   port does not depend on orbax.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem
from or_cdchomp_tpu_torch.convert import problem_from_numpy

FORMAT = "or_cdchomp_tpu_torch.problem/1"

# the JAX ChompProblem's leaves in jax.tree.flatten order
# (or_cdchomp_tpu/chomp/problem.py: its fields in order, ``hmc`` flattened
# as key, resample_iter, leapfrog_first), named as problem_from_numpy
# reads them
JAX_LEAVES = (
    "traj", "robot_pose", "AG", "B", "Evels", "trC", "jlimit_lower",
    "jlimit_upper", "epsilon", "epsilon_self", "obs_factor",
    "obs_factor_self", "lambda_", "hmc_resample_lambda", "pose_world_gsdf",
    "pose_gsdf_world", "field_enabled", "inactive_pos", "tsr_T0w_inv",
    "tsr_Twe_inv", "hmc.key", "hmc.resample_iter", "hmc.leapfrog_first",
    "iteration",
)


def save_problem(path: str, problem: ChompProblem, draw=None) -> None:
    """Save a problem (single or batched) to ``path`` with ``torch.save``;
    with ``draw`` (an ``HmcDraw``), its generator state too."""
    state = {"format": FORMAT,
             "leaves": {k: v.detach().cpu()
                        for k, v in problem.leaves().items()}}
    if draw is not None:
        state["draw"] = draw.state()
    torch.save(state, path)


def _npz_path(path):
    if path.endswith(".npz"):
        return path
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        return path + ".npz"
    return None


def _read_npz(path, dtype):
    with np.load(path) as data:
        n = len(data.files)
        if n != len(JAX_LEAVES):
            raise ValueError(f"{path}: {n} leaves, a JAX ChompProblem "
                             f"flattens to {len(JAX_LEAVES)}")
        arrays = {name: data[f"leaf_{i}"]
                  for i, name in enumerate(JAX_LEAVES)}
    if dtype is None:
        dtype = torch.from_numpy(np.asarray(arrays["traj"])).dtype
    return problem_from_numpy(arrays, device="cpu", dtype=dtype)


def _check(problem, template):
    got, want = problem.leaves(), template.leaves()
    if set(got) != set(want):
        raise ValueError(f"checkpoint leaves {sorted(set(got) ^ set(want))} "
                         f"differ from the template's")
    for k, v in want.items():
        if got[k].shape != v.shape or got[k].dtype != v.dtype:
            raise ValueError(
                f"checkpoint leaf {k} is {got[k].dtype} "
                f"{tuple(got[k].shape)}, the template's {v.dtype} "
                f"{tuple(v.shape)}")


def load_problem(path: str, template: ChompProblem = None, device=None,
                 draw=None) -> ChompProblem:
    """Restore a problem saved by :func:`save_problem`, or by the JAX
    package's portable ``.npz`` (``path`` ending in ``.npz``, or
    ``path + ".npz"`` where only that exists).

    With ``template``, the leaves go to the template's device and must
    match its leaf set, shapes and dtypes (ValueError otherwise; a JAX
    file's floating leaves take the template's floating dtype first, as
    the JAX run may have been float32 or float64).  Without one they go to
    ``device`` (the card by default) with the dtypes they were saved
    with.  ``draw`` (an ``HmcDraw``) is set to the saved draw state; a
    file saved without one raises then.
    """
    npz = _npz_path(path)
    state = {}
    if npz is not None:
        problem = _read_npz(npz, None if template is None
                            else template.traj.dtype)
    else:
        state = torch.load(path, map_location="cpu", weights_only=True)
        if state.get("format") != FORMAT:
            raise ValueError(f"{path}: not a problem checkpoint "
                             f"(format {state.get('format')!r})")
        problem = ChompProblem(**state["leaves"])
    if draw is not None and "draw" not in state:
        raise ValueError(f"{npz or path} holds no draw state")
    if template is not None:
        _check(problem, template)
        device = template.traj.device
    elif device is None:
        device = "cuda"
    problem = problem.to(device)
    if draw is not None:
        draw.load_state(state["draw"])
    return problem
