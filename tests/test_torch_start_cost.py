"""create's start_cost (the engine's extra-cost hook) in the port against
the JAX package at float64 on the CPU: one quadratic hook written in jnp
and in torch gives the same steps, module iterations and final costs,
per problem and over a batch; runs with different hooks get different
engines and runs with the same hook share one
(tests/test_api_drivers.py:38-80); a hook that torch.func.vmap cannot
take raises with a message naming it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import \
    problem_batch_from_grid as jax_batch_from_grid

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)

from torch_parity import GOAL, START, close, config1_module, share_fields

STEP_RTOL = 1e-9
N_ITER = 4
KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
          n_points=9)
# the posture the hook pulls every moving point towards, and its weight
Q_MID = 0.5 * (START + GOAL) + np.array([0.0, 0.3, 0.0, -0.2, 0.0, 0.1, 0.0])
W = 40.0


def jax_hook(T):
    d = T - jnp.asarray(Q_MID)
    return 0.5 * W * jnp.sum(d * d), W * d


def torch_hook(T):
    d = T - torch.as_tensor(Q_MID, dtype=T.dtype, device=T.device)
    return 0.5 * W * torch.sum(d * d), W * d


@pytest.fixture(scope="module")
def mods():
    return share_fields(
        config1_module(pt, dtype=torch.float64, device="cpu"),
        config1_module(oc, dtype=jnp.float64))


@pytest.fixture(scope="module")
def runs(mods):
    tm, jm = mods
    return (tm.runs[tm.create(**KW, start_cost=torch_hook)],
            jm.runs[jm.create(**KW, start_cost=jax_hook)])


def test_hook_steps_and_costs_match_jax(runs):
    """``iterate`` and ``costs_only`` of one problem: the hook's cost
    sits in the obstacle term, after the 1/m scaling."""
    trun, jrun = runs
    assert trun.engine.extra_cost is torch_hook
    jprob, jcosts = jrun.engine.iterate(jrun.problem, N_ITER)
    tprob, tcosts = trun.engine.iterate(trun.problem, N_ITER)
    close(tprob.traj, jprob.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)
    for tp, jp in ((trun.problem, jrun.problem), (tprob, jprob)):
        close(torch.stack(trun.engine.costs_only(tp)),
              jnp.stack(jrun.engine.costs_only(jp)), STEP_RTOL)
    # the hook moved the solve: without it the first step differs
    plain = trun.engine.iterate(trun.problem, 1)[0].traj
    trun.engine.extra_cost = None
    try:
        bare = trun.engine.iterate(trun.problem, 1)[0].traj
    finally:
        trun.engine.extra_cost = torch_hook
    assert float((plain - bare).abs().max()) > 1e-6


def test_module_iterate_matches_jax(mods):
    """create + iterate through both modules: the final cost each
    ``iterate`` returns, and the trajectory."""
    tm, jm = mods
    ht = tm.create(**KW, start_cost=torch_hook)
    hj = jm.create(**KW, start_cost=jax_hook)
    got = [tm.iterate(run=ht, n_iter=n) for n in (3, 2)]
    want = [jm.iterate(run=hj, n_iter=n) for n in (3, 2)]
    close(np.array(got), np.array(want), STEP_RTOL)
    close(tm.runs[ht].problem.traj, jm.runs[hj].problem.traj, STEP_RTOL)
    tm.destroy(run=ht)
    jm.destroy(run=hj)


def test_batch_with_hook_matches_jax_batch_solver(runs):
    """B = 3: the port vmaps the hook inside its batch step, the JAX
    BatchSolver vmaps the per-problem step."""
    trun, jrun = runs
    rng = np.random.default_rng(5)
    starts = START + 0.02 * rng.normal(size=(3, 7))
    goals = GOAL + 0.02 * rng.normal(size=(3, 7))
    tb = problem_batch_from_grid(trun.problem, starts, goals, trun.engine)
    jb = jax_batch_from_grid(jrun.problem, starts, goals, jrun.engine)
    tout, tcosts = BatchSolver(trun.engine).iterate(tb, N_ITER)
    jout, jcosts = JaxBatchSolver(jrun.engine).iterate(jb, N_ITER)
    close(tout.traj, jout.traj, STEP_RTOL)
    close(tcosts, jcosts, STEP_RTOL)
    tfin = torch.stack(trun.engine.final_costs_batch(tout), dim=-1)
    jfin = jnp.stack(jrun.engine.final_costs_batch(jout), axis=-1)
    close(tfin, jfin, STEP_RTOL)


def _counting(calls, name):
    def hook(T):
        calls[name] += 1
        return torch_hook(T)
    return hook


def test_two_hooks_get_two_engines(mods):
    """Two runs of the same static structure with different hooks each
    run their own (tests/test_api_drivers.py:38-65)."""
    tm, _ = mods
    calls = {"f": 0, "g": 0}
    hook_f, hook_g = _counting(calls, "f"), _counting(calls, "g")
    h1 = tm.create(**KW, start_cost=hook_f)
    tm.iterate(run=h1, n_iter=1)
    e1 = tm.runs[h1].engine
    tm.destroy(run=h1)
    assert calls["f"] > 0
    f_before = calls["f"]
    h2 = tm.create(**KW, start_cost=hook_g)
    tm.iterate(run=h2, n_iter=1)
    assert tm.runs[h2].engine is not e1
    tm.destroy(run=h2)
    assert calls["g"] > 0 and calls["f"] == f_before


def test_same_hook_shares_one_engine(mods):
    """tests/test_api_drivers.py:68-80."""
    tm, _ = mods
    h1 = tm.create(**KW, start_cost=torch_hook)
    e1 = tm.runs[h1].engine
    tm.destroy(run=h1)
    h2 = tm.create(**KW, start_cost=torch_hook)
    assert tm.runs[h2].engine is e1
    tm.destroy(run=h2)


def _item_hook(T):
    scale = float(T.abs().max().item())        # a host read: no vmap
    return scale * torch.sum(T * T), 2.0 * scale * T


def _branch_hook(T):
    if T.sum() > 0:                            # data-dependent control flow
        return torch.sum(T * T), 2.0 * T
    return torch.sum(T), torch.ones_like(T)


@pytest.mark.parametrize("hook", [_item_hook, _branch_hook],
                         ids=["item", "branch"])
def test_hook_vmap_cannot_take_raises(mods, hook):
    tm, _ = mods
    h = tm.create(**KW, start_cost=hook)
    with pytest.raises(RuntimeError, match=hook.__name__):
        tm.iterate(run=h, n_iter=1)
    tm.destroy(run=h)
