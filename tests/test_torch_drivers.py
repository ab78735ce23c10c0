"""The port's batch drivers against the JAX package's, float64 on the
CPU: iterate_masked with a masked tail, iterate_until's convergence
flag, solve with and without tol, final_costs_batch and best_of_batch
(ties, NaN rows)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import best_of_batch as jax_best_of

from or_cdchomp_tpu_torch.parallel.batch import BatchSolver, best_of_batch

from torch_parity import (GOAL, close, config1_module, jax_batch,
                          port_engine, port_probs)

RTOL = 1e-9


@pytest.fixture(scope="module")
def setup():
    mod = config1_module(oc, dtype=jnp.float64)
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                              obs_factor=500.0, n_points=11)]
    jprobs = jax_batch(run, 4, seed=5)
    # one JAX solver for every test: its jitted drivers compile once
    return run, jprobs, port_engine(run.engine), JaxBatchSolver(run.engine)


def test_iterate_masked_tail_matches_jax(setup):
    _, jprobs, eng, jsolver = setup
    jout, jcosts = jsolver.iterate_masked(jprobs, 3, 5)
    tout, tcosts = BatchSolver(eng).iterate_masked(port_probs(jprobs), 3, 5)
    assert tuple(tcosts.shape) == (5, 4, 3)
    close(tout.traj, jout.traj, RTOL)
    close(tcosts[:3], jcosts[:3], RTOL)        # rows >= valid unspecified
    np.testing.assert_array_equal(tout.iteration.numpy(), 3)


@pytest.mark.parametrize("tol", [1e9, -1.0])
def test_iterate_until_matches_jax(setup, tol):
    _, jprobs, eng, jsolver = setup
    jout, jlast, jconv = jsolver.iterate_until(jprobs, 3, 4, tol)
    tout, tlast, tconv = BatchSolver(eng).iterate_until(
        port_probs(jprobs), 3, 4, tol)
    assert bool(tconv) == bool(jconv) == (tol > 0)
    assert tconv.dtype == torch.bool and tconv.dim() == 0
    close(tlast, jlast, RTOL)
    close(tout.traj, jout.traj, RTOL)


def test_iterate_until_needs_a_step(setup):
    _, jprobs, eng, _ = setup
    with pytest.raises(ValueError, match="valid >= 1"):
        BatchSolver(eng).iterate_until(port_probs(jprobs), 0, 4)


@pytest.mark.parametrize("tol, want_done", [(None, 7), (1e9, 3), (-1.0, 7)])
def test_solve_matches_jax(setup, tol, want_done):
    """7 iterations in chunks of 3 (a ragged tail); tol=1e9 stops after
    the first chunk, tol=−1 never stops early."""
    _, jprobs, eng, jsolver = setup
    jout, jfin, jdone = jsolver.solve(jprobs, 7, chunk=3, tol=tol)
    tout, tfin, tdone = BatchSolver(eng).solve(port_probs(jprobs), 7,
                                               chunk=3, tol=tol)
    assert tdone == jdone == want_done
    assert tuple(tfin.shape) == (4, 3)
    close(tfin, jfin, RTOL)
    close(tout.traj, jout.traj, RTOL)


def test_final_costs_batch_matches_jax(setup):
    """The SoA cost report against JAX's vmap(costs_only) (the AoS
    path), after two steps so obstacle and self terms are live."""
    run, jprobs, eng, _ = setup
    jout, _ = run.engine.iterate_batch(jprobs, 2)
    want = run.engine.final_costs_batch(jout)
    got = eng.final_costs_batch(port_probs(jout))
    assert len(got) == 3 and all(tuple(g.shape) == (4,) for g in got)
    assert float(np.abs(np.asarray(want[1])).max()) > 0.0
    for g, w in zip(got, want):
        close(g, w, RTOL)
    close(got[0], np.asarray(want[1]) + np.asarray(want[2]), RTOL)


@pytest.mark.parametrize("totals, want", [
    ([3.0, 1.0, 2.0, 1.0], 1),                 # tie: first index
    ([3.0, 1.0, np.nan, 1.0], 2),              # NaN row wins, as jnp
    ([np.nan, 1.0, np.nan, 0.5], 0),           # first NaN row
    ([2.0, 2.0, 2.0, 2.0], 0),
])
def test_best_of_batch_matches_jax(setup, totals, want):
    _, jprobs, _, _ = setup
    finals = np.zeros((4, 3))
    finals[:, 0] = totals
    jbest, jidx = jax_best_of(jprobs, jnp.asarray(finals))
    tprobs = port_probs(jprobs)
    tbest, tidx = best_of_batch(tprobs, torch.as_tensor(finals))
    assert int(tidx) == int(jidx) == want
    close(tbest.traj, jbest.traj, 0.0)
    assert int(tbest.resample_iter) == int(jbest.hmc.resample_iter)
    for k, v in tbest.leaves().items():
        assert torch.equal(v, getattr(tprobs, k)[want]), k


def test_batch_hmc_state(setup):
    """problem_batch_from_grid starts every problem's HMC schedule at
    iteration 0 with a leapfrog half step first (JAX batch.py:87-92)."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    _, jprobs, eng, _ = setup
    tmpl = port_probs(jax.tree.map(lambda x: x[0], jprobs))
    tmpl = tmpl.replace(resample_iter=torch.tensor(9, dtype=torch.int32),
                        leapfrog_first=torch.tensor(False))
    starts = np.asarray(jprobs.traj)[:, 0]
    goals = np.asarray(jprobs.traj)[:, -1]
    tb = problem_batch_from_grid(tmpl, starts, goals, eng)
    assert tb.resample_iter.dtype == torch.int32
    assert tb.resample_iter.tolist() == [0] * 4
    assert tb.leapfrog_first.tolist() == [True] * 4
    close(tb.traj, jprobs.traj, 1e-12)
