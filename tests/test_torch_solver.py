"""The port's batched solver against the JAX package on the bench scene:
the identical JAX-built batch goes through both engines (float64 on CPU
for parity, float32 port vs float64 JAX for the BASELINE bar)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel.batch import \
    problem_batch_from_grid as jax_batch_from_grid

from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

from torch_parity import GOAL, START, config1_module, port_engine, port_probs

RTOL = 1e-9     # float64 through the whole step: summation order only
F32_BAR = 1e-3  # BASELINE correctness bar, max |Δtraj| f32 vs f64


def _jax_run(n_points):
    mod = config1_module(oc, dtype=jnp.float64)
    h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                   obs_factor=500.0, n_points=n_points)
    return mod.runs[h]


def _batch(run, B, seed=0, start_shift=None):
    rng = np.random.default_rng(seed)
    starts = np.tile(START, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(GOAL, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    if start_shift is not None:
        starts = starts + start_shift
    return jax_batch_from_grid(run.problem, starts, goals, run.engine)


@pytest.fixture(scope="module")
def run11():
    return _jax_run(11)


def _close(a, b, rtol=RTOL):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol,
                               atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("shift", [None, "past_limit"])
def test_one_step_matches_jax(run11, shift):
    """One step; ``past_limit`` starts problem 0 beyond J1's upper limit
    (2.6) so the joint-limit repair loop runs several rounds."""
    sh = None
    if shift:
        sh = np.zeros((4, 7))
        sh[0, 0] = 0.35
    jprobs = _batch(run11, 4, start_shift=sh)
    jnew, jcosts = jax.jit(run11.engine.step_batched)(jprobs)
    eng = port_engine(run11.engine, torch.float64)
    tnew, tcosts = eng.step_batched(port_probs(jprobs, torch.float64))
    _close(tnew.traj, jnew.traj)
    _close(tnew.AG, jnew.AG)
    _close(tcosts, jcosts)
    np.testing.assert_array_equal(tnew.iteration.numpy(),
                                  np.asarray(jnew.iteration))
    if shift:   # the start violated J1's limit; the repaired step does not
        assert float(jprobs.traj[0, 1:-1, 0].max()) > 2.6
        assert float(tnew.traj[0, 1:-1, 0].max()) <= 2.6 + 1e-12


def test_five_iterations_match_jax(run11):
    jprobs = _batch(run11, 4, seed=1)
    jout, jcosts = run11.engine.iterate_batch(jprobs, 5)   # (B, 5, 3)
    eng = port_engine(run11.engine, torch.float64)
    tout, tcosts = BatchSolver(eng).iterate(
        port_probs(jprobs, torch.float64), 5)            # (5, B, 3)
    assert tuple(tcosts.shape) == (5, 4, 3)
    _close(tout.traj, jout.traj)
    _close(tcosts.transpose(0, 1), jcosts)


def test_limit_repair_tie_takes_first_index(run11):
    """Two violations of equal size: both implementations repair the
    first one in row-major order first (argmax ties)."""
    jeng = run11.engine
    m, n = jeng.spec.m, jeng.spec.n
    T = np.zeros((2, m, n))
    lo = np.full((2, n), -1.0)
    hi = np.full((2, n), 1.0)
    T[0, 2, 3] = 1.25          # +0.25 over
    T[0, 5, 1] = -1.25         # −0.25 under: an exact tie
    T[1, 4, 6] = 1.5
    want = jax.jit(jeng._limit_repair_batched)(
        jnp.asarray(T), jnp.asarray(lo), jnp.asarray(hi))
    eng = port_engine(jeng, torch.float64)
    got = eng._limit_repair_batched(torch.as_tensor(T), torch.as_tensor(lo),
                                    torch.as_tensor(hi))
    _close(got, want)
    assert float(got.abs().max()) <= 1.0 + 1e-12


def test_f32_port_within_baseline_bar_of_f64_jax():
    run = _jax_run(21)
    jprobs = _batch(run, 4, seed=2)
    jout, _ = run.engine.iterate_batch(jprobs, 20)
    eng = port_engine(run.engine, torch.float32)
    tout, tcosts = BatchSolver(eng).iterate(
        port_probs(jprobs, torch.float32), 20)
    assert torch.isfinite(tcosts).all()
    err = np.abs(tout.traj.double().numpy() - np.asarray(jout.traj)).max()
    assert err <= F32_BAR, err
