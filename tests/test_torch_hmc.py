"""Momentum and HMC in the port's batched step against the JAX package,
float64 on the CPU.  jax.random's streams cannot be reproduced in torch,
so the port's deterministic resample update is fed JAX's own draws
(``JaxKeyDraw`` splits each problem's key as the JAX step does), and the
port's own generator is checked by its statistics."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import or_cdchomp_tpu as oc

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.solver import (HmcDraw, RecordingDraw,
                                               ReplayDraw, hmc_resample)
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)

from torch_parity import (GOAL, START, JaxKeyDraw, close, config1_module,
                          jax_batch, port_engine, port_probs)

RTOL = 1e-9   # float64 through the whole step: summation order only
HMC_LAMBDAS = [0.02, 2.0]   # 2.0: a second resample inside 5 iterations


@pytest.fixture(scope="module")
def jmod():
    return config1_module(oc, dtype=jnp.float64)


def _jax_run(jmod, **kw):
    h = jmod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    obs_factor=500.0, n_points=11, **kw)
    return jmod.runs[h]


def _port(run, jprobs):
    eng = port_engine(run.engine)
    eng.draw = JaxKeyDraw(jprobs.hmc.key, eng.spec.m, eng.spec.n)
    return eng, port_probs(jprobs)


def _same_state(tp, jp):
    close(tp.traj, jp.traj, RTOL)
    close(tp.AG, jp.AG, RTOL)
    for k in ("resample_iter", "leapfrog_first"):
        np.testing.assert_array_equal(getattr(tp, k).numpy(),
                                      np.asarray(getattr(jp.hmc, k)), k)
    np.testing.assert_array_equal(tp.iteration.numpy(),
                                  np.asarray(jp.iteration))


@pytest.mark.parametrize("lam", HMC_LAMBDAS)
def test_hmc_step_matches_jax(jmod, lam):
    run = _jax_run(jmod, use_hmc=True, hmc_resample_lambda=lam, seed=7)
    assert run.spec.use_hmc and run.spec.use_momentum
    jprobs = jax_batch(run, 4)
    jnew, jcosts = run.engine.iterate_batch(jprobs, 1)
    eng, tprobs = _port(run, jprobs)
    tnew, tcosts = eng.step_batched(tprobs)
    _same_state(tnew, jnew)
    close(tcosts, jcosts[:, 0], RTOL)
    # every problem resampled at iteration 0, and took the half step
    assert float(tnew.AG.abs().max()) > 0.0
    assert not bool(tnew.leapfrog_first.any())
    assert bool((tnew.resample_iter >= 1).all())


@pytest.mark.parametrize("lam", HMC_LAMBDAS)
def test_hmc_five_iterations_match_jax(jmod, lam):
    run = _jax_run(jmod, use_hmc=True, hmc_resample_lambda=lam, seed=7)
    jprobs = jax_batch(run, 4, seed=1)
    jout, jcosts = run.engine.iterate_batch(jprobs, 5)       # (B, 5, 3)
    eng, probs = _port(run, jprobs)
    resamples = torch.zeros(4, dtype=torch.int64)
    costs = []
    for _ in range(5):
        resamples += (probs.iteration == probs.resample_iter).long()
        probs, c = eng.step_batched(probs)
        costs.append(c)
    assert eng.draw.calls == 5
    _same_state(probs, jout)
    close(torch.stack(costs, dim=1), jcosts, RTOL)
    assert bool((resamples >= 1).all())
    if lam == 2.0:
        assert int(resamples.max()) >= 2


def test_momentum_without_hmc_matches_jax(jmod):
    run = _jax_run(jmod, use_momentum=True)
    assert run.spec.use_momentum and not run.spec.use_hmc
    jprobs = jax_batch(run, 3, seed=2)
    jout, jcosts = run.engine.iterate_batch(jprobs, 5)
    eng, probs = _port(run, jprobs)
    tout, tcosts = BatchSolver(eng).iterate(probs, 5)
    assert eng.draw.calls == 0           # no HMC: nothing drawn
    _same_state(tout, jout)
    close(tcosts.transpose(0, 1), jcosts, RTOL)


def test_masked_hmc_draws_once_per_applied_step(jmod):
    run = _jax_run(jmod, use_hmc=True, seed=3)
    jprobs = jax_batch(run, 2, seed=4)
    jout, _ = run.engine.iterate_batch(jprobs, 3)
    eng, probs = _port(run, jprobs)
    tout, costs = BatchSolver(eng).iterate_masked(probs, 3, 5)
    assert eng.draw.calls == 3 and tuple(costs.shape) == (5, 2, 3)
    _same_state(tout, jout)


def test_create_hmc_flags_and_second_create():
    """use_hmc implies momentum, as in the JAX package; a second create
    on the same module builds its own run with its own draw source."""
    mod = config1_module(pt, dtype=torch.float64, device="cpu")
    h1 = mod.create(robot="wam", adofgoal=GOAL, n_points=11)
    h2 = mod.create(robot="wam", adofgoal=GOAL, n_points=11, use_hmc=True,
                    hmc_resample_lambda=0.5, seed=7)
    h3 = mod.create(robot="wam", adofgoal=GOAL, n_points=11,
                    use_momentum=True)
    r1, r2, r3 = (mod.runs[h] for h in (h1, h2, h3))
    assert len({h1, h2, h3}) == 3
    assert (r1.spec.use_momentum, r1.spec.use_hmc) == (False, False)
    assert (r2.spec.use_momentum, r2.spec.use_hmc) == (True, True)
    assert (r3.spec.use_momentum, r3.spec.use_hmc) == (True, False)
    assert float(r2.problem.hmc_resample_lambda) == 0.5
    assert int(r2.problem.resample_iter) == 0
    assert bool(r2.problem.leapfrog_first)
    # the run's seed seeds its draw source
    z7 = r2.engine.draw.generator.initial_seed()
    assert z7 == 7 and r1.engine.draw.generator.initial_seed() == 0


def test_recorded_draws_replay_the_run():
    """A run's recorded draws, replayed into a run with another seed,
    give the same resample schedule and trajectories, which that run's
    own draws do not; a recorder with ``n`` keeps the first n problems'
    draws."""
    mod = config1_module(pt, dtype=torch.float64, device="cpu")
    runs = []
    for s in (7, 8):
        # creates of one structure share a cached engine and its batch
        # draw source; each run here needs an engine seeded by its own
        mod.clear_engine_cache()
        runs.append(mod.runs[mod.create(
            robot="wam", adofgoal=GOAL, n_points=11, use_hmc=True,
            hmc_resample_lambda=2.0, seed=s)])
    assert runs[0].engine is not runs[1].engine
    rng = np.random.default_rng(0)
    starts = START + 0.02 * rng.normal(size=(3, 7))
    goals = GOAL + 0.02 * rng.normal(size=(3, 7))

    def solve(run):
        probs = problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)
        return BatchSolver(run.engine).iterate(probs, 5)[0]

    own = solve(runs[1])
    rec = RecordingDraw(runs[0].engine.draw)
    runs[0].engine.draw = rec
    runs[1].engine.draw = ReplayDraw(rec.z, rec.u)
    outs = [solve(r) for r in runs]
    assert len(rec.z) == 5 and runs[1].engine.draw.calls == 5
    for k in ("traj", "AG", "resample_iter", "leapfrog_first"):
        assert torch.equal(getattr(outs[0], k), getattr(outs[1], k)), k
    assert not torch.equal(own.traj, outs[1].traj)
    short = RecordingDraw(HmcDraw(seed=1, device="cpu"), n=2)
    z, _ = short(_fake_batch(3, 4, 2, 0, 0.02))
    assert tuple(z.shape) == (3, 4, 2)
    assert torch.equal(short.z[0], z[:2]) and tuple(short.u[0].shape) == (2,)


def _fake_batch(B, m, n, it, lam, dtype=torch.float64):
    return types.SimpleNamespace(
        AG=torch.zeros((B, m, n), dtype=dtype),
        iteration=torch.full((B,), it, dtype=torch.int32),
        resample_iter=torch.full((B,), it, dtype=torch.int32),
        leapfrog_first=torch.zeros(B, dtype=torch.bool),
        hmc_resample_lambda=torch.full((B,), lam, dtype=dtype))


@pytest.mark.parametrize("it", [0, 50])
def test_own_generator_noise_std(it):
    """AG ~ N(0, 1/α) at a resample, α = 100·e^{0.02·it}: the sample std
    within 4σ of 1/√α over 20,000 × 6 draws."""
    B, m, n = 20_000, 3, 2
    probs = _fake_batch(B, m, n, it, 0.02)
    z, u = HmcDraw(seed=11, device="cpu")(probs)
    assert tuple(z.shape) == (B, m, n) and tuple(u.shape) == (B,)
    AG, nxt, leap = hmc_resample(probs, z, u)
    assert bool(leap.all()) and bool((nxt > it).all())
    want = 1.0 / np.sqrt(100.0 * np.exp(0.02 * it))
    N = B * m * n
    std = float(AG.std())
    assert abs(std - want) < 4 * want / np.sqrt(2 * N), (std, want)
    assert abs(float(AG.mean())) < 4 * want / np.sqrt(N)


@pytest.mark.parametrize("lam", [0.02, 0.5])
def test_own_generator_gap_mean(lam):
    """gap = 1 + ⌊E/λ⌋ with E ~ Exp(1) is 1 + Geometric: mean
    1 + 1/(e^λ − 1), std √(e^{−λ})/(1 − e^{−λ}); within 4σ of the mean
    over 20,000 draws, u within [1e-12, 1)."""
    B = 20_000
    probs = _fake_batch(B, 1, 1, 5, lam)
    z, u = HmcDraw(seed=5, device="cpu")(probs)
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    _, nxt, _ = hmc_resample(probs, z, u)
    gap = (nxt - 5).double()
    assert int(gap.min()) >= 1
    q = np.exp(-lam)
    mean, sd = 1.0 + 1.0 / (np.exp(lam) - 1.0), np.sqrt(q) / (1.0 - q)
    assert abs(float(gap.mean()) - mean) < 4 * sd / np.sqrt(B)


def test_resample_only_where_due():
    """A problem not at its resample iteration keeps AG, its schedule and
    its leapfrog flag; the draw is consumed all the same."""
    probs = _fake_batch(3, 2, 2, 4, 0.02)
    probs.resample_iter = torch.tensor([4, 9, 2], dtype=torch.int32)
    probs.AG = torch.full((3, 2, 2), 0.25, dtype=torch.float64)
    probs.leapfrog_first = torch.tensor([False, True, False])
    z = torch.ones((3, 2, 2), dtype=torch.float64)
    u = torch.full((3,), np.exp(-0.11), dtype=torch.float64)  # gap 1 + 5
    AG, nxt, leap = hmc_resample(probs, z, u)
    alpha = 100.0 * np.exp(0.02 * 4)
    np.testing.assert_allclose(AG[0].numpy(), 1.0 / np.sqrt(alpha))
    assert torch.equal(AG[1:], probs.AG[1:])
    assert nxt.tolist() == [4 + 1 + 5, 9, 2]
    assert leap.tolist() == [True, True, False]
