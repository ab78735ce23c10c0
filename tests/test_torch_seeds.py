"""Per-problem HMC seeds in the port, on the CPU at float64:
``problem_batch_from_grid(..., seeds=...)`` against the JAX package's
(the same batch, the seeds kept as a leaf), the draw's plain version
(ops/draw.py) against a pure-Python Philox4x32-10 and Box–Muller, a
seeded problem's draws and trajectory independent of its batch and of
the other rows' iterations, ``iterate_masked``, and the draws' mean and
spread (as tests/test_torch_hmc.py holds HmcDraw's)."""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel.batch import \
    problem_batch_from_grid as jax_batch_from_grid

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.solver import (RecordingDraw, SeededDraw,
                                               hmc_resample)
from or_cdchomp_tpu_torch.ops import draw
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)

from torch_parity import GOAL, START, close, table_module

M32 = 0xFFFFFFFF
# Random123's known answers for Philox4x32-10: (counter, key, output)
KATS = [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32,) * 4, (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
]
SEEDS = np.array([7, 8, 2 ** 40 + 3])
N_ITER = 5
KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
          n_points=9, use_hmc=True, hmc_resample_lambda=0.5)


def philox_py(ctr, key):
    """Philox4x32-10 in plain Python integers (Salmon et al., SC'11)."""
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + 0x9E3779B9) & M32, (k[1] + 0xBB67AE85) & M32]
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [((p1 >> 32) ^ c[1] ^ k[0]) & M32, p1 & M32,
             ((p0 >> 32) ^ c[3] ^ k[1]) & M32, p0 & M32]
    return c


def _key(seed):
    s = int(seed) & (2 ** 64 - 1)
    return s & M32, s >> 32


def test_philox_twin_matches_pure_python():
    """The twin's int64 rounds: Random123's known answers, and random
    counters and seeds (negative and above 2³² too)."""
    for ctr, key, want in KATS:
        assert tuple(philox_py(ctr, key)) == want
        if ctr[3] == 0:
            seed = key[0] | (key[1] << 32)
            got = draw.philox_ref(torch.tensor(seed - (seed >> 63 << 64)),
                                  *map(torch.tensor, ctr[:3]))
            assert tuple(got.tolist()) == want
    rng = np.random.default_rng(0)
    seeds = rng.integers(-2 ** 63, 2 ** 63 - 1, size=64, dtype=np.int64)
    c = rng.integers(0, 2 ** 32, size=(3, 64), dtype=np.int64)
    got = draw.philox_ref(torch.as_tensor(seeds),
                          *(torch.as_tensor(x) for x in c)).tolist()
    for i in range(64):
        assert got[i] == philox_py((*c[:, i].tolist(), 0), _key(seeds[i]))


def test_draw_words_and_transform_match_pure_python():
    """Counter layout (element block, iteration, stream) and the float64
    Box–Muller / uniform maps, against plain Python for m·n = 13 (a
    partial last block)."""
    m, n = 13, 1
    seed = torch.tensor([5, 2 ** 33 + 1])
    it = torch.tensor([0, 17], dtype=torch.int32)
    z, u, wz, wu = draw.hmc_draw(seed, it, m, n, torch.float64,
                                 want_words=True)
    assert tuple(wz.shape) == (2, 4, 4) and tuple(wu.shape) == (2, 4)
    for b in range(2):
        k = _key(seed[b])
        for j in range(4):
            assert wz[b, j].tolist() == philox_py((j, int(it[b]), 0, 0), k)
        assert wu[b].tolist() == philox_py((0, int(it[b]), 1, 0), k)
        want = []
        for j in range(4):
            w = wz[b, j].tolist()
            for h in range(2):
                r = math.sqrt(-2.0 * math.log((w[2 * h] + 1.0) * 2.0 ** -32))
                th = 2.0 * math.pi * (w[2 * h + 1] * 2.0 ** -32)
                want += [r * math.cos(th), r * math.sin(th)]
        close(z[b, :, 0], np.array(want[:m]), 1e-14)
        u_want = 1e-12 + (1.0 - 1e-12) * (wu[b, 0].item() * 2.0 ** -32)
        assert float(u[b]) == u_want
    z32, u32 = draw.hmc_draw(seed, it, m, n, torch.float32)
    assert torch.equal(z32, z.float()) and float(u32.max()) < 1.0


@pytest.fixture(scope="module")
def mods():
    out = []
    for pkg, kw in ((pt, dict(dtype=torch.float64, device="cpu")),
                    (oc, dict(dtype=jnp.float64))):
        mod = table_module(pkg, **kw)
        robot = mod.robots["wam"]
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.15)
        robot.enabled = True
        out.append(mod)
    return out


def _endpoints(B=3):
    rng = np.random.default_rng(6)
    return (START + 0.02 * rng.normal(size=(B, 7)),
            GOAL + 0.02 * rng.normal(size=(B, 7)))


def test_seeded_batch_matches_jax(mods):
    """The same batch as the JAX package's with the same seeds; the seeds
    are the int64 leaf hmc_seed (JAX keeps keys made from them)."""
    tm, jm = mods
    trun = tm.runs[tm.create(**KW)]
    jrun = jm.runs[jm.create(**KW)]
    starts, goals = _endpoints()
    tb = problem_batch_from_grid(trun.problem, starts, goals, trun.engine,
                                 seeds=SEEDS)
    jb = jax_batch_from_grid(jrun.problem, starts, goals, jrun.engine,
                             seeds=SEEDS)
    assert tb.hmc_seed.dtype == torch.int64
    assert tb.hmc_seed.tolist() == SEEDS.tolist()
    jhmc = jb.hmc._asdict()
    for k, v in tb.leaves().items():
        if k == "hmc_seed":
            continue
        want = np.asarray(jhmc[k] if k in jhmc else getattr(jb, k))
        assert tuple(v.shape) == want.shape, k
        if want.size:
            close(v, want, 1e-12)
    with pytest.raises(ValueError, match="one entry per problem"):
        problem_batch_from_grid(trun.problem, starts, goals, trun.engine,
                                seeds=SEEDS[:2])


def _solve(run, starts, goals, seeds, n_iter=N_ITER):
    """n_iter HMC steps of a seeded batch; returns (probs, recorded)."""
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine,
                                    seeds=seeds)
    rec = RecordingDraw(SeededDraw())
    probs, _ = run.engine.iterate_batched(probs, n_iter, rec)
    return probs, rec


def test_seeded_draws_do_not_depend_on_the_batch(mods):
    """Row 1 of a B = 3 batch and the same problem alone: bit-equal draws
    at every step, trajectories within 1e-12; the step takes SeededDraw
    itself for a seeded batch and never touches the engine's draw."""
    tm, _ = mods
    run = tm.runs[tm.create(**KW)]
    starts, goals = _endpoints()
    big, rec3 = _solve(run, starts, goals, SEEDS)
    one, rec1 = _solve(run, starts[1:2], goals[1:2], SEEDS[1:2])
    assert len(rec3.z) == len(rec1.z) == N_ITER
    for i in range(N_ITER):
        assert torch.equal(rec3.z[i][1:2], rec1.z[i])
        assert torch.equal(rec3.u[i][1:2], rec1.u[i])
    assert not torch.equal(rec3.z[0][0], rec3.z[0][1])
    close(big.traj[1:2], one.traj, 1e-12)
    assert torch.equal(big.resample_iter[1:2], one.resample_iter)

    calls, own = [], run.engine.draw
    run.engine.draw = lambda probs: calls.append(1)
    try:
        probs = problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine, seeds=SEEDS)
        out, _ = BatchSolver(run.engine).iterate(probs, 2)
    finally:
        run.engine.draw = own
    assert not calls
    close(out.traj, _solve(run, starts, goals, SEEDS, 2)[0].traj, 0.0)


def test_seeded_draws_follow_each_rows_iteration(mods):
    """A row's draw depends on its own iteration only: rows at different
    iterations in one batch draw what each draws alone;
    ``iterate_masked`` (valid 2 of 4) then 1 step equals 3 plain steps."""
    tm, _ = mods
    run = tm.runs[tm.create(**KW)]
    starts, goals = _endpoints()
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine,
                                    seeds=SEEDS)
    mixed = probs.replace(iteration=torch.tensor([4, 0, 9],
                                                 dtype=torch.int32))
    z, u = SeededDraw()(mixed)
    for b, it in enumerate((4, 0, 9)):
        solo = probs.replace(
            iteration=torch.tensor([it], dtype=torch.int32),
            hmc_seed=probs.hmc_seed[b:b + 1], AG=probs.AG[b:b + 1])
        zs, us = SeededDraw()(solo)
        assert torch.equal(z[b:b + 1], zs) and torch.equal(u[b:b + 1], us)
    solver = BatchSolver(run.engine)
    masked, costs = solver.iterate_masked(probs, 2, 4)
    assert tuple(costs.shape) == (4, 3, 3)
    masked, _ = solver.iterate(masked, 1)
    plain, _ = solver.iterate(probs, 3)
    assert torch.equal(masked.iteration, plain.iteration)
    close(masked.traj, plain.traj, 0.0)


def _fake_batch(B, m, n, it, lam, seed0=11):
    return types.SimpleNamespace(
        AG=torch.zeros((B, m, n), dtype=torch.float64),
        iteration=torch.full((B,), it, dtype=torch.int32),
        resample_iter=torch.full((B,), it, dtype=torch.int32),
        leapfrog_first=torch.zeros(B, dtype=torch.bool),
        hmc_resample_lambda=torch.full((B,), lam, dtype=torch.float64),
        hmc_seed=seed0 + torch.arange(B))


@pytest.mark.parametrize("it", [0, 50])
def test_seeded_noise_std(it):
    """AG ~ N(0, 1/α) at a resample: the sample std within 4σ of 1/√α and
    the mean within 4σ of 0, over 20,000 × 6 draws."""
    B, m, n = 20_000, 3, 2
    probs = _fake_batch(B, m, n, it, 0.02)
    z, u = SeededDraw()(probs)
    AG, nxt, leap = hmc_resample(probs, z, u)
    assert bool(leap.all()) and bool((nxt > it).all())
    want = 1.0 / np.sqrt(100.0 * np.exp(0.02 * it))
    N = B * m * n
    assert abs(float(AG.std()) - want) < 4 * want / np.sqrt(2 * N)
    assert abs(float(AG.mean())) < 4 * want / np.sqrt(N)


@pytest.mark.parametrize("lam", [0.02, 0.5])
def test_seeded_gap_mean(lam):
    """gap = 1 + ⌊E/λ⌋ with E ~ Exp(1): its mean within 4σ of
    1 + 1/(e^λ − 1) over 20,000 draws, u within [1e-12, 1)."""
    B = 20_000
    probs = _fake_batch(B, 1, 1, 5, lam, seed0=3)
    z, u = SeededDraw()(probs)
    assert float(u.min()) >= 1e-12 and float(u.max()) < 1.0
    _, nxt, _ = hmc_resample(probs, z, u)
    gap = (nxt - 5).double()
    assert int(gap.min()) >= 1
    q = np.exp(-lam)
    mean, sd = 1.0 + 1.0 / (np.exp(lam) - 1.0), np.sqrt(q) / (1.0 - q)
    assert abs(float(gap.mean()) - mean) < 4 * sd / np.sqrt(B)
