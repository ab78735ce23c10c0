"""The joint-limit repair (ops/limits.py) against the JAX package's
``ChompEngine._limit_repair_batched`` (a ``lax.while_loop``) at float64 on
the CPU, where ``limit_repair`` runs its plain version; the kernel's
premise (a row repaired alone equals its row of the batch); the engine's
dispatch; and the launch counts that a CUDA graph's replays add
(ops/kernels.py).  The kernel itself is held to the plain version on the
card (tests/test_torch_kernels_gpu.py, chip_smoke.py).

Small shapes: n_points 9 (m = 7) for the dense metric, n_points 18
(m = 16) for the semiseparable one, reached by patching ``SEP_MIN_M`` to
16 in both packages with their engine caches emptied."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import metric as jmm
from or_cdchomp_tpu.chomp import solver as jsolver

from or_cdchomp_tpu_torch.chomp import metric as tmm
from or_cdchomp_tpu_torch.ops import kernels, limits

from torch_parity import GOAL, close, port_engine, table_module

RTOL = 1e-12    # float64, the same rounds in the same order: sums only
SMALL_MIN_M = 16


@pytest.fixture(scope="module")
def jmod():
    """tests/test_transport.py's table world in the JAX package, one SDF
    at 0.15 m (the repair reads only the engine's metric)."""
    mod = table_module(oc, dtype=jnp.float64)
    robot = mod.robots["wam"]
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    robot.enabled = True
    return mod


def _engines(jmod, n_points):
    """(JAX engine, the port's CPU float64 engine) of a fresh run."""
    jmod._engine_cache.clear()
    h = jmod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                    obs_factor=500.0, n_points=n_points)
    jeng = jmod.runs[h].engine
    return jeng, port_engine(jeng)


def _limits(B, n):
    lo = np.full((B, n), -1.0)
    hi = np.full((B, n), 1.0)
    lo[:, 6] = -2.5                    # limits that differ by joint
    hi[:, 6] = 0.75
    return lo, hi


def _case(name, B, m, n):
    """(T, lo, hi) of a case, float64 numpy, seeded."""
    rng = np.random.default_rng(7)
    lo, hi = _limits(B, n)
    T = rng.uniform(-0.9, 0.7, size=(B, m, n))
    if name in ("many_rounds", "cap"):
        # row 0 far out in most entries, the others inside
        T[0] += rng.normal(size=(m, n)) * 1.5
    if name == "sep":
        # a few violations in rows 0, 2 and 3 (the semiseparable repair
        # spreads each over the whole column)
        T *= 0.3
        T[0, 3, 2] = 1.4
        T[0, m - 4, 5] = -1.2
        T[2, m // 2, 1] = 1.3
        T[3, 0, 6] = -2.7
    if name == "tie":
        T *= 0.3                       # far from the limits elsewhere
        T[0, 2, 3] = 1.25              # +0.25 over
        T[0, 5, 1] = -1.25             # -0.25 under: an exact tie
        T[1, 4, 6] = 0.85              # 0.1 over joint 7's own limit
    return T, lo, hi


def _both(jeng, teng, T, lo, hi):
    want = jax.jit(jeng._limit_repair_batched)(
        jnp.asarray(T), jnp.asarray(lo), jnp.asarray(hi))
    metric = teng.Ainv if teng.metric_mode == "dense" else teng.spec.dt
    got, stats = limits.limit_repair_ref(
        torch.as_tensor(T), torch.as_tensor(lo), torch.as_tensor(hi),
        metric, want_stats=True)
    return got, np.asarray(want), stats


@pytest.mark.parametrize("case", ["clean", "many_rounds", "tie", "cap",
                                  "sep"])
def test_limit_repair_matches_jax(jmod, monkeypatch, case):
    """The plain version against JAX's while_loop: no violation; one row
    needing many rounds beside rows needing none; an exact tie (the first
    index in row-major order wins); the round cap patched to 3 in both
    packages; the semiseparable metric."""
    n_points = 9
    if case == "cap":
        monkeypatch.setattr(jsolver, "_MAX_LIMIT_FIXES", 3)
        monkeypatch.setattr(limits, "_MAX_LIMIT_FIXES", 3)
    if case == "sep":
        monkeypatch.setattr(jmm, "SEP_MIN_M", SMALL_MIN_M)
        monkeypatch.setattr(tmm, "SEP_MIN_M", SMALL_MIN_M)
        n_points = SMALL_MIN_M + 2
    try:
        jeng, teng = _engines(jmod, n_points)
    finally:
        if case == "sep":
            monkeypatch.undo()
    mode = "sep" if case == "sep" else "dense"
    assert jeng.metric_mode == teng.metric_mode == mode
    m, n = teng.spec.m, teng.spec.n
    T, lo, hi = _case(case, 4, m, n)
    got, want, stats = _both(jeng, teng, T, lo, hi)
    close(got, want, RTOL)
    rounds = stats[:, 0].tolist()
    if case == "clean":
        assert rounds == [0, 0, 0, 0]
        assert torch.equal(got, torch.as_tensor(T))
    if case == "many_rounds":
        assert rounds[0] > 10 and rounds[1:] == [0, 0, 0]
        assert float(got[..., :6].abs().max()) <= 1.0 + 1e-12
    if case == "sep":
        assert min(rounds[0], rounds[2], rounds[3]) >= 1 and rounds[1] == 0
        assert float(got[..., :6].abs().max()) <= 1.0 + 1e-12
    if case == "cap":
        assert rounds == [3, 0, 0, 0]
        assert float(got.max()) > 1.0       # stopped short of clean
    if case == "tie":
        assert rounds[:2] == [2, 1]
        assert float(got[:, :, :6].abs().max()) <= 1.0 + 1e-12


def test_limit_repair_tie_first_round(jmod, monkeypatch):
    """After one round of the tie, the upper violation at (2, 3) (the
    first in row-major order) is repaired and the lower one at (5, 1) is
    still there, in both packages."""
    monkeypatch.setattr(jsolver, "_MAX_LIMIT_FIXES", 1)
    monkeypatch.setattr(limits, "_MAX_LIMIT_FIXES", 1)
    jeng, teng = _engines(jmod, 9)
    T, lo, hi = _case("tie", 2, teng.spec.m, teng.spec.n)
    got, want, _ = _both(jeng, teng, T, lo, hi)
    close(got, want, RTOL)
    assert float(got[0, 2, 3]) < 1.0
    assert float(got[0, 5, 1]) < -1.0


@pytest.mark.parametrize("case", ["many_rounds", "sep"])
def test_limit_repair_rows_alone(jmod, monkeypatch, case):
    """The kernel's premise: each row repaired alone (B = 1), rounding
    only until its own row is clean, equals its row of the batch, which
    rounds while any row violates; and its rounds are the batch's count
    for that row."""
    n_points = 9
    if case == "sep":
        monkeypatch.setattr(jmm, "SEP_MIN_M", SMALL_MIN_M)
        monkeypatch.setattr(tmm, "SEP_MIN_M", SMALL_MIN_M)
        n_points = SMALL_MIN_M + 2
    _, teng = _engines(jmod, n_points)
    metric = teng.Ainv if teng.metric_mode == "dense" else teng.spec.dt
    T, lo, hi = (torch.as_tensor(a) for a in _case(case, 4, teng.spec.m,
                                                    teng.spec.n))
    batch, stats = limits.limit_repair_ref(T, lo, hi, metric,
                                           want_stats=True)
    for b in range(4):
        one, st = limits.limit_repair_ref(T[b:b + 1], lo[b:b + 1],
                                          hi[b:b + 1], metric,
                                          want_stats=True)
        close(one[0], batch[b].numpy(), RTOL)
        assert torch.equal(st[0], stats[b])
    jmod._engine_cache.clear()


def test_limit_repair_dispatch(jmod):
    """The engine's repair on the CPU is the plain version under its
    metric; a device that is neither the CPU nor a card raises."""
    _, teng = _engines(jmod, 9)
    T, lo, hi = (torch.as_tensor(a) for a in _case("many_rounds", 3,
                                                    teng.spec.m,
                                                    teng.spec.n))
    assert torch.equal(teng._limit_repair_batched(T, lo, hi),
                       limits.limit_repair_ref(T, lo, hi, teng.Ainv))
    assert torch.equal(limits.limit_repair(T, lo, hi, teng.Ainv),
                       limits.limit_repair_ref(T, lo, hi, teng.Ainv))
    meta = T.to("meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        limits.limit_repair(meta, lo.to("meta"), hi.to("meta"), 0.1)


def test_limit_repair_work():
    """traffic_bytes and flops from a call's shapes and stats."""
    assert limits.traffic_bytes(256, 99, 7, 4) == (2 * 256 * 693
                                                   + 2 * 256 * 7) * 4
    stats = torch.tensor([[2, 5], [0, 0]], dtype=torch.int32)
    m, n = 99, 7
    assert limits.flops(m, n, stats) == (4 * m * n * 4 + 2 * m * n * 2
                                         + 2 * m * 5)


def test_launch_counts_through_capture():
    """kernels.count adds to the owner's count; while recording (a graph's
    capture) it only records; replay_counts counts each record once
    more."""
    owner = types.SimpleNamespace(LAUNCHES=0, OTHER=0)
    kernels.count(owner, "LAUNCHES")
    with kernels.recording() as records:
        kernels.count(owner, "LAUNCHES")
        kernels.count(owner, "OTHER")
    assert (owner.LAUNCHES, owner.OTHER) == (1, 0)
    assert [r[1] for r in records] == ["LAUNCHES", "OTHER"]
    for _ in range(3):
        kernels.replay_counts(records)
    assert (owner.LAUNCHES, owner.OTHER) == (4, 3)
