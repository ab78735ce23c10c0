"""A batch's rows built from its endpoints on the engine's device
(``ChompEngine.straight_lines``, ``ChompEngine.build_affine_rows``,
``problem_batch_from_grid``), held bit-equal in float64 on the CPU to
the numpy expressions they replace (the lines, and
``ChompEngine.build_affine_batch``): the dense metric, the
semiseparable one, start_tsr and the floating base with its kept
quaternion columns, at P = 1, 3 and 257.  The card's side is
tests/test_torch_build_rows_gpu.py."""

import numpy as np
import pytest
import torch

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import solver as solver_mod
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
from or_cdchomp_tpu_torch.utils import profiling

from torch_parity import (GOAL, config1_module, config4_kw, perturbed,
                          start_tsr)

N_POINTS = 9
CASES = ["dense", "sep", "start_tsr", "floating"]
SIZES = [1, 3, 257]
ROWS = ("traj", "B", "trC", "Evels")


@pytest.fixture(scope="module")
def mod():
    return config1_module(pt, cube_extent=0.08, dtype=torch.float64,
                          device="cpu")


@pytest.fixture(scope="module")
def runs(mod):
    """{case: (template problem, engine, run)}."""
    kw = dict(robot="wam", adofgoal=GOAL, n_points=N_POINTS)
    dense = mod.runs[mod.create(**kw)]
    tsr = mod.runs[mod.create(**kw, start_tsr=start_tsr(pt.TSR))]
    floating = mod.runs[mod.create(**config4_kw(pt.TSR, N_POINTS))]
    sep = ChompEngine(dense.spec, pt.wam7(), dense.engine.fields,
                      dtype=torch.float64, device="cpu", metric_mode="sep")
    assert dense.engine.metric_mode == "dense" and tsr.spec.start_tsr
    assert floating.spec.floating_base and floating.spec.n == 14
    return {"dense": (dense.problem, dense.engine, dense),
            "sep": (dense.problem, sep, dense),
            "start_tsr": (tsr.problem, tsr.engine, tsr),
            "floating": (floating.problem, floating.engine, floating)}


def _numpy_rows(engine, starts, goals):
    """The rows as the numpy build made them: (lines, B, trC, Evels),
    float64."""
    a = np.linspace(0.0, 1.0, engine.spec.n_points)[None, :, None]
    trajs = (1 - a) * starts[:, None, :] + a * goals[:, None, :]
    return (trajs,) + engine.build_affine_batch(trajs[:, 0], trajs[:, -1],
                                                starts.shape[1])


def _same(got, want):
    """Same shape, same bits."""
    got = got.detach().cpu()
    want = torch.as_tensor(np.asarray(want), dtype=got.dtype)
    assert got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("n", [1, 7, 8, 14, 17, 129, 300])
def test_numpy_sum_order(n):
    """The pairwise sum rounds as ``np.sum(axis=-1)`` does, where
    ``torch.sum`` need not: values over 40 binades."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(5, n)) * np.exp2(rng.integers(-20, 20, (5, n)))
    got = solver_mod._numpy_sum(torch.as_tensor(x))
    assert np.array_equal(got.numpy(), np.sum(x, axis=-1))


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_affine_rows_bit_equal_to_numpy(runs, case, P):
    """The lines and build_affine_rows in float64 are bit-equal to the
    numpy lines and build_affine_batch, on endpoints spread over many
    binades (the floating base's quaternion columns kept)."""
    _, engine, run = runs[case]
    starts, goals = perturbed(run, P, seed=P)
    rng = np.random.default_rng(P)
    scale = np.exp2(rng.integers(-12, 12, size=starts.shape))
    starts, goals = starts * scale, goals * scale[::-1]
    want = _numpy_rows(engine, starts, goals)
    s, g = (torch.as_tensor(x) for x in (starts, goals))
    lines = engine.straight_lines(s, g)
    got = (lines,) + engine.build_affine_rows(lines[:, 0], lines[:, -1])
    for x, w in zip(got, want):
        assert x.dtype == torch.float64
        _same(x, w)


@pytest.mark.parametrize("P", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_batch_rows_bit_equal_to_numpy_build(runs, case, P):
    """problem_batch_from_grid's traj, B, trC and Evels are the numpy
    build's, cast to the engine's dtype; every other leaf is the
    template's, broadcast, or a fresh HMC state; every leaf is
    contiguous; on the CPU no row is counted as built on a card."""
    tmpl, engine, run = runs[case]
    starts, goals = perturbed(run, P, seed=10 + P)
    with profiling.recording() as rec:
        probs = problem_batch_from_grid(tmpl, starts, goals, engine)
    assert rec.counters["build.rows_on_card"] == 0
    assert [s.name for s in rec.children(rec.top_level()[0])] == [
        "build.rows", "build.expand", "build.copy"]
    leaves = probs.leaves()
    for k, w in zip(ROWS, _numpy_rows(engine, starts, goals)):
        _same(leaves[k], w)
    for k, v in tmpl.leaves().items():
        if k not in ROWS + ("AG", "resample_iter", "leapfrog_first",
                            "iteration"):
            assert torch.equal(leaves[k], v.expand((P,) + v.shape))
    assert not leaves["AG"].any() and not leaves["iteration"].any()
    assert not leaves["resample_iter"].any()
    assert leaves["leapfrog_first"].all() and probs.hmc_seed is None
    assert all(v.is_contiguous() and v.shape[0] == P
               for v in leaves.values())


def test_float32_batch_is_the_numpy_build_cast(runs):
    """A float32 engine's rows are the float64 rows cast on its device,
    as the host cast made them."""
    tmpl, dense, run = runs["dense"]
    eng = ChompEngine(dense.spec, pt.wam7(), dense.fields,
                      dtype=torch.float32, device="cpu")
    starts, goals = perturbed(run, 5, seed=7)
    probs = problem_batch_from_grid(tmpl, starts, goals, eng)
    for k, w in zip(ROWS, _numpy_rows(eng, starts, goals)):
        got = probs.leaves()[k]
        assert got.dtype == torch.float32
        assert torch.equal(got, torch.as_tensor(w).to(torch.float32))


def test_endpoints_as_lists_tensors_and_with_seeds(runs):
    """Endpoints given as lists or float32 tensors build the rows of
    their float64 values; seeds still become the int64 leaf; the
    constants are made at the first batch and kept."""
    tmpl, engine, run = runs["dense"]
    starts, goals = perturbed(run, 3, seed=5)
    s32 = torch.as_tensor(starts, dtype=torch.float32)
    want = problem_batch_from_grid(tmpl, s32.double().numpy(),
                                   goals.tolist(), engine)
    consts = engine._row_consts()
    got = problem_batch_from_grid(tmpl, s32, torch.as_tensor(goals), engine,
                                  seeds=[4, 5, 6])
    assert engine._row_consts() is consts
    for k in ROWS:
        assert torch.equal(got.leaves()[k], want.leaves()[k])
    assert got.hmc_seed.dtype == torch.int64
    assert got.hmc_seed.tolist() == [4, 5, 6]
    with pytest.raises(ValueError, match="seeds must have one entry"):
        problem_batch_from_grid(tmpl, starts, goals, engine, seeds=[1, 2])


def test_replica_makes_its_own_row_constants(runs):
    """A replica drops the engine's kept row constants (they sit on the
    engine's device) and makes its own at its first batch."""
    tmpl, engine, run = runs["dense"]
    engine._row_consts()
    rep = engine._replica(torch.device("cpu"), slot=1)
    assert "_rows" not in rep.__dict__
    starts, goals = perturbed(run, 2, seed=9)
    a = problem_batch_from_grid(tmpl, starts, goals, rep)
    b = problem_batch_from_grid(tmpl, starts, goals, engine)
    for k in ROWS:
        assert torch.equal(a.leaves()[k], b.leaves()[k])
