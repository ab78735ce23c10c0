"""A batch's rows built on the card (``problem_batch_from_grid``) against
the numpy build they replace, at BASELINE config 1's shape (n_points 101)
and B = 256 and 10,240: the rows in float64 on the card are the numpy
rows; cast to float32, traj, B and Evels are the host cast's bits and
trC is within one float32 ulp of it.  Only the endpoints cross from the
host: the batch's ``host_sync`` count is their two copies (three with
seeds), as torch's sync debug mode counts them.  Skipped without a CUDA
device; run on the card with
``python -m pytest tests/test_torch_build_rows_gpu.py -q --noconftest``
(tests/conftest.py configures JAX, which that machine does not have)."""

import warnings

import numpy as np
import pytest
import torch

from or_cdchomp_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])


@pytest.fixture(scope="module")
def run():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import or_cdchomp_tpu_torch as pt

    mod = pt.CHOMPModule(dtype=torch.float32, device="cuda")
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(boxes=[
        ((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    robot = pt.Robot("wam", pt.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    return mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=101)]


def _numpy_rows(engine, starts, goals):
    a = np.linspace(0.0, 1.0, engine.spec.n_points)[None, :, None]
    trajs = (1 - a) * starts[:, None, :] + a * goals[:, None, :]
    return (trajs,) + engine.build_affine_batch(trajs[:, 0], trajs[:, -1],
                                                starts.shape[1])


def _build(run, starts, goals, **kw):
    """The batch, its recording and the syncs sync debug mode warned of."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording() as rec:
                probs = problem_batch_from_grid(run.problem, starts, goals,
                                                run.engine, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    return probs, rec, len(syncs)


@pytest.mark.parametrize("P", [256, 10240])
def test_rows_on_card_match_the_numpy_build(run, P):
    rng = np.random.default_rng(P)
    starts = START + 0.02 * rng.normal(size=(P, 7))
    goals = GOAL + 0.02 * rng.normal(size=(P, 7))
    eng = run.engine
    _build(run, starts, goals)                 # the constants, once
    probs, rec, syncs = _build(run, starts, goals)
    assert rec.counters["build.rows_on_card"] == P
    assert rec.counters["host_sync"] == 2 == syncs
    _, rec, syncs = _build(run, starts, goals, seeds=np.arange(P))
    assert rec.counters["host_sync"] == 3 == syncs

    want = _numpy_rows(eng, starts, goals)
    s, g = (torch.as_tensor(x, device="cuda") for x in (starts, goals))
    lines = eng.straight_lines(s, g)
    got = (lines,) + eng.build_affine_rows(lines[:, 0], lines[:, -1])
    for x, w in zip(got, want):                  # float64 on the card
        assert torch.equal(x.cpu(), torch.as_tensor(w))
    leaves = probs.leaves()
    for k, w in zip(("traj", "B", "trC", "Evels"), want):
        x = leaves[k]
        assert x.dtype == torch.float32 and x.is_cuda and x.is_contiguous()
        w32 = np.asarray(w).astype(np.float32)
        if k == "trC":
            ulp = np.spacing(np.abs(w32))
            assert np.all(np.abs(x.cpu().numpy() - w32) <= ulp)
        else:
            assert torch.equal(x.cpu(), torch.as_tensor(w32))
