"""What the CPU can check of the step replayed as a CUDA graph
(chomp/solver.py ``StepGraph``, ``ChompEngine.stepper``): off the card,
``iterate_batched`` is the eager loop of ``step_batched``, bit for bit;
a replica captures its own graphs; an engine holds no reference cycle,
so the module's engine cache frees an evicted engine, its graphs' memory
pools with it, at once; BatchSolver's default device list.  The replays
themselves run on the card (tests/test_torch_kernels_gpu.py,
chip_smoke.py)."""

import gc
import weakref

import numpy as np
import pytest
import torch

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import solver as solver_mod
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)

from torch_parity import GOAL, START, table_module


@pytest.fixture(scope="module")
def mod():
    m = table_module(pt, dtype=torch.float64, device="cpu")
    robot = m.robots["wam"]
    robot.enabled = False
    m.computedistancefield(kinbody="table", cube_extent=0.15)
    robot.enabled = True
    return m


def _batch(mod, B=3, **kw):
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, n_points=9, **kw)]
    rng = np.random.default_rng(0)
    starts = np.tile(START, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(GOAL, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    starts[0, 0] = 2.75                # past J1's limit: the repair runs
    return run, problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)


@pytest.mark.parametrize("hmc", [False, True])
def test_cpu_iterate_is_the_eager_loop(mod, hmc):
    """iterate_batched on the CPU against step_batched calls: the state
    and the costs bit-equal, the same draws (two generators of one
    seed), and an empty iterate returning the batch itself."""
    kw = dict(use_hmc=True, hmc_resample_lambda=2.0) if hmc else {}
    run, probs = _batch(mod, **kw)
    eng = run.engine
    assert isinstance(eng.stepper(probs), solver_mod._EagerSteps)
    draw = solver_mod.HmcDraw(4, "cpu")
    want, costs = probs, []
    for _ in range(4):
        want, c = eng.step_batched(want, draw if hmc else None)
        costs.append(c)
    got, gcosts = eng.iterate_batched(
        probs, 4, solver_mod.HmcDraw(4, "cpu") if hmc else None)
    for k, v in want.leaves().items():
        assert torch.equal(got.leaves()[k], v), k
    assert torch.equal(gcosts, torch.stack(costs, dim=1))
    same, empty = eng.iterate_batched(probs, 0)
    assert same is probs and tuple(empty.shape) == (3, 0, 3)


def test_replica_captures_its_own(mod):
    """A replica does not share its engine's captured steps."""
    run, _ = _batch(mod)
    eng = run.engine
    eng.__dict__["_graphs"] = {"key": "the engine's"}
    try:
        rep = eng._replica("cpu", 1)
        assert "_graphs" not in rep.__dict__
    finally:
        del eng.__dict__["_graphs"]
        eng.__dict__.pop("_replicas", None)


def test_evicted_engine_freed_at_once(mod):
    """With the garbage collector off, an engine dropped from the module's
    cache and no run's is freed (its replicas too): nothing keeps its
    graphs' memory."""
    gc.disable()
    try:
        h = mod.create(robot="wam", adofgoal=GOAL, n_points=11)
        eng = mod.runs[h].engine
        refs = weakref.ref(eng), weakref.ref(eng._replica("cpu", 1))
        eng.__dict__["_graphs"] = {"key": "a captured step"}
        del eng
        mod.destroy(run=h)
        mod.clear_engine_cache()
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_default_devices_of_a_cpu_engine(mod):
    """JAX's default device list: a CPU engine stays alone (a CUDA engine
    spreads over every visible card, its own first)."""
    run, probs = _batch(mod)
    solver = BatchSolver(run.engine)
    assert solver.devices == [torch.device("cpu")]
    assert solver.replicas == [run.engine]
