"""The port's checkpoints, float64 on the CPU (counterpart of
tests/test_checkpoint_addfield.py:34, 56): save → load → continue equals
an uninterrupted run bit for bit, for a module run with HMC (its
``HmcDraw`` saved beside the problem) and for a batch on per-problem
seeds (the problem alone); a leaf set, shape or dtype other than the
template's raises; and a problem the JAX package wrote to its portable
``.npz`` (its ``_flatten`` + ``np.savez``, called here) loads into the
port and runs 4 steps within 1e-9 of the JAX package's own run."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.checkpoint import _flatten

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.checkpoint import load_problem, save_problem
from or_cdchomp_tpu_torch.chomp.solver import HmcDraw
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)

from torch_parity import (GOAL, START, close, jax_batch, port_engine,
                          port_probs, table_module)

RTOL = 1e-9          # the port against the JAX package, 4 steps
HMC_KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=9,
              use_hmc=True, hmc_resample_lambda=0.5)


@pytest.fixture(scope="module")
def mod():
    m = table_module(pt, dtype=torch.float64, device="cpu")
    m.robots["wam"].enabled = False
    m.computedistancefield(kinbody="table", cube_extent=0.15)
    m.robots["wam"].enabled = True
    return m


def _equal(a, b):
    assert set(a.leaves()) == set(b.leaves())
    for k, v in a.leaves().items():
        assert v.dtype == getattr(b, k).dtype, k
        assert torch.equal(v, getattr(b, k)), k


def test_resume_hmc_run_bitexact(mod, tmp_path):
    """A module run with HMC (seed 11): 4 iterations, save with its draw,
    load into a fresh run (another seed), 4 more — equal to 8 straight;
    without the draw the resumed run draws other numbers."""
    path = str(tmp_path / "run.pt")
    h = mod.create(**HMC_KW, seed=11)
    mod.iterate(run=h, n_iter=4)
    save_problem(path, mod.runs[h].problem, draw=mod.runs[h].draw)

    fresh = mod.runs[mod.create(**HMC_KW, seed=99)]
    fresh.problem = load_problem(path, template=fresh.problem,
                                 draw=fresh.draw)
    _equal(fresh.problem, mod.runs[h].problem)
    h2 = [k for k, v in mod.runs.items() if v is fresh][0]
    mod.iterate(run=h2, n_iter=4)

    h3 = mod.create(**HMC_KW, seed=11)
    mod.iterate(run=h3, n_iter=8)
    _equal(fresh.problem, mod.runs[h3].problem)

    other = mod.runs[mod.create(**HMC_KW, seed=99)]
    other.problem = load_problem(path, template=other.problem)
    h4 = [k for k, v in mod.runs.items() if v is other][0]
    mod.iterate(run=h4, n_iter=4)
    assert not torch.equal(other.problem.traj, mod.runs[h3].problem.traj)


def test_resume_seeded_batch_bitexact(mod, tmp_path):
    """A batch on per-problem seeds resumes from the problem alone."""
    path = str(tmp_path / "batch.pt")
    run = mod.runs[mod.create(**HMC_KW)]
    rng = np.random.default_rng(2)
    starts = np.tile(START, (5, 1)) + 0.01 * rng.normal(size=(5, 7))
    goals = np.tile(GOAL, (5, 1)) + 0.01 * rng.normal(size=(5, 7))

    def batch():
        return problem_batch_from_grid(run.problem, starts, goals,
                                       run.engine, seeds=[4, 9, 2, 7, 5])

    solver = BatchSolver(run.engine)
    mid, _ = solver.iterate(batch(), 3)
    save_problem(path, mid)
    back = load_problem(path, template=batch())
    _equal(back, mid)
    assert back.hmc_seed.tolist() == [4, 9, 2, 7, 5]
    resumed, _ = solver.iterate(back, 3)
    straight, _ = solver.iterate(batch(), 6)
    _equal(resumed, straight)


def test_load_without_template(mod, tmp_path):
    path = str(tmp_path / "p.pt")
    prob = mod.runs[mod.create(**HMC_KW)].problem
    save_problem(path, prob)
    back = load_problem(path, device="cpu")
    _equal(back, prob)
    assert back.hmc_seed is None


@pytest.mark.parametrize("change", ["shape", "dtype", "leaves"])
def test_mismatch_raises(mod, tmp_path, change):
    path = str(tmp_path / "p.pt")
    run = mod.runs[mod.create(**HMC_KW)]
    save_problem(path, run.problem)
    if change == "shape":
        tmpl = mod.runs[mod.create(**dict(HMC_KW, n_points=11))].problem
    elif change == "dtype":
        tmpl = run.problem.to(dtype=torch.float32)
    else:
        tmpl = run.problem.replace(hmc_seed=torch.tensor(3))
    with pytest.raises(ValueError, match="template"):
        load_problem(path, template=tmpl)


def test_draw_state_errors(mod, tmp_path):
    path = str(tmp_path / "p.pt")
    run = mod.runs[mod.create(**HMC_KW)]
    save_problem(path, run.problem)
    with pytest.raises(ValueError, match="no draw state"):
        load_problem(path, template=run.problem, draw=HmcDraw(0, "cpu"))
    state = HmcDraw(0, "cpu").state()
    assert state["device"] == "cpu" and state["rng"].dtype == torch.uint8
    with pytest.raises(ValueError, match="cuda generator"):
        HmcDraw(0, "cpu").load_state(dict(state, device="cuda"))


@pytest.fixture(scope="module")
def jax_world():
    jmod = table_module(oc, dtype=jnp.float64)
    jmod.robots["wam"].enabled = False
    jmod.computedistancefield(kinbody="table", cube_extent=0.15)
    jmod.robots["wam"].enabled = True
    return jmod.runs[jmod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                                 obs_factor=500.0, n_points=9)]


def test_jax_npz_loads_and_runs(jax_world, tmp_path):
    """The JAX package's portable .npz of a B = 4 batch (after 2 JAX
    steps) loads into the port, bit-equal to the arrays, and 4 port steps
    from it stay within 1e-9 of 4 JAX steps."""
    run = jax_world
    jmid, _ = run.engine.iterate_batch(jax_batch(run, 4, seed=1), 2)
    path = str(tmp_path / "jax_ckpt.npz")
    np.savez(path, **_flatten(jmid))
    want = port_probs(jmid)
    got = load_problem(path, template=want)
    _equal(got, want)
    # the JAX package saves to path + ".npz" when given a bare path
    _equal(load_problem(path[:-4], device="cpu"), want)

    jout, jcosts = run.engine.iterate_batch(jmid, 4)
    tout, tcosts = port_engine(run.engine).iterate_batched(got, 4)
    close(tout.traj, jout.traj, RTOL)
    close(tcosts, jcosts, RTOL)
    assert tout.iteration.tolist() == [6] * 4


def test_jax_npz_single_problem(jax_world, tmp_path):
    path = str(tmp_path / "one.npz")
    np.savez(path, **_flatten(jax_world.problem))
    got = load_problem(path, device="cpu")
    _equal(got, port_probs(jax_world.problem))
    with pytest.raises(ValueError, match="template"):
        load_problem(path, template=got.to(dtype=torch.float32).replace(
            traj=got.traj[:3].float()))
