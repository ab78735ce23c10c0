"""The port's floating base against the JAX package on config 4's scene
(benchmarks/configs.py:102-134: WAM7 on an SE(3) base, n = 14, the
upright everyn TSR, table + mug at 0.08 m) at float64 on the CPU: the
cost and gradient with the base's Jᵀ block, one step and a 5-iteration
solve, and create's problem with a base goal or a start trajectory."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import cost_soa as jax_cost_soa
from or_cdchomp_tpu.parallel.batch import problem_batch_from_grid
from or_cdchomp_tpu.tsr import TSR as JaxTSR

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

from torch_parity import (GOAL, START, close, config1_module, config4_kw,
                          perturbed, port_engine, port_probs)

N_POINTS = 9
B = 3


@pytest.fixture(scope="module")
def mods():
    """Config 4's scene in both packages: (port on the CPU, JAX)."""
    return (config1_module(pt, cube_extent=0.08, dtype=torch.float64,
                           device="cpu"),
            config1_module(oc, cube_extent=0.08, dtype=jnp.float64))


@pytest.fixture(scope="module")
def jrun(mods):
    jm = mods[1]
    return jm.runs[jm.create(**config4_kw(JaxTSR, N_POINTS))]


@pytest.fixture(scope="module")
def jprobs(jrun):
    starts, goals = perturbed(jrun, B)
    return problem_batch_from_grid(jrun.problem, starts, goals, jrun.engine)


def test_floating_cost_grad_matches_jax(jrun, jprobs):
    jeng = jrun.engine
    jc, jG, _ = jax_cost_soa.total_cost_grad_batched(
        jeng.spec, jeng.fk, jeng.fields, jeng.same_link, jeng.radii_act,
        jeng.radii_all, jprobs)
    eng = port_engine(jeng)
    assert eng.n_spheres_active == len(eng._sphere_order)  # all spheres move
    tc, tG, _ = cost_soa.total_cost_grad_batched(
        eng.spec, eng.fk, eng.fields, eng.pairs, eng.radii_act,
        port_probs(jprobs))
    assert tuple(tG.shape) == (B, eng.spec.m, 14)
    assert float(np.abs(np.asarray(jG)[..., :7]).max()) > 0.0  # base block
    close(tc, jc, 1e-10)
    close(tG, jG, 1e-10)


def test_floating_step_matches_jax(jrun, jprobs):
    jnew, jcosts = jax.jit(jrun.engine.step_batched)(jprobs)
    eng = port_engine(jrun.engine)
    tnew, tcosts = eng.step_batched(port_probs(jprobs))
    close(tnew.traj, jnew.traj, 1e-9)
    close(tnew.AG, jnew.AG, 1e-9)
    close(tcosts, jcosts, 1e-9)
    q = tnew.traj[..., 3:7]
    assert float((q.norm(dim=-1) - 1.0).abs().max()) < 1e-14


def test_floating_five_iterations_match_jax(jrun, jprobs):
    jout, jcosts = jrun.engine.iterate_batch(jprobs, 5)       # (B, 5, 3)
    eng = port_engine(jrun.engine)
    tout, tcosts = BatchSolver(eng).iterate(port_probs(jprobs), 5)
    close(tout.traj, jout.traj, 1e-9)
    close(tcosts.transpose(0, 1), jcosts, 1e-9)
    # the projection pulls the enabled rows (roll, pitch) toward 0
    before = eng.constraint_values(port_probs(jprobs)).abs().max()
    assert float(eng.constraint_values(tout).abs().max()) < float(before)


def _create_kw(tsr_cls, case):
    base0 = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    st = np.stack([np.concatenate([base0, START]),
                   np.concatenate([[0.05, 0.02, 0.0, 0.1, 0.0, 0.0, 1.0],
                                   0.5 * (START + GOAL)]),
                   np.concatenate([[0.15, 0.1, 0.0, 0.0, 0.0, 0.0, 1.0],
                                   GOAL])])
    if case == "basegoal_everyn":
        return config4_kw(tsr_cls, N_POINTS)
    kw = config4_kw(tsr_cls, N_POINTS)
    del kw["adofgoal"], kw["basegoal"]
    if case == "starttraj_everyn":
        return dict(kw, starttraj=st)
    # a floating base and end and start TSRs
    tsr = kw.pop("everyn_tsr")
    return dict(kw, starttraj=st, con_tsrs=[("start", tsr)],
                con_tsr=("end", tsr))


@pytest.mark.parametrize("case", ["basegoal_everyn", "starttraj_everyn",
                                  "starttraj_con_tsrs"])
def test_floating_create_matches_jax(mods, case):
    tm, jm = mods
    trun = tm.runs[tm.create(**_create_kw(pt.TSR, case))]
    jrun_ = jm.runs[jm.create(**_create_kw(JaxTSR, case))]
    assert tuple(trun.spec) == tuple(jrun_.spec)
    assert tuple(trun.engine.cons) == tuple(jrun_.engine.cons)
    jl = {k: np.asarray(v) for k, v in jrun_.problem._asdict().items()
          if k != "hmc"}
    for k, v in trun.problem.leaves().items():
        if k in jl:
            assert v.numpy().shape == jl[k].shape, k
            np.testing.assert_allclose(v.numpy(), jl[k], rtol=1e-12,
                                       atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(trun.engine._sphere_order,
                                  jrun_.engine._sphere_order)
    assert trun.problem.inactive_pos.shape == (0, 3)
