"""Config 2 (benchmarks/configs.py:67-89: three SDFs, self-collision
weights, the robot base at y = −1.2) through both packages' CHOMPModule,
float64 on the CPU: create's problem and field stack, one step and a
5-iteration solve of a batch built by each package, and the obstacle
cost with the spheres moved into the fields."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.chomp import cost_soa as jax_cost_soa

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp.cost_soa import (_obstacle_soa,
                                                sphere_kinematics)
from or_cdchomp_tpu_torch.ops.sdf_lookup import obstacle
from or_cdchomp_tpu_torch.ops.voxelize import voxelize_scene
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                 problem_batch_from_grid)
from or_cdchomp_tpu_torch.utils import np_pose

from torch_parity import (CONFIG2_KW, GOAL, START, close, config2_module,
                          jax_batch, port_engine, to_numpy)

RTOL = 1e-9


@pytest.fixture(scope="module")
def runs():
    kw = dict(robot="wam", adofgoal=GOAL, n_points=11, **CONFIG2_KW)
    tm = config2_module(pt, dtype=torch.float64, device="cpu")
    jm = config2_module(oc, dtype=jnp.float64)
    return tm, jm, tm.runs[tm.create(**kw)], jm.runs[jm.create(**kw)]


def test_config2_create_matches_jax(runs):
    _, _, trun, jrun = runs
    assert tuple(trun.spec) == tuple(jrun.spec) and trun.spec.n_fields == 3
    tl = trun.problem.leaves()
    jl = {k[4:] if k.startswith("hmc.") else k: v
          for k, v in to_numpy(jrun.problem).items() if k != "hmc.key"}
    assert set(tl) == set(jl)
    for k, v in jl.items():
        got = tl[k].numpy()
        assert got.shape == v.shape and got.dtype == v.dtype, k
        np.testing.assert_allclose(got, v, rtol=1e-12, atol=1e-12,
                                   err_msg=k)
    tf, jf = trun.engine.fields, jrun.engine.fields
    # three fields padded to the largest grid, +inf padding
    assert tf.data.shape[0] == 3
    np.testing.assert_array_equal(tf.sizes.numpy(), np.asarray(jf.sizes))
    assert tuple(tf.data.shape[1:]) == tuple(tf.sizes.numpy().max(axis=0))
    np.testing.assert_allclose(tf.lengths.numpy(), np.asarray(jf.lengths),
                               rtol=1e-12)
    td, jd = tf.data.numpy(), np.asarray(jf.data)
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))   # padding
    # a field whose occupancy agrees agrees everywhere; the shelf's
    # differs on touching cells only (next test), and its distances
    # with it
    same_occ = [np.array_equal(td[f] <= 0.0, jd[f] <= 0.0) for f in range(3)]
    assert same_occ == [True, False, True]
    for f in (0, 2):
        np.testing.assert_allclose(td[f], jd[f], rtol=1e-12, atol=1e-12)


def test_config2_occupancy_differs_only_on_touching_cells(runs):
    """Where the two packages' fields disagree on occupancy, the probe
    cube (half extent 0.05 m) touches a primitive: in float64 the cell
    is occupied with the cube grown by 1e-6 m and free with it shrunk by
    1e-6 m.  Each package's float32 SAT test rounds such a tie its own
    way (XLA's and torch's einsum orders differ)."""
    tm, jm, _, _ = runs
    cube = 0.05
    n_diff = 0
    for f, (ts, js) in enumerate(zip(tm.sdfs, jm.sdfs)):
        td, jd = ts.grid.data.numpy(), np.asarray(js.grid.data)
        diff = np.argwhere((td <= 0.0) != (jd <= 0.0))
        n_diff += len(diff)
        if not len(diff):
            continue
        grid = ts.grid
        pose = np_pose.compose(tm._get_body(ts.kinbody_name).pose, ts.pose)
        sub = torch.as_tensor(diff)
        c = grid.center_of_index(sub).double().numpy()
        cw = np.stack([np_pose.apply(pose, p) for p in c])
        scenes, poses = tm._world_occupancy_scene()

        def occ(e):
            hit = np.zeros(len(cw), bool)
            for sc, p in zip(scenes, poses):
                loc = np.stack([np_pose.apply(np_pose.invert(p), q)
                                for q in cw])
                sc64 = type(sc)(*(t.double() for t in sc))
                hit |= voxelize_scene(sc64, torch.as_tensor(loc), e).numpy()
            return hit

        assert occ(cube + 1e-6).all() and not occ(cube - 1e-6).any(), f
    assert n_diff > 0   # the scene has touching cells: the test bites


def _batches(runs, B, seed):
    """The same B problems from each package's create; the port's engine
    takes the JAX field stack, so the touching cells above cannot make
    the solves differ."""
    _, _, trun, jrun = runs
    eng = port_engine(jrun.engine)
    jb = jax_batch(jrun, B, seed=seed)
    starts = np.asarray(jb.traj)[:, 0]
    goals = np.asarray(jb.traj)[:, -1]
    tb = problem_batch_from_grid(trun.problem, starts, goals, eng)
    return eng, tb, jb


def test_config2_step_matches_jax(runs):
    jrun = runs[3]
    eng, tb, jb = _batches(runs, 4, seed=0)
    jnew, jcosts = jrun.engine.iterate_batch(jb, 1)
    tnew, tcosts = eng.step_batched(tb)
    close(tnew.traj, jnew.traj, RTOL)
    close(tcosts, jcosts[:, 0], RTOL)
    # the obstacle + self cost is live; on these trajectories it is
    # self-collision alone (the arm stays outside the three field boxes,
    # which the next test covers)
    assert float(np.asarray(jcosts)[..., 1].max()) > 0.0


def test_config2_obstacle_in_fields_matches_jax(runs):
    """The obstacle cost and gradient of the three-field stack against
    the JAX package's SoA obstacle cost at 1e-10, with the sphere cloud
    moved into the fields and a 1 m hinge, so that every lookup, the
    padded min-select over F = 3 and ``field_enabled`` (field f off in
    problem f + 1) reach the result.  Problem 0 has every field on; each
    other problem differs from itself with every field on, so each field
    is live."""
    jrun = runs[3]
    eng, tb, jb = _batches(runs, 4, seed=3)
    _, x, vel, acc = sphere_kinematics(eng.spec, eng.fk, tb)
    inside = torch.tensor([0.2, 0.2, 0.8], dtype=x.dtype).view(3, 1, 1, 1)
    x = (x - x.mean(dim=(1, 2, 3), keepdim=True) + inside).contiguous()
    enabled = np.ones((4, 3), bool)
    for f in range(3):
        enabled[f + 1, f] = False
    tb = tb.replace(epsilon=torch.ones(4, dtype=torch.float64),
                    field_enabled=torch.as_tensor(enabled))
    jb = jb._replace(epsilon=jnp.ones(4, jnp.float64),
                     field_enabled=jnp.asarray(enabled))
    c_t, w_t = _obstacle_soa(eng.fields, eng.radii_act, tb, x, vel, acc)
    je = jrun.engine
    c_j, w_j, _, _, _ = jax_cost_soa._obstacle_soa(
        je.spec, je.fields, je.radii_act, jb,
        tuple(jnp.asarray(c.numpy()) for c in x),
        tuple(jnp.asarray(c.numpy()) for c in vel),
        tuple(jnp.asarray(c.numpy()) for c in acc), jnp.float64)
    close(c_t, c_j, 1e-10)
    close(w_t, np.stack([np.asarray(c) for c in w_j]), 1e-10)
    cost, _ = obstacle(x, vel, acc, eng.fields.data, eng.fields.sizes,
                       eng.fields.lengths, tb.pose_gsdf_world,
                       tb.pose_world_gsdf, tb.field_enabled, eng.radii_act,
                       tb.epsilon, tb.obs_factor)
    # the hinge is active on 0.95 of the (point, sphere, problem) queries
    assert float((cost != 0.0).double().mean()) > 0.9
    c_on, _ = _obstacle_soa(eng.fields, eng.radii_act,
                            tb.replace(field_enabled=torch.ones((4, 3),
                                                                dtype=bool)),
                            x, vel, acc)
    assert not bool(torch.isclose(c_on[1:], c_t[1:], rtol=1e-9).any())


def test_config2_five_iterations_match_jax(runs):
    jrun = runs[3]
    eng, tb, jb = _batches(runs, 3, seed=1)
    jout, jcosts = jrun.engine.iterate_batch(jb, 5)
    tout, tcosts = BatchSolver(eng).iterate(tb, 5)
    close(tout.traj, jout.traj, RTOL)
    close(tcosts.transpose(0, 1), jcosts, RTOL)


def test_config2_final_costs(runs):
    """The port's cost report runs the SoA cost path, as the JAX step
    does: it matches JAX's SoA obstacle+self cost at 1e-9.  JAX's own
    report (vmap(costs_only), the AoS path) rotates by the base
    quaternion in the sandwich form, which for config 2's base
    (|q|² = 1 + 1.3e-6) differs from the SoA form by a few 1e-6
    relative, so against it the bar is 1e-5."""
    jrun = runs[3]
    eng, tb, jb = _batches(runs, 3, seed=2)
    jout, _ = jrun.engine.iterate_batch(jb, 3)
    tout, _ = BatchSolver(eng).iterate(tb, 3)
    got = torch.stack(eng.final_costs_batch(tout), dim=-1)
    je = jrun.engine
    j_soa, _, _ = jax_cost_soa.total_cost_grad_batched(
        je.spec, je.fk, je.fields, je.same_link, je.radii_act, je.radii_all,
        jout)
    close(got[:, 1], j_soa, RTOL)
    want = np.stack(je.final_costs_batch(jout), axis=-1)
    close(got[:, 2], want[:, 2], RTOL)                  # smoothness
    close(got, want, 1e-5)


def test_config2_robot_base_is_carried(runs):
    trun = runs[2]
    base = trun.problem.robot_pose.numpy()
    np.testing.assert_array_equal(base, [0.0, -1.2, 1.0, 0.0, 0.70711, 0.0,
                                         0.70711])
    np.testing.assert_array_equal(trun.problem.traj[0].numpy(), START)
