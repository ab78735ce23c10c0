"""Helpers of the port's parity tests (tests/test_torch_*.py): the
benchmark scenes of benchmarks/configs.py through either package's
CHOMPModule, JAX-built problem batches, and the port's engine and
problems made from the JAX ones, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from or_cdchomp_tpu.parallel.batch import \
    problem_batch_from_grid as jax_batch_from_grid

from or_cdchomp_tpu_torch.chomp.constraints import TSRConstraintSet
from or_cdchomp_tpu_torch.chomp.problem import ChompSpec
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.convert import fields_from_numpy, problem_from_numpy
from or_cdchomp_tpu_torch.models.robot import link_poses_np
from or_cdchomp_tpu_torch.models.wam7 import wam7
from or_cdchomp_tpu_torch.utils import np_pose

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
# config 2's robot base (benchmarks/configs.py:38-40)
CONFIG2_BASE = np.array([0.0, -1.2, 1.0, 0.0, 0.70711, 0.0, 0.70711])
CONFIG2_FIELDS = ("table", "shelf", "mugs")


def config1_module(pkg, cube_extent=0.04, **mod_kw):
    """Config 1's scene (table + mug, one SDF at 0.04 m; config 4 builds
    it at 0.08 m) in ``pkg`` (``or_cdchomp_tpu`` or
    ``or_cdchomp_tpu_torch``); no run yet."""
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(pkg.KinBody("table", pkg.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(pkg.KinBody("mug", pkg.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = pkg.Robot("wam", pkg.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=cube_extent)
    robot.enabled = True
    return mod


def table_module(pkg, **mod_kw):
    """tests/test_transport.py's world: a table at 0.6 m and the WAM7 at
    START, in ``pkg``; no field yet."""
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(pkg.KinBody("table", pkg.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    mod.add_robot(pkg.Robot("wam", pkg.wam7(), q_active=START.copy()))
    return mod


# start_tsr's bounds: the end effector's height held, x, y and the
# rotation free
Z_ONLY = np.array([[-10, 10], [-10, 10], [0, 0], [-np.pi, np.pi],
                   [-np.pi, np.pi], [-np.pi, np.pi]])


def start_tsr(tsr_cls, lift=0.03):
    """A start TSR for ``tsr_cls`` (either package's TSR): the WAM7's
    tool height at START plus ``lift`` metres, so that point 0 starts
    off it."""
    model = wam7()
    ee = link_poses_np(model, START, np_pose.POSE_ID)[model.ee_link]
    H = np.eye(4)
    H[:3, 3] = np_pose.compose(ee, model.ee_origin)[:3]
    H[2, 3] += lift
    return tsr_cls.from_matrices(H, np.eye(4), Bw=Z_ONLY)


def config2_module(pkg, **mod_kw):
    """Config 2's scene (benchmarks/configs.py:67-89): table, shelf and
    mug cluster, three SDFs at 0.05 m, the robot base at y = −1.2."""
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(pkg.KinBody("table", pkg.Scene.build(
        boxes=[((0.0, 0.0, 0.7, 0, 0, 0, 1), (0.35, 0.75, 0.02))])))
    mod.add_kinbody(pkg.KinBody("shelf", pkg.Scene.build(
        boxes=[((0.45, 0.5, 1.0, 0, 0, 0, 1), (0.05, 0.3, 0.3)),
               ((0.45, 0.5, 1.3, 0, 0, 0, 1), (0.3, 0.3, 0.02))])))
    mod.add_kinbody(pkg.KinBody("mugs", pkg.Scene.build(
        cylinders=[((0.1, 0.2, 0.76, 0, 0, 0, 1), 0.04, 0.06),
                   ((-0.1, -0.3, 0.76, 0, 0, 0, 1), 0.05, 0.08)])))
    robot = pkg.Robot("wam", pkg.wam7(), pose=CONFIG2_BASE.copy(),
                      q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    for name in CONFIG2_FIELDS:
        mod.computedistancefield(kinbody=name, cube_extent=0.05)
    robot.enabled = True
    return mod


CONFIG2_KW = dict(lambda_=100.0, obs_factor=500.0, obs_factor_self=10.0,
                  epsilon_self=0.04)


# config 4 (benchmarks/configs.py:102-134): the upright everyn TSR and
# the base goal, for either package's TSR class
CONFIG4_BW = np.array([[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
                       [-np.pi, np.pi]])
CONFIG4_BASEGOAL = np.array([0.15, 0.1, 0.0, 0.0, 0.0, 0.0, 1.0])


def config4_kw(tsr_cls, n_points):
    """create's kwargs of config 4 with ``tsr_cls``'s upright TSR."""
    tsr = tsr_cls.from_matrices(np.eye(4), np.eye(4), Bw=CONFIG4_BW)
    return dict(robot="wam", adofgoal=GOAL, basegoal=CONFIG4_BASEGOAL,
                floating_base=True, lambda_=200.0, obs_factor=200.0,
                n_points=n_points, everyn_tsr=tsr)


def perturbed(run, B, seed=0, sigma=0.02):
    """benchmarks/run.py:37-47's batch endpoints: B copies of the run's
    first and last points plus σ-normal noise, a floating base's
    quaternion columns 3:7 kept.  Returns (starts, goals) (B, n)."""
    rng = np.random.default_rng(seed)
    traj = np.asarray(run.problem.traj)
    n = traj.shape[1]
    starts = np.tile(traj[0], (B, 1)) + sigma * rng.normal(size=(B, n))
    goals = np.tile(traj[-1], (B, 1)) + sigma * rng.normal(size=(B, n))
    if run.spec.floating_base:
        starts[:, 3:7] = traj[0, 3:7]
        goals[:, 3:7] = traj[-1, 3:7]
    return starts, goals


def jax_batch(run, B, seed=0):
    """B seed-perturbed problems around START → GOAL, built by the JAX
    package (per-problem HMC keys from seeds 0..B−1)."""
    rng = np.random.default_rng(seed)
    starts = np.tile(START, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(GOAL, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    return jax_batch_from_grid(run.problem, starts, goals, run.engine)


def port_engine(jeng, dtype=torch.float64):
    """The port's CPU engine for a JAX engine: same spec, fields and
    constraint layout (not its extra-cost hook, which is JAX code)."""
    f = jeng.fields
    fields = fields_from_numpy(np.asarray(f.data), np.asarray(f.sizes),
                               np.asarray(f.lengths), device="cpu",
                               dtype=dtype)
    cons = TSRConstraintSet.build(list(zip(jeng.cons.point_idx,
                                           jeng.cons.enabled)))
    return ChompEngine(ChompSpec(*jeng.spec), wam7(), fields, dtype=dtype,
                       device="cpu", cons=cons)


def to_numpy(jprobs):
    """A JAX problem (batch) as problem_from_numpy's dict."""
    d = {k: np.asarray(v) for k, v in jprobs._asdict().items() if k != "hmc"}
    d.update({f"hmc.{k}": np.asarray(v)
              for k, v in jprobs.hmc._asdict().items()})
    return d


def port_probs(jprobs, dtype=torch.float64):
    return problem_from_numpy(to_numpy(jprobs), device="cpu", dtype=dtype)


class JaxKeyDraw:
    """An HMC draw source that replays the JAX package's per-problem
    keys exactly as ``ChompEngine._maybe_resample`` splits them
    (solver.py:263-270): split(key, 3), normal(k_noise, (m, n)),
    uniform(k_exp, (), minval=1e-12), float64.  ``calls`` counts the
    draws."""

    def __init__(self, keys, m, n):
        self.keys = jnp.asarray(keys)
        self.calls = 0

        def one(k):
            key, k_noise, k_exp = jax.random.split(k, 3)
            return (key, jax.random.normal(k_noise, (m, n), jnp.float64),
                    jax.random.uniform(k_exp, (), jnp.float64, minval=1e-12))

        self._split = jax.jit(jax.vmap(one))

    def __call__(self, probs):
        self.calls += 1
        self.keys, z, u = self._split(self.keys)
        return torch.as_tensor(np.array(z)), torch.as_tensor(np.array(u))


def close(a, b, rtol):
    """Every element within rtol, and atol rtol·max|b|."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


def share_fields(tm, jm):
    """Give the port's module ``tm`` the JAX module's field values: the
    two packages' float32 EDTs differ by an ulp on some cells (684 of
    config 1's 2,304), which moves a solve by ~5e-9 relative, so a
    module-level parity test compares the algorithms on one field."""
    for ts, js in zip(tm.sdfs, jm.sdfs):
        ts.grid.data = torch.as_tensor(np.array(js.grid.data),
                                       device=ts.grid.data.device)
    tm.clear_engine_cache()
    return tm, jm
