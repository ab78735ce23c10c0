"""User-facing module API (counterpart of or_cdchomp_tpu/api.py).

``CHOMPModule`` keeps the reference's world registry (kinbodies,
robots), SDF registry and run registry with the same command names,
kwargs, defaults and error strings (orcdchomp_mod.cpp:297-589,
1800-2101).  Ported so far: ``add_kinbody``, ``add_robot``,
``computedistancefield`` (with the reference's raw cache file) and
``create`` with momentum and HMC, a floating base, ``starttraj`` and
the TSR constraints ``con_tsr``, ``con_tsrs`` and ``everyn_tsr``
(``start_tsr`` and ``start_cost`` need the per-problem path, which is
not ported).  A created run's engine and problem feed
``parallel.batch`` for batched solves.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp import metric as metric_mod
from or_cdchomp_tpu_torch.chomp.constraints import TSRConstraintSet
from or_cdchomp_tpu_torch.chomp.problem import ChompProblem, ChompSpec
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.models.robot import RobotModel, sphere_positions_np
from or_cdchomp_tpu_torch.ops.edt import signed_edt
from or_cdchomp_tpu_torch.ops.flood import exterior_free_mask
from or_cdchomp_tpu_torch.ops.grid import Grid3D, pad_stack_grids
from or_cdchomp_tpu_torch.ops.quat import pose_apply
from or_cdchomp_tpu_torch.ops.voxelize import Scene, voxelize_scene
from or_cdchomp_tpu_torch.utils import np_pose

_DEFAULTS = dict(  # orcdchomp_mod.cpp:1840-1875
    n_points=101, lambda_=10.0, epsilon=0.1, epsilon_self=0.04,
    obs_factor=200.0, obs_factor_self=10.0, hmc_resample_lambda=0.02,
    derivative=1,
)


def _quat_to_R_np(q):
    """Unit quaternion → rotation matrix, host float64 (kin.c:348-368;
    copied from or_cdchomp_tpu/tsr.py quat_to_R_np)."""
    qx, qy, qz, qw = np.asarray(q, dtype=np.float64)
    xx, xy, xz, xw = qx * qx, qx * qy, qx * qz, qx * qw
    yy, yz, yw = qy * qy, qy * qz, qy * qw
    zz, zw = qz * qz, qz * qw
    return np.array([
        [1 - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), 1 - 2 * (xx + zz), 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), 1 - 2 * (xx + yy)],
    ])


def _cache_read(path, sizes):
    """The cached field at ``path`` as a float32 (sizes) array, or None
    if the file is missing or its size does not match."""
    try:
        raw = np.fromfile(path, dtype=np.float32)
    except OSError:
        return None
    if raw.size != int(np.prod(sizes)):
        return None
    return raw.reshape(tuple(int(s) for s in sizes))


@dataclasses.dataclass
class KinBody:
    """A rigid obstacle body: analytic primitive set + world pose."""

    name: str
    scene: Scene
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np_pose.POSE_ID.copy())
    enabled: bool = True

    def aabb_at_origin(self, padding=0.0):
        """Conservative AABB of the scene primitives with the body at the
        origin (KinBodyComputeEnabledAABB parity,
        orcdchomp_mod.cpp:376-393)."""
        lo = np.full(3, np.inf)
        hi = np.full(3, -np.inf)
        sc = self.scene
        bp = sc.box_pose.cpu().numpy()
        bh = sc.box_half.cpu().numpy()
        for i in range(bp.shape[0]):
            ext = np.abs(_quat_to_R_np(bp[i, 3:])) @ bh[i]
            lo = np.minimum(lo, bp[i, :3] - ext)
            hi = np.maximum(hi, bp[i, :3] + ext)
        scenter = sc.sphere_center.cpu().numpy()
        sradius = sc.sphere_radius.cpu().numpy()
        for i in range(scenter.shape[0]):
            lo = np.minimum(lo, scenter[i] - sradius[i])
            hi = np.maximum(hi, scenter[i] + sradius[i])
        cp = sc.cyl_pose.cpu().numpy()
        cr = sc.cyl_radius.cpu().numpy()
        ch = sc.cyl_half.cpu().numpy()
        for i in range(cp.shape[0]):
            ext = np.sqrt(cr[i] ** 2 + ch[i] ** 2)  # conservative
            lo = np.minimum(lo, cp[i, :3] - ext)
            hi = np.maximum(hi, cp[i, :3] + ext)
        if not np.all(np.isfinite(lo)):
            lo = np.zeros(3)
            hi = np.zeros(3)
        return lo - padding, hi + padding


@dataclasses.dataclass
class Robot:
    """A robot body: kinematic model + current configuration."""

    name: str
    model: RobotModel                 # with active DOFs already selected
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np_pose.POSE_ID.copy())
    q_active: np.ndarray = None
    enabled: bool = True

    def __post_init__(self):
        if self.q_active is None:
            self.q_active = np.zeros(self.model.n_dof)
        self.q_active = np.asarray(self.q_active, dtype=np.float64)

    def sphere_world(self):
        """World (positions (S, 3), radii (S,)) of every sphere at the
        current configuration, float64 on the host
        (``sphere_positions_np``, the JAX package's host FK)."""
        return (sphere_positions_np(self.model, self.q_active, self.pose),
                np.asarray(self.model.sphere_radius))


@dataclasses.dataclass
class SdfEntry:
    """Registry entry (struct sdf, orcdchomp_mod.h:36-40)."""

    kinbody_name: str
    grid: Grid3D
    pose: np.ndarray   # (7,) grid frame in kinbody frame


@dataclasses.dataclass
class Run:
    """One CHOMP run (struct run, orcdchomp_mod.cpp:886-966)."""

    engine: ChompEngine
    problem: ChompProblem
    spec: ChompSpec
    robot: Robot


class CHOMPModule:
    """The module: world registry + SDF registry + run registry.  Fields,
    engines and problems live on ``device`` (the card unless the caller
    names another) in ``dtype``."""

    def __init__(self, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.bodies: Dict[str, KinBody] = {}
        self.robots: Dict[str, Robot] = {}
        self.sdfs: List[SdfEntry] = []
        self.runs: Dict[str, Run] = {}
        self._next_run = 0

    # ----- world management ----------------------------------------------

    def add_kinbody(self, body: KinBody):
        self.bodies[body.name] = body
        return body

    def add_robot(self, robot: Robot):
        self.robots[robot.name] = robot
        return robot

    def _get_body(self, name):
        if name in self.bodies:
            return self.bodies[name]
        if name in self.robots:
            return self.robots[name]
        raise KeyError(f"no kinbody named {name!r}")

    def _resolve_robot(self, robot) -> Robot:
        if isinstance(robot, Robot):
            return robot
        return self.robots[robot]

    # ----- distance fields ------------------------------------------------

    def _world_occupancy_scene(self):
        """(scenes, poses) of every *enabled* body, the field's own
        kinbody included (the named body only anchors the grid)."""
        scenes, poses = [], []
        for b in self.bodies.values():
            if b.enabled:
                scenes.append(b.scene)
                poses.append(b.pose)
        for r in self.robots.values():
            if not r.enabled:
                continue
            x, rad = r.sphere_world()
            scenes.append(Scene.build(
                spheres=[(x[i], float(rad[i])) for i in range(len(rad))]))
            poses.append(np_pose.POSE_ID)  # sphere centres already world
        return scenes, poses

    def computedistancefield(self, kinbody=None, cube_extent=0.02,
                             aabb_padding=0.2, cache_filename=None,
                             require_cache=False, **_):
        """Build + register an SDF around ``kinbody`` (AABB at origin +
        padding, voxelize, flood-fill the exterior, signed EDT; registry
        keyed by kinbody name — orcdchomp_mod.cpp:297-589).

        ``cache_filename``: the reference's cache (orcdchomp_mod.cpp:
        416-444), the field's raw float32 values in C order.  A file
        whose size matches the grid is read instead of building the
        field; a missing file or one of another size is a miss, after
        which the field is built and written there.  ``require_cache``
        makes a miss raise."""
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        body = self._get_body(name)
        if any(s.kinbody_name == name for s in self.sdfs):
            raise RuntimeError("We already have an sdf for this kinbody!")

        lo, hi = body.aabb_at_origin()
        center = 0.5 * (lo + hi)
        extents = 0.5 * (hi - lo)
        sizes = np.ceil((extents + aabb_padding) / cube_extent).astype(int)
        lengths = sizes * 2.0 * cube_extent
        grid_pose = np_pose.POSE_ID.copy()
        grid_pose[:3] = center - 0.5 * lengths
        grid = None
        if cache_filename:
            data = _cache_read(cache_filename, sizes)
            if data is not None:
                grid = Grid3D(
                    data=torch.as_tensor(data, device=self.device),
                    lengths=torch.as_tensor(lengths, dtype=torch.float32,
                                            device=self.device))
        if grid is None:
            if require_cache:
                raise RuntimeError(
                    "Field not found from cache, but require_cache flag set!")
            grid = self._build_sdf_grid(body, grid_pose, sizes, lengths,
                                        float(cube_extent))
            if cache_filename:
                grid.data.cpu().numpy().astype(np.float32).tofile(
                    cache_filename)
        self.sdfs.append(SdfEntry(kinbody_name=name, grid=grid,
                                  pose=grid_pose))
        return ""

    def _build_sdf_grid(self, body, grid_pose, sizes, lengths, cube_extent):
        """Voxelize → exterior flood fill → signed EDT, in float32 on the
        module's device."""
        f32 = dict(dtype=torch.float32, device=self.device)
        pose_world_gsdf = np_pose.compose(body.pose, grid_pose)
        grid = Grid3D.create(sizes, lengths, device=self.device)
        centers_w = pose_apply(torch.as_tensor(pose_world_gsdf, **f32),
                               grid.all_centers())
        occ = torch.zeros(tuple(int(s) for s in sizes), dtype=torch.bool,
                          device=self.device)
        scenes, poses = self._world_occupancy_scene()
        for sc, p in zip(scenes, poses):
            inv = torch.as_tensor(np_pose.invert(p), **f32)
            occ = occ | voxelize_scene(sc.to(self.device),
                                       pose_apply(inv, centers_w),
                                       cube_extent)
        occ = exterior_free_mask(occ)   # enclosed pockets → obstacle
        return Grid3D(data=signed_edt(occ, grid.lengths), lengths=grid.lengths)

    # ----- create ---------------------------------------------------------

    def create(self, robot=None, adofgoal=None, basegoal=None,
               floating_base=False, lambda_=None, starttraj=None,
               n_points=None, con_tsr=None, con_tsrs=None, start_tsr=None,
               start_cost=None, everyn_tsr=None, use_momentum=False,
               use_hmc=False, hmc_resample_lambda=None, seed=0,
               epsilon=None, epsilon_self=None, obs_factor=None,
               obs_factor_self=None, no_report_cost=False,
               dat_filename=None, derivative=None, ee_force=None,
               ee_torque_weights=None, **_):
        """Set up a run; returns an opaque run handle string.

        Same validation rules and messages as mod::create
        (orcdchomp_mod.cpp:2090-2101).  ``use_hmc`` implies momentum;
        ``seed`` seeds the run's HMC draw source (``ChompEngine.draw``).
        Kwargs of features not ported yet raise NotImplementedError
        naming the kwarg.
        """
        r = self._resolve_robot(robot)
        n_points = n_points or _DEFAULTS["n_points"]
        lambda_ = _DEFAULTS["lambda_"] if lambda_ is None else lambda_
        epsilon = _DEFAULTS["epsilon"] if epsilon is None else epsilon
        epsilon_self = (_DEFAULTS["epsilon_self"] if epsilon_self is None
                        else epsilon_self)
        obs_factor = (_DEFAULTS["obs_factor"] if obs_factor is None
                      else obs_factor)
        obs_factor_self = (_DEFAULTS["obs_factor_self"]
                           if obs_factor_self is None else obs_factor_self)
        hmc_resample_lambda = (_DEFAULTS["hmc_resample_lambda"]
                               if hmc_resample_lambda is None
                               else hmc_resample_lambda)
        D = _DEFAULTS["derivative"] if derivative is None else derivative

        if adofgoal is None and starttraj is None:
            raise ValueError("Did not pass either adofgoal or starttraj!")
        if adofgoal is not None and starttraj is not None:
            raise ValueError("Cannot pass both adofgoal and starttraj!")
        if floating_base and basegoal is None and starttraj is None:
            raise ValueError("Passed floating_base with no basegoal!")
        if not floating_base and basegoal is not None:
            raise ValueError("Passed basegoal with no floating_base!")
        if not self.sdfs:
            raise ValueError(
                "No signed distance fields have yet been computed!")
        if lambda_ < 0.01:
            raise ValueError("lambda must be >=0.01!")
        if n_points < 3:
            raise ValueError("n_points must be >=3!")
        if floating_base and start_tsr is not None:
            raise ValueError(
                "floating_base and start_tsr together is not yet implemented!")

        n_adof = r.model.n_dof
        n = (7 if floating_base else 0) + n_adof
        if adofgoal is not None and len(adofgoal) != n_adof:
            raise ValueError("size of adofgoal does not match active dofs!")
        # ee_force / ee_torque_weights: validated as the reference does
        # (orcdchomp_mod.cpp:2036-2078), which never implemented the cost
        if ee_force is not None:
            ee_force = np.atleast_1d(np.asarray(ee_force, dtype=np.float64))
            if ee_force.shape not in ((1,), (3,)):
                raise ValueError("ee_force must be length 1 or 3!")
        if ee_torque_weights is not None:
            if np.asarray(ee_torque_weights).shape != (n_adof,):
                raise ValueError(
                    "size of ee_torque_weights does not match active dofs!")

        # both need the per-problem (AoS) step, which is not ported
        for kw, v in dict(start_tsr=start_tsr, start_cost=start_cost).items():
            if v is not None:
                raise NotImplementedError(f"{kw}: not ported yet")

        m = n_points - 2
        spec = ChompSpec(n_points=n_points, n=n, m=m, D=D,
                         floating_base=bool(floating_base),
                         use_momentum=bool(use_momentum or use_hmc),
                         use_hmc=bool(use_hmc), n_fields=len(self.sdfs))

        # initial trajectory (orcdchomp_mod.cpp:2371-2464): starttraj
        # resampled to n_points, else the straight line; a floating
        # base's quaternion normalised at every point
        if starttraj is not None:
            st = np.asarray(starttraj, dtype=np.float64)
            if st.shape[1] != n:
                raise ValueError(f"starttraj must have width n={n}")
            src_t = np.linspace(0.0, 1.0, st.shape[0])
            dst_t = np.linspace(0.0, 1.0, n_points)
            traj = np.stack(
                [np.interp(dst_t, src_t, st[:, j]) for j in range(n)], axis=1)
        else:
            start = (np.concatenate([r.pose, r.q_active]) if floating_base
                     else r.q_active.copy())
            goal = (np.concatenate([np.asarray(basegoal, dtype=np.float64),
                                    np.asarray(adofgoal, dtype=np.float64)])
                    if floating_base else np.asarray(adofgoal, np.float64))
            a = np.linspace(0.0, 1.0, n_points)[:, None]
            traj = (1 - a) * start[None, :] + a * goal[None, :]
        if floating_base:
            for i in range(n_points):
                traj[i, :7] = np_pose.normalize(traj[i, :7])

        ops = metric_mod.build_metric(m, spec.dt, D=D)     # chomp.c:239-428
        # joint limits (orcdchomp_mod.cpp:2638-2660); the base is free
        lo = np.asarray(r.model.dof_limits_lower, dtype=np.float64)
        hi = np.asarray(r.model.dof_limits_upper, dtype=np.float64)
        if floating_base:
            lo = np.concatenate([np.full(7, -np.inf), lo])
            hi = np.concatenate([np.full(7, np.inf), hi])

        # rooted SDFs (orcdchomp_mod.cpp:2347-2369)
        pw, pg = [], []
        for s in self.sdfs:
            p = np_pose.compose(self._get_body(s.kinbody_name).pose, s.pose)
            pw.append(p)
            pg.append(np_pose.invert(p))

        # TSR constraints (orcdchomp_mod.cpp:2569-2614)
        entries, tsr_T0w_inv, tsr_Twe_inv = [], [], []

        def add_con(tsr, point_idx):
            entries.append((point_idx, tsr.enabled_mask()))
            tsr_T0w_inv.append(np_pose.invert(tsr.T0w))
            tsr_Twe_inv.append(np_pose.invert(tsr.Twe))

        if everyn_tsr is not None:
            for i in range(m):
                add_con(everyn_tsr, i)
        all_con_tsrs = list(con_tsrs or [])
        if con_tsr is not None:
            all_con_tsrs.append(con_tsr)
        for ctype, tsr in all_con_tsrs:    # type 'all' | 'start' | 'end'
            if ctype == "start":
                add_con(tsr, 0)
            elif ctype == "end":
                add_con(tsr, m - 1)
            elif ctype == "all":
                for i in range(m):
                    add_con(tsr, i)
            else:
                raise ValueError("con_tsr type must be start, end, or all")
        cons = TSRConstraintSet.build(entries)

        engine = ChompEngine(
            spec, r.model, pad_stack_grids([s.grid for s in self.sdfs],
                                           self.device, self.dtype),
            dtype=self.dtype, device=self.device, metric_ops=ops, seed=seed,
            cons=cons)
        B, trC, Evels = engine.build_affine(traj[0], traj[-1], n)

        # inactive sphere world positions (orcdchomp_mod.cpp:2334-2345)
        order = engine._sphere_order
        n_act = engine.n_spheres_active
        if len(order) > n_act:
            x_all, _ = r.sphere_world()
            inactive_pos = x_all[order[n_act:]]
        else:
            inactive_pos = np.zeros((0, 3))

        opts = dict(dtype=self.dtype, device=self.device)

        def t(x):
            return torch.as_tensor(np.asarray(x, np.float64), **opts)

        problem = ChompProblem(
            traj=t(traj), robot_pose=t(r.pose),
            AG=torch.zeros((m, n), **opts), B=t(B), Evels=t(Evels),
            trC=t(trC), jlimit_lower=t(lo), jlimit_upper=t(hi),
            epsilon=t(epsilon), epsilon_self=t(epsilon_self),
            obs_factor=t(obs_factor), obs_factor_self=t(obs_factor_self),
            lambda_=t(lambda_), hmc_resample_lambda=t(hmc_resample_lambda),
            pose_world_gsdf=t(np.reshape(pw, (-1, 7))),
            pose_gsdf_world=t(np.reshape(pg, (-1, 7))),
            field_enabled=torch.ones(len(self.sdfs), dtype=torch.bool,
                                     device=self.device),
            inactive_pos=t(inactive_pos),
            tsr_T0w_inv=t(np.reshape(tsr_T0w_inv, (-1, 7))),
            tsr_Twe_inv=t(np.reshape(tsr_Twe_inv, (-1, 7))),
            resample_iter=torch.zeros((), dtype=torch.int32,
                                      device=self.device),
            leapfrog_first=torch.ones((), dtype=torch.bool,
                                      device=self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device))

        handle = f"run{self._next_run}"
        self._next_run += 1
        self.runs[handle] = Run(engine=engine, problem=problem, spec=spec,
                                robot=r)
        return handle
