"""User-facing module API (counterpart of or_cdchomp_tpu/api.py).

``CHOMPModule`` keeps the reference's world registry (kinbodies,
robots), SDF registry and run registry with the same command names,
kwargs, defaults and error strings (orcdchomp_mod.cpp:175-3066,
orcdchomp.py:204-219):

 - viewspheres, computedistancefield (with the reference's raw cache
   file), addfield_fromobsarray, viewfields, removefield
 - create / iterate / gettraj / destroy, runchomp
 - gettraj_batch: retime and check a whole BatchSolver batch

``create`` takes every kwarg of the reference: momentum and HMC, a
floating base, ``starttraj``, the TSR constraints ``con_tsr``,
``con_tsrs``, ``everyn_tsr`` and ``start_tsr`` (the start point moves,
held to its TSR), and ``start_cost``, an extra-cost hook of one problem
that the engine applies with ``torch.func.vmap``.  A run is one problem:
``iterate`` steps it as a batch of one through
``ChompEngine.step_batched``, with the run's own HMC draw source, so
runs that share a cached engine share no random state.
``SendCommand`` takes the reference's command strings (transport.py).
Robots can grab kinbodies (their spheres re-root to the grabbing link).
A created run's engine and problem feed ``parallel.batch`` for batched
solves.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp import metric as metric_mod
from or_cdchomp_tpu_torch.chomp.constraints import TSRConstraintSet
from or_cdchomp_tpu_torch.chomp.problem import (ChompProblem, ChompSpec,
                                                as_batch, first)
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine, HmcDraw
from or_cdchomp_tpu_torch.models.robot import (CompiledFK, RobotModel,
                                               link_poses_np,
                                               sphere_positions_np)
from or_cdchomp_tpu_torch.ops.edt import signed_edt
from or_cdchomp_tpu_torch.ops.flood import exterior_free_mask
from or_cdchomp_tpu_torch.ops.grid import Grid3D, pad_stack_grids
from or_cdchomp_tpu_torch.ops.quat import pose_apply
from or_cdchomp_tpu_torch.ops.voxelize import (Scene, scene_distance,
                                               voxelize_scene)
from or_cdchomp_tpu_torch.transport import send_command
from or_cdchomp_tpu_torch.utils import np_pose
from or_cdchomp_tpu_torch.utils.profiling import PhaseTimers, phase

_DEFAULTS = dict(  # orcdchomp_mod.cpp:1840-1875
    n_points=101, lambda_=10.0, epsilon=0.1, epsilon_self=0.04,
    obs_factor=200.0, obs_factor_self=10.0, hmc_resample_lambda=0.02,
    derivative=1,
)

# bytes of the largest float64 tensor of one chunk of the trajectory
# collision check: the (chunk, samples, S, S, 3) sphere-pair tensor, or
# the (chunk, samples, S, T, 3) sphere-triangle tensor of a mesh body
# (check_chunk)
CHECK_PAIR_BYTES = 512 * 2 ** 20
# bytes of the float64 (cells, primitives, 3, 3) tensor of one chunk of
# cells in the field build's voxelization (_build_sdf_grid)
VOXEL_CHUNK_BYTES = 2 ** 27


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
    grabbed_by: Optional[str] = None   # robot currently grabbing this body

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
        tv = sc.tri_verts.cpu().numpy()
        if tv.shape[0]:
            pts = tv.reshape(-1, 3)
            lo = np.minimum(lo, pts.min(axis=0))
            hi = np.maximum(hi, pts.max(axis=0))
        if not np.all(np.isfinite(lo)):
            lo = np.zeros(3)
            hi = np.zeros(3)
        return lo - padding, hi + padding


@dataclasses.dataclass
class Robot:
    """A robot body: kinematic model + current configuration.  Its host
    kinematics (sphere and link poses) run in float64 numpy
    (``sphere_positions_np``, ``link_poses_np``)."""

    name: str
    model: RobotModel                 # with active DOFs already selected
    pose: np.ndarray = dataclasses.field(
        default_factory=lambda: np_pose.POSE_ID.copy())
    q_active: np.ndarray = None
    enabled: bool = True
    grabbed: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.q_active is None:
            self.q_active = np.zeros(self.model.n_dof)
        self.q_active = np.asarray(self.q_active, dtype=np.float64)
        # reference configuration for self-collision-check exclusions:
        # captured at construction (and re-captured at grab/release),
        # never at whatever config the first collision check happens to
        # run at — mirroring OpenRAVE's load-time adjacency
        self._reset_exclude_ref()

    def GetName(self):  # OpenRAVE-style accessor used by callers
        return self.name

    def _link_world_pose(self, link: str) -> np.ndarray:
        return link_poses_np(self.model, self.q_active, self.pose)[
            self.model.link_names.index(link)]

    def _sphere_owners(self):
        """Per-sphere owner tags aligned with model.sphere_radius: None
        for the robot's own spheres, the grabbed body's name for spheres
        added by :meth:`grab`.  Kept as an explicit list so releasing one
        body never shifts another body's spheres."""
        if not hasattr(self, "_owner_tags"):
            self._owner_tags = [None] * len(self.model.sphere_radius)
        return self._owner_tags

    def grab(self, body: KinBody, link: str):
        """Attach ``body`` to ``link``: its collision spheres re-root to
        the grabbing link and move with the robot from now on
        (GetGrabbed/IsGrabbing handling, orcdchomp_mod.cpp:2200-2208).

        The body's sphere primitives become robot spheres in the link
        frame (boxes and cylinders by their bounding spheres — the
        reference requires sphere models on grabbed bodies the same way,
        orcdchomp_kdata parity)."""
        if body.name in self.grabbed:
            raise RuntimeError(f"{body.name} is already grabbed")
        owners = self._sphere_owners()
        link_world = self._link_world_pose(link)
        into_link = np_pose.compose(np_pose.invert(link_world), body.pose)
        centers, radii = body.scene.bounding_spheres()
        local = (np.stack([np_pose.apply(into_link, c) for c in centers])
                 if len(radii) else np.zeros((0, 3)))
        self.model = self.model.with_spheres(
            [(link, local[i], float(radii[i])) for i in range(len(radii))])
        self._owner_tags = owners + [body.name] * len(radii)
        self.grabbed[body.name] = (link, into_link)
        body.grabbed_by = self.name
        self._reset_exclude_ref()

    def grabbed_body_pose(self, body_name: str) -> np.ndarray:
        """Current world pose of a grabbed body (it rides the grabbing
        link, as OpenRAVE updates grabbed-body transforms with the
        robot)."""
        link, into_link = self.grabbed[body_name]
        return np_pose.compose(self._link_world_pose(link), into_link)

    def release(self, body: KinBody):
        """Detach a grabbed body: remove exactly its spheres (found by
        owner tag, robust to several grabs at once) and leave the body
        where the grabbing link carried it (OpenRAVE Release semantics:
        the body keeps its current world transform)."""
        body.pose = self.grabbed_body_pose(body.name)
        self.grabbed.pop(body.name)
        owners = self._sphere_owners()
        keep = [i for i, o in enumerate(owners) if o != body.name]
        self.model = self.model.select_spheres(np.asarray(keep, np.int64))
        self._owner_tags = [owners[i] for i in keep]
        body.grabbed_by = None
        self._reset_exclude_ref()

    def check_exclude_mask(self):
        """(S, S) bool: sphere pairs the hard self-collision *check*
        ignores — adjacent links plus pairs already overlapping at the
        robot's *reference* configuration (OpenRAVE marks initially
        colliding link pairs as adjacent, so its CheckSelfCollision never
        reports them).  The reference configuration is captured at
        construction and re-captured when the sphere set changes
        (grab/release), never at check time, so a robot momentarily in
        a colliding configuration cannot whitelist colliding pairs."""
        if self._check_exclude is None:
            q_ref, pose_ref = self._exclude_ref
            x = sphere_positions_np(self.model, q_ref, pose_ref)
            rad = np.asarray(self.model.sphere_radius, dtype=np.float64)
            dist = np.linalg.norm(x[:, None, :] - x[None, :, :], axis=-1)
            overlap = dist < (rad[:, None] + rad[None, :])
            self._check_exclude = self.model.sphere_adjacent_link() | overlap
        return self._check_exclude

    def _reset_exclude_ref(self):
        """Capture the exclusion reference configuration (at construction,
        and when the sphere set changes)."""
        self._exclude_ref = (self.q_active.copy(),
                             np.asarray(self.pose, np.float64).copy())
        self._check_exclude = None

    def sphere_world(self):
        """World (positions (S, 3), radii (S,)) of every sphere at the
        current configuration, float64 on the host
        (``sphere_positions_np``, the JAX package's host FK)."""
        return (sphere_positions_np(self.model, self.q_active, self.pose),
                np.asarray(self.model.sphere_radius))

    def aabb_at_origin(self, padding=0.0):
        """AABB of the sphere model with the base at the origin."""
        x = sphere_positions_np(self.model, self.q_active, np_pose.POSE_ID)
        r = np.asarray(self.model.sphere_radius)[:, None]
        return (x - r).min(axis=0) - padding, (x + r).max(axis=0) + padding


@dataclasses.dataclass
class SdfEntry:
    """Registry entry (struct sdf, orcdchomp_mod.h:36-40)."""

    kinbody_name: str
    grid: Grid3D
    pose: np.ndarray   # (7,) grid frame in kinbody frame


@dataclasses.dataclass
class Trajectory:
    """Retimed output trajectory (gettraj result)."""

    times: np.ndarray          # (n_points,)
    positions: np.ndarray      # (n_points, n_adof)
    base_poses: Optional[np.ndarray] = None  # (n_points, 7) if floating
    # affine_velocities group of the merged reference trajectory
    # (orcdchomp_mod.cpp:2940-2948): Δpose/Δt per waypoint, zeros at 0
    base_velocities: Optional[np.ndarray] = None  # (n_points, 7)
    in_collision: bool = False

    @property
    def duration(self):
        return float(self.times[-1])

    def sample(self, t):
        """Linear interpolation at time t (the retimer is linear)."""
        t = np.clip(t, 0.0, self.duration)
        i = int(np.searchsorted(self.times, t, side="right") - 1)
        i = min(max(i, 0), len(self.times) - 2)
        dt = self.times[i + 1] - self.times[i]
        a = 0.0 if dt <= 0 else (t - self.times[i]) / dt
        q = (1 - a) * self.positions[i] + a * self.positions[i + 1]
        if self.base_poses is None:
            return q, None
        bp = (1 - a) * self.base_poses[i] + a * self.base_poses[i + 1]
        return q, np_pose.normalize(bp)


@dataclasses.dataclass
class Run:
    """One CHOMP run (struct run, orcdchomp_mod.cpp:886-966): a single
    problem (unbatched leaves) on its engine, with its own HMC draw
    source ``draw``.  ``fk`` is the float64 FK over every sphere on the
    module's device that the trajectory collision check runs."""

    engine: ChompEngine
    problem: ChompProblem
    spec: ChompSpec
    robot: Robot
    fk: CompiledFK
    n_points: int
    draw: HmcDraw
    iteration: int = 0
    dat_filename: Optional[str] = None
    no_report_cost: bool = False
    dat_rows: list = dataclasses.field(default_factory=list)
    start_time: float = dataclasses.field(default_factory=time.time)


class CheckResult(NamedTuple):
    """Per problem of a trajectory collision check: the verdict, each
    checked body's hit flag and the self-collision flag (all False for a
    zero-length trajectory), and the checked bodies' names."""

    collides: np.ndarray     # (B,) bool
    env_hits: np.ndarray     # (n_bodies, B) bool
    self_hit: np.ndarray     # (B,) bool
    names: list


def check_chunk(samples, spheres, device_chunk=None, triangles=0):
    """Problems per chunk of the trajectory collision check: as many as
    keep both the (chunk, samples, S, S, 3) float64 pair tensor and the
    (chunk, samples, S, T, 3) float64 tensor of a mesh body's
    ``triangles`` (its largest) within CHECK_PAIR_BYTES, at least one, at
    most ``device_chunk`` if given."""
    per_problem = samples * spheres * max(spheres, triangles) * 3 * 8
    chunk = max(1, CHECK_PAIR_BYTES // max(per_problem, 1))
    return chunk if device_chunk is None else max(1, min(chunk,
                                                         device_chunk))


def voxelize_chunked(placed, centers, cube_extent, centers64=None):
    """Occupancy (N,) of the cell cubes at world ``centers`` (N, 3) against
    every (scene, world pose of the scene) of ``placed``, in chunks of
    cells that keep each scene's float64 (cells, primitives, 3, 3) tensor
    within VOXEL_CHUNK_BYTES.  A mesh's triangles are tested in float64
    on ``centers64`` (the same centres in float64) where given.  Each
    cell's test is elementwise, so the result equals one piece's."""
    occ = torch.zeros(centers.shape[0], dtype=torch.bool,
                      device=centers.device)
    for sc, pose in placed:
        inv = np_pose.invert(pose)
        local = pose_apply(torch.as_tensor(inv, dtype=centers.dtype,
                                           device=centers.device), centers)
        local64 = None
        if centers64 is not None and sc.tri_verts.shape[0]:
            local64 = pose_apply(torch.as_tensor(
                inv, dtype=torch.float64, device=centers.device), centers64)
        step = max(1, VOXEL_CHUNK_BYTES // (72 * max(sc.n_primitives, 1)))
        for lo in range(0, centers.shape[0], step):
            part = slice(lo, lo + step)
            occ[part] |= voxelize_scene(
                sc, local[part], cube_extent,
                None if local64 is None else local64[part])
    return occ


def _retime(q, vmax):
    """Linear retime of (B, P, n) waypoints at joint speed limits vmax:
    OpenRAVE's linear retimer times each piecewise-linear segment at
    max_j |Δq_j| / vmax_j, floored at 1e-6 (orcdchomp_mod.cpp:2905-2911).
    Returns (times (B, P), seg (B, P-1))."""
    dq = np.abs(np.diff(q, axis=1))
    seg = np.maximum((dq / vmax[None, None, :]).max(axis=2), 1e-6)
    times = np.concatenate([np.zeros((q.shape[0], 1)),
                            np.cumsum(seg, axis=1)], axis=1)
    return times, seg


class CHOMPModule:
    """The module: world registry + SDF registry + run registry.  Fields,
    engines and problems live on ``device`` (the card unless the caller
    names another) in ``dtype``."""

    # max engines kept alive by the cache (each pins a field stack on the
    # device); live runs keep their own engine references, so eviction
    # never breaks an existing run
    ENGINE_CACHE_MAX = 16

    def __init__(self, dtype=torch.float32, device="cuda"):
        self.dtype = dtype
        self.device = torch.device(device)
        self.bodies: Dict[str, KinBody] = {}
        self.robots: Dict[str, Robot] = {}
        self.sdfs: List[SdfEntry] = []
        self.runs: Dict[str, Run] = {}
        self._next_run = 0
        # engine cache: evicted when the field registry changes, and
        # LRU-bounded; insertion order is LRU order
        self._engine_cache = {}
        self._fields_version = 0
        # the last trajectory check's sizes: samples per problem, spheres,
        # problems per chunk
        self.last_check = None
        # the last computedistancefield's PhaseTimers
        self.sdf_timers = None

    def _evict_engines(self):
        """Drop cached engines built against a superseded field registry
        (their field stacks pin device memory of removed or replaced
        SDFs; the reference frees SDF grids eagerly: removefield
        orcdchomp_mod.cpp:799-847, run_destroy 3039-3066), then LRU-bound
        what remains."""
        stale = [k for k in self._engine_cache
                 if k[2] != self._fields_version]
        for k in stale:
            del self._engine_cache[k]
        while len(self._engine_cache) > self.ENGINE_CACHE_MAX:
            del self._engine_cache[next(iter(self._engine_cache))]

    def clear_engine_cache(self):
        """Drop every cached engine (device memory is freed once no live
        run references it)."""
        self._engine_cache.clear()

    def _fields_changed(self):
        self._fields_version += 1
        self._evict_engines()

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

    def viewspheres(self, robot=None, **_):
        """The robot's sphere model in world coordinates as a list of
        (name, center, radius) — the data the reference renders as
        orcdchomp_sphere_%d kinbodies (orcdchomp_mod.cpp:175-289)."""
        x, rad = self._resolve_robot(robot).sphere_world()
        return [(f"orcdchomp_sphere_{i}", x[i], float(rad[i]))
                for i in range(len(rad))]

    # ----- distance fields ------------------------------------------------

    def _body_world_pose(self, b) -> np.ndarray:
        """Effective world pose of a kinbody or robot: a grabbed body
        rides its grabbing link (its stored ``pose`` is stale while
        grabbed).  A robot is never grabbed (the JAX package reads
        ``grabbed_by``, which its Robot lacks, and raises here)."""
        by = getattr(b, "grabbed_by", None)
        if by and by in self.robots:
            return self.robots[by].grabbed_body_pose(b.name)
        return b.pose

    def _world_occupancy_scene(self):
        """(scenes, poses) of every *enabled* body, the field's own
        kinbody included (the named body only anchors the grid); a
        grabbed body is an ordinary enabled kinbody at its carried pose,
        and an enabled robot contributes its spheres."""
        scenes, poses = [], []
        for b in self.bodies.values():
            if b.enabled:
                scenes.append(b.scene)
                poses.append(self._body_world_pose(b))
        for r in self.robots.values():
            if not r.enabled:
                continue
            x, rad = r.sphere_world()
            scenes.append(Scene.build(
                spheres=[(x[i], float(rad[i])) for i in range(len(rad))]))
            poses.append(np_pose.POSE_ID)  # sphere centres already world
        return scenes, poses

    def _check_new_field(self, kinbody):
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        body = self._get_body(name)
        if any(s.kinbody_name == name for s in self.sdfs):
            raise RuntimeError("We already have an sdf for this kinbody!")
        return name, body

    def computedistancefield(self, kinbody=None, cube_extent=0.02,
                             aabb_padding=0.2, cache_filename=None,
                             require_cache=False, **_):
        """Build + register an SDF around ``kinbody`` (a kinbody or a
        robot: AABB at origin + padding, voxelize, flood-fill the
        exterior, signed EDT; registry keyed by kinbody name —
        orcdchomp_mod.cpp:297-589).

        ``cache_filename``: the reference's cache (orcdchomp_mod.cpp:
        416-444), the field's raw float32 values in C order.  A file
        whose size matches the grid is read instead of building the
        field; a missing file or one of another size is a miss, after
        which the field is built and written there.  ``require_cache``
        makes a miss raise.

        ``self.sdf_timers`` (a ``PhaseTimers``) holds this call's host
        walls of ``cache_read``, ``sdf_build`` (which ends in a device
        sync, so it holds the build's device time) and ``cache_write``
        (the reference times the build, orcdchomp_mod.cpp:459-565);
        inside the build, profiler ranges ``voxelize``, ``flood`` and
        ``edt`` split it without a sync."""
        name, body = self._check_new_field(kinbody)
        lo, hi = body.aabb_at_origin()
        center = 0.5 * (lo + hi)
        extents = 0.5 * (hi - lo)
        sizes = np.ceil((extents + aabb_padding) / cube_extent).astype(int)
        lengths = sizes * 2.0 * cube_extent
        grid_pose = np_pose.POSE_ID.copy()
        grid_pose[:3] = center - 0.5 * lengths
        timers = self.sdf_timers = PhaseTimers()
        grid = None
        if cache_filename:
            with timers.tic("cache_read"):
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
            with timers.tic("sdf_build"):
                grid = self._build_sdf_grid(body, grid_pose, sizes, lengths,
                                            float(cube_extent))
                if grid.data.is_cuda:
                    torch.cuda.synchronize(grid.data.device)
            if cache_filename:
                with timers.tic("cache_write"):
                    grid.data.cpu().numpy().astype(np.float32).tofile(
                        cache_filename)
        self.sdfs.append(SdfEntry(kinbody_name=name, grid=grid,
                                  pose=grid_pose))
        self._fields_changed()
        return ""

    def _build_sdf_grid(self, body, grid_pose, sizes, lengths, cube_extent):
        """Voxelize → exterior flood fill → signed EDT, in float32 on the
        module's device, at any grid size (the JAX package sends grids
        above 192³ cells to host C++; here every grid builds on the
        device).  The grid's world frame takes the body's carried pose if
        it is grabbed, as create and viewfields do."""
        f32 = dict(dtype=torch.float32, device=self.device)
        pose_world_gsdf = np_pose.compose(self._body_world_pose(body),
                                          grid_pose)
        grid = Grid3D.create(sizes, lengths, device=self.device)
        centers_w = pose_apply(torch.as_tensor(pose_world_gsdf, **f32),
                               grid.all_centers()).reshape(-1, 3)
        scenes, poses = self._world_occupancy_scene()
        scenes = [sc.to(self.device) for sc in scenes]
        centers64 = None
        if any(sc.tri_verts.shape[0] for sc in scenes):
            g64 = Grid3D(data=grid.data, lengths=torch.as_tensor(
                lengths, dtype=torch.float64, device=self.device))
            centers64 = pose_apply(
                torch.as_tensor(pose_world_gsdf, dtype=torch.float64,
                                device=self.device),
                g64.all_centers()).reshape(-1, 3)
        with phase("voxelize"):
            occ = voxelize_chunked(list(zip(scenes, poses)), centers_w,
                                   cube_extent, centers64=centers64)
        with phase("flood"):
            occ = exterior_free_mask(occ.reshape(tuple(int(s)
                                                       for s in sizes)))
        with phase("edt"):
            data = signed_edt(occ, grid.lengths)
        return Grid3D(data=data, lengths=grid.lengths)

    def addfield_fromobsarray(self, kinbody=None, obsarray=None, sizes=None,
                              lengths=None, pose=None, **_):
        """Register an SDF computed from a raw occupancy array (nonzero =
        obstacle; orcdchomp_mod.cpp:592-722), on the module's device."""
        name, _ = self._check_new_field(kinbody)
        obsarray = np.asarray(obsarray)
        if sizes is not None:
            obsarray = obsarray.reshape(tuple(sizes))
        lengths = np.asarray(lengths, dtype=np.float64)
        pose = (np_pose.normalize(pose) if pose is not None
                else np_pose.POSE_ID.copy())
        data = signed_edt(torch.as_tensor(obsarray != 0, device=self.device),
                          lengths)
        grid = Grid3D(data=data, lengths=torch.as_tensor(
            lengths, dtype=torch.float32, device=self.device))
        self.sdfs.append(SdfEntry(kinbody_name=name, grid=grid, pose=pose))
        self._fields_changed()
        return ""

    def viewfields(self, **_):
        """Per field, the occupied (sd ≤ 0) cell centres in world
        coordinates (float32) — the data viewfields renders
        (orcdchomp_mod.cpp:724-797)."""
        out = {}
        for s in self.sdfs:
            body = self._get_body(s.kinbody_name)
            pw = np_pose.compose(self._body_world_pose(body), s.pose)
            pts = s.grid.all_centers()[s.grid.data <= 0.0]
            out[s.kinbody_name] = pose_apply(
                torch.as_tensor(pw, dtype=torch.float32, device=pts.device),
                pts).cpu().numpy()
        return out

    def removefield(self, kinbody=None, **_):
        name = kinbody if isinstance(kinbody, str) else kinbody.name
        for i, s in enumerate(self.sdfs):
            if s.kinbody_name == name:
                del self.sdfs[i]
                self._fields_changed()
                return ""
        raise RuntimeError("kinbody not found, or has no sdf attached!")

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
        ``seed`` seeds the run's HMC draw source (``Run.draw``), and the
        engine's (``ChompEngine.draw``, which batch solves use) when this
        create builds the engine rather than taking a cached one.
        ``start_tsr`` makes the start point a moving point
        (m = n_points − 1) held to that TSR; ``start_cost`` is the
        engine's ``extra_cost`` hook, ``hook(T_mov (m, n)) → (cost (),
        grad (m, n))`` on tensors.
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

        m = n_points - 2 + (start_tsr is not None)
        spec = ChompSpec(n_points=n_points, n=n, m=m, D=D,
                         floating_base=bool(floating_base),
                         use_momentum=bool(use_momentum or use_hmc),
                         use_hmc=bool(use_hmc),
                         start_tsr=start_tsr is not None,
                         n_fields=len(self.sdfs))

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

        # chomp.c:239-428; under start_tsr the start point is free.  The
        # semiseparable metric for long default-metric trajectories (JAX
        # api.py:733-737) builds no m×m operator
        use_sep = (metric_mod.sep_eligible(D, start_tsr is None)
                   and m >= metric_mod.SEP_MIN_M)
        ops = None if use_sep else metric_mod.build_metric(
            m, spec.dt, D=D, has_init0=start_tsr is None)
        init0 = None if start_tsr is not None else traj[0]
        # joint limits (orcdchomp_mod.cpp:2638-2660); the base is free
        lo = np.asarray(r.model.dof_limits_lower, dtype=np.float64)
        hi = np.asarray(r.model.dof_limits_upper, dtype=np.float64)
        if floating_base:
            lo = np.concatenate([np.full(7, -np.inf), lo])
            hi = np.concatenate([np.full(7, np.inf), hi])

        # rooted SDFs (orcdchomp_mod.cpp:2347-2369); a grabbed anchor body
        # carries its field with the grabbing link
        pw, pg = [], []
        for s in self.sdfs:
            p = np_pose.compose(
                self._body_world_pose(self._get_body(s.kinbody_name)), s.pose)
            pw.append(p)
            pg.append(np_pose.invert(p))

        # TSR constraints (orcdchomp_mod.cpp:2569-2614)
        entries, tsr_T0w_inv, tsr_Twe_inv = [], [], []

        def add_con(tsr, point_idx):
            entries.append((point_idx, tsr.enabled_mask()))
            tsr_T0w_inv.append(np_pose.invert(tsr.T0w))
            tsr_Twe_inv.append(np_pose.invert(tsr.Twe))

        if start_tsr is not None:
            add_con(start_tsr, 0)
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

        # the engine, shared by creates of the same static structure
        # (api.py:792-809); the model is keyed by identity (grab and
        # release make a new one), the fields by their registry version,
        # the hook by identity (the cached engine holds it, so its id is
        # not reused while the entry lives)
        key = (spec, id(r.model), self._fields_version, cons,
               None if start_cost is None else id(start_cost))
        engine = self._engine_cache.pop(key, None)
        if engine is None:
            engine = ChompEngine(
                spec, r.model, pad_stack_grids([s.grid for s in self.sdfs],
                                               self.device, self.dtype),
                dtype=self.dtype, device=self.device, metric_ops=ops,
                seed=seed, cons=cons, extra_cost=start_cost,
                metric_mode="sep" if use_sep else "dense")
        self._engine_cache[key] = engine   # at the back: most recent
        self._evict_engines()
        B, trC, Evels = engine.build_affine(init0, traj[-1], n)

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
        self.runs[handle] = Run(
            engine=engine, problem=problem, spec=spec, robot=r,
            fk=CompiledFK(r.model, dtype=torch.float64, device=self.device),
            n_points=n_points, draw=HmcDraw(seed, self.device),
            dat_filename=dat_filename, no_report_cost=bool(no_report_cost))
        return handle

    # ----- iterate --------------------------------------------------------

    def iterate(self, run=None, n_iter=1, max_time=None,
                trajs_fileformstr=None, cost=None, verbose=False, **_):
        """Run n_iter CHOMP iterations (orcdchomp_mod.cpp:2690-2852).

        Returns the final total cost (which the reference writes to the
        output stream), from ``final_costs_batch``.  The run steps as a
        batch of one with its own draw source.  ``max_time`` (a
        wall-clock budget) and ``trajs_fileformstr`` (the trajectory
        written before each iteration) are handled between iterations;
        otherwise the costs come to the host once per ITER_CHUNK steps.
        """
        rn = self.runs[run]
        if n_iter < 0:
            raise ValueError("n_iter must be >=0!")
        t0 = time.time()
        done = 0
        chunk = 1 if (max_time is not None or trajs_fileformstr) \
            else rn.engine.ITER_CHUNK
        probs = as_batch(rn.problem)
        while done < n_iter:
            todo = min(chunk, n_iter - done)
            if trajs_fileformstr:
                np.savetxt(trajs_fileformstr % rn.iteration,
                           rn.problem.traj.cpu().numpy())
            probs, costs = rn.engine.iterate_batched(probs, todo, rn.draw)
            rn.problem = first(probs)
            costs = costs[0].cpu().numpy()                 # (todo, 3)
            # no_report_cost suppresses the per-iteration cost report
            # (README.md:137); the .dat rows do not depend on it: the
            # reference's fprintf to fp_dat is unconditional
            # (orcdchomp_mod.cpp:2810-2818)
            if rn.dat_filename or not rn.no_report_cost:
                for k in range(todo):
                    it = rn.iteration + k
                    if verbose and not rn.no_report_cost:
                        print(f"iter:{it:2d} cost_total:{costs[k, 0]:f} "
                              f"cost_obs:{costs[k, 1]:f} "
                              f"cost_smooth:{costs[k, 2]:f}")
                    rn.dat_rows.append(
                        [it, time.time() - t0, costs[k, 0], costs[k, 1],
                         costs[k, 2]])
            done += todo
            rn.iteration += todo
            if max_time is not None and time.time() - t0 > max_time:
                break
        total, c_obs, c_smooth = torch.stack(
            rn.engine.final_costs_batch(probs))[:, 0].tolist()
        if verbose:
            print(f"iter:{rn.iteration:2d} cost_total:{total:f} "
                  f"cost_obs:{c_obs:f} cost_smooth:{c_smooth:f} [FINAL]")
        if rn.dat_filename:
            with open(rn.dat_filename, "w") as f:
                for row in rn.dat_rows:
                    f.write(" ".join(str(v) for v in row) + "\n")
        if cost is not None:
            cost[0] = total
        return total

    # ----- gettraj --------------------------------------------------------

    def gettraj(self, run=None, no_collision_check=False,
                no_collision_exception=False, no_collision_details=False,
                **_):
        """Extract, retime and validity-check the trajectory
        (orcdchomp_mod.cpp:2854-3011): the batched check at one
        problem."""
        rn = self.runs[run]
        (out,) = self._retimed(rn, rn.problem.traj[None])
        if not no_collision_check:
            res = self._check_traj_collision_batch(
                rn, out.positions[None],
                None if out.base_poses is None else out.base_poses[None],
                out.times[None])
            if not no_collision_details:
                for name, hit in zip(res.names, res.env_hits[:, 0]):
                    if hit:
                        print(f"Collision with {name}")
                if res.self_hit[0]:
                    print("Self collision")
            out.in_collision = bool(res.collides[0])
            if out.in_collision and not no_collision_exception:
                raise RuntimeError("Resulting trajectory is in collision!")
        return out

    def _retimed(self, rn, traj):
        """(B,) Trajectory of a (B, P, n) trajectory tensor: the linear
        retime at the robot's joint speed limits, and for a floating base
        the reference's affine_velocities, Δpose over the active DOFs'
        segment times (orcdchomp_mod.cpp:2914-2956).  Returns a list of
        B Trajectory."""
        traj = traj.double().cpu().numpy()
        if rn.spec.floating_base:
            base, q = traj[:, :, :7], traj[:, :, 7:]
        else:
            base, q = None, traj
        times, seg = _retime(
            q, np.asarray(rn.robot.model.dof_max_vel, dtype=np.float64))
        out = []
        for b in range(traj.shape[0]):
            bv = None
            if base is not None:
                bv = np.zeros_like(base[b])
                bv[1:] = (base[b, 1:] - base[b, :-1]) / seg[b, :, None]
            out.append(Trajectory(
                times=times[b], positions=q[b],
                base_poses=None if base is None else base[b],
                base_velocities=bv))
        return out

    def gettraj_batch(self, run=None, probs=None, no_collision_check=False,
                      device_chunk=None, **_):
        """gettraj for a whole BatchSolver problem batch in one call: the
        same linear retime and ~0.04 rad sampled collision check, with
        the FK and the sphere tests on the module's device in chunks of
        problems sized by :func:`check_chunk` (``device_chunk`` caps a
        chunk).  ``run`` supplies the robot and scene the batch was built
        from.

        Returns ``(trajs, in_collision)``: a list of B
        :class:`Trajectory` (each with ``.in_collision`` set) and the (B,)
        bool array.  No exception for a colliding trajectory: batch
        callers filter instead."""
        rn = self.runs[run]
        trajs = self._retimed(rn, probs.traj)
        collides = np.zeros(len(trajs), dtype=bool)
        if not no_collision_check:
            collides = self._check_traj_collision_batch(
                rn, np.stack([t.positions for t in trajs]),
                None if trajs[0].base_poses is None else
                np.stack([t.base_poses for t in trajs]),
                np.stack([t.times for t in trajs]), device_chunk).collides
        for t, c in zip(trajs, collides):
            t.in_collision = bool(c)
        return trajs, collides

    def _check_traj_collision_batch(self, rn: Run, q, base, times,
                                    device_chunk=None) -> CheckResult:
        """Sampled validity check of B retimed trajectories, q (B, P, n),
        base (B, P, 7) or None, times (B, P) (orcdchomp_mod.cpp:
        2958-3006): samples every ~0.04 rad of configuration arc length,
        the sphere model against each enabled body's analytic distance
        and the sphere pairs outside ``Robot.check_exclude_mask``.  Bodies
        grabbed by the checked robot move with it and are skipped; bodies
        held by others stay obstacles at their carried pose.  Runs in
        float64 on the module's device, so that the verdict does not
        depend on the solve's precision."""
        B, P, n = q.shape
        dev = rn.fk.device
        f64 = dict(dtype=torch.float64, device=dev)
        dur = times[:, -1]
        dist = np.linalg.norm(np.diff(q, axis=1), axis=2).sum(axis=1)
        active = dist > 0
        # a zero-length trajectory samples t = 0 only; its verdict is
        # False whatever the samples say (the per-run path returns early)
        step = np.where(active, dur * 0.04 / np.maximum(dist, 1e-300), 0.0)
        n_samp = np.where(active, np.ceil(dur / np.maximum(step, 1e-9)), 1)
        T_s = int(max(1, n_samp.max()))

        scenes, invs, names = [], [], []
        for b in self.bodies.values():
            if not b.enabled or b.grabbed_by == rn.robot.name:
                continue
            scenes.append(b.scene.to(**f64))
            invs.append(torch.as_tensor(
                np_pose.invert(self._body_world_pose(b)), **f64))
            names.append(b.name)
        rad = torch.as_tensor(rn.robot.model.sphere_radius, **f64)
        pair_ok = ~torch.as_tensor(rn.robot.check_exclude_mask(), device=dev)
        rsum = rad[:, None] + rad[None, :]
        S = rad.shape[0]
        tris = max([sc.tri_verts.shape[0] for sc in scenes], default=0)
        chunk = check_chunk(T_s, S, device_chunk, tris)
        self.last_check = dict(samples=T_s, spheres=S, triangles=tris,
                               chunk=chunk)
        fixed_base = torch.as_tensor(rn.robot.pose, **f64)

        hits = np.zeros((len(scenes) + 1, B), dtype=bool)
        si = torch.arange(T_s, **f64)[None, :]
        for lo in range(0, B, chunk):
            hi = min(lo + chunk, B)
            tt = torch.as_tensor(times[lo:hi], **f64)           # (nb, P)
            stp = torch.as_tensor(step[lo:hi], **f64)[:, None]
            ns = torch.as_tensor(n_samp[lo:hi], **f64)[:, None]
            # uniform-in-time samples; indices past a problem's own count
            # collapse to t = 0 (a sample it checks anyway)
            ts = torch.minimum(torch.where(si < ns, si * stp, 0.0),
                               tt[:, -1:])                      # (nb, T_s)
            # Trajectory.sample, batched: the last waypoint time <= t
            idx = ((tt[:, None, :] <= ts[:, :, None]).sum(-1) - 1).clamp(
                0, P - 2)
            t0 = torch.gather(tt, 1, idx)
            dt = torch.gather(tt, 1, idx + 1) - t0
            a = torch.where(dt > 0, (ts - t0) / torch.where(dt > 0, dt, 1.0),
                            0.0)[..., None]

            def lerp(v):                                        # (nb, P, c)
                v = torch.as_tensor(v[lo:hi], **f64)
                at = idx[..., None].expand(-1, -1, v.shape[-1])
                return ((1 - a) * torch.gather(v, 1, at)
                        + a * torch.gather(v, 1, at + 1))       # (nb, T_s, c)

            qT = lerp(q).permute(1, 2, 0)                       # (T_s, n, nb)
            if base is None:
                bpos, bq = tuple(fixed_base[:3]), tuple(fixed_base[3:])
            else:
                bp = lerp(base)
                bp = torch.cat([bp[..., :3], bp[..., 3:] / torch.linalg.norm(
                    bp[..., 3:], dim=-1, keepdim=True)], dim=-1)
                bpos = tuple(bp[..., i].T for i in range(3))
                bq = tuple(bp[..., i].T for i in range(3, 7))
            x = torch.stack(rn.fk.fk_soa(qT, bpos, bq).x)       # (3,T_s,S,nb)
            x = x.permute(3, 1, 2, 0)                           # (nb,T_s,S,3)
            flags = [torch.any(scene_distance(sc, pose_apply(inv, x)) < rad,
                               dim=(1, 2))
                     for sc, inv in zip(scenes, invs)]
            pair = torch.linalg.norm(x[:, :, :, None] - x[:, :, None],
                                     dim=-1)                    # (nb,T_s,S,S)
            flags.append(torch.any((pair < rsum) & pair_ok, dim=(1, 2, 3)))
            hits[:, lo:hi] = torch.stack(flags).cpu().numpy()
        hits &= active[None, :]
        return CheckResult(collides=hits.any(axis=0), env_hits=hits[:-1],
                           self_hit=hits[-1], names=names)

    # ----- string transport (orcwrap parity) ------------------------------

    def SendCommand(self, cmd: str, releasegil: bool = False) -> str:
        """Dispatch a shell-quoted command string (the reference's
        SendCommand wire format, orcwrap.cpp:37-69)."""
        return send_command(self, cmd)

    # ----- destroy / runchomp --------------------------------------------

    def destroy(self, run=None, **_):
        del self.runs[run]
        return ""

    def runchomp(self, n_iter=None, max_time=None, trajs_fileformstr=None,
                 cost=None, no_collision_check=False,
                 no_collision_exception=False, no_collision_details=False,
                 **kwargs):
        """create + iterate + gettraj + destroy (orcdchomp.py:204-219)."""
        run = self.create(**kwargs)
        try:
            self.iterate(run=run, n_iter=1 if n_iter is None else n_iter,
                         max_time=max_time,
                         trajs_fileformstr=trajs_fileformstr, cost=cost)
            traj = self.gettraj(
                run=run, no_collision_check=no_collision_check,
                no_collision_exception=no_collision_exception,
                no_collision_details=no_collision_details)
        finally:
            self.destroy(run=run)
        return traj
