"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the CUDA kernels from or_cdchomp_tpu_torch/csrc (K1 obstacle, K2
self-collision, the seeded HMC draw, the joint-limit repair, the FK and
the Jᵀ map of the step), holds each
against its plain PyTorch version at the shapes of the paths below, and
drives all five of BASELINE's configurations through CHOMPModule and
BatchSolver, each with the kernel launch counts set to 0 just before it
and read just after (K1, K2 and the limits kernel once a step, a CUDA
graph's replays counted as its capture recorded them):

- config 1 (the main path): the bench scene (WAM7 + hand, table + mug,
  one SDF), 256 perturbed problems, 100 iterations of
  BatchSolver.iterate in float32;
- config 2: three SDFs (table, shelf, mugs; cache files), self-collision
  weights and a moved robot base, 256 problems, BatchSolver.solve of 100
  iterations and the final cost report;
- config 3: config 1's scene with HMC (seed 7), 256 problems,
  BatchSolver.solve and best_of_batch;
- config 4: WAM7 on an SE(3) floating base (n = 14) with the upright
  everyn TSR at every moving point, table + mug at 0.08 m (cache file),
  n_points = 51, λ = 200, obs_factor = 200, 256 problems,
  BatchSolver.iterate of 100 iterations and the final cost report; both
  kernels are held against their plain versions on its inputs (K2 with
  no inactive sphere), the projection's dense and quasiseparable solves
  are timed, and the constraint residual is read before and after;
- config 5: config 1 at 10,240 problems, 100 iterations; both kernels
  are held against their plain versions again on its inputs, and K1 is
  timed there.

On a card every iterate replays one CUDA graph of the step
(ChompEngine.iterate_batched).  Configs 1, 3 (seeded), 4, 5 and the long
batch each hold a replayed iterate(100) against 100 eager step_batched
calls (state and costs bit-equal), count the host syncs of a replayed
iterate(100) (none), and time both in turns with their device idle
shares (graph_check).  The FK kernel is held against the plain fk_soa
and timed with its inputs cold, beside its byte bound, at configs 1 and
5's shapes (101 points, B = 256 and 10,240) and at the float64
trajectory check's of a B = 1 gettraj.  The Jᵀ map kernel is held
against its plain version and the step's plain phase on config 1's and
config 5's own step inputs and timed with them cold, beside its byte
bound (``--jtmap`` adds config 4, the tray and float64).  The limits
kernel is held
against its plain
version at config 1's shape with rows pushed out of their limits, in
float32 and float64, and at m = 999 (the semiseparable metric).

Config 1's B = 256 solve also runs over two replicas on the one card
(``BatchSolver(engine, devices=[card, card])``: the engine and a copy,
one layout-kernel launch, 128 rows each, stepped in turn), K1, K2 and
the limits kernel counted by the profiler on the card (launches_by_card)
and every row bit-equal to ``devices=[card]``, the
two walls in turns; config 3's unseeded HMC batch the same way, its
whole-batch draws bit-equal; and the layout kernel timed at its pair
table (config 1's 207 pairs; the grab's 3,617 in the grab phase).

Then the libcd math library: every quat / spatial function of the
pose-algebra API in float32 on 65,536 seeded inputs against the port's
CPU float64; the per-problem FK (fk_spheres, apply_sphere_jacT) at
config 1's 256 × 99 configurations against fk_soa /
apply_sphere_jacT_soa; and multigrid_interp_grad at the batches' sphere
centres on config 1's field and config 2's three (the latter also with
the cloud moved into them), one launch of K1's raw lookup
(sdf_cell_lookup_kernel) per call, its cells bit-equal to the plain
version and the values against the CPU's float64, timed beside the
plain version and one torch.gather.

Then the module commands on config 1's world (runchomp, B = 1 create +
iterate, gettraj, gettraj_batch, the field commands), a grabbed tray of
110 spheres (K2's tiled path: its launch facts, one device kernel per
call with the engine's pair layout and two without, the layout kernel
bit-equal to its plain version, the skip shares), and the front door:
the WAM7 + hand
loaded from OpenRAVE XML text and driven by SendCommand strings only
(create with start_tsr at n_points 101, iterate 100, gettraj, destroy)
against the same strings on the CPU in float64, B = 256 batches with
start_tsr and with a quadratic start_cost hook timed beside config 1 and
re-solved on the CPU, and both kernels at the start_tsr shape (m = 100).

Three phases of long trajectories, meshes and seeds follow:

- long trajectories: config 1's world at n_points 1001 (m = 999, the
  semiseparable metric, checked to hold no m×m tensor), B = 256,
  iterate(100) with its step profile, K1 and K2 held and timed at
  m = 999, the first 8 problems re-solved on the CPU in float64; and
  runchomp at n_points 258 (m = 256) against the CPU float64 runchomp;
- the mesh demo (examples/wam7_mesh_demo.py's scene: box meshes for the
  table, a 24-gon mug): its field at 0.04 m against the CPU build (ties
  listed) and built in chunks against one piece, runchomp
  collision-free against the CPU float64 runchomp, a B = 256 batch with
  gettraj_batch's verdicts against the CPU float64 check, K1 on the mesh
  field; then the table at 0.0025 m (180 × 240 × 184 cells, above
  192³): build wall and peak memory, its sign against sd_trimesh at
  10,000 sampled cells, K1 and a B = 256 iterate on it;
- seeded HMC: config 3 with seeds 7 + p at B = 256: the draw kernel
  against its plain version (words bit-equal), one draw launch per step,
  and rows 0-7 re-run as a batch of 8: draws bit-equal at every step,
  trajectories within 1e-5.

Three phases of the multi-process layer, checkpoints and the phase
ranges follow:

- distributed: this process joins an NCCL world of one (a TCPStore on
  127.0.0.1) and solves config 1's B = 256 batch with a mesh BatchSolver
  (solve with tol, all_hosts_best), bit-equal to the plain solver, with
  its collectives counted (none per step, one all-reduce per chunk) and
  the two walls in turns; then two child processes of this script
  (``--dist-child``) share the card over gloo, 128 rows each of config
  3's HMC batch on seeds arange(256), held to this process's solve of
  all 256 (same best index, best cost within 1e-6 relative, max
  |Δtraj| ≤ 1e-5);
- checkpoint: a config 3 module run resumed across save_problem /
  load_problem with its HmcDraw, and the seeded batch from the problem
  alone, each bit-equal to an uninterrupted run; save and load walls,
  file sizes;
- phase profile: configs 1 and 4 under torch.profiler, device and host
  ms per step per phase, every K1 launch in ``obstacle`` and every K2
  launch in ``selfcol``; config 1's warm iterate(100) with the ranges
  and with ``phase`` swapped for a null context, in turns; the 0.0025 m
  mesh field's build split into voxelize, flood and edt.

Then float64 on the card: config 1's world through
CHOMPModule(dtype=float64) on the card, which runs the float64 kernels
(K1, K2 and the raw lookup, each launched and counted), runchomp at
n_points 101, a B = 4 batch and multigrid_interp_grad held to the CPU's
float64 on the same field within 1e-9 (1e-12 for the lookup); each
float64 kernel against its plain version on the batch's inputs (K1 and
the lookup bit-equal, K2 within 1e-12 with its launch facts and one
device kernel per call), timed.  And the port's scripts:
drive_torch.py and examples/torch_*.py, each in a child process
(``--script``) at its own defaults, exit code 0 and K1 and K2 launched.

Each is timed on the card first; then the first 8 problems of configs
1, 2, 3 and 4 are re-solved on the CPU in float64 through the same API
(config 3 fed the card's own HMC draws) and held to max |Δtraj| ≤ 1e-3.
Any failed phase exits non-zero.

    python3 chip_smoke.py
    python3 chip_smoke.py --split 4   # the seeded split alone, 4 ranks
                                      # (NCCL, one per card, on 4 cards)
    python3 chip_smoke.py --cards 4   # one process over 4 cards
    python3 chip_smoke.py --fk        # the build and the FK kernel alone
    python3 chip_smoke.py --jtmap     # the build and the Jᵀ map kernel alone

``--cards N`` (a machine of N >= 2 cards): every kernel launched on the
last card with cuda:0 current against its plain version; then
BatchSolver over all N cards in one process (its default, every card: a
replica per card, each step one graph replay per card, issued in turn)
against one card:
config 1's B = 256 solve, config 3's seeded batch (best_of_batch) and
its unseeded one, every row bit-equal, K1, K2, the limits kernel and
the draw counted per card by the profiler;
config 5 at B = 10,240; config 1's float64 B = 4
batch over two cards against the CPU's float64; solves/s of one card
and of N in turns; and the ``--split N`` reading (split_solve).

Prints the card (nvidia-smi name, power limit), the obstacle kernel's
launch per configuration and the self-collision kernel's (grid, threads,
shared memory, resident blocks, registers, spills), K2's skip shares on
the flagship batch, a JSON line of per-kernel results
(device time beside the bound: bytes over 3.35 TB/s or operations over
67 TFLOP/s fp32, whichever is larger), and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ITER = 100
N_POINTS = 101
BATCH = 256
BATCH_POD = 10_240   # config 5
N_CHECK = 8          # problems re-solved on the CPU in float64
WARM_REPS = 5        # warm walls of configs 2 and 3
TRAJ_BAR = 1e-3      # BASELINE bar: max |Δtraj| float32 card vs float64
KERNEL_RTOL = 1e-5   # kernel vs plain version, both float32 on the card
PROFILE_TRIES = 5    # profiles kernels_per_call takes when one records nothing
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet, 700 W)
L2_BYTES = 50 * 2 ** 20     # H100 SXM L2 cache (data sheet)
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
FP64_FLOPS_PER_S = 34e12    # H100 SXM fp64 outside the tensor cores
START = [2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]
GOAL = [0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0]
# config 2's robot base (benchmarks/configs.py:38-40)
CONFIG2_BASE = [0.0, -1.2, 1.0, 0.0, 0.70711, 0.0, 0.70711]
CACHE_DIR = ROOT / "or_cdchomp_tpu_torch" / "build" / "sdf_cache"
# config 4 (benchmarks/configs.py:102-134)
CONFIG4_POINTS = 51
CONFIG4_BW = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0],
              [-math.pi, math.pi]]
CONFIG4_BASEGOAL = [0.15, 0.1, 0.0, 0.0, 0.0, 0.0, 1.0]
# the module-commands phase: a straight line from START through the table
THROUGH_TABLE = [0.0, 1.5, 0.0, 0.5, 0.0, 0.0, 0.0]
LATENCY_REPS = 3     # warm walls of create + iterate(100) at B = 1
N_CHECK_POD = 512    # config 5 problems whose gettraj_batch flags the CPU checks
# the grab phase: a tray of 10 x 11 spheres of 1.5 cm radius, 3 cm apart,
# held 22 cm out from the hand's base frame
TRAY_OFFSET = [0.0, 0.0, 0.22, 0.0, 0.0, 0.0, 1.0]
# the front door: the robot waits 0.1 rad up on J2 from START, its tool
# ~4 cm above the start TSR's height (x, y and rotation free)
FRONT_START = [2.5, -1.7, 0.0, 2.0, 0.0, 0.2, 0.0]
FRONT_BW = [[-10, 10], [-10, 10], [0, 0], [-math.pi, math.pi],
            [-math.pi, math.pi], [-math.pi, math.pi]]
# the start_cost hook's mid posture and weight
FRONT_QMID = [1.45, -0.45, 0.05, 1.65, 0.0, -0.15, 0.0]
FRONT_W = 0.05
XML_BAR = {"cpu": 1e-12, "cuda": 1e-5}   # XML robot vs wam7(), f64 / f32
# long trajectories: config 1 at m = 999 (the semiseparable metric) and
# runchomp at the first semiseparable shape (m = 256)
LONG_POINTS = 1001
SEP_FIRST_POINTS = 258
# the mesh demo (examples/wam7_mesh_demo.py:38-52) and its large grid:
# the table at 0.0025 m, 180 x 240 x 184 cells, above 192^3
MESH_EXTENT = 0.04
LARGE_EXTENT = 0.0025
N_SIGN = 10_000      # sampled cells of the large grid's sign check
TIE_BAND = 1e-5      # m: a cell whose verdict flips within it is a tie
SEEDED_BAR = 1e-5    # seeded rows: B = 256 against B = 8 on the card
DRAW_RTOL = 1e-6     # draw kernel against its plain version
# the distributed phase: its convergence tolerance, the rendezvous and
# collective timeout, a gloo child's time limit, and the bar of the two
# ranks' best cost against one process's
DIST_TOL = 1e-3
DIST_TIMEOUT = 120
DIST_CHILD_TIMEOUT = 300
DIST_COST_RTOL = 1e-6
CKPT_DIR = ROOT / "or_cdchomp_tpu_torch" / "build" / "ckpt"
# the libcd math phase: seeded inputs per quat / spatial function; the
# bar of the card's float32 against the CPU's float64, as max |Δ| /
# max(1, |value|); fk_spheres against fk_soa (m) and apply_sphere_jacT
# against its SoA form (relative to max |G|), both float32 on the card;
# multigrid_interp_grad's value (m) and gradient against the CPU's
# float64 where both read the same cells, and the share of (field,
# query) that may read other ones (a query within an ulp of a cell
# centre or face, in float32 and float64 apart)
LIBCD_N = 65_536
LIBCD_BAR = 1e-4
FK_BAR = 1e-5
JACT_RTOL = 1e-4
GRID_BAR = 1e-5
GRID_OTHER = 1e-3

# float64 on the card: K1's, K2's and the raw lookup's float64 kernels,
# held to the CPU's float64 on the same field
F64_KERNEL_RTOL = 1e-12   # K2's float64 kernel vs its plain version
F64_TRAJ_BAR = 1e-9     # max |Δtraj|, card against CPU
F64_COST_RTOL = 1e-9
F64_GRID_BAR = 1e-12    # multigrid_interp_grad, relative to max(1, |v|)
F64_BATCH = 4
# --cards N: warm walls of one card against every card, taken in turns
CARD_REPS = 4
# a split batch's costs against one device's (float32 on the card)
SPLIT_COST_RTOL = 1e-6
# replayed iterate against eager steps: warm walls of each, in turns
GRAPH_REPS = 3
# steps of an iterate whose launches the profiler counts by kernel name
PROBE_STEPS = 10

# the port's scripts, each run in a child process at its own defaults
SCRIPTS = ("drive_torch.py", "examples/torch_wam7_demo.py",
           "examples/torch_batch_validate_demo.py",
           "examples/torch_urdf_client_demo.py",
           "examples/torch_wam7_mesh_demo.py")
SCRIPT_TIMEOUT = 300


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---- the configurations (benchmarks/configs.py, copied) --------------------

def config1_world(pt, dtype, device, model=None, q=START):
    """The bench.py scene (table + mug) and the robot ``model`` (the
    built-in WAM7 by default) at ``q``, no field yet; returns (module,
    robot)."""
    import numpy as np

    from or_cdchomp_tpu_torch.api import KinBody, Robot

    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = mod.add_robot(Robot("wam", model or pt.wam7(),
                                q_active=np.array(q)))
    return mod, robot


def bench_module(pt, dtype, device):
    """Config 1: the bench.py scene through the port's API; returns
    (module, run)."""
    mod, robot = config1_world(pt, dtype, device)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    h = mod.create(**run_kw())
    return mod, mod.runs[h]


def config2_module(pt, dtype, device, require_cache=False):
    """Config 2 (benchmarks/configs.py:67-89): table, shelf and mug
    cluster as three SDFs at 0.05 m, read from / written to CACHE_DIR,
    the robot base at y = −1.2; returns (module, run)."""
    import numpy as np

    from or_cdchomp_tpu_torch.api import KinBody, Robot

    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.0, 0.0, 0.7, 0, 0, 0, 1), (0.35, 0.75, 0.02))])))
    mod.add_kinbody(KinBody("shelf", pt.Scene.build(
        boxes=[((0.45, 0.5, 1.0, 0, 0, 0, 1), (0.05, 0.3, 0.3)),
               ((0.45, 0.5, 1.3, 0, 0, 0, 1), (0.3, 0.3, 0.02))])))
    mod.add_kinbody(KinBody("mugs", pt.Scene.build(
        cylinders=[((0.1, 0.2, 0.76, 0, 0, 0, 1), 0.04, 0.06),
                   ((-0.1, -0.3, 0.76, 0, 0, 0, 1), 0.05, 0.08)])))
    robot = Robot("wam", pt.wam7(), pose=np.array(CONFIG2_BASE),
                  q_active=np.array(START))
    mod.add_robot(robot)
    robot.enabled = False
    for name in ("table", "shelf", "mugs"):
        mod.computedistancefield(
            kinbody=name, cube_extent=0.05,
            cache_filename=str(CACHE_DIR / f"sdf_{name}.dat"),
            require_cache=require_cache)
    robot.enabled = True
    h = mod.create(**run_kw(), obs_factor_self=10.0, epsilon_self=0.04)
    return mod, mod.runs[h]


def config3_run(pt, dtype, device):
    """Config 3 (benchmarks/configs.py:92-99): config 1's module, then a
    second create with HMC; returns the HMC run."""
    mod, _ = bench_module(pt, dtype, device)
    h = mod.create(**run_kw(), use_hmc=True, hmc_resample_lambda=0.02,
                   seed=7)
    return mod.runs[h]


def config4_run(pt, dtype, device, require_cache=False):
    """Config 4 (benchmarks/configs.py:102-134): config 1's table + mug
    as one SDF at 0.08 m (read from / written to CACHE_DIR), WAM7 on an
    SE(3) floating base (n = 14) moving to CONFIG4_BASEGOAL, an upright
    everyn TSR on the end effector (roll and pitch pinned) at every
    moving point; returns the run."""
    import numpy as np

    mod, robot = config1_world(pt, dtype, device)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.08,
                             cache_filename=str(CACHE_DIR / "sdf_float.dat"),
                             require_cache=require_cache)
    robot.enabled = True
    tsr = pt.TSR.from_matrices(np.eye(4), np.eye(4),
                               Bw=np.array(CONFIG4_BW))
    h = mod.create(robot="wam", adofgoal=np.array(GOAL),
                   basegoal=np.array(CONFIG4_BASEGOAL), floating_base=True,
                   lambda_=200.0, obs_factor=200.0, n_points=CONFIG4_POINTS,
                   everyn_tsr=tsr)
    return mod.runs[h]


def run_endpoints(run, batch):
    """benchmarks/run.py:37-47's batch: seed 0, σ = 0.02 around the
    run's first and last points, a floating base's quaternion columns
    3:7 kept.  Returns float64 (starts, goals), (batch, n) each."""
    import numpy as np

    rng = np.random.default_rng(0)
    traj = run.problem.traj.double().cpu().numpy()
    n = traj.shape[1]
    starts = np.tile(traj[0], (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    goals = np.tile(traj[-1], (batch, 1)) + 0.02 * rng.normal(size=(batch, n))
    if run.spec.floating_base:
        starts[:, 3:7] = traj[0, 3:7]
        goals[:, 3:7] = traj[-1, 3:7]
    return starts, goals


def bench_endpoints(batch):
    """bench.py's seed-0 perturbed starts and goals, (batch, 7) each."""
    import numpy as np

    rng = np.random.default_rng(0)
    starts = np.tile(np.array(START), (batch, 1)) \
        + 0.02 * rng.normal(size=(batch, 7))
    goals = np.tile(np.array(GOAL), (batch, 1)) \
        + 0.02 * rng.normal(size=(batch, 7))
    return starts, goals


def run_kw(goal=GOAL):
    """create's kwargs of a config-1 run."""
    import numpy as np

    return dict(robot="wam", adofgoal=np.array(goal), lambda_=100.0,
                obs_factor=500.0, n_points=N_POINTS)


def head(probs, n):
    """The first n problems of a batch, on the CPU in float64."""
    import torch

    from or_cdchomp_tpu_torch.chomp.problem import ChompProblem

    return ChompProblem(**{k: v[:n] for k, v in probs.leaves().items()}).to(
        "cpu", torch.float64)


def tray_scene(pt):
    """The grab phase's tray: 110 spheres of 1.5 cm radius."""
    return pt.Scene.build(spheres=[
        ((0.03 * (i - 4.5), 0.03 * (j - 5.0), 0.0), 0.015)
        for i in range(10) for j in range(11)])


def grab_tray(pt, mod):
    """Adds the tray to ``mod`` at TRAY_OFFSET from the robot's hand and
    grabs it there; returns the tray."""
    from or_cdchomp_tpu_torch.api import KinBody
    from or_cdchomp_tpu_torch.models.robot import link_poses_np
    from or_cdchomp_tpu_torch.utils import np_pose

    robot = mod.robots["wam"]
    hand = link_poses_np(robot.model, robot.q_active, robot.pose)[
        robot.model.link_names.index("handbase")]
    tray = mod.add_kinbody(KinBody("tray", tray_scene(pt),
                                   pose=np_pose.compose(hand, TRAY_OFFSET)))
    robot.grab(tray, "handbase")
    return tray


def due_tally(draw, dues):
    """Wraps an HMC draw source: appends to ``dues`` each call's (B,)
    mask of the problems that resample at this step, on the device."""
    def tallied(probs):
        dues.append(probs.iteration == probs.resample_iter)
        return draw(probs)
    return tallied


# ---- the front door: a robot from XML, driven by command strings ------------

def wam7_xml(pt):
    """The port's built-in WAM7 + hand (``wam7(active="all")``) as
    OpenRAVE robot XML text: each body placed from its parent by
    <Translation> and <quat> (w x y z), each joint a hinge about its axis
    in the child frame (a fixed joint disabled), limits in radians, the
    16 spheres in <orcdchomp><spheres>, and a <Manipulator> whose chain
    makes the 7 arm joints the active DOFs."""
    model = pt.wam7(active="all")
    names = model.link_names

    def nums(v):
        return " ".join(repr(float(x)) for x in v)

    out = ['<Robot name="BarrettWAM">', " <KinBody>",
           f'  <Body name="{names[0]}" type="static"/>']
    for i in range(1, len(names)):
        o = model.origin[i]
        out += [f'  <Body name="{names[i]}">',
                f"   <offsetfrom>{names[model.parent[i]]}</offsetfrom>",
                f"   <Translation>{nums(o[:3])}</Translation>",
                f"   <quat>{nums([o[6], *o[3:6]])}</quat>", "  </Body>"]
    for i in range(1, len(names)):
        d = int(model.dof_index[i])
        kind = "slider" if model.jtype[i] == 2 else "hinge"
        enable = "" if d >= 0 else ' enable="false"'
        out += [f'  <Joint name="{model.joint_names[i]}" type="{kind}"'
                f"{enable}>",
                f"   <Body>{names[model.parent[i]]}</Body>"
                f"<Body>{names[i]}</Body>",
                f"   <offsetfrom>{names[i]}</offsetfrom>",
                f"   <axis>{nums(model.axis[i])}</axis>"]
        if d >= 0:
            lim = nums([model.dof_limits_lower[d], model.dof_limits_upper[d]])
            out += [f"   <limitsrad>{lim}</limitsrad>",
                    f"   <maxvel>{float(model.dof_max_vel[d])!r}</maxvel>"]
        out.append("  </Joint>")
    out.append("  <orcdchomp><spheres>")
    for link, pos, r in zip(model.sphere_link, model.sphere_pos,
                            model.sphere_radius):
        out.append(f'   <sphere link="{names[link]}" pos="{nums(pos)}" '
                   f'radius="{float(r)!r}"/>')
    out += ["  </spheres></orcdchomp>", " </KinBody>",
            ' <Manipulator name="arm">',
            f"  <base>{names[0]}</base>",
            f"  <effector>{names[model.ee_link]}</effector>",
            f"  <Translation>{nums(model.ee_origin[:3])}</Translation>",
            " </Manipulator>", "</Robot>"]
    return "\n".join(out)


def xml_sphere_error(torch, pt, model, device, dtype, n=64):
    """max |Δx| of the sphere centres of ``model`` against the built-in
    wam7() at n seeded configurations within the joint limits, through
    CompiledFK on ``device`` in ``dtype``."""
    import numpy as np

    from or_cdchomp_tpu_torch.models.robot import CompiledFK

    ref = pt.wam7()
    rng = np.random.default_rng(11)
    q = rng.uniform(ref.dof_limits_lower, ref.dof_limits_upper,
                    size=(n, ref.n_dof))
    opts = dict(dtype=dtype, device=device)
    qT = torch.as_tensor(q.T[None], **opts)                # (1, n_dof, n)
    base = torch.as_tensor(np.tile([0, 0, 0, 0, 0, 0, 1.0], (n, 1)), **opts)
    xs = []
    for mdl in (model, ref):
        fk = CompiledFK(mdl, **opts)
        xs.append(fk.fk_soa(
            qT, tuple(base[:, i] for i in range(3)),
            tuple(base[:, i] for i in range(3, 7))).x)
    return float((xs[0].double() - xs[1].double()).abs().max())


def front_door_tsr(pt):
    """The front door's start TSR: the tool held at its height in
    START, x, y and the rotation free."""
    import numpy as np

    from or_cdchomp_tpu_torch.models.robot import link_poses_np
    from or_cdchomp_tpu_torch.utils import np_pose

    model = pt.wam7()
    ee = link_poses_np(model, np.array(START), np_pose.POSE_ID)[
        model.ee_link]
    H = np.eye(4)
    H[:3, 3] = np_pose.compose(ee, model.ee_origin)[:3]
    return pt.TSR.from_matrices(H, np.eye(4), Bw=np.array(FRONT_BW))


def front_door_module(pt, model, dtype, device):
    """Config 1's world with the robot ``model`` at FRONT_START, its field
    built by a command string; returns the module."""
    mod, robot = config1_world(pt, dtype, device, model, FRONT_START)
    robot.enabled = False
    check(mod.SendCommand("computedistancefield kinbody table "
                          "cube_extent 0.04") == "", "computedistancefield")
    robot.enabled = True
    return mod


def string_drive(pt, mod, tsr, n_iter=N_ITER, n_points=N_POINTS):
    """The reference-style drive, by command strings only: create with
    start_tsr, iterate, gettraj, destroy.  Returns (final cost, gettraj's
    JSON as a dict, point 0's constraint residual (max |value|) before
    and after, the run's spec)."""
    import json

    from or_cdchomp_tpu_torch.chomp.problem import as_batch

    goal = " ".join(repr(float(v)) for v in GOAL)
    h = mod.SendCommand(
        f"create robot wam adofgoal '{goal}' n_points {n_points} lambda 100 "
        f"obs_factor 500 start_tsr '{tsr.serialize()}'")
    rn = mod.runs[h]
    before = float(rn.engine.constraint_values(as_batch(rn.problem))
                   .abs().max())
    cost = float(mod.SendCommand(f"iterate run {h} n_iter {n_iter}"))
    after = float(rn.engine.constraint_values(as_batch(rn.problem))
                  .abs().max())
    out = json.loads(mod.SendCommand(f"gettraj run {h}"))
    check(mod.SendCommand(f"destroy run {h}") == "" and h not in mod.runs,
          "destroy")
    return cost, out, before, after, rn.spec


def quadratic_hook(torch):
    """create's start_cost for the front door: ½·FRONT_W·Σ (T −
    FRONT_QMID)² over the moving points, pulling them towards a mid
    posture; torch ops only, so torch.func.vmap takes it.  The mid
    posture is made on the device and in the dtype of the rows the hook
    is given, once each: a BatchSolver over several cards runs the hook
    on each card's rows, so it holds no tensor of a fixed card."""
    mids = {}

    def hook(T):
        key = (T.device, T.dtype)
        if key not in mids:
            mids[key] = torch.as_tensor(FRONT_QMID, dtype=T.dtype,
                                        device=T.device)
        d = T - mids[key]
        return 0.5 * FRONT_W * torch.sum(d * d), FRONT_W * d
    return hook


# ---- timing and comparison --------------------------------------------------

def time_ms(torch, fn, reps=20):
    """Median device time of fn over reps, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def device_ms(torch, fn, reps=20):
    """Device time per call of fn, from torch.profiler over reps calls:
    for each kernel fn launches, the mean duration of its recorded
    launches times its launches per call.  The profiler loses some
    kernel events (on an H100 with torch 2.11: 1 of 20 in most profiles,
    up to 12 of 20 late in this script's run), so a plain sum over reps
    reads low; the per-call count is ceil(recorded / reps), right while
    fewer than reps launches of a kernel are lost.  A loss is printed.  A
    profile that records no device activity at all (seen once late in
    this script's run), or a kernel fewer than reps / 2 times (a loss
    the rule cannot repair: a kernel launched k times a call and
    recorded r < reps times counts ceil(r / reps) = 1, not k), is taken
    again; None if the second is no better."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(2):
        us = defaultdict(list)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in device_events(torch, prof):
            us[e.name].append(e.device_time)
        sparse = sorted(len(v) for v in us.values() if len(v) < reps / 2)
        if us and not sparse:
            break
        print("device_ms: the profile recorded "
              + (f"kernels fewer than {reps} / 2 times: {sparse}" if us
                 else "no device activity")
              + ("; taking it again" if attempt == 0 else ""))
    if sparse:
        return None
    lost = {n: len(v) for n, v in us.items() if len(v) % reps}
    if lost:
        print(f"device_ms: {len(lost)} of {len(us)} kernels recorded a "
              f"count that is not a multiple of {reps} calls: "
              f"{sorted(lost.values())}")
    total = sum(statistics.mean(v) * -(-len(v) // reps) for v in us.values())
    return total / 1e3 if us else None


def device_events(torch, prof):
    """The device work a finished torch.profiler run recorded: kernels,
    memcpys and memsets.  Left out are the GPU-side copies of the
    host's ``record_function`` ranges (the solver's phase ranges open
    while a profiler records): they span the kernels they hold, so
    counting them too counts those kernels twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)]


def busy_ms(events):
    """Device busy time of events: the length of the union of their
    intervals (kernels on two streams may overlap), ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, lo, hi = 0.0, None, None
    for s, e in spans:
        if hi is None or s > hi:
            if hi is not None:
                total += hi - lo
            lo, hi = s, e
        else:
            hi = max(hi, e)
    if hi is not None:
        total += hi - lo
    return total / 1e3


def profile_calls(torch, fn, reps):
    """torch.profiler over reps calls of fn: (top-level aten calls, device
    kernels, device busy ms, wall ms, the summed length of the ranges'
    GPU-side copies in ms), each per call; the wall is taken under the
    profiler, with synchronize.  Busy is the union of the device events'
    intervals (device_events, busy_ms)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    kern = device_events(torch, prof)
    spans = sum(e.time_range.elapsed_us() for e in events
                if e.device_type == cuda
                and getattr(e, "is_user_annotation", False)) / 1e3
    aten = [e for e in events if e.device_type != cuda
            and e.name.startswith("aten::")
            and (e.cpu_parent is None
                 or not e.cpu_parent.name.startswith("aten::"))]
    return (len(aten) / reps, len(kern) / reps, busy_ms(kern) / reps, wall,
            spans / reps)


def step_profile(torch, eng, probs, label, card, reps=5):
    """Print one step's host and device work: aten calls, device kernels,
    device busy time and the idle share of the step's wall; fails unless
    the idle share lies in [0, 1]."""
    state = [probs]

    def step():
        state[0], _ = eng.step_batched(state[0])

    calls, kern, busy, wall, spans = profile_calls(torch, step, reps)
    idle = 1.0 - busy / wall
    print(f"{label} step profile over {reps} steps: {calls:.0f} aten calls, "
          f"{kern:.0f} device kernels, device busy {busy:.4f} ms of a "
          f"{wall:.4f} ms wall (under the profiler), device idle "
          f"{idle:.4f} on {card}; left out: {spans:.4f} ms of phase ranges' "
          f"GPU-side copies")
    check(0.0 <= idle <= 1.0, f"{label} step profile: device idle {idle} "
          f"outside [0, 1]")


def kernels_per_call(torch, fn, reps=20):
    """Device kernels (memsets and copies too) that one call of fn
    launches, from the profiler over reps calls: for each name it
    recorded, ceil(recorded / reps), as device_ms counts them, since the
    profiler loses some events.  A profile with no device event at all
    (late in this script's run the profiler has recorded none in two
    profiles running) is taken again, up to PROFILE_TRIES in all."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = Counter(e.name for e in device_events(torch, prof))
        if names:
            break
        print("kernels_per_call: the profile recorded no device activity; "
              "taking it again")
    return sum(-(-c // reps) for c in names.values())


def host_syncs(torch, fn):
    """Every host synchronisation that fn makes, from torch.cuda's sync
    debug mode: the innermost frames (file:line function) of the Python
    stack at each, innermost first.  The port's sync counters
    (utils/profiling.py ``to_host`` and the like) only pass the call on,
    so the site is their caller's frame."""
    import traceback
    import warnings

    found = []
    counters = str(Path("or_cdchomp_tpu_torch", "utils", "profiling.py"))

    def hook(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack()[:-1]
                  if Path(f.filename).name != "warnings.py"
                  and not f.filename.endswith(counters)]
        # switching the mode itself is reported as one; it is not fn's
        if ("synchroniz" in str(message)
                and frames[-1].name != "set_sync_debug_mode"):
            found.append([f"{Path(f.filename).name}:{f.lineno} {f.name}"
                          for f in reversed(frames[-4:])])

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return found


def graph_ms(torch, fn, reps=20):
    """Device time per call of fn from CUDA events around the replay of
    one CUDA graph of reps calls, so no host work lies between its
    kernels; None if fn cannot be captured."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        print(f"graph_ms: capture failed: {e}")
        return None
    return time_ms(torch, g.replay, reps=5) / reps


def timings(torch, kernel, plain, plain_reps=20):
    """(kernel ms, plain ms) per call from CUDA events, and the same pair
    as device time: from the profiler, or where it records no device
    activity from a CUDA graph's replay (graph_ms); the plain version
    over ``plain_reps`` calls."""
    out = [time_ms(torch, kernel), time_ms(torch, plain, plain_reps)]
    for fn, reps in ((kernel, 20), (plain, plain_reps)):
        ms = device_ms(torch, fn, reps)
        if ms is None:
            ms = graph_ms(torch, fn)
            print(f"timings: device time from a CUDA graph's replay: {ms}")
        out.append(ms)
    return tuple(out)


def kernel_entry(name, source, replaces, err, t, nbytes, nflops,
                 flops_per_s=FP32_FLOPS_PER_S):
    """One kernel's entry of the JSON line.  ms / plain_ms: device time
    per call (timings; the CUDA-event time per call only where neither
    the profiler nor a graph capture gave one, which is printed);
    call_ms / plain_call_ms: CUDA-event time per call, host work of the
    wrapper included.  bound_ms: the larger of nbytes over the memory
    rate and nflops over ``flops_per_s`` (the fp32 rate; FP64_FLOPS_PER_S
    for a float64 kernel)."""
    if None in t[2:]:
        print(f"{name}: no device time; the CUDA-event time per call "
              f"stands in for it")
    ms = t[2] if t[2] is not None else t[0]
    plain_ms = t[3] if t[3] is not None else t[1]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nflops / flops_per_s * 1e3
    bound = max(by_bytes, by_ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_share=bound / ms, library_ms=None, call_ms=t[0],
                plain_call_ms=t[1], bytes=nbytes, flops=nflops)


def compare(torch, name, got, want, exact=False, rtol=KERNEL_RTOL):
    """max |got − want|; raises unless equal (exact) or within
    rtol, atol rtol·max|want|."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()) == bool(torch.isfinite(want).all()),
          f"{name}: non-finite values differ")
    err = float((got.double() - want.double()).abs().max())
    if exact:
        check(torch.equal(got, want), f"{name}: not bit-equal (max {err})")
        return err
    scale = float(want.double().abs().max())
    ok = torch.allclose(got.double(), want.double(), rtol=rtol,
                        atol=rtol * scale)
    check(bool(ok), f"{name}: max |err| {err} beyond rtol {rtol}, "
          f"atol {rtol}·{scale}")
    return err


def obstacle_args(engine, probs, x_mov, vel, acc):
    """K1's arguments on a path's own inputs."""
    fields = engine.fields
    return [x_mov, vel, acc, fields.data, fields.sizes, fields.lengths,
            probs.pose_gsdf_world, probs.pose_world_gsdf,
            probs.field_enabled, engine.radii_act, probs.epsilon,
            probs.obs_factor]


def check_obstacle(torch, sdf_lookup, oargs, label, hinge=True):
    """K1 against its plain version on both of its paths: the solve's
    (no one-sided choices out; queries certainly outside a field's box
    skip it) and want_dirs' (every field in full), each with bit-equal
    cost and gradient, the latter also with 100% one-sided-neighbour
    agreement; and (``hinge``) some cost.  Returns max_abs_err."""
    cost_k, grad_k, dirs_k = sdf_lookup.obstacle(*oargs, want_dirs=True)
    cost_m, grad_m = sdf_lookup.obstacle(*oargs)
    cost_r, grad_r, dirs_r = sdf_lookup.obstacle_ref(*oargs, want_dirs=True)
    # counted, not averaged: a float mean of 4.6e7 ones need not read 1
    n_diff = int((dirs_k != dirs_r).sum())
    agree = 1.0 - n_diff / dirs_r.numel()
    check(n_diff == 0, f"{label}: use_next differs on {n_diff} of "
          f"{dirs_r.numel()} queries")
    err = 0.0
    for path, cost, grad in (("solve path", cost_m, grad_m),
                             ("want_dirs path", cost_k, grad_k)):
        err = max(err, compare(torch, f"{label} {path} cost", cost, cost_r,
                               exact=True),
                  compare(torch, f"{label} {path} gradient", grad, grad_r,
                          exact=True))
    active = float((cost_r != 0.0).double().mean())
    check(active > 0.0 or not hinge, f"{label}: no active hinge")
    print(f"{label}: use_next agreement {agree:.6f}, solve and want_dirs "
          f"paths bit-equal, max_abs_err {err}, hinge active on "
          f"{active:.4f} of the queries")
    return err


def moved_in_args(torch, oargs, probs):
    """Config 2's K1 arguments with the sphere cloud moved into the three
    fields, a 1 m hinge width and field 0, 1 or 2 disabled in every
    fourth problem: on the path's own inputs the arm stays outside the
    field boxes and the hinge is idle, here every lookup, the min-select
    over the padded fields and field_enabled reach the cost."""
    x = oargs[0]
    wide = list(oargs)
    inside = torch.tensor([0.2, 0.2, 0.8], device=x.device).view(3, 1, 1, 1)
    wide[0] = (x - x.mean(dim=(1, 2, 3), keepdim=True) + inside).contiguous()
    wide[10] = torch.ones_like(probs.epsilon)
    enabled = probs.field_enabled.clone()
    for f in range(enabled.shape[1]):
        enabled[f + 1::4, f] = False
    wide[8] = enabled
    return wide


def k1_bytes(sdf_lookup, oargs):
    """K1's bytes on a call's own inputs: the field cells its in-box
    queries need (sdf_lookup.obstacle_cells), not the whole stack."""
    x, data = oargs[0], oargs[3]
    m, S, B = x.shape[1:]
    cells = sdf_lookup.obstacle_cells(x, data, oargs[4], oargs[5], oargs[6],
                                      oargs[8])
    return sdf_lookup.obstacle_traffic_bytes(m, S, B, *data.shape, cells,
                                             x.dtype.itemsize)


def k1_launch(torch, sdf_lookup, oargs, label):
    """Print K1's launch for these arguments: the wrapper's geometry and
    the path's registers, spills and resident blocks."""
    x, data = oargs[0], oargs[3]
    geom = sdf_lookup.device_geometry(*x.shape[1:], *data.shape,
                                      x.device.index, x.dtype)
    info = sdf_lookup.launch_info(geom.smem_bytes, x.dtype)
    print(f"{label} K1 launch: stack "
          f"{data.element_size() * data.numel()} B read through "
          f"__ldg, {geom.grid} blocks of {geom.threads} "
          f"threads, {geom.per} (tile, row) units each of {geom.units}, "
          f"{geom.smem_bytes} B dynamic shared memory per block, "
          f"{info['blocks_per_sm']} blocks per SM, {info['registers']} "
          f"registers, {info['local_bytes']} B local (spill) per thread")
    return geom, info


def time_obstacle(torch, sdf_lookup, oargs, label):
    t = timings(torch, lambda: sdf_lookup.obstacle(*oargs),
                lambda: sdf_lookup.obstacle_ref(*oargs))
    print(f"{label}: per call {t[0]:.4f} ms vs plain {t[1]:.4f} ms, "
          f"device {t[2]} ms vs plain {t[3]} ms")
    return t


def warm_walls(torch, fn, reps):
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def eager_iterate(torch, eng, probs, n, draw=None):
    """n eager step_batched calls (no CUDA graph): (probs, costs (B, n,
    3)), as iterate_batched returns them."""
    costs = []
    for _ in range(n):
        probs, c = eng.step_batched(probs, draw)
        costs.append(c)
    return probs, torch.stack(costs, dim=1)


# the kernels of a step, each by its wrapper's count and by a pattern of
# the name the profiler gives it, mangled or not (K2 has a staged and a
# tiled kernel; the layout kernel is not a step's)
STEP_KERNELS = (("obstacle", r"obstacle_kernel"),
                ("selfcol", r"selfcol(_tiled)?_kernel"),
                ("limits", r"limit_repair_kernel"),
                ("draw", r"hmc_draw_kernel"))
# those a CUDA graph of the step replays
REPLAYED_KERNELS = ("obstacle", "selfcol", "limits")


def wrapper_counts():
    """The step kernels' wrapper counts (a replay adds the launches its
    capture recorded; ops/kernels.py)."""
    from or_cdchomp_tpu_torch.ops import draw, limits, sdf_lookup, selfcol

    return {"obstacle": sdf_lookup.LAUNCHES, "selfcol": selfcol.LAUNCHES,
            "limits": limits.LAUNCHES, "draw": draw.LAUNCHES}


def launches_by_card(torch, fn, label):
    """The step kernels that fn() launches, measured: fn runs under
    torch.profiler and its device events are counted by kernel name and
    card; beside them, what the wrappers counted over the same call.
    Returns ({card index: {kernel: events}}, {kernel: wrapper count}).

    Held equal: the kernels of REPLAYED_KERNELS, whose wrapper counts a
    replay infers from its capture.  The draw runs eagerly before each
    replay and its wrapper counts each real launch; its events are
    returned, not held: on an H100 late in this script's run the profiler
    loses eager launches (device_ms), and it recorded 9 of a seeded
    batch's 10 draws in five profiles running, and again after a few
    warm-up kernels in each profile, while it recorded every replayed
    kernel.  A profile that records fewer replayed launches than the
    wrappers counted is taken again, up to PROFILE_TRIES in all."""
    import re
    from collections import Counter, defaultdict

    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        before = wrapper_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync_all(torch)
        counted = {k: v - before[k] for k, v in wrapper_counts().items()}
        cards = defaultdict(Counter)
        for e in device_events(torch, prof):
            for k, pattern in STEP_KERNELS:
                if re.search(pattern, e.name):
                    cards[e.device_index][k] += 1
        seen = sum(cards.values(), Counter())
        if all(seen[k] >= counted[k] for k in REPLAYED_KERNELS):
            break
        print(f"{label}: the profile recorded {dict(seen)} launches, the "
              f"wrappers counted {counted}; taking it again")
    check(all(seen[k] == counted[k] for k in REPLAYED_KERNELS),
          f"{label}: the profile recorded {dict(seen)} launches, the "
          f"wrappers counted {counted}")
    return ({i: {k: c.get(k, 0) for k, _ in STEP_KERNELS}
             for i, c in cards.items()}, counted)


STATE_LEAVES = ("traj", "AG", "iteration", "resample_iter", "leapfrog_first")


def graph_check(torch, label, eng, probs, card, reps=GRAPH_REPS):
    """A batch's replayed iterate(100) (ChompEngine.iterate_batched: one
    CUDA graph of the step, replayed) against 100 eager step_batched
    calls: every state leaf and cost bit-equal; no host sync in a
    replayed iterate(100); solves/s of each in turns (reps each, with
    the spread); aten calls, device kernels, busy and idle share per step
    of each, from the profiler over 10 steps.  Returns (solves/s
    replayed, solves/s eager)."""
    B = probs.traj.shape[0]
    t0 = time.perf_counter()
    want, wcosts = eager_iterate(torch, eng, probs, N_ITER)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    got, gcosts = eng.iterate_batched(probs, N_ITER)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"{label}: eager {N_ITER} steps {t1 - t0:.3f} s, replayed "
          f"iterate({N_ITER}) {t2 - t1:.3f} s (first call, its capture "
          f"included unless an earlier call captured it)")
    for k in STATE_LEAVES:
        a, b = getattr(got, k), getattr(want, k)
        check(torch.equal(a, b), f"{label}: replayed {k} differs from the "
              f"eager steps (max {float((a.double() - b.double()).abs().max())})")
    check(torch.equal(gcosts, wcosts), f"{label}: replayed costs differ "
          f"(max {float((gcosts - wcosts).abs().max())})")
    syncs = host_syncs(torch, lambda: eng.iterate_batched(probs, N_ITER))
    print(f"{label}: replayed iterate({N_ITER}) bit-equal to the eager "
          f"steps (state and costs); {len(syncs)} host syncs in a replayed "
          f"iterate({N_ITER}) at {sync_sites(syncs)}")
    check(not syncs, f"{label}: host syncs in a replayed iterate")
    walls = in_turns(torch, {
        "eager": lambda: eager_iterate(torch, eng, probs, N_ITER),
        "replayed": lambda: eng.iterate_batched(probs, N_ITER)}, reps)
    print_rates(walls, B, f"{label} {N_ITER} steps", card)
    for arm, fn in (("eager", lambda: eager_iterate(torch, eng, probs, 10)),
                    ("replayed", lambda: eng.iterate_batched(probs, 10))):
        calls, kern, busy, wall, _ = profile_calls(torch, fn, 2)
        print(f"{label} {arm} step (profiler, 2 x 10 steps): "
              f"{calls / 10:.1f} aten calls, {kern / 10:.1f} device kernels, "
              f"device busy {busy / 10:.4f} ms of a {wall / 10:.4f} ms wall, "
              f"device idle {1.0 - busy / wall:.4f} on {card}")
        check(kern > 0 and 0.0 <= 1.0 - busy / wall <= 1.0,
              f"{label} {arm}: {kern} device kernels, busy {busy} of {wall}")
    # the wrappers' counts of a replay are its capture's, added again: the
    # profiler's events show what each replay launched
    steps = PROBE_STEPS
    seeded = eng.spec.use_hmc and probs.hmc_seed is not None
    want = {"obstacle": steps, "selfcol": steps, "limits": steps,
            "draw": steps if seeded else 0}
    cards, counted = launches_by_card(
        torch, lambda: eng.iterate_batched(probs, steps),
        f"{label} replayed launches")
    seen = cards.get(probs.traj.device.index, {})
    print(f"{label}: a replayed iterate({steps}) launched {seen} on its "
          f"card (profiler events by kernel name; expected {want}, the "
          f"draw's eager launches not held), the wrappers counted "
          f"{counted}")
    check(len(cards) <= 1 and counted == want
          and all(seen.get(k, 0) == want[k] for k in REPLAYED_KERNELS),
          f"{label}: replayed launches {cards}, counted {counted}, "
          f"expected {want}")
    return tuple(B / statistics.median(walls[k])
                 for k in ("replayed", "eager"))


def pushed_out(torch, T, lo, hi, seed=5):
    """T (B, m, n) with rows pushed out of their finite limits (lo, hi
    (B, n)) as a step's update pushes them: in every row but each eighth,
    1–2 excursions of one joint past one of its limits, a triangle over
    3–15 consecutive points peaking 0.01–0.3 beyond it (seeded); a copy.
    (Independent entries past opposite limits of one joint at adjacent
    points make the repair run its 1,000 rounds and end on a chaotic
    path: the plain version in float32 and float64 then differ by O(1),
    so no kernel can be held to it there.)"""
    import numpy as np

    rng = np.random.default_rng(seed)
    B, m, n = T.shape
    lo_h, hi_h = lo.double().cpu().numpy(), hi.double().cpu().numpy()
    out = T.double().cpu().numpy().copy()
    for b in range(B):
        if b % 8 == 0:
            continue
        joints = [j for j in range(n)
                  if np.isfinite(lo_h[b, j]) and np.isfinite(hi_h[b, j])]
        for j in rng.choice(joints, size=min(1 + b % 2, len(joints)),
                            replace=False):
            w = int(rng.integers(3, 16))
            i0 = int(rng.integers(m))
            over = rng.uniform(0.01, 0.3)
            up = rng.random() < 0.5
            for i in range(max(0, i0 - w + 1), min(m, i0 + w)):
                dv = over * (1.0 - abs(i - i0) / w)
                if up:
                    out[b, i, j] = max(out[b, i, j], hi_h[b, j] + dv)
                else:
                    out[b, i, j] = min(out[b, i, j], lo_h[b, j] - dv)
    return torch.as_tensor(out, dtype=T.dtype, device=T.device)


def limits_entry(torch, name, T, lo, hi, metric, card, max_ill):
    """The limits kernel on T against its plain version on the card:
    every row but the plain version's ill-conditioned ones (at most
    ``max_ill``, counted, printed and kept in the entry) within rtol
    KERNEL_RTOL in float32, F64_KERNEL_RTOL in float64, with the plain
    version's rounds; two launches bit-equal; timed; its entry (launches
    unset)."""
    from or_cdchomp_tpu_torch.ops import limits

    f64 = T.dtype == torch.float64
    got, stats = limits.limit_repair(T, lo, hi, metric, want_stats=True)
    want, wstats = limits.limit_repair_ref(T, lo, hi, metric,
                                           want_stats=True)
    # Some rows are ill-conditioned: one that reaches the round cap has
    # bounced between two entries at opposite limits, an ulp or so out,
    # for most of its 1,000 rounds, and one with a long tail of rounds
    # (tens, at m = 999) amplifies each rounding.  Where such a row ends
    # depends on every rounding on the way, so no other sum order can be
    # held to the plain version's there: in float32 the plain version's
    # own float64 run strays from it too.  Which rows these are is read
    # from the plain version alone: those it leaves at the cap and, in
    # float32, those where it strays from its own float64 run beyond the
    # tolerance.  They are counted (at most max_ill, the count this
    # input has shown) and printed, each version's distance from the
    # float64 run beside the other's; every other row is held to the
    # tolerance and to the plain version's rounds.
    rtol = F64_KERNEL_RTOL if f64 else KERNEL_RTOL
    cap = limits._MAX_LIMIT_FIXES
    ill = wstats[:, 0] >= cap
    want64 = want.double()
    if not f64:
        metric64 = (metric.double() if isinstance(metric, torch.Tensor)
                    else metric)
        want64 = limits.limit_repair_ref(T.double(), lo.double(),
                                         hi.double(), metric64)
        scale = float(want64.abs().max())
        ill |= ((want.double() - want64).abs().amax(dim=(1, 2))
                > rtol * scale)
    n_ill = int(ill.sum())
    check(n_ill <= max_ill, f"{name}: {n_ill} rows ill-conditioned in the "
          f"plain version, expected at most {max_ill}")
    err = compare(torch, name, got[~ill], want[~ill], rtol=rtol)
    other = int((stats[~ill, 0] != wstats[~ill, 0]).sum())
    check(other == 0, f"{name}: {other} of the compared rows took other "
          f"rounds than the plain version")
    ill_err = [0.0, 0.0]
    if n_ill:
        ill_err = [float((x[ill].double() - want64[ill]).abs().max())
                   for x in (got, want)]
    check(torch.equal(limits.limit_repair(T, lo, hi, metric), got),
          f"{name}: two launches differ")
    # the plain version syncs once a round, up to 1,000 rounds a call
    t = timings(torch, lambda: limits.limit_repair(T, lo, hi, metric),
                lambda: limits.limit_repair_ref(T, lo, hi, metric), 5)
    B, m, n = T.shape
    rounds = stats[:, 0].cpu()
    # no PyTorch call computes the repair (a data-dependent loop of an
    # argmax, a sparse A⁻¹ product and an update per problem)
    entry = kernel_entry(
        name, "or_cdchomp_tpu_torch/csrc/limits.cu",
        "or_cdchomp_tpu/chomp/solver.py:400", err, t,
        limits.traffic_bytes(B, m, n, T.element_size()),
        limits.flops(m, n, stats.cpu()),
        FP64_FLOPS_PER_S if f64 else FP32_FLOPS_PER_S)
    entry["ill_conditioned_rows"] = n_ill
    print(f"{name} (B={B}, m={m}, n={n}, "
          f"{'dense' if isinstance(metric, torch.Tensor) else 'sep'}): "
          f"max_abs_err {err} over the well-conditioned rows, each with "
          f"the plain version's rounds; {n_ill} ill-conditioned rows (at "
          f"most {max_ill}; rounds {stats[ill, 0].tolist()}, the plain "
          f"version's {wstats[ill, 0].tolist()}), max |Δ| from the plain "
          f"version's float64 run there: kernel {ill_err[0]}, plain "
          f"{ill_err[1]}; rounds per problem {int(rounds.min())}-"
          f"{int(rounds.max())} (sum {int(rounds.sum())}; the plain "
          f"version's sum {int(wstats[:, 0].sum())}); per call "
          f"{t[0]:.4f} ms vs plain {t[1]:.4f} ms; "
          f"device {entry['ms']} ms vs plain {entry['plain_ms']} ms, bound "
          f"{entry['bound_ms']} ms ({entry['bound_by']}), share "
          f"{entry['bound_share']:.4f} on {card}")
    return entry


def fk_args(traj, base=None):
    """fk_soa's inputs as the port builds them: qT a permuted view of traj
    (B, n_points, n); the base the components of ``base`` ((B, 7) per
    problem, (7,) one pose for all) or, without it, each point's first 7
    columns (the floating base)."""
    Tt = traj.permute(1, 2, 0)
    if base is None:
        return (Tt[:, 7:], tuple(Tt[:, i] for i in range(3)),
                tuple(Tt[:, i] for i in range(3, 7)))
    comps = base.unbind(-1)
    return Tt, comps[:3], comps[3:]


def fk_check(torch, name, fk, traj, base):
    """The FK kernel on fk_args(traj, base) against its plain version:
    every output within KERNEL_RTOL (F64_KERNEL_RTOL in float64) of the
    plain version's; one launch, counted by the caller.  Returns the
    largest error."""
    args = fk_args(traj, base)
    got = fk.fk_soa(*args)
    want = fk.fk_soa_plain(*args)
    rtol = F64_KERNEL_RTOL if fk.dtype == torch.float64 else KERNEL_RTOL
    return max(compare(torch, f"{name} {f}", g, w, rtol=rtol)
               for f, g, w in zip(("x", "anch_pos", "anch_q", "axis_w",
                                   "red_pos", "red_q"), got, want))


def fk_entry(torch, name, fk, traj, base, card):
    """fk_check, checked to launch the kernel once; both versions timed
    with traj and base cold (each call a copy from cold_ring); its entry,
    whose launches the caller sets from a counted run of the kernel's
    path."""
    from or_cdchomp_tpu_torch.ops import fk as fk_kernel

    f64 = fk.dtype == torch.float64
    rtol = F64_KERNEL_RTOL if f64 else KERNEL_RTOL
    fk_kernel.FK_LAUNCHES = 0
    err = fk_check(torch, name, fk, traj, base)
    check(fk_kernel.FK_LAUNCHES == 1,
          f"{name}: {fk_kernel.FK_LAUNCHES} launches for one call")
    args = fk_args(traj, base)
    cold = cold_ring((traj,) if base is None else (traj, base))
    t = timings(torch, lambda: fk.fk_soa(*fk_args(*cold())),
                lambda: fk.fk_soa_plain(*fk_args(*cold())), 5)
    del cold
    P, D, B = args[0].shape
    S = len(fk.sphere_subset)
    n_base = P * B if base is None else base.numel() // 7
    # no PyTorch call computes the chain: the plain version is ~650
    # elementwise calls
    entry = kernel_entry(
        name, "or_cdchomp_tpu_torch/csrc/fk.cu",
        "none (or_cdchomp_tpu/models/robot.py fk_soa is plain jnp)", err, t,
        fk_kernel.traffic_bytes(P, B, D, S, n_base, traj.element_size()),
        fk_kernel.flops(fk.fk_table, D, S, P, B),
        FP64_FLOPS_PER_S if f64 else FP32_FLOPS_PER_S)
    print(f"{name} ({fk.dtype}, n_points={P}, B={B}, D={D}, S={S}, "
          f"{'floating' if base is None else 'fixed'} base): max_abs_err "
          f"{err} (rtol {rtol}); inputs cold, per call {t[0]:.4f} ms vs "
          f"plain {t[1]:.4f} ms; device {entry['ms']} ms vs plain "
          f"{entry['plain_ms']} ms, bound {entry['bound_ms']} ms "
          f"({entry['bound_by']}, {entry['bytes']} B), share "
          f"{entry['bound_share']:.4f} on {card}")
    return entry


def fk_phase(torch, pt, card, mod, run, probs):
    """The FK kernel (csrc/fk.cu) at the main path's shapes: config 1's
    B = 256 and config 5's B = 10,240 (101 points, fixed base, float32),
    and the float64 trajectory check of a B = 1 gettraj (one pose for the
    base; its samples from the check); returns their entries.  The
    floating base (config 4's shape) is config4_phase's, and fk_main's."""
    import numpy as np

    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    engine = run.engine
    entries = [fk_entry(torch, "fk_soa", engine.fk, probs.traj,
                        probs.robot_pose, card)]
    starts5, goals5 = bench_endpoints(BATCH_POD)
    probs5 = problem_batch_from_grid(run.problem, starts5, goals5, engine)
    entries.append(fk_entry(torch, "fk_soa_b10240", engine.fk, probs5.traj,
                            probs5.robot_pose, card))
    del probs5
    h = next(h for h, r in mod.runs.items() if r is run)
    mod.gettraj(run=h, no_collision_exception=True)
    T_s = mod.last_check["samples"]
    model = run.fk.model
    rng = np.random.default_rng(19)
    q = rng.uniform(np.maximum(model.dof_limits_lower, -3.0),
                    np.minimum(model.dof_limits_upper, 3.0),
                    size=(1, T_s, model.n_dof))
    f64 = dict(dtype=torch.float64, device=run.fk.device)
    entries.append(fk_entry(
        torch, "fk_soa_check_f64", run.fk, torch.as_tensor(q, **f64),
        torch.as_tensor(run.robot.pose, **f64), card))
    return entries


def jtmap_inputs(torch, engine, probs):
    """The Jᵀ map's inputs on a batch's own step: (anchors, axes, x_mov,
    w_obs, w_self) as total_cost_grad_batched hands them over (the
    anchors and axes views of the FK's outputs), and the FK's whole
    anchor and axis outputs they are views of."""
    from or_cdchomp_tpu_torch.chomp import cost_soa

    spec = engine.spec
    fk_out, x_mov, vel, acc = cost_soa.sphere_kinematics(spec, engine.fk,
                                                         probs)
    _, w_obs = cost_soa._obstacle_soa(engine.fields, engine.radii_act,
                                      probs, x_mov, vel, acc)
    _, w_self = cost_soa._selfcol_soa((*engine.pairs, engine.pair_layout),
                                      probs, x_mov, vel)
    torch.cuda.synchronize()
    return x_mov, w_obs, w_self, fk_out.anch_pos, fk_out.axis_w


def jtmap_views(spec, x_mov, w_obs, w_self, anch, axes):
    """jtmap's (anchors, axes, x, w_obs, w_self) from the whole FK
    outputs: the moving points' views, as the step takes them."""
    from or_cdchomp_tpu_torch.chomp.cost_soa import mov_lo

    lo, m = mov_lo(spec), spec.m
    return (anch[:, lo:lo + m], axes[:, lo:lo + m], x_mov, w_obs, w_self)


def jtmap_entry(torch, name, engine, probs, card):
    """The Jᵀ map kernel (csrc/jtmap.cu) on a batch's own step inputs:
    against its plain version reading the same table (jtmap_table_ref)
    and against the step's plain phase (cost_soa._jacT_plain, the
    parent's code), one launch a call; both timed with the inputs cold
    (each call a copy from cold_ring); its entry, beside its byte bound."""
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import jtmap

    spec, fk = engine.spec, engine.fk
    f64 = fk.dtype == torch.float64
    rtol = F64_KERNEL_RTOL if f64 else KERNEL_RTOL
    totals = spec.floating_base
    whole = jtmap_inputs(torch, engine, probs)
    args = jtmap_views(spec, *whole)
    jtmap.JT_LAUNCHES = 0
    G, tot = jtmap.jtmap(fk.jt_table, fk.n_dof, *args, totals=totals)
    torch.cuda.synchronize()
    check(jtmap.JT_LAUNCHES == 1,
          f"{name}: {jtmap.JT_LAUNCHES} launches for one call")
    G_ref, tot_ref = jtmap.jtmap_table_ref(fk.jt_table, fk.n_dof, *args,
                                           totals=totals)
    G_pl, tot_pl = cost_soa._jacT_plain(fk, *args, totals)
    err_ref = compare(torch, f"{name} G vs table walk", G, G_ref, rtol=rtol)
    err = compare(torch, f"{name} G vs plain phase", G, G_pl, rtol=rtol)
    if totals:
        err_ref = max(err_ref, compare(torch, f"{name} totals vs table walk",
                                       tot, tot_ref, rtol=rtol))
        err = max(err, compare(torch, f"{name} totals vs plain phase", tot,
                               tot_pl, rtol=rtol))
    same = torch.equal(G, G_ref) and (not totals or torch.equal(tot,
                                                                 tot_ref))
    del G, tot, G_ref, tot_ref, G_pl, tot_pl
    cold = cold_ring(whole)
    t = timings(torch,
                lambda: jtmap.jtmap(fk.jt_table, fk.n_dof,
                                    *jtmap_views(spec, *cold()),
                                    totals=totals),
                lambda: cost_soa._jacT_plain(
                    fk, *jtmap_views(spec, *cold()), totals), 5)
    del cold
    _, m, S, B = args[2].shape
    D = fk.n_dof
    # the plain phase is ~34 aten passes; no one PyTorch call computes it
    entry = kernel_entry(
        name, "or_cdchomp_tpu_torch/csrc/jtmap.cu",
        "none (or_cdchomp_tpu/models/robot.py apply_sphere_jacT_soa is "
        "plain jnp)", err, t,
        jtmap.traffic_bytes(m, S, D, B, args[2].element_size(), totals),
        jtmap.flops(fk.jt_table, D, m, B, totals),
        FP64_FLOPS_PER_S if f64 else FP32_FLOPS_PER_S)
    print(f"{name} ({fk.dtype}, m={m}, B={B}, D={D}, S={S}, totals "
          f"{totals}): max_abs_err {err} vs the plain phase (rtol {rtol}), "
          f"{err_ref} vs the table walk (bit-equal {same}); inputs cold, "
          f"per call {t[0]:.4f} ms vs plain {t[1]:.4f} ms; device "
          f"{entry['ms']} ms vs plain {entry['plain_ms']} ms, bound "
          f"{entry['bound_ms']} ms ({entry['bound_by']}, {entry['bytes']} "
          f"B), share {entry['bound_share']:.4f} on {card}")
    return entry


def jtmap_phase(torch, pt, card, run, probs):
    """The Jᵀ map kernel at the main path's shapes: config 1's B = 256
    and config 5's B = 10,240 (99 moving points, 15 active spheres,
    float32); returns their entries.  Config 4's floating base, the
    tray's 125 active spheres and float64 are jtmap_main's."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    engine = run.engine
    entries = [jtmap_entry(torch, "jtmap", engine, probs, card)]
    starts5, goals5 = bench_endpoints(BATCH_POD)
    probs5 = problem_batch_from_grid(run.problem, starts5, goals5, engine)
    entries.append(jtmap_entry(torch, "jtmap_b10240", engine, probs5, card))
    return entries


def counts_zero(sdf_lookup, selfcol, draw=None):
    from or_cdchomp_tpu_torch.ops import fk, jtmap, limits

    sdf_lookup.LAUNCHES = 0
    selfcol.LAUNCHES = 0
    fk.FK_LAUNCHES = 0
    jtmap.JT_LAUNCHES = 0
    limits.LAUNCHES = 0
    if draw is not None:
        draw.LAUNCHES = 0


def counts(sdf_lookup, selfcol):
    from or_cdchomp_tpu_torch.ops import fk

    return {"obstacle": sdf_lookup.LAUNCHES, "selfcol": selfcol.LAUNCHES,
            "fk_soa": fk.FK_LAUNCHES}


def check_launches(got, want, label, steps=None, fk=None):
    """K1, K2 and the FK kernel launched ``want`` times each (a cost pass
    launches each once), the FK kernel ``fk`` times where given (the FK
    also runs without K1 and K2: constraint values, the trajectory
    check); with ``steps``, the limits kernel once a step (counted since
    counts_zero)."""
    from or_cdchomp_tpu_torch.ops import limits

    for k, v in got.items():
        w = fk if k == "fk_soa" and fk is not None else want
        check(v == w, f"{label}: {k} launched {v} times, expected {w}")
    if steps is not None:
        check(limits.LAUNCHES == steps, f"{label}: the limits kernel "
              f"launched {limits.LAUNCHES} times, expected {steps}")


def max_dtraj(out, ref):
    return float((out.traj[:N_CHECK].double().cpu() - ref.traj).abs().max())


def time_projection(torch, constraints, eng, probs, fk_out, card):
    """The projection of config 4's batch with the dense Cholesky and with
    the quasiseparable scan: per-call time (CUDA events, host work
    included) and device time (profiler), their agreement, and the solve
    the rule takes at this shape."""
    spec, cons = eng.spec, eng.cons
    val, jac = constraints.eval_tsr_all_soa(spec, eng.fk, probs, probs.traj,
                                            cons, fk_out)
    m = spec.m
    AG = probs.AG + 1e-3            # a small update in every row

    def project():
        return constraints.project_constraints(
            spec, cons, eng.proj_ops, probs.lambda_, AG,
            probs.traj[:, 1:1 + m], val, jac)

    def forced(limit):
        def fn():
            saved = constraints._DENSE_MAX_ELEMS
            constraints._DENSE_MAX_ELEMS = limit
            try:
                return project()
            finally:
                constraints._DENSE_MAX_ELEMS = saved
        return fn

    dense, sss = forced(1 << 62), forced(0)
    for name, fn, reps in (
            ("evaluation", lambda: constraints.eval_tsr_all_soa(
                spec, eng.fk, probs, probs.traj, cons, fk_out), 20),
            ("dense projection", dense, 20), ("sss projection", sss, 3)):
        calls, kern, busy, wall, _ = profile_calls(torch, fn, reps)
        print(f"config 4 TSR {name}: {calls:.0f} aten calls, {kern:.0f} "
              f"device kernels, device busy {busy:.4f} ms, wall {wall:.4f} "
              f"ms per call (under the profiler)")
    got_d, got_s = dense(), sss()
    check(bool(torch.isfinite(got_d).all() and torch.isfinite(got_s).all()),
          "config 4: non-finite projection")
    diff = float((got_d - got_s).abs().max())
    scale = float(got_s.abs().max())
    t_d = (time_ms(torch, dense), device_ms(torch, dense))
    t_s = (time_ms(torch, sss, reps=5), device_ms(torch, sss, reps=5))
    C, k = cons.n_constraints, sum(cons.enabled[0])
    rule = "sss" if constraints.use_sss(spec, cons, probs.traj.shape[0]) \
        else "dense"
    print(f"config 4 projection (B={probs.traj.shape[0]}, C={C}, k={k}, "
          f"system {C * k}x{C * k}): dense per call {t_d[0]:.4f} ms, device "
          f"{t_d[1]} ms; sss per call {t_s[0]:.4f} ms, device {t_s[1]} ms; "
          f"max |dense - sss| {diff} of max |correction| {scale}; the rule "
          f"takes {rule} on {card}")


def config4_phase(torch, pt, card, dev):
    """Config 4 on the card: the kernels on its inputs (the FK kernel
    with each point's floating base), the projection solves, iterate(100)
    with the final cost report and its launches, the constraint residual
    and the warm wall.  Returns (output problems, starts, goals, [K1
    entry, K2 entry, FK entry])."""
    from or_cdchomp_tpu_torch.chomp import constraints, cost_soa
    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    t0 = time.perf_counter()
    run = config4_run(pt, torch.float32, dev)
    eng = run.engine
    starts, goals = run_endpoints(run, BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    torch.cuda.synchronize()
    spec, cons = eng.spec, eng.cons
    print(f"config 4 setup (SDF build + cache write, create, batch): "
          f"{time.perf_counter() - t0:.2f} s; field stack "
          f"{tuple(eng.fields.data.shape)}, n = {spec.n}, m = {spec.m}, "
          f"{cons.n_constraints} constraints of {cons.k_total} rows")
    check(spec.floating_base and spec.n == 14
          and spec.m == CONFIG4_POINTS - 2, f"config 4 spec {spec}")
    check(cons.n_constraints == spec.m and cons.k_total == 2 * spec.m,
          f"config 4 constraints {cons.n_constraints}, {cons.k_total}")

    fk_out, x, vel, acc = cost_soa.sphere_kinematics(spec, eng.fk, probs)
    m, S, B = x.shape[1:]
    check((m, S, B) == (spec.m, 16, BATCH), f"config 4 spheres {(m, S, B)}")
    fk4 = fk_entry(torch, "fk_soa_config4", eng.fk, probs.traj, None, card)
    oargs = obstacle_args(eng, probs, x, vel, acc)
    k1_launch(torch, sdf_lookup, oargs, "config 4")
    err = check_obstacle(torch, sdf_lookup, oargs, "config 4 obstacle",
                         hinge=False)
    t = time_obstacle(torch, sdf_lookup, oargs, "config 4 obstacle")
    F, mx, my, mz = eng.fields.data.shape
    k1 = kernel_entry(
        "obstacle_config4", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs),
        sdf_lookup.obstacle_flops(m, S, B, F))

    # a floating base moves every sphere: K2 with no inactive one
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    check(tuple(xo.shape) == (3, 0, BATCH), f"config 4 xo {tuple(xo.shape)}")
    sargs = (x, vel, xo, *eng.pairs, probs.epsilon_self,
             probs.obs_factor_self)
    P = eng.pairs[0].shape[0]
    info = selfcol.launch_info(S, 0)
    votes, near, taken, reach = selfcol.vote_stats(
        x, xo, *eng.pairs, probs.epsilon_self)
    print(f"config 4 selfcol (Sa = {S}, SI = 0, {P} pairs): "
          f"{info['threads']} threads, {info['smem_bytes']} B shared memory "
          f"per block, {info['blocks_per_sm']} blocks per SM; warp vote skips "
          f"{(votes - taken) / votes:.4f}; {reach} of {m * P * B} in reach")
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    err = max(compare(torch, "config 4 selfcol net", net_k, net_r),
              compare(torch, "config 4 selfcol cost", c_k, c_r))
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"config 4 selfcol: max_abs_err {err}, per call {t[0]:.4f} ms vs "
          f"plain {t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms")
    k2 = kernel_entry(
        "selfcol_config4", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, S, 0, B, P), selfcol.flops(m, B, P, reach))
    for r in (k1, k2):
        print(f"{r['name']}: device {r['ms']} ms, bound {r['bound_ms']} ms "
              f"({r['bound_by']}), share {r['bound_share']:.4f} on {card}")

    time_projection(torch, constraints, eng, probs, fk_out, card)
    step_profile(torch, eng, probs, "config 4", card)
    # the limits kernel loops on the card: the step makes no host sync
    syncs = host_syncs(torch, lambda: eng.step_batched(probs))
    print(f"config 4 step: {len(syncs)} host syncs, at {syncs}")
    check(not syncs, "config 4: a host sync in the step")
    res0 = float(eng.constraint_values(probs).abs().max())

    counts_zero(sdf_lookup, selfcol)
    solver = BatchSolver(eng)
    t0 = time.perf_counter()
    out, costs = solver.iterate(probs, N_ITER)
    fin = torch.stack(eng.final_costs_batch(out), dim=-1)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    print(f"config 4: iterate({N_ITER}) + final costs at B={BATCH} in "
          f"{first_wall:.3f} s (first call), launches {launches} "
          f"(expected {N_ITER} + 1 each)")
    check_launches(launches, N_ITER + 1, "config 4",
                   steps=N_ITER)
    k1["launches"], k2["launches"] = launches["obstacle"], launches["selfcol"]
    fk4["launches"] = launches["fk_soa"]
    check(tuple(costs.shape) == (N_ITER, BATCH, 3)
          and tuple(out.traj.shape) == (BATCH, CONFIG4_POINTS, 14),
          f"config 4: costs {tuple(costs.shape)}, traj {tuple(out.traj.shape)}")
    check(bool(torch.isfinite(costs).all() and torch.isfinite(fin).all()
               and torch.isfinite(out.traj).all()),
          "config 4: non-finite costs or trajectories")
    qerr = float((out.traj[..., 3:7].norm(dim=-1) - 1.0).abs().max())
    check(qerr <= 1e-5, f"config 4: base quaternion norm off by {qerr}")
    res1 = float(eng.constraint_values(out).abs().max())
    print(f"config 4 mean (total, obstacle + self, smoothness) cost: first "
          f"iteration {costs[0].mean(0).tolist()}, final report "
          f"{fin.mean(0).tolist()}")
    print(f"config 4 constraint residual (max |roll|, |pitch| of the end "
          f"effector over the batch): start {res0}, end {res1}; base "
          f"quaternion norms within {qerr} of 1")
    check(res1 < res0, "config 4: the constraint residual did not fall")

    wall, walls = warm_walls(torch, lambda: solver.iterate(probs, N_ITER),
                             WARM_REPS)
    print(f"config 4 iterate({N_ITER}) at B={BATCH}: median warm wall {wall} "
          f"s of {walls}, {BATCH / wall} solves/s on {card}")
    graph_check(torch, "config 4", eng, probs, card)
    return out, starts, goals, [k1, k2, fk4]


def sync_sites(syncs):
    """{innermost frame: count} of host_syncs' list."""
    sites = {}
    for st in syncs:
        sites[st[0]] = sites.get(st[0], 0) + 1
    return sites


def check_flags(label, got, want):
    """Fails, printing the problems, unless two arrays of collision
    verdicts agree."""
    import numpy as np

    bad = np.nonzero(got != want)[0]
    if len(bad):
        print(f"{label}: verdicts differ at problems {bad.tolist()} (card "
              f"{got[bad].tolist()}, CPU float64 {want[bad].tolist()})")
    check(len(bad) == 0, f"{label}: {len(bad)} verdicts differ from the CPU")


def module_phase(torch, pt, card, dev, out1, out5):
    """The module commands on config 1's world on the card: runchomp at
    full width against the CPU float64 runchomp and against row 0 of a
    B = 256 batch with the same endpoints, the B = 1 latency of create +
    iterate(100) with its host syncs and launches, gettraj's wall, a
    colliding straight line, gettraj_batch on config 1's and config 5's
    solved batches against CPU float64 checks, the field commands, and
    K1 through a forced split.  Returns K1's split entry and the FK
    kernel's launches over the counted gettraj calls (the float64
    check's)."""
    import numpy as np

    from or_cdchomp_tpu_torch.chomp import solver as solver_mod
    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    f32, f64, cpu = torch.float32, torch.float64, "cpu"
    mod, _ = bench_module(pt, f32, dev)
    kw = run_kw()

    # -- runchomp at full width, strict collision check -----------------------
    t0 = time.perf_counter()
    traj = mod.runchomp(n_iter=N_ITER, **kw)
    torch.cuda.synchronize()
    print(f"module runchomp (n_points {N_POINTS}, {N_ITER} iterations, "
          f"strict check): {time.perf_counter() - t0:.3f} s (first call), "
          f"duration {traj.duration:.6f}, in collision {traj.in_collision}")
    check(isinstance(traj, pt.api.Trajectory) and not traj.in_collision
          and traj.positions.shape == (N_POINTS, 7)
          and np.isfinite(traj.positions).all(), "runchomp trajectory")

    # -- B = 1 latency: create + iterate(100), warm ---------------------------
    def create_iterate(walls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = mod.create(**kw)
        t1 = time.perf_counter()
        mod.iterate(run=h, n_iter=N_ITER)
        torch.cuda.synchronize()
        walls.append((t1 - t0, time.perf_counter() - t1))
        return h

    mod.destroy(run=create_iterate([]))                  # warm-up
    walls = []
    for _ in range(LATENCY_REPS):
        mod.destroy(run=create_iterate(walls))
    tot = [a + b for a, b in walls]
    print(f"B=1 create + iterate({N_ITER}): median warm wall "
          f"{statistics.median(tot)} s of {tot} (create "
          f"{[a for a, _ in walls]} s, iterate {[b for _, b in walls]} s) "
          f"on {card}")
    counts_zero(sdf_lookup, selfcol)
    h = create_iterate([])
    launches = counts(sdf_lookup, selfcol)
    print(f"B=1 create + iterate({N_ITER}): launches {launches} (expected "
          f"{N_ITER} + 1 each, the final cost report's)")
    check_launches(launches, N_ITER + 1, "B=1 iterate",
                   steps=N_ITER)
    steps = solver_mod.ChompEngine.ITER_CHUNK
    syncs = host_syncs(torch, lambda: mod.iterate(run=h, n_iter=steps))
    print(f"B=1 iterate({steps}): {len(syncs)} host syncs "
          f"({len(syncs) / steps:.4f} per step) at {sync_sites(syncs)}")
    check(all(" iterate" in st[0] for st in syncs),
          "B=1 iterate: a host sync outside the cost reads")
    t_get = []
    counts_zero(sdf_lookup, selfcol)
    for _ in range(LATENCY_REPS + 1):
        t0 = time.perf_counter()
        mod.gettraj(run=h)
        t_get.append(time.perf_counter() - t0)
    launches = counts(sdf_lookup, selfcol)
    print(f"B=1 gettraj with its collision check "
          f"({mod.last_check['samples']} samples of "
          f"{mod.last_check['spheres']} spheres): warm walls {t_get[1:]} s "
          f"on {card}, launches {launches} over {LATENCY_REPS + 1} calls "
          f"(the float64 check's FK once each)")
    check_launches(launches, 0, "B=1 gettraj", fk=LATENCY_REPS + 1)
    f64_check_launches = launches["fk_soa"]
    mod.destroy(run=h)

    # -- the same problem as row 0 of a B = 256 batch -------------------------
    run = mod.runs[mod.create(**kw)]
    same = problem_batch_from_grid(
        run.problem, np.tile(START, (BATCH, 1)), np.tile(GOAL, (BATCH, 1)),
        run.engine)
    outb, _ = BatchSolver(run.engine).iterate(same, N_ITER)
    d_batch = float(np.abs(outb.traj[0].double().cpu().numpy()
                           - traj.positions).max())
    print(f"runchomp against row 0 of a B={BATCH} batch of the same "
          f"problem: max |Δtraj| {d_batch} (bar {TRAJ_BAR})")
    check(d_batch <= TRAJ_BAR, f"runchomp vs batch row 0: {d_batch}")

    # -- a straight line through the table, no iterations ---------------------
    hc = mod.create(**run_kw(THROUGH_TABLE))
    try:
        mod.gettraj(run=hc, no_collision_details=True)
        check(False, "the colliding line raised nothing")
    except RuntimeError as e:
        check(str(e) == "Resulting trajectory is in collision!",
              f"colliding line: {e}")
    coll = mod.gettraj(run=hc, no_collision_exception=True)
    check(coll.in_collision, "colliding line: in_collision not set")
    card_traj = mod.runs[hc].problem.traj

    # -- gettraj_batch on config 1's and config 5's solved batches ------------
    hb = next(iter(mod.runs))
    flags = {}
    for label, probs in (("config 1", out1), ("config 5", out5)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_mem = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        trajs, fl = mod.gettraj_batch(run=hb, probs=probs)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base_mem
        B = probs.traj.shape[0]
        flags[label] = fl
        print(f"gettraj_batch {label} (B={B}): {int(fl.sum())} of {B} in "
              f"collision, {mod.last_check['samples']} samples of "
              f"{mod.last_check['spheres']} spheres, chunk "
              f"{mod.last_check['chunk']} problems, wall {wall} s "
              f"({B / wall} checks/s), peak device memory {peak} B above "
              f"the {base_mem} B in use, on {card}")
        check(len(trajs) == B, f"gettraj_batch {label}: {len(trajs)} trajs")

    # -- the CPU float64 side of the comparisons ------------------------------
    mod64, _ = bench_module(pt, f64, cpu)
    t0 = time.perf_counter()
    traj64 = mod64.runchomp(n_iter=N_ITER, **kw)
    d_cpu = float(np.abs(traj.positions - traj64.positions).max())
    print(f"runchomp against the CPU float64 runchomp: max |Δtraj| {d_cpu} "
          f"(bar {TRAJ_BAR}), {time.perf_counter() - t0:.2f} s")
    check(d_cpu <= TRAJ_BAR, f"runchomp vs CPU float64: {d_cpu}")
    h64 = mod64.create(**run_kw(THROUGH_TABLE))
    rn64 = mod64.runs[h64]
    rn64.problem = rn64.problem.replace(traj=card_traj.cpu().double())
    coll64 = mod64.gettraj(run=h64, no_collision_exception=True)
    print(f"colliding line: the card's gettraj raised the reference's "
          f"message, in_collision {coll.in_collision}; CPU float64 check "
          f"in_collision {coll64.in_collision}")
    check(coll64.in_collision == coll.in_collision,
          "colliding line: the CPU verdict differs")
    t0 = time.perf_counter()
    for label, probs, n in (("config 1", out1, BATCH),
                            ("config 5", out5, N_CHECK_POD)):
        _, fl64 = mod64.gettraj_batch(run=h64, probs=head(probs, n))
        check_flags(f"gettraj_batch {label}", flags[label][:n], fl64)
        print(f"gettraj_batch {label}: the first {n} flags equal the CPU "
              f"float64 check's ({int(fl64.sum())} in collision)")
    print(f"CPU float64 checks: {time.perf_counter() - t0:.2f} s")

    # -- addfield_fromobsarray → viewfields → removefield on the card ---------
    rng = np.random.default_rng(3)
    occ = (rng.uniform(size=(8, 9, 7)) < 0.15).astype(np.uint8)
    field = dict(kinbody="mug", obsarray=occ, lengths=(0.4, 0.45, 0.35),
                 pose=[0.5, -0.6, 0.2, 0.0, 0.0, 0.38268343, 0.92387953])
    views = []
    for m_ in (mod, mod64):
        check(m_.addfield_fromobsarray(**field) == "", "addfield")
        views.append(m_.viewfields()["mug"])
        check(m_.removefield(kinbody="mug") == "" and
              "mug" not in m_.viewfields(), "removefield")
    check(mod.sdfs[-1].kinbody_name == "table", "field registry")
    d_view = float(np.abs(views[0] - views[1]).max())
    print(f"addfield_fromobsarray → viewfields → removefield on the card: "
          f"{len(views[0])} occupied cells, max |Δ| against the CPU "
          f"{d_view}")
    check(views[0].shape == views[1].shape and d_view <= 1e-5,
          "viewfields differ from the CPU")

    # -- K1 through a forced split, on the main path's cost report ------------
    eng = run.engine
    m, S = eng.spec.m, eng.n_spheres_active
    saved = sdf_lookup.MAX_QUERIES
    sdf_lookup.MAX_QUERIES = m * S * 100         # 256 problems: 100, 100, 56
    try:
        counts_zero(sdf_lookup, selfcol)
        split_fin = torch.stack(eng.final_costs_batch(out1))
        split_launches = counts(sdf_lookup, selfcol)["obstacle"]
        from or_cdchomp_tpu_torch.chomp import cost_soa
        _, x, v, a = cost_soa.sphere_kinematics(eng.spec, eng.fk, out1)
        oargs = obstacle_args(eng, out1, x, v, a)
        split = sdf_lookup.obstacle(*oargs)
        t = timings(torch, lambda: sdf_lookup.obstacle(*oargs),
                    lambda: sdf_lookup.obstacle_ref(*oargs))
    finally:
        sdf_lookup.MAX_QUERIES = saved
    whole = sdf_lookup.obstacle(*oargs)
    whole_fin = torch.stack(eng.final_costs_batch(out1))
    err = max(compare(torch, "K1 split cost", split[0], whole[0], exact=True),
              compare(torch, "K1 split gradient", split[1], whole[1],
                      exact=True),
              compare(torch, "split final costs", split_fin, whole_fin,
                      exact=True))
    print(f"K1 forced split (at most {m * S * 100} queries a launch): "
          f"{split_launches} launches for the final cost report, bit-equal "
          f"to one launch; device {t[2]} ms vs plain {t[3]} ms")
    check(split_launches == 3, f"K1 split launched {split_launches} times")
    F, mx, my, mz = eng.fields.data.shape
    entry = kernel_entry(
        "obstacle_split", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs),
        sdf_lookup.obstacle_flops(m, S, BATCH, F))
    entry["launches"] = split_launches
    return entry, f64_check_launches


def k2_launch(torch, selfcol, sargs, label, card):
    """K2's launch facts on a path's own inputs (sargs end with the
    engine's pair layout): the block, its shared memory, residency,
    registers and spills, the tiled ring's slots, and the device kernels
    one call launches (fails unless 1).  On the tiled path, the layout
    kernel against its plain version (bit-equal) and the kernels of a
    call that brings no layout (the layout kernel and K2's, 2)."""
    x, xo, pi, pj, rsum, layout = sargs[0], sargs[2], *sargs[3:6], sargs[8]
    Sa, SI = x.shape[2], xo.shape[1]
    info = selfcol.launch_info(Sa, SI, x.dtype)
    line = (f"{label} selfcol launch: {info['path']} path, "
            f"{info['threads']} threads, {info['smem_bytes']} B shared "
            f"memory per block, {info['blocks_per_sm']} blocks per SM, "
            f"{info['registers']} registers, {info['local_bytes']} B local "
            f"(spill) per thread")
    if info["path"] == "tiled":
        line += (", every chunk resident" if selfcol.ring_resident(
            Sa + SI, x.dtype.itemsize) else ", chunks streamed")
    one = kernels_per_call(torch, lambda: selfcol.selfcol_pairs(*sargs))
    print(f"{line}; {one:.0f} device kernel(s) per call with the engine's "
          f"layout on {card}")
    check(one == 1, f"{label} selfcol: {one} device kernels per call")
    if info["path"] != "tiled":
        return
    made = selfcol.pair_layout(pi, pj, rsum, Sa, Sa + SI)
    plain = selfcol.pair_layout_ref(pi.cpu(), pj.cpu(), rsum.cpu(), Sa,
                                    Sa + SI)
    for got, eng_t, want in zip(made, layout, plain):
        check(torch.equal(got.cpu(), want) and torch.equal(eng_t.cpu(), want),
              f"{label} selfcol layout: kernel, engine and plain differ")
    bare = kernels_per_call(torch, lambda: selfcol.selfcol_pairs(*sargs[:-1]))
    print(f"{label} selfcol layout kernel: bit-equal to its plain version "
          f"and to the engine's layout; a call without a layout launches "
          f"{bare:.0f} device kernels")
    check(bare == 2, f"{label} selfcol: {bare} device kernels per call "
          f"without a layout")


def grab_phase(torch, pt, card, dev):
    """The robot grabs a tray of 110 spheres at its hand (S = 126, 125
    active, 1 inactive): K2's tiled path against its plain version and
    itself, a B = 256 solve of 100 iterations with its launches, the CPU
    float64 re-solve of 8 problems, and release; the layout kernel at its
    pair table, timed.  Returns K2's and the layout kernel's entries."""
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    t0 = time.perf_counter()
    mod, _ = bench_module(pt, torch.float32, dev)
    tray = grab_tray(pt, mod)
    robot = mod.robots["wam"]
    run = mod.runs[mod.create(**run_kw())]
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    torch.cuda.synchronize()
    _, x, vel, _ = cost_soa.sphere_kinematics(eng.spec, eng.fk, probs)
    m, Sa, B = x.shape[1:]
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    SI = xo.shape[1]
    P = eng.pairs[0].shape[0]
    print(f"grab setup (grab, create, batch): {time.perf_counter() - t0:.2f} "
          f"s; {len(robot.model.sphere_radius)} spheres, Sa = {Sa}, SI = "
          f"{SI}, {P} pairs")
    check((len(robot.model.sphere_radius), Sa, SI) == (126, 125, 1),
          f"grab sphere counts {(Sa, SI)}")
    check(selfcol.launch_shape(Sa, SI)[0] == "tiled",
          "grab: K2 did not take the tiled path")
    sargs = (x, vel, xo, *eng.pairs, probs.epsilon_self,
             probs.obs_factor_self, eng.pair_layout)
    k2_launch(torch, selfcol, sargs, "grab", card)
    votes, near, taken, reach = selfcol.vote_stats(
        x, xo, *eng.pairs, probs.epsilon_self)
    print(f"grab selfcol skips: of {votes} votes {near} pass the box test "
          f"and {taken} are taken ({(votes - taken) / votes:.4f} skipped); "
          f"{reach} of {m * P * B} (point, pair, problem) in reach")
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    err = max(compare(torch, "grab selfcol net", net_k, net_r),
              compare(torch, "grab selfcol cost", c_k, c_r))
    again = selfcol.selfcol_pairs(*sargs)
    check(torch.equal(again[0], net_k) and torch.equal(again[1], c_k),
          "grab selfcol: two launches on the same inputs differ")
    bare = selfcol.selfcol_pairs(*sargs[:-1])
    check(torch.equal(bare[0], net_k) and torch.equal(bare[1], c_k),
          "grab selfcol: a call without the layout differs")
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"grab selfcol: max_abs_err {err}, bit-equal across launches, per "
          f"call {t[0]:.4f} ms vs plain {t[1]:.4f} ms, device {t[2]} ms vs "
          f"plain {t[3]} ms")
    entry = kernel_entry(
        "selfcol_grab", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, Sa, SI, B, P), selfcol.flops(m, B, P, reach))
    print(f"selfcol_grab: device {entry['ms']} ms, bound {entry['bound_ms']} "
          f"ms ({entry['bound_by']}), share {entry['bound_share']:.4f} on "
          f"{card}")
    del net_k, c_k, net_r, c_r, again, bare

    counts_zero(sdf_lookup, selfcol)
    selfcol.LAYOUT_LAUNCHES = 0
    t0 = time.perf_counter()
    out, costs = BatchSolver(eng).iterate(probs, N_ITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    print(f"grab: iterate({N_ITER}) at B={BATCH} in {wall:.3f} s (first "
          f"call), {BATCH / wall} solves/s, launches {launches}, layout "
          f"kernel {selfcol.LAYOUT_LAUNCHES} on {card}")
    check_launches(launches, N_ITER, "grab",
                   steps=N_ITER)
    check(selfcol.LAYOUT_LAUNCHES == 0, "grab: the step built a pair layout")
    entry["launches"] = launches["selfcol"]
    # the layout kernel at the grab's pair table: the engine builds its
    # layout on the host, so the grab's iterate launches it no time
    entry_layout = layout_entry(torch, selfcol, eng.pairs, Sa, Sa + SI,
                                "selfcol_layout_grab", card)
    entry_layout["launches"] = 0
    check(bool(torch.isfinite(costs).all() and torch.isfinite(out.traj).all()),
          "grab: non-finite costs or trajectories")

    t0 = time.perf_counter()
    mod64, _ = bench_module(pt, torch.float64, "cpu")
    grab_tray(pt, mod64)
    run64 = mod64.runs[mod64.create(**run_kw())]
    p64 = problem_batch_from_grid(run64.problem, starts[:N_CHECK],
                                  goals[:N_CHECK], run64.engine)
    out64, _ = BatchSolver(run64.engine).iterate(p64, N_ITER)
    dtraj = max_dtraj(out, out64)
    print(f"grab CPU float64 re-solve of {N_CHECK} problems: max |Δtraj| "
          f"{dtraj} (bar {TRAJ_BAR}), {time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"grab: max |Δtraj| {dtraj} > {TRAJ_BAR}")
    robot.release(tray)
    check(len(robot.model.sphere_radius) == 16
          and tray.grabbed_by is None, "release")
    print(f"release: {len(robot.model.sphere_radius)} spheres")
    return entry, entry_layout


def front_door_phase(torch, pt, card, dev):
    """The reference's front door on the card: the WAM7 + hand loaded
    from OpenRAVE XML text, held against the built-in wam7(); a solve
    driven by command strings only (computedistancefield, create with
    start_tsr at n_points 101, iterate 100, gettraj, destroy) against
    the same strings on the CPU in float64, with its launches and point
    0's residual; B = 256 batches with start_tsr and with a quadratic
    start_cost hook, timed beside config 1, re-solved on the CPU; K1 and
    K2 at the start_tsr shape against their plain versions.  Returns
    their kernel entries."""
    import numpy as np

    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    f32, f64, cpu = torch.float32, torch.float64, "cpu"

    # -- the robot from XML ---------------------------------------------------
    t0 = time.perf_counter()
    xml = wam7_xml(pt)
    model = pt.parse_robot_xml(xml)
    errs = {d: xml_sphere_error(torch, pt, model, d, dt)
            for d, dt in (("cpu", f64), ("cuda", f32))}
    print(f"front door: WAM7 + hand from {len(xml)} B of OpenRAVE XML "
          f"({len(model.link_names)} links, {model.n_dof} active DOFs "
          f"{model.dof_names}, {len(model.sphere_radius)} spheres) in "
          f"{time.perf_counter() - t0:.3f} s; sphere centres against "
          f"wam7() at 64 configurations: max |Δx| {errs['cpu']} (CPU "
          f"float64, bar {XML_BAR['cpu']}), {errs['cuda']} (card float32, "
          f"bar {XML_BAR['cuda']})")
    check(model.dof_names == pt.wam7().dof_names, "XML robot's DOFs")
    for d, e in errs.items():
        check(e <= XML_BAR[d], f"XML robot's spheres ({d}): {e}")

    # -- driven by command strings, on the card and on the CPU ----------------
    tsr = front_door_tsr(pt)
    mod = front_door_module(pt, model, f32, dev)
    counts_zero(sdf_lookup, selfcol)
    t0 = time.perf_counter()
    cost, out, before, after, spec = string_drive(pt, mod, tsr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    mod64 = front_door_module(pt, model, f64, cpu)
    t1 = time.perf_counter()
    cost64, out64, before64, after64, _ = string_drive(pt, mod64, tsr)
    wall64 = time.perf_counter() - t1
    d_str = float(np.abs(np.array(out["positions"])
                         - np.array(out64["positions"])).max())
    print(f"front door strings (create start_tsr, n_points {N_POINTS}, m "
          f"{spec.m}; iterate {N_ITER}; gettraj; destroy): {wall:.3f} s "
          f"(first call) on {card}, launches {launches} (expected {N_ITER} "
          f"+ 1 each, the FK {N_ITER} + 4); final cost {cost} (CPU float64 {cost64}); point 0's "
          f"residual {before} → {after} (CPU float64 {before64} → "
          f"{after64}); max |Δtraj| against the CPU float64 strings {d_str} "
          f"(bar {TRAJ_BAR}, {wall64:.2f} s on the CPU)")
    check(spec.start_tsr and spec.m == N_POINTS - 1, f"front door {spec}")
    # the FK also runs for the residuals before and after and for
    # gettraj's float64 check
    check_launches(launches, N_ITER + 1, "front door strings",
                   steps=N_ITER, fk=N_ITER + 4)
    check(len(out["positions"]) == N_POINTS
          and np.isfinite(np.array(out["positions"])).all(),
          "front door gettraj")
    check(after < 0.01 * before, f"point 0's residual {before} → {after}")
    check(d_str <= TRAJ_BAR, f"front door strings vs CPU: {d_str}")

    # -- B = 256 batches: start_tsr, and a start_cost hook --------------------
    _, run1 = bench_module(pt, f32, dev)
    starts, goals = bench_endpoints(BATCH)
    hook = quadratic_hook(torch)
    runs = {"config 1": run1,
            "start_tsr": mod.runs[mod.create(**run_kw(), start_tsr=tsr)],
            "start_cost": mod.runs[mod.create(**run_kw(), start_cost=hook)]}
    check(runs["start_cost"].engine.extra_cost is hook, "start_cost hook")
    batches = {k: problem_batch_from_grid(r.problem, starts, goals, r.engine)
               for k, r in runs.items()}
    solvers = {k: BatchSolver(r.engine) for k, r in runs.items()}
    outs, batch_launches = {}, {}
    for k in ("start_tsr", "start_cost"):
        counts_zero(sdf_lookup, selfcol)
        t0 = time.perf_counter()
        outs[k], costs = solvers[k].iterate(batches[k], N_ITER)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        batch_launches[k] = counts(sdf_lookup, selfcol)
        print(f"front door {k}: iterate({N_ITER}) at B={BATCH} in {wall:.3f} "
              f"s (first call), launches {batch_launches[k]}")
        check_launches(batch_launches[k], N_ITER, f"front door {k}",
                       steps=N_ITER)
        check(bool(torch.isfinite(costs).all()
                   and torch.isfinite(outs[k].traj).all()),
              f"front door {k}: non-finite costs or trajectories")
    # warm walls in turns, config 1 beside the two
    walls = {k: [] for k in solvers}
    for _ in range(LATENCY_REPS):
        for k, sv in solvers.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sv.iterate(batches[k], N_ITER)
            torch.cuda.synchronize()
            walls[k].append(time.perf_counter() - t0)
    for k, w in walls.items():
        print(f"front door {k} iterate({N_ITER}) at B={BATCH}: warm walls "
              f"{w} s, median {BATCH / statistics.median(w)} solves/s on "
              f"{card}")
    res = runs["start_tsr"].engine.constraint_values
    r0 = float(res(batches["start_tsr"]).abs().max())
    r1 = float(res(outs["start_tsr"]).abs().max())
    print(f"front door start_tsr batch: point 0's residual over the batch "
          f"{r0} → {r1}")
    check(r1 < 0.1 * r0, f"start_tsr batch residual {r0} → {r1}")

    # -- K1 and K2 at the start_tsr shape (m = 100) ---------------------------
    eng, probs = runs["start_tsr"].engine, batches["start_tsr"]
    _, x, vel, acc = cost_soa.sphere_kinematics(eng.spec, eng.fk, probs)
    m, S, B = x.shape[1:]
    check((m, S, B) == (N_POINTS - 1, 15, BATCH), f"start_tsr {(m, S, B)}")
    oargs = obstacle_args(eng, probs, x, vel, acc)
    k1_launch(torch, sdf_lookup, oargs, "start_tsr")
    err = check_obstacle(torch, sdf_lookup, oargs, "start_tsr obstacle")
    t = time_obstacle(torch, sdf_lookup, oargs, "start_tsr obstacle")
    F, mx, my, mz = eng.fields.data.shape
    e1 = kernel_entry(
        "obstacle_start_tsr", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs),
        sdf_lookup.obstacle_flops(m, S, B, F))
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    sargs = (x, vel, xo, *eng.pairs, probs.epsilon_self,
             probs.obs_factor_self)
    P, SI = eng.pairs[0].shape[0], xo.shape[1]
    *_, reach = selfcol.vote_stats(x, xo, *eng.pairs, probs.epsilon_self)
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    err = max(compare(torch, "start_tsr selfcol net", net_k, net_r),
              compare(torch, "start_tsr selfcol cost", c_k, c_r))
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"start_tsr selfcol: max_abs_err {err}, per call {t[0]:.4f} ms vs "
          f"plain {t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms")
    e2 = kernel_entry(
        "selfcol_start_tsr", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, S, SI, B, P), selfcol.flops(m, B, P, reach))
    for e, k in ((e1, "obstacle"), (e2, "selfcol")):
        e["launches"] = batch_launches["start_tsr"][k]
        print(f"{e['name']}: device {e['ms']} ms, bound {e['bound_ms']} ms "
              f"({e['bound_by']}), share {e['bound_share']:.4f} on {card}")
    del x, vel, acc, oargs, sargs, net_k, c_k, net_r, c_r

    # -- the first 8 of each batch re-solved on the CPU in float64 ------------
    cpu_runs = {
        "start_tsr": mod64.runs[mod64.create(**run_kw(), start_tsr=tsr)],
        "start_cost": mod64.runs[mod64.create(
            **run_kw(), start_cost=quadratic_hook(torch))]}
    for k, r in cpu_runs.items():
        t0 = time.perf_counter()
        p64 = problem_batch_from_grid(r.problem, starts[:N_CHECK],
                                      goals[:N_CHECK], r.engine)
        out64, _ = BatchSolver(r.engine).iterate(p64, N_ITER)
        dtraj = max_dtraj(outs[k], out64)
        print(f"front door {k} CPU float64 re-solve of {N_CHECK} problems: "
              f"max |Δtraj| {dtraj} (bar {TRAJ_BAR}), "
              f"{time.perf_counter() - t0:.2f} s")
        check(dtraj <= TRAJ_BAR, f"front door {k}: max |Δtraj| {dtraj}")
    return [e1, e2]


def square_tensors(obj, m, seen=None, depth=0):
    """Shapes of the tensors held by ``obj`` (its attributes, and those of
    the tuples, lists, dicts and objects among them, four levels deep)
    that have two axes of length m."""
    import torch

    seen = set() if seen is None else seen
    if id(obj) in seen or depth > 4:
        return []
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return [tuple(obj.shape)] if list(obj.shape).count(m) >= 2 else []
    if isinstance(obj, dict):
        items = list(obj.values())
    elif isinstance(obj, (tuple, list)):
        items = list(obj)
    elif hasattr(obj, "__dict__") and not isinstance(obj, type):
        items = list(vars(obj).values())
    else:
        return []
    return [sh for it in items
            for sh in square_tensors(it, m, seen, depth + 1)]


def kernels_at(torch, sdf_lookup, selfcol, eng, probs, label, card,
               k2=True):
    """K1 (both paths) and, with ``k2``, K2 against their plain versions
    on a path's own inputs, timed; returns their kernel entries (launches
    unset)."""
    from or_cdchomp_tpu_torch.chomp import cost_soa

    _, x, vel, acc = cost_soa.sphere_kinematics(eng.spec, eng.fk, probs)
    m, S, B = x.shape[1:]
    f64 = x.dtype == torch.float64
    rate = FP64_FLOPS_PER_S if f64 else FP32_FLOPS_PER_S
    oargs = obstacle_args(eng, probs, x, vel, acc)
    k1_launch(torch, sdf_lookup, oargs, label)
    err = check_obstacle(torch, sdf_lookup, oargs, f"{label} obstacle")
    t = time_obstacle(torch, sdf_lookup, oargs, f"{label} obstacle")
    F, mx, my, mz = eng.fields.data.shape
    tag = label.replace(" ", "_")
    e1 = kernel_entry(
        f"obstacle_{tag}", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs),
        sdf_lookup.obstacle_flops(m, S, B, F), rate)
    if not k2:
        print(f"{e1['name']}: device {e1['ms']} ms, bound {e1['bound_ms']} "
              f"ms ({e1['bound_by']}), share {e1['bound_share']:.4f} on "
              f"{card}")
        return [e1]
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    sargs = (x, vel, xo, *eng.pairs, probs.epsilon_self,
             probs.obs_factor_self, eng.pair_layout)
    P, SI = eng.pairs[0].shape[0], xo.shape[1]
    *_, reach = selfcol.vote_stats(x, xo, *eng.pairs, probs.epsilon_self)
    k2_launch(torch, selfcol, sargs, label, card)
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    rtol = F64_KERNEL_RTOL if f64 else KERNEL_RTOL
    err = max(compare(torch, f"{label} selfcol net", net_k, net_r,
                      rtol=rtol),
              compare(torch, f"{label} selfcol cost", c_k, c_r, rtol=rtol))
    again = selfcol.selfcol_pairs(*sargs)
    check(torch.equal(again[0], net_k) and torch.equal(again[1], c_k),
          f"{label} selfcol: two launches on the same inputs differ")
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"{label} selfcol: max_abs_err {err} (rtol {rtol}), bit-equal "
          f"across launches, per call {t[0]:.4f} ms vs plain {t[1]:.4f} "
          f"ms, device {t[2]} ms vs plain {t[3]} ms")
    e2 = kernel_entry(
        f"selfcol_{tag}", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, S, SI, B, P, x.dtype.itemsize),
        selfcol.flops(m, B, P, reach), rate)
    for e in (e1, e2):
        print(f"{e['name']}: device {e['ms']} ms, bound {e['bound_ms']} ms "
              f"({e['bound_by']}), share {e['bound_share']:.4f} on {card}")
    return [e1, e2]


def long_phase(torch, pt, card, dev):
    """Long trajectories: config 1's world at n_points 1001 (m = 999, the
    semiseparable metric, no m×m tensor), B = 256, K1 and K2 held against
    their plain versions and timed, iterate(100) with its launches, step
    profile and warm walls, the limits kernel with rows pushed out, the
    replayed iterate against eager steps; runchomp at n_points 258 (the first
    semiseparable shape); then the first 8 problems and the runchomp on
    the CPU in float64.  Returns the kernel entries."""
    import numpy as np

    from or_cdchomp_tpu_torch.ops import limits, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    f32, f64, cpu = torch.float32, torch.float64, "cpu"
    kw = dict(run_kw(), n_points=LONG_POINTS)
    t0 = time.perf_counter()
    mod, _ = bench_module(pt, f32, dev)
    run = mod.runs[mod.create(**kw)]
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    torch.cuda.synchronize()
    m = eng.spec.m
    square = square_tensors(eng, m) + square_tensors(probs, m)
    print(f"long batch setup (create n_points {LONG_POINTS}, batch): "
          f"{time.perf_counter() - t0:.2f} s; m = {m}, metric "
          f"{eng.metric_mode}, A {eng.A}, Ainv {eng.Ainv}, tensors with two "
          f"axes of {m}: {square}")
    check(m == LONG_POINTS - 2 and eng.metric_mode == "sep"
          and eng.A is None and eng.Ainv is None and eng.metric_ops is None,
          f"long batch: metric {eng.metric_mode}")
    check(not square, f"long batch: m x m tensors {square}")
    entries = kernels_at(torch, sdf_lookup, selfcol, eng, probs, "m999",
                         card)
    T, lo, hi = probs.traj[:, 1:-1], probs.jlimit_lower, probs.jlimit_upper
    # this seeded input leaves two rows at the cap and one with a 45-round
    # tail in the plain version (PERF.md §6)
    entries.append(limits_entry(torch, "limit_repair_m999",
                                pushed_out(torch, T, lo, hi), lo, hi,
                                eng.spec.dt, card, max_ill=3))

    counts_zero(sdf_lookup, selfcol)
    solver = BatchSolver(eng)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out, costs = solver.iterate(probs, N_ITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    peak = torch.cuda.max_memory_allocated()
    print(f"long batch: iterate({N_ITER}) at B={BATCH}, m={m} in {wall:.3f} "
          f"s (first call), launches {launches}, peak device memory {peak} "
          f"B on {card}")
    check_launches(launches, N_ITER, "long batch",
                   steps=N_ITER)
    launches["limits"] = limits.LAUNCHES
    for e, k in zip(entries, ("obstacle", "selfcol", "limits")):
        e["launches"] = launches[k]
    check(tuple(out.traj.shape) == (BATCH, LONG_POINTS, 7)
          and bool(torch.isfinite(costs).all())
          and bool(torch.isfinite(out.traj).all()),
          "long batch: shapes or non-finite values")
    c0, c1 = float(costs[0, :, 0].mean()), float(costs[-1, :, 0].mean())
    print(f"long batch mean total cost: first iteration {c0:.6f}, last "
          f"{c1:.6f}")
    check(c1 < c0, "long batch: the mean total cost did not fall")
    step_profile(torch, eng, probs, "long batch (m = 999)", card)
    wall, walls = warm_walls(torch, lambda: solver.iterate(probs, N_ITER), 3)
    print(f"long batch iterate({N_ITER}) at B={BATCH}: median warm wall "
          f"{wall} s of {walls}, {BATCH / wall} solves/s on {card}")
    graph_check(torch, "long batch (m = 999)", eng, probs, card)

    kw258 = dict(run_kw(), n_points=SEP_FIRST_POINTS)
    h = mod.create(**kw258)
    check(mod.runs[h].engine.metric_mode == "sep", "n_points 258: not sep")
    mod.destroy(run=h)
    t0 = time.perf_counter()
    traj = mod.runchomp(n_iter=N_ITER, no_collision_exception=True, **kw258)
    torch.cuda.synchronize()
    print(f"runchomp n_points {SEP_FIRST_POINTS} (m = 256, sep): "
          f"{time.perf_counter() - t0:.3f} s (first call), in collision "
          f"{traj.in_collision}")

    # -- the CPU float64 side -------------------------------------------------
    t0 = time.perf_counter()
    mod64, _ = bench_module(pt, f64, cpu)
    run64 = mod64.runs[mod64.create(**kw)]
    p64 = problem_batch_from_grid(run64.problem, starts[:N_CHECK],
                                  goals[:N_CHECK], run64.engine)
    out64, _ = BatchSolver(run64.engine).iterate(p64, N_ITER)
    dtraj = max_dtraj(out, out64)
    print(f"long batch CPU float64 re-solve of {N_CHECK} problems: max "
          f"|Δtraj| {dtraj} (bar {TRAJ_BAR}), "
          f"{time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"long batch: max |Δtraj| {dtraj}")
    t0 = time.perf_counter()
    traj64 = mod64.runchomp(n_iter=N_ITER, no_collision_exception=True,
                            **kw258)
    d = float(np.abs(traj.positions - traj64.positions).max())
    print(f"runchomp n_points {SEP_FIRST_POINTS} against the CPU float64 "
          f"runchomp: max |Δtraj| {d} (bar {TRAJ_BAR}), in collision "
          f"{traj.in_collision} (CPU {traj64.in_collision}), "
          f"{time.perf_counter() - t0:.2f} s")
    check(d <= TRAJ_BAR, f"runchomp n_points 258 vs CPU: {d}")
    check(traj.in_collision == traj64.in_collision,
          "runchomp n_points 258: the collision verdicts differ")
    return entries


def mesh_world(pt, dtype, device, cube_extent=MESH_EXTENT):
    """examples/wam7_mesh_demo.py:38-52's scene: the table top and leg as
    box meshes, the mug as a 24-gon cylinder mesh, the WAM7 at START; the
    table's field at ``cube_extent``.  Returns the module."""
    import numpy as np

    from or_cdchomp_tpu_torch.api import KinBody, Robot
    from or_cdchomp_tpu_torch.ops.voxelize import (box_trimesh,
                                                   cylinder_trimesh)

    top_v, top_f = box_trimesh((0.25, 0.4, 0.02))
    leg_v, leg_f = box_trimesh((0.08, 0.08, 0.25))
    mug_v, mug_f = cylinder_trimesh(0.04, 0.06, n=24)
    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), top_v, top_f),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), leg_v, leg_f)])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mug_v, mug_f)])))
    robot = mod.add_robot(Robot("wam", pt.wam7(), q_active=np.array(START)))
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=cube_extent)
    robot.enabled = True
    return mod


def shell_ties(torch, mod, cells, extent):
    """Which of the field's ``cells`` (K, 3) are ties: cells whose cube,
    in float64 on the CPU, meets a mesh with its half extent widened by
    TIE_BAND but not with it narrowed by TIE_BAND."""
    from or_cdchomp_tpu_torch.ops.quat import pose_apply
    from or_cdchomp_tpu_torch.ops.voxelize import voxelize_scene
    from or_cdchomp_tpu_torch.utils import np_pose

    f64 = dict(dtype=torch.float64, device="cpu")
    sdf = mod.sdfs[0]
    sizes = torch.tensor(sdf.grid.data.shape, **f64)
    lengths = sdf.grid.lengths.to(**f64)
    pose = np_pose.compose(mod.bodies[sdf.kinbody_name].pose, sdf.pose)
    c = pose_apply(torch.as_tensor(pose, **f64),
                   (torch.as_tensor(cells, **f64) + 0.5) / sizes * lengths)
    wide = torch.zeros(len(cells), dtype=torch.bool)
    narrow = torch.zeros(len(cells), dtype=torch.bool)
    for b in mod.bodies.values():
        inv = torch.as_tensor(np_pose.invert(b.pose), **f64)
        sc = b.scene.to(**f64)
        wide |= voxelize_scene(sc, pose_apply(inv, c), extent + TIE_BAND)
        narrow |= voxelize_scene(sc, pose_apply(inv, c), extent - TIE_BAND)
    return (wide & ~narrow).numpy()


def mesh_phase(torch, pt, card, dev):
    """The mesh demo on the card: the field at 0.04 m against a CPU build
    (ties listed), runchomp (n_points 101, 100 iterations, collision-free)
    against the CPU float64 runchomp, a B = 256 batch with its launches
    and gettraj_batch's verdicts against the CPU float64 check; then the
    table at 0.0025 m (above 192³ cells): its build wall and peak memory,
    its sign against sd_trimesh at 10,000 cells, and a B = 256 iterate
    on it.  Returns the kernel entries."""
    import numpy as np

    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.ops.quat import pose_apply
    from or_cdchomp_tpu_torch.ops.voxelize import scene_distance
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)
    from or_cdchomp_tpu_torch.utils import np_pose

    f32, f64, cpu = torch.float32, torch.float64, "cpu"
    t0 = time.perf_counter()
    mod = mesh_world(pt, f32, dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    mod64 = mesh_world(pt, f64, cpu)
    t2 = time.perf_counter()
    a = mod.sdfs[0].grid.data.cpu()
    b = mod64.sdfs[0].grid.data
    check(a.shape == b.shape, f"mesh field {tuple(a.shape)} vs "
          f"{tuple(b.shape)}")
    flips = torch.nonzero((a <= 0) != (b <= 0)).numpy()
    ties = shell_ties(torch, mod64, flips, MESH_EXTENT) if len(flips) \
        else np.zeros(0, bool)
    same = (a <= 0) == (b <= 0)
    print(f"mesh field at {MESH_EXTENT} m: {tuple(a.shape)} cells, built in "
          f"{t1 - t0:.3f} s on the card ({t2 - t1:.3f} s on the CPU); "
          f"occupancy differs from the CPU build on {len(flips)} cells "
          f"{flips.tolist()}, of which ties (within {TIE_BAND} m) "
          f"{int(ties.sum())}; max |Δfield| where the occupancy agrees "
          f"{float((a - b)[same].abs().max())}")
    check(bool(ties.all()), f"mesh field: cells {flips[~ties].tolist()} "
          "differ from the CPU build and are not ties")
    check(float(a.min()) < 0.0, "mesh field: no obstacle cell")
    # the field built in chunks of a few hundred cells equals one piece,
    # for the meshes and for config 1's box and cylinder
    from or_cdchomp_tpu_torch import api as api_mod
    whole = [mod.sdfs[0].grid.data,
             bench_module(pt, f32, dev)[0].sdfs[0].grid.data]
    saved = api_mod.VOXEL_CHUNK_BYTES
    api_mod.VOXEL_CHUNK_BYTES = 2 ** 16
    try:
        parts = [mesh_world(pt, f32, dev).sdfs[0].grid.data,
                 bench_module(pt, f32, dev)[0].sdfs[0].grid.data]
    finally:
        api_mod.VOXEL_CHUNK_BYTES = saved
    for label, w, c in zip(("mesh", "config 1"), whole, parts):
        compare(torch, f"{label} field built in chunks", c, w, exact=True)
    print("mesh and config 1 fields built in chunks of 64 KiB: bit-equal to "
          "one piece")

    # -- runchomp on the mesh field -------------------------------------------
    t0 = time.perf_counter()
    traj = mod.runchomp(n_iter=N_ITER, no_collision_exception=True,
                        **run_kw())
    torch.cuda.synchronize()
    print(f"mesh runchomp (n_points {N_POINTS}, {N_ITER} iterations): "
          f"{time.perf_counter() - t0:.3f} s (first call), in collision "
          f"{traj.in_collision}, check of {mod.last_check['triangles']} "
          f"triangles in chunks of {mod.last_check['chunk']}")
    check(not traj.in_collision, "mesh runchomp ends in collision")

    # -- a B = 256 batch on the mesh field ------------------------------------
    run = mod.runs[mod.create(**run_kw())]
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    entries = kernels_at(torch, sdf_lookup, selfcol, eng, probs, "mesh",
                         card, k2=False)
    counts_zero(sdf_lookup, selfcol)
    t0 = time.perf_counter()
    out, costs = BatchSolver(eng).iterate(probs, N_ITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    print(f"mesh batch: iterate({N_ITER}) at B={BATCH} in {wall:.3f} s "
          f"(first call), launches {launches}")
    check_launches(launches, N_ITER, "mesh batch",
                   steps=N_ITER)
    entries[0]["launches"] = launches["obstacle"]
    check(bool(torch.isfinite(costs).all()
               and torch.isfinite(out.traj).all()),
          "mesh batch: non-finite costs or trajectories")
    hb = next(h for h, r in mod.runs.items() if r is run)
    t0 = time.perf_counter()
    _, flags = mod.gettraj_batch(run=hb, probs=out)
    print(f"mesh gettraj_batch (B={BATCH}): {int(flags.sum())} in "
          f"collision, {mod.last_check['samples']} samples, "
          f"{mod.last_check['triangles']} triangles, chunk "
          f"{mod.last_check['chunk']}, {time.perf_counter() - t0:.3f} s")

    # -- the CPU float64 side -------------------------------------------------
    t0 = time.perf_counter()
    traj64 = mod64.runchomp(n_iter=N_ITER, no_collision_exception=True,
                            **run_kw())
    d = float(np.abs(traj.positions - traj64.positions).max())
    h64 = mod64.create(**run_kw())
    _, flags64 = mod64.gettraj_batch(run=h64, probs=head(out, N_CHECK))
    print(f"mesh runchomp against the CPU float64 runchomp: max |Δtraj| {d} "
          f"(bar {TRAJ_BAR}); gettraj_batch's first {N_CHECK} verdicts "
          f"{flags[:N_CHECK].tolist()} (CPU float64 {flags64.tolist()}), "
          f"{time.perf_counter() - t0:.2f} s")
    check(d <= TRAJ_BAR, f"mesh runchomp vs CPU: {d}")
    check_flags("mesh gettraj_batch", flags[:N_CHECK], flags64)
    del mod, mod64, run, eng, probs, out, costs

    # -- the large grid: above 192³ cells, built on the card ------------------
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    big = mesh_world(pt, f32, dev, LARGE_EXTENT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    sdf = big.sdfs[0]
    sizes = tuple(sdf.grid.data.shape)
    cells = int(np.prod(sizes))
    print(f"large mesh field at {LARGE_EXTENT} m: {sizes} = {cells} cells "
          f"(192^3 = {192 ** 3}), built on the card in {wall:.3f} s (first "
          f"call), peak device memory {peak} B ({peak / 2 ** 30:.3f} GiB) "
          f"above the {base} B in use, on {card}")
    check(cells > 192 ** 3, f"large grid has {cells} cells")
    rng = np.random.default_rng(5)
    idx = rng.integers(0, sizes, size=(N_SIGN, 3))
    f64d = dict(dtype=torch.float64, device=dev)
    centres = ((torch.as_tensor(idx, **f64d) + 0.5)
               / torch.tensor(sizes, **f64d) * sdf.grid.lengths.to(**f64d))
    world = pose_apply(torch.as_tensor(np_pose.compose(
        big.bodies["table"].pose, sdf.pose), **f64d), centres)
    sd = torch.stack([scene_distance(
        body.scene.to(**f64d), pose_apply(torch.as_tensor(
            np_pose.invert(body.pose), **f64d), world))
        for body in big.bodies.values()]).amin(0)
    field = sdf.grid.data[tuple(torch.as_tensor(idx, device=dev).T)]
    far = sd.abs() > 2 * LARGE_EXTENT * math.sqrt(3.0)
    wrong = far & ((field <= 0) != (sd <= 0))
    print(f"large mesh field sign against sd_trimesh at {N_SIGN} sampled "
          f"cells: {int(far.sum())} farther than a cell diagonal, "
          f"{int(wrong.sum())} of them of the other sign, "
          f"{int((sd[far] <= 0).sum())} inside")
    check(int(wrong.sum()) == 0, "large mesh field: wrong signs")
    check(int((sd[far] <= 0).sum()) > 0, "large mesh field: no inside cell")
    runL = big.runs[big.create(**run_kw())]
    probsL = problem_batch_from_grid(runL.problem, starts, goals,
                                     runL.engine)
    (eL,) = kernels_at(torch, sdf_lookup, selfcol, runL.engine, probsL,
                       "large grid", card, k2=False)
    counts_zero(sdf_lookup, selfcol)
    t0 = time.perf_counter()
    outL, costsL = BatchSolver(runL.engine).iterate(probsL, N_ITER)
    torch.cuda.synchronize()
    launches = counts(sdf_lookup, selfcol)
    print(f"large grid batch: iterate({N_ITER}) at B={BATCH} in "
          f"{time.perf_counter() - t0:.3f} s (first call), launches "
          f"{launches}")
    check_launches(launches, N_ITER, "large grid batch",
                   steps=N_ITER)
    eL["launches"] = launches["obstacle"]
    check(bool(torch.isfinite(costsL).all()
               and torch.isfinite(outL.traj).all()),
          "large grid batch: non-finite costs or trajectories")
    return entries + [eL]


def seeded_phase(torch, pt, card, dev):
    """Config 3 (HMC, λ_resample 0.02) at B = 256 with seeds 7 + p: the
    draw kernel against its plain version (words bit-equal, z and u within
    DRAW_RTOL), 100 steps with one draw launch each, and rows 0-7 re-run
    as a batch of 8 with the same seeds: their draws bit-equal at every
    step and their trajectories within SEEDED_BAR.  Returns the draw
    kernel's entry."""
    import numpy as np

    from or_cdchomp_tpu_torch.chomp.solver import RecordingDraw, SeededDraw
    from or_cdchomp_tpu_torch.ops import draw, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    f32 = torch.float32
    run = config3_run(pt, f32, dev)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    seeds = 7 + np.arange(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng,
                                    seeds=seeds)
    m, n = eng.spec.m, eng.spec.n
    err = 0.0
    for step in (0, 37):
        it = (probs.iteration + step).contiguous()
        got = draw.hmc_draw(probs.hmc_seed, it, m, n, f32, want_words=True)
        want = draw.hmc_draw_ref(probs.hmc_seed, it, m, n, f32,
                                 want_words=True)
        for g, w, name in zip(got[2:], want[2:], ("z words", "u words")):
            compare(torch, f"draw {name} (iteration {step})", g, w,
                    exact=True)
        for g, w, name in zip(got[:2], want[:2], ("z", "u")):
            e = float((g.double() - w.double()).abs().max())
            scale = float(w.double().abs().max())
            check(bool(torch.allclose(g.double(), w.double(), rtol=DRAW_RTOL,
                                      atol=DRAW_RTOL * scale)),
                  f"draw {name}: max |err| {e} beyond rtol {DRAW_RTOL}")
            err = max(err, e)
    seed, it0 = probs.hmc_seed, probs.iteration
    t = timings(torch, lambda: draw.hmc_draw(seed, it0, m, n, f32),
                lambda: draw.hmc_draw_ref(seed, it0, m, n, f32))
    print(f"hmc_draw (B={BATCH}, m={m}, n={n}): words bit-equal to the "
          f"plain version, z and u max |err| {err}; per call {t[0]:.4f} ms "
          f"vs plain {t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms")
    # bound: the seeds and iterations read, z and u written; torch.randn
    # on one generator is not the same function, so no library call
    entry = kernel_entry(
        "hmc_draw", "or_cdchomp_tpu_torch/csrc/draw.cu",
        "or_cdchomp_tpu/chomp/solver.py:263", err, t,
        draw.traffic_bytes(BATCH, m, n, 4), 0)
    print(f"hmc_draw: device {entry['ms']} ms, bound {entry['bound_ms']} ms "
          f"({entry['bound_by']}), share {entry['bound_share']:.4f} on "
          f"{card}")

    rec = RecordingDraw(SeededDraw(), N_CHECK)
    counts_zero(sdf_lookup, selfcol, draw)
    t0 = time.perf_counter()
    out, costs = eng.iterate_batched(probs, N_ITER, rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts(sdf_lookup, selfcol), hmc_draw=draw.LAUNCHES)
    print(f"seeded HMC: iterate({N_ITER}) at B={BATCH} in {wall:.3f} s "
          f"(first call), launches {launches} on {card}")
    check_launches(launches, N_ITER, "seeded HMC",
                   steps=N_ITER)
    entry["launches"] = launches["hmc_draw"]
    check(bool(torch.isfinite(costs).all())
          and bool(torch.isfinite(out.traj).all()),
          "seeded HMC: non-finite costs or trajectories")
    check(bool((out.resample_iter >= N_ITER).all()),
          "seeded HMC: a resample iteration was passed over")
    probs8 = problem_batch_from_grid(run.problem, starts[:N_CHECK],
                                     goals[:N_CHECK], eng,
                                     seeds=seeds[:N_CHECK])
    rec8 = RecordingDraw(SeededDraw())
    out8, _ = eng.iterate_batched(probs8, N_ITER, rec8)
    same = all(torch.equal(a, b) for a, b in zip(rec.z + rec.u,
                                                 rec8.z + rec8.u))
    d = float((out.traj[:N_CHECK] - out8.traj).abs().max())
    print(f"seeded HMC rows 0-{N_CHECK - 1} as a batch of {N_CHECK}: draws "
          f"bit-equal at all {len(rec8.z)} steps {same}, same resample "
          f"schedule "
          f"{torch.equal(out.resample_iter[:N_CHECK], out8.resample_iter)}, "
          f"max |Δtraj| {d} (bar {SEEDED_BAR})")
    check(len(rec.z) == len(rec8.z) == N_ITER and same,
          "seeded HMC: rows draw differently in a batch of 8")
    check(d <= SEEDED_BAR, f"seeded HMC: rows moved {d} in a batch of 8")
    graph_check(torch, "config 3 seeded", eng, probs, card)
    return entry


# ---- the multi-process layer, checkpoints, the phase profile ---------------

def free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class CollectiveCount:
    """Counts calls of torch.distributed's collectives while entered."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "broadcast", "reduce", "reduce_scatter", "reduce_scatter_tensor",
             "all_to_all", "all_to_all_single", "gather", "scatter",
             "barrier", "send", "recv")

    def __init__(self):
        self.calls = {}

    def __enter__(self):
        import torch.distributed as dist

        self._saved = {n: getattr(dist, n) for n in self.NAMES}
        for name, fn in self._saved.items():
            def wrap(*a, _fn=fn, _name=name, **kw):
                self.calls[_name] = self.calls.get(_name, 0) + 1
                return _fn(*a, **kw)
            setattr(dist, name, wrap)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False

    def total(self):
        return sum(self.calls.values())


def seeded_hmc_batch(pt, dtype, device):
    """Config 3's world (HMC, seed 7) and its B = 256 batch on per-row
    seeds arange(256), the global row indices; returns (engine, batch)."""
    import numpy as np

    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    run = config3_run(pt, dtype, device)
    starts, goals = bench_endpoints(BATCH)
    return run.engine, problem_batch_from_grid(
        run.problem, starts, goals, run.engine, seeds=np.arange(BATCH))


def dist_child(rank, world, port, outdir):
    """One rank of split_solve: its host_local_batch rows of config 3's
    seeded B = 256 batch on its card (gloo where the ranks share one,
    NCCL where each has its own: ``multihost.choose_backend``),
    solve(100, tol=-inf) (the converged flag all-reduced every chunk,
    never set), all_hosts_best; writes its rows and result to outdir."""
    import datetime

    import torch

    torch.set_num_threads(2)
    sys.path.insert(0, str(ROOT))
    import or_cdchomp_tpu_torch as pt
    import torch.distributed as dist
    from or_cdchomp_tpu_torch.parallel import multihost as mh
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mh.initialize(f"127.0.0.1:{port}", world, rank,
                  timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    want = mh.choose_backend(world, torch.cuda.device_count())
    check(dist.get_backend() == want, f"rank {rank}: backend "
          f"{dist.get_backend()}, expected {want}")
    init_s = time.perf_counter() - t0
    eng, probs = seeded_hmc_batch(pt, torch.float32, torch.device("cuda"))
    # NCCL sets its communicator up at the first collective: time that
    # apart from the solve
    t0 = time.perf_counter()
    dist.all_reduce(mh.comm_tensor(torch.ones(1, device=probs.traj.device)))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mesh = mh.pod_mesh()
    solver = BatchSolver(eng, mesh=mesh)
    local = solver.shard(probs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, fin, done = solver.solve(local, N_ITER, tol=-math.inf)
    best, idx = mh.all_hosts_best(out, fin)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    start, size = mh.host_local_batch(BATCH)
    torch.save({"traj": out.traj.cpu(), "finals": fin.cpu(),
                "best_traj": best.traj.cpu(), "rows": [start, size]},
               str(Path(outdir) / f"rank{rank}.pt"))
    print("RESULT " + json.dumps({
        "rank": rank, "rows": [start, size], "done": done,
        "best_idx": int(idx), "local_min": float(fin[:, 0].min()),
        "backend": dist.get_backend(),
        "device": torch.cuda.current_device(),
        "init_s": init_s, "first_s": first_s, "wall_s": wall}), flush=True)
    dist.destroy_process_group()
    return 0


def distributed_phase(torch, pt, card, dev):
    """(a) This process joins an NCCL world of one: config 1's B = 256
    batch through BatchSolver(engine, mesh=pod_mesh()).solve(tol) and
    all_hosts_best, bit-equal to the plain solver and best_of_batch in
    the same process, with 0 collectives per step and 1 per chunk; walls
    in turns.  (b) Two child processes share the card over gloo, 128 rows
    each of config 3's seeded B = 256 HMC batch, against this process's
    solve of all 256 rows."""
    import datetime

    import torch.distributed as dist

    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel import multihost as mh
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     best_of_batch,
                                                     problem_batch_from_grid)

    f32 = torch.float32
    # -- (a) NCCL, world size 1 ---------------------------------------------
    t0 = time.perf_counter()
    mh.initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                  timeout=datetime.timedelta(seconds=DIST_TIMEOUT))
    init_s = time.perf_counter() - t0
    check(dist.get_backend() == "nccl", "distributed: backend not nccl")
    t0 = time.perf_counter()
    flag = torch.ones((), dtype=torch.int32, device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    print(f"distributed: NCCL world of 1: init_process_group {init_s:.3f} s, "
          f"first all-reduce {first_s:.3f} s")
    mesh = mh.pod_mesh()
    _, run = bench_module(pt, f32, dev)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    dsolver, plain = BatchSolver(eng, mesh=mesh), BatchSolver(eng)
    local = mh.make_global_problems(dsolver.shard(probs), mesh)
    check(torch.equal(local.traj, probs.traj), "distributed: shard rows")

    with CollectiveCount() as per_step:
        dsolver.iterate(local, 10)
    with CollectiveCount() as per_chunk:
        dsolver.iterate_until(local, 10, 10, DIST_TOL)
    print(f"distributed: collectives per 10 steps {per_step.calls}, per "
          f"converged-checked chunk {per_chunk.calls}")
    check(per_step.total() == 0, "distributed: a step exchanged data")
    check(per_chunk.calls == {"all_reduce": 1},
          f"distributed: chunk collectives {per_chunk.calls}")

    counts_zero(sdf_lookup, selfcol)
    with CollectiveCount() as solve_calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_d, fin_d, done_d = dsolver.solve(local, N_ITER, tol=DIST_TOL)
        best_d, idx_d = mh.all_hosts_best(out_d, fin_d)
        torch.cuda.synchronize()
        wall_d = time.perf_counter() - t0
    launches = counts(sdf_lookup, selfcol)
    chunks = -(-done_d // 10)
    check(solve_calls.calls == {"all_reduce": chunks, "all_gather": 1,
                                "broadcast": 1},
          f"distributed: solve collectives {solve_calls.calls}, "
          f"{chunks} chunks")
    check_launches(launches, done_d + 1, "distributed solve",
                   steps=done_d)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p, fin_p, done_p = plain.solve(probs, N_ITER, tol=DIST_TOL)
    best_p, idx_p = best_of_batch(out_p, fin_p)
    torch.cuda.synchronize()
    wall_p = time.perf_counter() - t0
    same = (done_d == done_p and torch.equal(out_d.traj, out_p.traj)
            and torch.equal(fin_d, fin_p) and int(idx_d) == int(idx_p)
            and all(torch.equal(v, getattr(best_d, k))
                    for k, v in best_p.leaves().items()))
    print(f"distributed: solve(tol={DIST_TOL}) at B={BATCH}: {done_d} "
          f"steps in {chunks} chunks, collectives {solve_calls.calls}, "
          f"launches {launches}; wall {wall_d:.4f} s (mesh, with "
          f"all_hosts_best) vs {wall_p:.4f} s (plain, with best_of_batch), "
          f"first calls; bit-equal {same}; best index {int(idx_d)} on {card}")
    check(same, "distributed: the NCCL world-of-one solve is not bit-equal "
          "to the plain solver")
    walls = {"mesh": [], "plain": []}
    for arm in ("mesh", "plain", "plain", "mesh", "mesh", "plain"):
        s = dsolver if arm == "mesh" else plain
        walls[arm].append(warm_walls(
            torch, lambda: s.solve(local, N_ITER, tol=DIST_TOL), 1)[0])
    wm, wp = statistics.median(walls["mesh"]), statistics.median(walls["plain"])
    print(f"distributed: warm solve(tol) walls in turns: mesh {walls['mesh']} "
          f"(median {wm} s, {BATCH / wm} solves/s), plain {walls['plain']} "
          f"(median {wp} s, {BATCH / wp} solves/s) on {card}")
    dist.destroy_process_group()
    check(not dist.is_initialized(), "distributed: group not destroyed")

    # -- (b) two gloo ranks share the card ----------------------------------
    split_solve(torch, pt, card, dev, 2)


def split_solve(torch, pt, card, dev, nranks):
    """Config 3's seeded B = 256 HMC batch (seeds arange(256)) split over
    ``nranks`` child processes of this script (``--dist-child``), each
    on card rank % cards, against this process's solve of all 256 rows:
    the same best index on every rank, the best cost within
    DIST_COST_RTOL, every rank's rows within SEEDED_BAR."""
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver, best_of_batch

    f32 = torch.float32
    outdir = ROOT / "or_cdchomp_tpu_torch" / "build" / "dist"
    outdir.mkdir(parents=True, exist_ok=True)
    for old in outdir.glob("rank*.pt"):
        old.unlink()
    eng3, probs3 = seeded_hmc_batch(pt, f32, dev)
    solver3 = BatchSolver(eng3, devices=[dev])
    t0 = time.perf_counter()
    out3, fin3, done3 = solver3.solve(probs3, N_ITER, tol=-math.inf)
    best3, idx3 = best_of_batch(out3, fin3)
    torch.cuda.synchronize()
    wall3 = time.perf_counter() - t0
    port = free_port()
    # the sockets on the loopback interface: the machine may have no other
    env = dict(os.environ)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--dist-child",
         str(rank), str(nranks), str(port), str(outdir)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(nranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_CHILD_TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        raise PhaseFailed(f"distributed: a child rank hung past "
                          f"{DIST_CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    children_s = time.perf_counter() - t0
    res = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        check(p.returncode == 0 and line,
              f"distributed: child rank {rank} failed (rc {p.returncode}):"
              f"\n{out[-3000:]}")
        res.append(json.loads(line[-1][len("RESULT "):]))
    best_cost3 = float(fin3[idx3, 0])
    rank_best = min(r["local_min"] for r in res)
    rel = abs(rank_best - best_cost3) / abs(best_cost3)
    print(f"distributed: {nranks} {res[0]['backend']} ranks on cards "
          f"{[r['device'] for r in res]}, ~{BATCH // nranks} rows each of "
          f"config 3's seeded HMC batch (seeds arange({BATCH})): "
          f"{children_s:.2f} s for the processes; rank walls (solve + "
          f"all_hosts_best) {[r['wall_s'] for r in res]} s, init "
          f"{[r['init_s'] for r in res]} s, first collective "
          f"{[r['first_s'] for r in res]} s; one process {wall3:.4f} s "
          f"(first call) on {card}")
    for r in res:
        d = torch.load(str(outdir / f"rank{r['rank']}.pt"), weights_only=True)
        start, size = d["rows"]
        ref = out3.traj[start:start + size].cpu()
        dtraj = float((d["traj"] - ref).abs().max())
        bit = torch.equal(d["traj"], ref)
        base, rem = divmod(BATCH, nranks)
        want = [r["rank"] * base + min(r["rank"], rem),
                base + (r["rank"] < rem)]
        print(f"distributed: rank {r['rank']} rows [{start}, {size}]: max "
              f"|Δtraj| {dtraj} (bar {SEEDED_BAR}), bit-equal {bit}; best "
              f"index {r['best_idx']} vs {int(idx3)}, "
              f"{r['done']} steps vs {done3}")
        check(r["rows"] == [start, size] == want,
              f"distributed: rank {r['rank']} rows {r['rows']}")
        check(dtraj <= SEEDED_BAR,
              f"distributed: rank {r['rank']} moved {dtraj}")
        check(r["best_idx"] == int(idx3),
              f"distributed: best index {r['best_idx']} != {int(idx3)}")
    print(f"distributed: best cost over the ranks {rank_best} vs one "
          f"process {best_cost3} (relative {rel}, bar {DIST_COST_RTOL})")
    check(rel <= DIST_COST_RTOL,
          f"distributed: best cost {rank_best} vs {best_cost3}")
    bests = [torch.load(str(outdir / f"rank{r}.pt"),
                        weights_only=True)["best_traj"]
             for r in range(nranks)]
    check(all(torch.equal(b, bests[0]) for b in bests),
          "distributed: the ranks' best differ")
    return res, wall3


def checkpoint_phase(torch, pt, card, dev):
    """A config 3 module run (HmcDraw, seed 7): 50 iterations, save with
    its draw, load into a fresh module's run, 50 more — bit-equal to 100
    straight; then config 3's seeded B = 256 batch from the problem
    alone.  Prints the save and load walls and the file sizes."""
    from or_cdchomp_tpu_torch.checkpoint import load_problem, save_problem
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

    f32 = torch.float32
    half = N_ITER // 2
    kw = dict(run_kw(), use_hmc=True, hmc_resample_lambda=0.02)

    def leaves_equal(a, b):
        return all(torch.equal(v, getattr(b, k))
                   for k, v in a.leaves().items())

    CKPT_DIR.mkdir(parents=True, exist_ok=True)
    mod, _ = bench_module(pt, f32, dev)
    h = mod.create(**kw, seed=7)
    mod.iterate(run=h, n_iter=half)
    path = str(CKPT_DIR / "run_ckpt.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_problem(path, mod.runs[h].problem, draw=mod.runs[h].draw)
    save_s = time.perf_counter() - t0
    size = Path(path).stat().st_size
    fresh, _ = bench_module(pt, f32, dev)
    h2 = fresh.create(**kw, seed=12345)
    rn2 = fresh.runs[h2]
    t0 = time.perf_counter()
    rn2.problem = load_problem(path, template=rn2.problem, draw=rn2.draw)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    fresh.iterate(run=h2, n_iter=N_ITER - half)
    h3 = mod.create(**kw, seed=7)
    mod.iterate(run=h3, n_iter=N_ITER)
    same = leaves_equal(rn2.problem, mod.runs[h3].problem)
    print(f"checkpoint: config 3 module run (HmcDraw, seed 7) {half} + "
          f"{N_ITER - half} iterations across save / load into a fresh "
          f"module: bit-equal to {N_ITER} straight {same}; save {save_s:.4f} "
          f"s, load {load_s:.4f} s, {size} B on {card}")
    check(same, "checkpoint: the resumed module run differs")

    eng, probs = seeded_hmc_batch(pt, f32, dev)
    solver = BatchSolver(eng)
    mid, _ = solver.iterate(probs, half)
    bpath = str(CKPT_DIR / "batch_ckpt.pt")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_problem(bpath, mid)
    save_s = time.perf_counter() - t0
    bsize = Path(bpath).stat().st_size
    t0 = time.perf_counter()
    back = load_problem(bpath, template=probs)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed, _ = solver.iterate(back, N_ITER - half)
    straight, _ = solver.iterate(probs, N_ITER)
    same = leaves_equal(resumed, straight)
    print(f"checkpoint: config 3 seeded batch (B={BATCH}) {half} + "
          f"{N_ITER - half} iterations across save / load: bit-equal to "
          f"{N_ITER} straight {same}; save {save_s:.4f} s, load "
          f"{load_s:.4f} s, {bsize} B on {card}")
    check(same, "checkpoint: the resumed seeded batch differs")


def phase_profile(torch, eng, probs, label, card, reps=5):
    """torch.profiler over reps steps of a batch: device and host ms per
    step per phase, and every K1 / K2 launch's phase.  Returns the two
    reports."""
    from torch.profiler import ProfilerActivity, profile

    from or_cdchomp_tpu_torch.utils.profiling import (format_phase_report,
                                                      phase_device_report,
                                                      phase_host_report,
                                                      phase_kernels)

    state = [probs]
    eng.step_batched(state[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            state[0], _ = eng.step_batched(state[0])
        torch.cuda.synchronize()
    kern = phase_kernels(prof)
    dev_ms, host_ms = {}, {}
    for _, ph, us in kern:
        dev_ms[ph] = dev_ms.get(ph, 0.0) + us / 1e3 / reps
    for ph, ms in phase_host_report(prof).items():
        host_ms[ph] = ms / reps
    k1 = [ph for name, ph, _ in kern if "obstacle_kernel" in name]
    k2 = [ph for name, ph, _ in kern if "selfcol" in name]
    print(f"{label} phase profile over {reps} steps, on {card}:")
    print(format_phase_report(dev_ms, "device ms per step"))
    print(format_phase_report(host_ms, "host ms per step"))
    print(f"{label}: K1 launches recorded {len(k1)} (phases {set(k1)}), "
          f"K2 {len(k2)} (phases {set(k2)}), of {reps} each")
    check(k1 and set(k1) == {"obstacle"},
          f"{label}: K1 launches charged to {set(k1)}")
    check(k2 and set(k2) == {"selfcol"},
          f"{label}: K2 launches charged to {set(k2)}")
    # the replayed path: each replay's kernels charged by the step graph's
    # node map (a replay the profiler lost an event of matches none)
    eng.iterate_batched(state[0], 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        settle = torch.zeros(8, device=probs.traj.device)
        for _ in range(8):
            settle.add_(1)
        torch.cuda.synchronize()
        eng.iterate_batched(state[0], reps)
        torch.cuda.synchronize()
    graph = eng.stepper(state[0]).node_map
    replayed = phase_device_report(prof, maps=[graph] if graph else [])
    if replayed is None:
        print(f"{label} replayed steps: a replay lost an event; no split")
    else:
        replayed = {ph: ms / reps for ph, ms in replayed.items()}
        print(format_phase_report(replayed, "device ms per replayed step"))
        check(replayed.get("fk", 0.0) > 0.0 and
              replayed.get("obstacle", 0.0) > 0.0,
              f"{label}: replayed phases {sorted(replayed)}")
    return dev_ms, host_ms


def range_cost_us(torch, n=20_000):
    """Host µs per entered and left range: ``phase`` as shipped, a null
    context, and an NVTX push / pop pair alone."""
    import contextlib

    from or_cdchomp_tpu_torch.utils.profiling import phase

    out = {}
    for name, cm in (("phase", phase),
                     ("null", lambda n: contextlib.nullcontext())):
        t0 = time.perf_counter()
        for _ in range(n):
            with cm("fk"):
                pass
        out[name] = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        torch.cuda.nvtx.range_push("fk")
        torch.cuda.nvtx.range_pop()
    out["nvtx"] = (time.perf_counter() - t0) / n * 1e6
    return out


def profile_phase(torch, pt, card, dev):
    """The phase ranges on the card: configs 1 and 4 profiled 5 steps each
    (device and host ms per phase, K1 in obstacle, K2 in selfcol); config
    1's 100 warm eager steps with the ranges as shipped and with ``phase``
    swapped for a null context, in turns; the 0.0025 m mesh field's build
    split into voxelize, flood and edt."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from or_cdchomp_tpu_torch.chomp import cost_soa, solver as solver_mod
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
    from or_cdchomp_tpu_torch.utils.profiling import (BUILD_PHASES,
                                                      format_phase_report,
                                                      phase_host_report,
                                                      phase_kernels)

    f32 = torch.float32
    _, run = bench_module(pt, f32, dev)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    print(f"host µs per range before this phase's profiles: "
          f"{range_cost_us(torch)}")
    phase_profile(torch, eng, probs, "config 1", card)
    run4 = config4_run(pt, f32, dev, require_cache=True)
    s4, g4 = run_endpoints(run4, BATCH)
    probs4 = problem_batch_from_grid(run4.problem, s4, g4, run4.engine)
    phase_profile(torch, run4.engine, probs4, "config 4", card)

    shipped = (cost_soa.phase, solver_mod.phase)

    def null(name, *args):
        return contextlib.nullcontext()

    # the eager steps: a replayed iterate enters no range
    walls = {"ranges": [], "null": []}
    try:
        for arm in ("ranges", "null", "null", "ranges") * 2 + ("ranges",
                                                               "null"):
            cost_soa.phase = solver_mod.phase = (
                shipped[0] if arm == "ranges" else null)
            walls[arm].append(warm_walls(
                torch, lambda: eager_iterate(torch, eng, probs, N_ITER),
                1)[0])
    finally:
        cost_soa.phase, solver_mod.phase = shipped
    print(f"host µs per range after them: {range_cost_us(torch)}")
    wr, wn = statistics.median(walls["ranges"]), statistics.median(walls["null"])
    print(f"phase ranges' cost: config 1 warm eager steps ({N_ITER}) at "
          f"B={BATCH}, in turns: ranges {walls['ranges']} (median {wr} s), "
          f"null context {walls['null']} (median {wn} s): "
          f"{(wr - wn) / wn:+.4f} of the wall on {card}")

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        big = mesh_world(pt, f32, dev, LARGE_EXTENT)
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    sizes = tuple(big.sdfs[0].grid.data.shape)
    dev_ms = {}
    for _, ph, us in phase_kernels(prof, BUILD_PHASES):
        dev_ms[ph] = dev_ms.get(ph, 0.0) + us / 1e3
    host_ms = phase_host_report(prof, BUILD_PHASES)
    build = {k: v for k, v in dev_ms.items() if k in BUILD_PHASES}
    print(f"large mesh field build ({sizes}, {LARGE_EXTENT} m), profiled "
          f"({t1 - t0:.2f} s under the profiler, {time.perf_counter() - t1:.2f}"
          f" s to read its {len(prof.events())} events), on {card}:")
    print(format_phase_report(build, "device ms"))
    print(format_phase_report(
        {k: v for k, v in host_ms.items() if k in BUILD_PHASES}, "host ms"))
    print(big.sdf_timers.report())
    check(set(build) == set(BUILD_PHASES),
          f"large field build: phases {sorted(build)}")


# ---- libcd math: pose / spatial algebra, per-problem FK, SDF lookups --------

# the quat / spatial functions held on the card: (module, name, argument
# names of libcd_inputs or constants, keyword arguments, one comparison
# kind per output: "v" values, "ang" angles modulo 2π, "q" quaternions up
# to sign (quat_from_R's candidate choice may flip in float32 at a tie),
# "pose" values and such a quaternion, "xyzypr" values and angles)
LIBCD_V = (0.3, -0.2, 0.7)
LIBCD_K = (0.1, 0.2, -0.3, 0.927361849549570)
LIBCD_SPRING = dict(Klin=10.0, Blin=2.0, Kang=5.0, Bang=0.5)
LIBCD_CASES = [
    ("quat", "quat_identity", (), {}, ("v",)),
    ("quat", "pose_identity", (), {}, ("v",)),
    ("quat", "quat_flip_closerto", ("q", "t"), {}, ("v",)),
    ("quat", "pose_flip_closerto", ("pose", "pose_t"), {}, ("v",)),
    ("quat", "quat_compose", ("q", "q2"), {}, ("v",)),
    ("quat", "quat_rotate_const", ("q", LIBCD_V), {}, ("v",)),
    ("quat", "quat_compose_const", ("q", LIBCD_K), {}, ("v",)),
    ("quat", "pose_compose", ("pose", "pose2"), {}, ("v",)),
    ("quat", "pose_rotate_vec", ("pose", "v"), {}, ("v",)),
    ("quat", "quat_invert", ("q",), {}, ("v",)),
    ("quat", "quat_from_R", ("R",), {}, ("q",)),
    ("quat", "pose_to_H", ("pose",), {}, ("v",)),
    ("quat", "pose_from_H", ("H",), {}, ("pose",)),
    ("quat", "pose_from_dR", ("pos", "R"), {}, ("pose",)),
    ("quat", "quat_from_axisangle", ("axis", "angle"), {}, ("v",)),
    ("quat", "quat_to_axisangle", ("q",), {}, ("v", "v")),
    ("quat", "quat_to_ypr", ("q",), {}, ("ang",)),
    ("quat", "pose_to_xyzypr", ("pose",), {}, ("xyzypr",)),
    ("quat", "quat_to_ypr_J", ("q",), {}, ("v",)),
    ("quat", "pose_to_xyzypr_J", ("pose",), {}, ("v",)),
    ("quat", "quat_from_ypr", ("ypr",), {}, ("v",)),
    ("quat", "pose_from_xyzypr", ("xyzypr",), {}, ("v",)),
    ("quat", "axisangle_rotate", ("axis", "angle", "v"), {}, ("v",)),
    ("quat", "axisangle_to_R", ("axis", "angle"), {}, ("v",)),
    ("quat", "pose_to_dR", ("pose",), {}, ("v", "v")),
    ("quat", "pose_to_pos_quat", ("pose",), {}, ("v", "v")),
    ("quat", "pose_from_pos_quat", ("pos", "q"), {}, ("v",)),
    ("quat", "pose_from_op", ("pos", "to"), {}, ("pose", "v")),
    ("quat", "pose_from_op_diff", ("pos", "d"), {}, ("pose", "v")),
    ("spatial", "cross_mat", ("v",), {}, ("v",)),
    ("spatial", "xm_from_pose", ("pose",), {}, ("v",)),
    ("spatial", "xm_to_pose", ("xm",), {}, ("pose",)),
    ("spatial", "xf_from_pose", ("pose",), {}, ("v",)),
    ("spatial", "xf_to_pose", ("xf",), {}, ("pose",)),
    ("spatial", "inertia_x", ("pose", "I6"), {}, ("v",)),
    ("spatial", "pose_from_spavel_unittime", ("twist",), {}, ("v",)),
    ("spatial", "H_from_spavel_unittime", ("twist",), {}, ("v",)),
    ("spatial", "x_invert", ("m6",), {}, ("v",)),
    ("spatial", "v_to_pos", ("six", "v"), {}, ("v",)),
    ("spatial", "v_from_pos", ("six", "v"), {}, ("v",)),
    ("spatial", "f_to_pos", ("six", "v"), {}, ("v",)),
    ("spatial", "f_from_pos", ("six", "v"), {}, ("v",)),
    ("spatial", "pose_jac", ("pose",), {}, ("v",)),
    ("spatial", "pose_jac_inverse", ("pose",), {}, ("v",)),
    ("spatial", "inertia_from_com", ("mass", "pos", "Icom"), {}, ("v",)),
    ("spatial", "inertia_to_com", ("I6",), {}, ("v", "v", "v")),
    ("spatial", "inertia_sphere_solid", ("pos", "mass", "radius"), {},
     ("v",)),
    ("spatial", "vxIv", ("six", "I6"), {}, ("v",)),
    ("spatial", "spring_damper", ("pose", "six", "pose_r", "six2"),
     LIBCD_SPRING, ("v",)),
    ("spatial", "mat_crossf", ("six",), {}, ("v",)),
    ("spatial", "mat_crossm", ("six",), {}, ("v",)),
]


def libcd_inputs(torch, np, n, seed=3):
    """n seeded inputs of each kind, float64 numpy rounded through float32
    (the card's float32 and the CPU's float64 read the same numbers).
    Quaternions are unit, with |sin(pitch)| < 0.99 and |qw| < 0.99 (off
    the gimbal lock, where the ypr Jacobian's 1/cos(pitch) grows, and off
    the axis-angle map's small-angle end); a flip target is at
    least 0.01 from the tie q·t = 0, a spring reference's error rotation
    is not the identity (|q·rq| < 0.99), and pose_from_op's direction is
    at least 0.01 from its branch |z_x| = 0.9."""
    from or_cdchomp_tpu_torch.ops import quat as tq
    from or_cdchomp_tpu_torch.ops import spatial as ts

    rng = np.random.default_rng(seed)

    def unit(a):
        return a / np.linalg.norm(a, axis=-1, keepdims=True)

    def quats():
        q = unit(rng.normal(size=(4 * n, 4)))
        s2 = 2.0 * (q[:, 3] * q[:, 1] - q[:, 2] * q[:, 0])
        return q[(np.abs(s2) < 0.99) & (np.abs(q[:, 3]) < 0.99)][:n]

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64)

    q, q2 = quats(), quats()
    dot = np.abs(np.sum(q * q2, axis=-1))[:, None]
    turn = tq.quat_compose_const(t64(q), [np.sin(np.pi / 4), 0.0, 0.0,
                                          np.cos(np.pi / 4)]).numpy()
    d = rng.normal(size=(n, 3))
    zx = np.abs(d[:, 0]) / np.linalg.norm(d, axis=-1)
    d[np.abs(zx - 0.9) < 0.01] = (0.0, 0.0, 1.0)
    pos, pos2 = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    A = rng.normal(size=(n, 3, 3))
    raw = dict(q=q, q2=q2, t=np.where(dot > 0.01, q2, -q),
               rq=np.where(dot < 0.99, q2, turn), pos=pos, pos2=pos2,
               v=rng.normal(size=(n, 3)), d=d, to=pos + d,
               axis=unit(rng.normal(size=(n, 3))),
               angle=rng.uniform(-np.pi, np.pi, size=n),
               ypr=rng.uniform(-3.0, 3.0, size=(n, 3)),
               six=rng.normal(size=(n, 6)), six2=rng.normal(size=(n, 6)),
               twist=rng.normal(size=(n, 6)), m6=rng.normal(size=(n, 6, 6)),
               mass=rng.uniform(0.5, 3.0, size=n),
               radius=rng.uniform(0.1, 0.5, size=n),
               Icom=A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(3))
    raw["pose"] = np.concatenate([pos, q], axis=-1)
    raw["pose2"] = np.concatenate([pos2, q2], axis=-1)
    raw["pose_t"] = np.concatenate([pos2, raw["t"]], axis=-1)
    raw["pose_r"] = np.concatenate([pos2, raw["rq"]], axis=-1)
    raw["xyzypr"] = np.concatenate([pos, raw["ypr"]], axis=-1)
    pose = t64(raw["pose"])
    raw.update(R=tq.quat_to_R(t64(q)).numpy(), H=tq.pose_to_H(pose).numpy(),
               xm=ts.xm_from_pose(pose).numpy(),
               xf=ts.xf_from_pose(pose).numpy(),
               I6=ts.inertia_from_com(t64(raw["mass"]), t64(pos),
                                      t64(raw["Icom"])).numpy())
    return {k: v.astype(np.float32).astype(np.float64) for k, v in raw.items()}


def libcd_err(torch, got, want, kind):
    """max |got − want| / max(1, |want|) over the comparison ``kind``."""
    g, w = got.double().cpu(), want
    check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
    d = g - w
    if kind in ("ang", "xyzypr"):
        a = d[..., -3:] if kind == "xyzypr" else d
        a = torch.remainder(a + math.pi, 2 * math.pi) - math.pi
        d = torch.cat([d[..., :-3], a], dim=-1) if kind == "xyzypr" else a
    if kind in ("q", "pose"):
        qd = torch.minimum((g[..., -4:] - w[..., -4:]).abs().amax(-1),
                           (g[..., -4:] + w[..., -4:]).abs().amax(-1))
        rest = (d[..., :-4].abs() / w[..., :-4].abs().clamp(min=1.0))
        return max(float(qd.max()),
                   float(rest.max()) if rest.numel() else 0.0)
    return float((d.abs() / w.abs().clamp(min=1.0)).max())


def libcd_math(torch, np, device, n=LIBCD_N):
    """Every function of LIBCD_CASES on ``device`` in float32 against the
    port's CPU float64 on the same n inputs: {name: worst error}."""
    from or_cdchomp_tpu_torch.ops import quat as tq
    from or_cdchomp_tpu_torch.ops import spatial as ts

    inp = libcd_inputs(torch, np, n)
    worst = {}
    for mod, name, args, kw, kinds in LIBCD_CASES:
        fn = getattr(tq if mod == "quat" else ts, name)
        outs = []
        for dev, dt in ((device, torch.float32), ("cpu", torch.float64)):
            a = [torch.as_tensor(inp[k], dtype=dt, device=dev)
                 if isinstance(k, str) else np.asarray(k) for k in args]
            out = fn(*a, **kw) if a else fn(dtype=dt, device=dev)
            outs.append(out if isinstance(out, tuple) else (out,))
        check(len(outs[0]) == len(kinds), f"{name}: {len(outs[0])} outputs")
        worst[name] = max(libcd_err(torch, g, w, k)
                          for g, w, k in zip(*outs, kinds))
    return worst


def record_lookups(sdf_lookup):
    """Swap ``sdf_lookup.sdf_cell_lookup`` for a recorder of its calls
    (data, sub, nbr, cells); returns (calls, restore)."""
    calls, inner = [], sdf_lookup.sdf_cell_lookup

    def rec(data, sub, nbr):
        out = inner(data, sub, nbr)
        calls.append((data, sub, nbr, out))
        return out

    sdf_lookup.sdf_cell_lookup = rec

    def restore():
        sdf_lookup.sdf_cell_lookup = inner

    return calls, restore


def sphere_queries(torch, engine, probs, moved_in=False):
    """The batch's moving sphere centres in each field's frame, (B, m, S,
    F, 3): multigrid_interp_grad's queries on a path's own inputs; with
    ``moved_in`` the cloud is centred at (0.2, 0.2, 0.8) as
    moved_in_args centres it, inside config 2's three fields."""
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops.quat import pose_apply

    _, x_mov, _, _ = cost_soa.sphere_kinematics(engine.spec, engine.fk,
                                                probs)
    xw = x_mov.permute(3, 1, 2, 0)                       # (B, m, S, 3)
    if moved_in:
        xw = xw - xw.mean(dim=(0, 1, 2)) + torch.tensor(
            [0.2, 0.2, 0.8], device=xw.device)
    pg = probs.pose_gsdf_world[:, None, None]            # (B, 1, 1, F, 7)
    return pose_apply(pg, xw[..., None, :]).contiguous()


def cold_ring(args):
    """A callable that returns a copy of the tensors ``args`` per call,
    in turn from a ring whose other copies hold more than twice
    L2_BYTES, so each call finds its copy evicted from L2."""
    size = sum(a.numel() * a.element_size() for a in args)
    ring = [args] + [tuple(a.clone() for a in args)
                     for _ in range(1 + 2 * L2_BYTES // size)]
    it = itertools.cycle(ring)
    return lambda: next(it)


def multigrid_on_card(torch, grid, sdf_lookup, fields, p, label, card,
                      timed=True):
    """multigrid_interp_grad on the card at p (..., F, 3): one launch of
    K1's raw lookup, its cells bit-equal to sdf_cell_lookup_ref, value
    and gradient against the CPU float64 call where both read the same
    cells; if ``timed``, the kernel, its plain version, the one-gather
    library call and the whole call timed, and the kernel's entry of the
    JSON line returned; the kernel, its plain version and the library
    call read their inputs cold (cold_ring), as bound_ms counts them."""
    args = (fields.data, fields.sizes, fields.lengths)
    calls, restore = record_lookups(sdf_lookup)
    try:
        sdf_lookup.LOOKUP_LAUNCHES = 0
        v, g, inb = grid.multigrid_interp_grad(*args, p)
        launches = sdf_lookup.LOOKUP_LAUNCHES
        cpu = [a.cpu() for a in args]
        v64, g64, inb64 = grid.multigrid_interp_grad(
            cpu[0].double(), cpu[1], cpu[2].double(), p.cpu().double())
    finally:
        restore()
    check(launches == 1 and len(calls) == 2,
          f"{label}: {launches} lookup launches, {len(calls)} lookups")
    data, sub, nbr, cells = calls[0]
    err = compare(torch, f"{label} cells", torch.stack(cells),
                  torch.stack(sdf_lookup.sdf_cell_lookup_ref(data, sub, nbr)),
                  exact=True)
    F, Q = sub.shape[:2]

    def fq(t):                                   # (..., F) → (F, Q)
        return t.reshape(-1, F).T.cpu()

    same = ((sub.cpu() == calls[1][1]).all(-1)
            & (nbr.cpu() == calls[1][2]).all(-1) & (fq(inb) == fq(inb64)))
    fin = torch.isfinite(fq(v64))
    check(bool((torch.isfinite(fq(v)) == fin)[same].all()),
          f"{label}: +inf reads differ from the CPU's")
    def worst(t):                                # 0 for no element
        return float(t.max()) if t.numel() else 0.0

    dv = worst((fq(v).double() - fq(v64))[same & fin].abs())
    dg = worst(fq((g.double().cpu() - g64).abs().amax(dim=-1))[same])
    other = 1.0 - float(same.double().mean())
    print(f"{label}: multigrid_interp_grad at {tuple(p.shape)}, {launches} "
          f"launch of sdf_cell_lookup_kernel, cells bit-equal to the plain "
          f"version; against CPU float64 on the {int(same.sum())} (field, "
          f"query) reading the same cells: max |Δvalue| {dv}, max |Δgrad| "
          f"{dg} (bar {GRID_BAR}); {other:.2e} of them read other cells "
          f"(bar {GRID_OTHER}); {int(fq(inb).sum())} in a box, "
          f"{int((~fin & fq(inb64)).sum())} of those read +inf")
    check(dv <= GRID_BAR and dg <= GRID_BAR, f"{label}: value {dv}, "
          f"gradient {dg} beyond {GRID_BAR}")
    check(other <= GRID_OTHER, f"{label}: {other} read other cells")
    if not timed:
        return None

    flat = data.reshape(F, -1)
    _, mx, my, mz = data.shape

    def idx(x, y, z):
        return (x.long() * my + y) * mz + z

    (sx, sy, sz), (nx, ny, nz) = sub.unbind(-1), nbr.unbind(-1)
    gidx = torch.stack([idx(sx, sy, sz), idx(nx, sy, sz), idx(sx, ny, sz),
                        idx(sx, sy, nz)], dim=1).reshape(F, 4 * Q)
    lib = torch.gather(flat, 1, gidx).reshape(F, 4, Q).transpose(0, 1)
    check(torch.equal(lib, torch.stack(cells)),
          f"{label}: the one-gather library call reads other cells")
    # timed cold, as bound_ms counts the bytes from device memory: each
    # call reads its own copy of the inputs from a ring of copies
    kin, lin = cold_ring((data, sub, nbr)), cold_ring((flat, gidx))

    def library():
        f, i = lin()
        return torch.gather(f, 1, i)

    t = timings(torch, lambda: sdf_lookup.sdf_cell_lookup(*kin()),
                lambda: sdf_lookup.sdf_cell_lookup_ref(*kin()))
    lib_ms = device_ms(torch, library)
    if lib_ms is None:
        lib_ms = graph_ms(torch, library)
    lib_call = time_ms(torch, library, reps=5)
    whole = time_ms(torch, lambda: grid.multigrid_interp_grad(*args, p),
                    reps=5)
    nbytes = (data.element_size() * (F * mx * my * mz + 4 * F * Q)
              + 4 * 2 * F * Q * 3)
    e = kernel_entry(label, "or_cdchomp_tpu_torch/csrc/obstacle.cu",
                     "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t, nbytes,
                     0)
    e["launches"] = launches
    e["library_ms"] = lib_ms          # None where neither gave a device time
    print(f"{label}: inputs cold; kernel device {e['ms']} ms (per call "
          f"{t[0]:.4f} ms), "
          f"plain {e['plain_ms']} ms, one torch.gather {e['library_ms']} ms "
          f"(per call {lib_call:.4f} ms), bound {e['bound_ms']} ms (bytes), "
          f"share {e['bound_share']:.4f}; the whole multigrid_interp_grad "
          f"call {whole:.4f} ms per call, on {card}")
    return e


def libcd_phase(torch, pt, card, dev, engine, probs, eng2, probs2):
    """The libcd math library on the card: every new quat / spatial
    function in float32 on LIBCD_N seeded inputs against the CPU's
    float64; the per-problem FK (fk_spheres, apply_sphere_jacT) at config
    1's B × m configurations against fk_soa / apply_sphere_jacT_soa; and
    multigrid_interp_grad on config 1's field and config 2's three at the
    batches' sphere centres, with one launch of K1's raw lookup each
    (counts zeroed just before, read just after).  Returns the lookup's
    entries of the JSON line."""
    import numpy as np

    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import grid, sdf_lookup, selfcol

    t0 = time.perf_counter()
    worst = libcd_math(torch, np, dev)
    t_math = time.perf_counter() - t0
    bad = {k: v for k, v in worst.items() if not v <= LIBCD_BAR}
    print(f"libcd math: {len(worst)} functions on {LIBCD_N} inputs, card "
          f"float32 against CPU float64, worst max |Δ| / max(1, |value|): "
          + ", ".join(f"{k} {v:.2e}" for k, v in sorted(worst.items())))
    check(not bad, f"libcd math beyond {LIBCD_BAR}: {bad}")

    fk = engine.fk
    lo, m = engine.mov_lo, engine.spec.m
    q = probs.traj[:, lo:lo + m]                          # (B, m, n)
    base = probs.robot_pose[:, None]                      # (B, 1, 7)
    x, jac, _ = fk.fk_spheres(q, base)
    _, anchors = fk.red_poses(q, base)
    fk_out, x_mov, _, _ = cost_soa.sphere_kinematics(engine.spec, fk, probs)
    dx = float((x - x_mov.permute(3, 1, 2, 0)).abs().max())
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    w = torch.randn(tuple(x.shape), generator=gen, device=dev)
    g = fk.apply_sphere_jacT(anchors, x, w)               # (B, m, D)
    g_soa = fk.apply_sphere_jacT_soa(
        fk_out.anch_pos[:, lo:lo + m], fk_out.axis_w[:, lo:lo + m], x_mov,
        w.permute(3, 1, 2, 0)).permute(2, 0, 1)
    scale = float(g_soa.abs().max())
    dg = float((g - g_soa).abs().max()) / scale
    dj = float((torch.einsum("bmsci,bmsc->bmi", jac, w) - g).abs().max()) \
        / scale
    print(f"per-problem FK at {tuple(q.shape)}: fk_spheres against fk_soa "
          f"max |Δx| {dx} m (bar {FK_BAR}); apply_sphere_jacT against "
          f"apply_sphere_jacT_soa {dg} and against the Jacobians' "
          f"contraction {dj}, relative to max |G| {scale} (bar {JACT_RTOL})")
    check(dx <= FK_BAR, f"fk_spheres vs fk_soa: {dx}")
    check(dg <= JACT_RTOL and dj <= JACT_RTOL,
          f"apply_sphere_jacT: {dg}, {dj}")
    t_fk = time.perf_counter() - t0 - t_math

    # config 2's arm stays outside its three field boxes (every query
    # reads +inf), so its cloud is also moved into them; that call is timed
    p1 = sphere_queries(torch, engine, probs)
    p2 = sphere_queries(torch, eng2, probs2)
    p2_in = sphere_queries(torch, eng2, probs2, moved_in=True)
    counts_zero(sdf_lookup, selfcol)
    entries = [multigrid_on_card(torch, grid, sdf_lookup, engine.fields, p1,
                                 "sdf_cell_lookup", card)]
    multigrid_on_card(torch, grid, sdf_lookup, eng2.fields, p2,
                      "config 2 sphere centres", card, timed=False)
    entries.append(multigrid_on_card(torch, grid, sdf_lookup, eng2.fields,
                                     p2_in, "sdf_cell_lookup_f3", card))
    check(counts(sdf_lookup, selfcol) == {"obstacle": 0, "selfcol": 0,
                                          "fk_soa": 0},
          "multigrid_interp_grad launched K1's obstacle kernel, K2 or the FK")
    wall = time.perf_counter() - t0
    print(f"libcd math phase: {wall:.2f} s on {card} (functions "
          f"{t_math:.2f} s, FK {t_fk:.2f} s, lookups "
          f"{wall - t_math - t_fk:.2f} s)")
    return entries


def float64_phase(torch, pt, card, dev):
    """float64 on the card: config 1's world through
    CHOMPModule(dtype=float64) on the card and on the CPU, one field
    shared through a cache file; runchomp (n_points 101, 100 iterations),
    a B = 4 BatchSolver batch and multigrid_interp_grad at the batch's
    sphere centres, the card against the CPU within F64_TRAJ_BAR /
    F64_COST_RTOL / F64_GRID_BAR.  On the card they run K1's, K2's and
    the raw lookup's float64 kernels (counts zeroed just before the
    card's calls, read just after: one K1 and one K2 launch per step,
    one lookup launch); then each kernel is held to its plain version
    on the batch's inputs and timed, and the limits kernel at config 1's
    shape (B = 256) with rows pushed out.  Returns the four kernel
    entries."""
    import numpy as np

    from or_cdchomp_tpu_torch.ops import grid, limits, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    f64 = torch.float64
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache = CACHE_DIR / "f64_table.dat"
    cache.unlink(missing_ok=True)
    starts, goals = bench_endpoints(F64_BATCH)
    res = []
    for where in (dev, torch.device("cpu")):        # the card first
        mod, robot = config1_world(pt, f64, where)
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.04,
                                 cache_filename=str(cache),
                                 require_cache=bool(res))
        robot.enabled = True
        counts_zero(sdf_lookup, selfcol)
        sdf_lookup.LOOKUP_LAUNCHES = 0
        walls = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cost = [0.0]
        traj = mod.runchomp(n_iter=N_ITER, cost=cost, **run_kw())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        run = mod.runs[mod.create(**run_kw())]
        check(run.problem.traj.dtype == f64
              and run.problem.traj.device.type == where.type,
              f"float64 run on {where}: {run.problem.traj.dtype}")
        probs = problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)
        t0 = time.perf_counter()
        out, costs = BatchSolver(run.engine).iterate(probs, N_ITER)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        fields = run.engine.fields
        p = sphere_queries(torch, run.engine, out)
        t0 = time.perf_counter()
        v, g, inb = grid.multigrid_interp_grad(fields.data, fields.sizes,
                                               fields.lengths, p)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = dict(counts(sdf_lookup, selfcol),
                        lookup=sdf_lookup.LOOKUP_LAUNCHES,
                        limits=limits.LAUNCHES)
        res.append((traj, cost[0], out, costs, (v, g, inb), walls,
                    launches, (run, p)))
    (traj, cost, out, costs, grid_out, walls, launches, (run, p)) = res[0]
    eng = run.engine
    (traj_c, cost_c, out_c, costs_c, grid_c, walls_c, _, _) = res[1]
    steps = launches["obstacle"]
    print(f"float64 on the card: launches {launches} (runchomp's and the "
          f"batch's {2 * N_ITER} steps and checks, one lookup; the FK "
          f"besides once for runchomp's trajectory check and once for the "
          f"lookup's queries)")
    check(steps >= 2 * N_ITER and launches["selfcol"] == steps
          and launches["fk_soa"] == steps + 2
          and launches["lookup"] == 1 and launches["limits"] == 2 * N_ITER,
          f"float64 on the card: launches {launches}")
    d_run = float(np.abs(traj.positions - traj_c.positions).max())
    d_cost = abs(cost - cost_c) / abs(cost_c)
    check(traj.in_collision == traj_c.in_collision is False,
          "float64 runchomp: collision verdicts")
    d_batch = float((out.traj.cpu() - out_c.traj).abs().max())
    # each cost kind (total, obstacle + self, smoothness) relative to its
    # largest value, as the tests' close() holds costs
    d_bcost = float(((costs.cpu() - costs_c).abs() / costs_c.abs().amax(
        dim=(0, 1)).clamp(min=1e-300)).max())
    v, gr, inb = (t.cpu() for t in grid_out)
    vc, gc, inbc = grid_c
    fin = torch.isfinite(vc)
    check(torch.equal(inb, inbc) and torch.equal(fin, torch.isfinite(v))
          and bool(fin.any()), "float64 multigrid: in-bounds / finite sets")
    d_grid = max(float(((v - vc).abs() / vc.abs().clamp(min=1.0))[fin].max()),
                 float((gr - gc).abs().max() / gc.abs().max().clamp(min=1.0)))
    print(f"float64 runchomp (n_points {N_POINTS}, {N_ITER} iterations): "
          f"card {walls[0]} s, CPU {walls_c[0]} s; max |Δtraj| {d_run} (bar "
          f"{F64_TRAJ_BAR}), final cost {cost} vs {cost_c}, rel {d_cost} "
          f"(bar {F64_COST_RTOL}) on {card}")
    print(f"float64 BatchSolver.iterate({N_ITER}) at B={F64_BATCH}: card "
          f"{walls[1]} s, CPU {walls_c[1]} s; max |Δtraj| {d_batch}, max "
          f"relative |Δcost| {d_bcost} on {card}")
    print(f"float64 multigrid_interp_grad at {int(fin.numel())} (query, "
          f"field) sphere centres: card {walls[2]} s, CPU {walls_c[2]} s; "
          f"max |Δ| / max(1, |v|) {d_grid} (bar {F64_GRID_BAR}) on {card}")
    check(d_run <= F64_TRAJ_BAR and d_batch <= F64_TRAJ_BAR,
          f"float64 card vs CPU: max |Δtraj| {d_run}, {d_batch}")
    check(d_cost <= F64_COST_RTOL and d_bcost <= F64_COST_RTOL,
          f"float64 card vs CPU: relative |Δcost| {d_cost}, {d_bcost}")
    check(d_grid <= F64_GRID_BAR, f"float64 multigrid: {d_grid}")

    # -- the float64 kernels against their plain versions ----------------------
    entries = kernels_at(torch, sdf_lookup, selfcol, eng, out, "f64", card)
    entries.append(multigrid_on_card(torch, grid, sdf_lookup, eng.fields, p,
                                     "sdf_cell_lookup_f64", card))
    s256, g256 = bench_endpoints(BATCH)
    p256 = problem_batch_from_grid(run.problem, s256, g256, eng)
    T = p256.traj[:, 1:-1]
    lo, hi = p256.jlimit_lower, p256.jlimit_upper
    entries.append(limits_entry(torch, "limit_repair_f64",
                                pushed_out(torch, T, lo, hi), lo, hi,
                                eng.Ainv, card, max_ill=0))
    for e, k in zip(entries, ("obstacle", "selfcol", "lookup", "limits")):
        e["launches"] = launches[k]
    return entries


def script_child(path):
    """``--script PATH``: run one of the port's scripts as __main__ with
    its defaults, the kernel launch counts zeroed before it; print its
    wall and the counts as a JSON line last."""
    import runpy

    sys.path.insert(0, str(ROOT))
    import torch

    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol

    counts_zero(sdf_lookup, selfcol)
    sys.argv = [path]
    t0 = time.perf_counter()
    runpy.run_path(str(ROOT / path), run_name="__main__")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(json.dumps({"wall_s": wall, "launches": counts(sdf_lookup,
                                                         selfcol)}))
    return 0


def scripts_phase(card):
    """The port's five scripts (SCRIPTS), one child process each
    (``--script``) on the card at the script's own default size: exit
    code 0, the script's wall inside its process and its K1 and K2
    launches, both > 0."""
    for name in ("wam7_demo_sdf.npy", "demo_sdf_table.npy"):
        (CACHE_DIR / name).unlink(missing_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    t_all = time.perf_counter()
    for path in SCRIPTS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                               "--script", path], cwd=ROOT, env=env,
                              capture_output=True, text=True,
                              timeout=SCRIPT_TIMEOUT)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        for line in lines[:-1]:
            print(f"  {path}: {line}")
        check(proc.returncode == 0,
              f"{path} exited {proc.returncode}: {proc.stderr[-2000:]}")
        got = json.loads(lines[-1])
        print(f"script {path}: exit 0, {got['wall_s']} s inside its process "
              f"({wall} s with the process start), launches "
              f"{got['launches']} on {card}")
        check(all(v > 0 for v in got["launches"].values()),
              f"{path}: a kernel was not launched: {got['launches']}")
    print(f"scripts phase: {time.perf_counter() - t_all} s")


# ---- one process over several devices ---------------------------------------

def sync_all(torch):
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def in_turns(torch, fns, reps):
    """Warm walls of each of ``fns`` ({label: call}), taken in turns
    (every card synchronised around each call); {label: walls}."""
    walls = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            sync_all(torch)
            t0 = time.perf_counter()
            fn()
            sync_all(torch)
            walls[k].append(time.perf_counter() - t0)
    return walls


def print_rates(walls, batch, what, card):
    """solves/s from the median wall of each label, with the spread."""
    for k, w in walls.items():
        med = statistics.median(w)
        print(f"{what}, {k}: median warm wall {med} s of {w} (spread "
              f"{min(w)} - {max(w)} s), {batch / med} solves/s "
              f"({batch / max(w)} - {batch / min(w)}) on {card}")


def layout_entry(torch, selfcol, pairs, Sa, So, name, card):
    """The pair-layout kernel on a pair table against its plain version
    on the card (bit-equal), timed; its kernel entry (launches unset)."""
    got = selfcol.pair_layout(*pairs, Sa, So)
    want = selfcol.pair_layout_ref(*pairs, Sa, So)
    err = max(compare(torch, f"{name} {k}", g, w, exact=True)
              for k, g, w in zip(("masks", "partners", "rs"), got, want))
    t = timings(torch, lambda: selfcol.pair_layout(*pairs, Sa, So),
                lambda: selfcol.pair_layout_ref(*pairs, Sa, So))
    P = pairs[0].shape[0]
    # no PyTorch call computes the layout (a sort, a scatter and bit
    # packing at the least)
    entry = kernel_entry(
        name, "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.layout_traffic_bytes(P, Sa, So, pairs[2].element_size()), 0)
    print(f"{name} (P={P}, Sa={Sa}, So={So}): bit-equal to its plain "
          f"version; per call {t[0]:.4f} ms vs plain {t[1]:.4f} ms; device "
          f"{entry['ms']} ms vs plain {entry['plain_ms']} ms, bound "
          f"{entry['bound_ms']} ms ({entry['bound_by']}), share "
          f"{entry['bound_share']:.4f} on {card}")
    return entry


def replica_solve(torch, sdf_lookup, selfcol, make_solver, fn, steps,
                  label, limit_steps, probs):
    """Counts zeroed, then ``make_solver()`` (building any replica it
    lacks: one layout launch each) and ``fn(solver)``: the wrappers count
    K1 and K2 ``steps`` times and the limits kernel ``limit_steps`` times
    for every replica.  Then, measured, the solver's iterate(PROBE_STEPS)
    of ``probs`` under the profiler (launches_by_card): on each card, K1,
    K2 and the limits kernel PROBE_STEPS times for each part there, and
    the draw as often on a seeded HMC batch; and each replica with rows
    holds its own step graphs.  Returns (solver, fn's result, the
    wrappers' counts of fn (K1, K2, layout, draw), wall)."""
    from or_cdchomp_tpu_torch.ops import draw

    counts_zero(sdf_lookup, selfcol, draw)
    selfcol.LAYOUT_LAUNCHES = 0
    sync_all(torch)
    t0 = time.perf_counter()
    solver = make_solver()
    out = fn(solver)
    sync_all(torch)
    wall = time.perf_counter() - t0
    launches = dict(counts(sdf_lookup, selfcol),
                    selfcol_layout=selfcol.LAYOUT_LAUNCHES,
                    draw=draw.LAUNCHES)
    devs = [str(d) for d in solver.devices]
    print(f"{label}: {len(devs)} replicas on {devs}, launches {launches}, "
          f"{wall:.3f} s (first call, replicas built)")
    check(launches["obstacle"] == launches["selfcol"] == launches["fk_soa"]
          == steps * len(devs), f"{label}: launches {launches}")
    check_launches({}, steps, label, steps=limit_steps * len(devs))

    parts = [i for i, _, _ in solver._placement(int(probs.traj.shape[0]))]
    seeded = solver.engine.spec.use_hmc and probs.hmc_seed is not None
    want = {}
    for i in parts:
        n = want.setdefault(solver.devices[i].index, {
            "obstacle": 0, "selfcol": 0, "limits": 0, "draw": 0})
        for k in n:
            n[k] += PROBE_STEPS if k != "draw" or seeded else 0
    cards, counted = launches_by_card(
        torch, lambda: solver.iterate(probs, PROBE_STEPS),
        f"{label} iterate({PROBE_STEPS})")
    graphs = [id(solver.replicas[i].__dict__.get("_graphs")) for i in parts]
    print(f"{label}: iterate({PROBE_STEPS}) launched {cards} by card "
          f"(profiler events by kernel name; expected {want}, the draw's "
          f"eager launches not held), the wrappers counted {counted}; "
          f"{len(set(graphs))} replicas' own step graphs for {len(parts)} "
          f"parts")

    def replayed(by_card):
        return {i: {k: c[k] for k in REPLAYED_KERNELS}
                for i, c in by_card.items()}

    total = {k: sum(c[k] for c in want.values()) for k, _ in STEP_KERNELS}
    check(replayed(cards) == replayed(want) and counted == total,
          f"{label}: launches by card {cards}, counted {counted}, expected "
          f"{want}")
    check(len(set(graphs)) == len(parts)
          and all(solver.replicas[i].__dict__.get("_graphs") for i in parts),
          f"{label}: the parts' replicas do not each hold their own graphs")
    return solver, out, launches, wall


def same_solve(torch, label, got, want):
    """A split solve against one device's: the state of every row
    bit-equal (trajectory, iteration, HMC schedule); the costs within
    SPLIT_COST_RTOL of their largest value (each row's cost is a sum over
    its (point, sphere) terms, reduced over an (m, S, B) tensor whose
    reduction order on the card depends on B), bit-equality printed."""
    (out, fin), (out1, fin1) = got, want
    for k in ("traj", "iteration", "resample_iter", "leapfrog_first"):
        a, b = getattr(out, k), getattr(out1, k)
        check(torch.equal(a, b), f"{label}: {k} differs from one device "
              f"(max {float((a.double() - b.double()).abs().max())})")
    d = float((fin.double() - fin1.double()).abs().max())
    scale = float(fin1.double().abs().max())
    print(f"{label}: every row's state bit-equal to one device's; costs "
          f"max |Δ| {d} of max |cost| {scale} (bar {SPLIT_COST_RTOL} "
          f"relative), bit-equal {torch.equal(fin, fin1)}")
    check(d <= SPLIT_COST_RTOL * scale, f"{label}: costs differ by {d}")


def unseeded_split(torch, pt, dev, devices, label):
    """Config 3's unseeded HMC batch (B = 256, every row drawing from the
    engine's generator) solve(100) on ``devices`` against devices=[dev],
    each arm from a fresh generator of seed 7 whose draws are recorded:
    the draws (one whole-batch draw per step on the engine's card, each
    part taking its rows to its own), every row's state and the resample
    schedule bit-equal to one device's."""
    from or_cdchomp_tpu_torch.chomp.solver import HmcDraw, RecordingDraw
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    run = config3_run(pt, torch.float32, dev)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    outs, recs = [], []
    for devs in ([dev], devices):
        eng.draw = RecordingDraw(HmcDraw(7, dev))
        outs.append(BatchSolver(eng, devices=devs).solve(probs, N_ITER))
        recs.append(eng.draw)
    check(len(recs[0].z) == len(recs[1].z) == N_ITER,
          f"{label}: {len(recs[0].z)} and {len(recs[1].z)} draws")
    for i, (a, b) in enumerate(zip(recs[0].z + recs[0].u,
                                   recs[1].z + recs[1].u)):
        check(tuple(a.shape) == tuple(b.shape) and torch.equal(a, b),
              f"{label}: draw {i} differs from one device's")
    nxt = outs[0][0].resample_iter
    print(f"{label}: {N_ITER} whole-batch draws of {tuple(recs[1].z[0].shape)}"
          f" bit-equal to one device's over {[str(d) for d in devices]}; "
          f"next resample at iterations {int(nxt.min())} - {int(nxt.max())}")
    same_solve(torch, label, outs[1][:2], outs[0][:2])


def devices_phase(torch, pt, card, dev, engine, probs):
    """Config 1's B = 256 solve(100) on devices=[dev, dev]: two replicas
    (the engine and a copy, built here: one layout launch) stepping 128
    rows each in turn on one card, K1 and K2 counted (101 each a replica)
    and measured by the profiler (replica_solve), every row bit-equal to
    devices=[dev]; the two walls in turns;
    config 3's unseeded HMC batch on devices=[dev, dev] (unseeded_split);
    the layout kernel at config 1's pair table against its plain
    version, timed.  Returns the layout kernel's entry."""
    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

    one = BatchSolver(engine, devices=[dev])
    out1, fin1, _ = one.solve(probs, N_ITER)
    solver, (out2, fin2, done2), launches, _ = replica_solve(
        torch, sdf_lookup, selfcol,
        lambda: BatchSolver(engine, devices=[dev, dev]),
        lambda s: s.solve(probs, N_ITER), N_ITER + 1,
        "devices phase, config 1 solve", N_ITER, probs)
    check(solver.replicas[0] is engine and solver.replicas[1] is not engine,
          "devices phase: replicas")
    check(launches["selfcol_layout"] == 1 and done2 == N_ITER,
          f"devices phase: {launches['selfcol_layout']} layout launches, "
          f"{done2} steps")
    check([p[1:] for p in solver._placement(BATCH)]
          == [(0, BATCH // 2), (BATCH // 2, BATCH)], "devices phase: rows")
    same_solve(torch, "devices phase", (out2, fin2), (out1, fin1))
    walls = in_turns(torch, {
        "devices=[dev]": lambda: one.solve(probs, N_ITER),
        "devices=[dev, dev]": lambda: solver.solve(probs, N_ITER)}, 3)
    print_rates(walls, BATCH, f"devices phase, config 1 solve({N_ITER})",
                card)
    unseeded_split(torch, pt, dev, [dev, dev],
                   "devices phase, config 3 unseeded")
    entry = layout_entry(torch, selfcol, engine.pairs,
                         engine.n_spheres_active, len(engine._sphere_order),
                         "selfcol_layout", card)
    entry["launches"] = launches["selfcol_layout"]
    return entry


def guard_phase(torch, pt, card, last):
    """Every kernel launched on the last card with cuda:0 current, each
    against its plain version on the same inputs: config 1's world
    through CHOMPModule(device=last), K1 (both paths) and K2's staged
    path at its B = 256 batch, K2's tiled path and K1 in float64 on the
    same inputs, the layout kernel on its pair table, the raw lookup at
    random cells, the draw on seeds arange(256), the limits kernel in
    float32 and float64 with rows pushed out, the FK kernel in float32
    and float64 at the batch's trajectories; then two steps of the
    engine there (its first step eager, the second a graph replay)."""
    import numpy as np

    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.models.robot import CompiledFK
    from or_cdchomp_tpu_torch.ops import draw, fk, limits, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    torch.cuda.set_device(0)
    _, run = bench_module(pt, torch.float32, last)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    _, x, vel, acc = cost_soa.sphere_kinematics(eng.spec, eng.fk, probs)
    check(x.device == last and torch.cuda.current_device() == 0,
          f"guard: inputs on {x.device}, current "
          f"{torch.cuda.current_device()}")
    before = (sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES,
              selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES, draw.LAUNCHES,
              limits.LAUNCHES, fk.FK_LAUNCHES)
    oargs = obstacle_args(eng, probs, x, vel, acc)
    check_obstacle(torch, sdf_lookup, oargs, "guard obstacle")
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    sargs = (x, vel, xo, *eng.pairs, probs.epsilon_self,
             probs.obs_factor_self)
    check(selfcol.launch_shape(15, 1)[0] == "staged", "guard: K2 path")
    for g, w, k in zip(selfcol.selfcol_pairs(*sargs),
                       selfcol.selfcol_pairs_ref(*sargs), ("net", "cost")):
        compare(torch, f"guard selfcol staged {k}", g, w)
    d = [a.double() if a.is_floating_point() else a for a in sargs]
    layout = selfcol.pair_layout(*d[3:6], 15, 16)
    for g, w, k in zip(layout, selfcol.pair_layout_ref(*d[3:6], 15, 16),
                       ("masks", "partners", "rs")):
        compare(torch, f"guard layout f64 {k}", g, w, exact=True)
    got, want = (selfcol.selfcol_pairs(*d, layout),
                 selfcol.selfcol_pairs_ref(*d))
    for g, w, k in zip(got, want, ("net", "cost")):
        compare(torch, f"guard selfcol tiled f64 {k}", g, w,
                rtol=F64_KERNEL_RTOL)
    d1 = [a.double() if a.is_floating_point() else a for a in oargs]
    for g, w in zip(sdf_lookup.obstacle(*d1), sdf_lookup.obstacle_ref(*d1)):
        compare(torch, "guard obstacle f64", g, w, exact=True)
    for g, w, k in zip(selfcol.pair_layout(*eng.pairs, 15, 16),
                       selfcol.pair_layout_ref(*eng.pairs, 15, 16),
                       ("masks", "partners", "rs")):
        compare(torch, f"guard layout {k}", g, w, exact=True)
    rng = np.random.default_rng(5)
    F, mx, my, mz = eng.fields.data.shape
    Q = 100_000
    sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
    nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                  np.array([mx, my, mz]) - 1).astype(np.int32)
    largs = (eng.fields.data, torch.as_tensor(sub, device=last),
             torch.as_tensor(nbr, device=last))
    compare(torch, "guard sdf_cell_lookup",
            torch.stack(sdf_lookup.sdf_cell_lookup(*largs)),
            torch.stack(sdf_lookup.sdf_cell_lookup_ref(*largs)), exact=True)
    seed = torch.arange(BATCH, device=last)
    it = torch.full((BATCH,), 3, dtype=torch.int32, device=last)
    got = draw.hmc_draw(seed, it, eng.spec.m, eng.spec.n, torch.float32,
                        want_words=True)
    want = draw.hmc_draw_ref(seed, it, eng.spec.m, eng.spec.n,
                             torch.float32, want_words=True)
    for g, w, k in zip(got[2:], want[2:], ("z words", "u words")):
        compare(torch, f"guard draw {k}", g, w, exact=True)
    T, lo, hi = probs.traj[:, 1:-1], probs.jlimit_lower, probs.jlimit_upper
    T = pushed_out(torch, T, lo, hi)
    for dt, rtol in ((torch.float32, KERNEL_RTOL),
                     (torch.float64, F64_KERNEL_RTOL)):
        a = (T.to(dt), lo.to(dt), hi.to(dt), eng.Ainv.to(dt))
        compare(torch, f"guard limit_repair {dt}", limits.limit_repair(*a),
                limits.limit_repair_ref(*a), rtol=rtol)
    fk64 = CompiledFK(eng.fk.model, dtype=torch.float64,
                      sphere_subset=eng.fk.sphere_subset, device=last)
    for f, name in ((eng.fk, "guard fk_soa"), (fk64, "guard fk_soa f64")):
        fk_check(torch, name, f, probs.traj.to(f.dtype),
                 probs.robot_pose.to(f.dtype))
    out, costs = eng.iterate_batched(probs, 2)
    torch.cuda.synchronize(last)
    after = (sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES,
             selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES, draw.LAUNCHES,
             limits.LAUNCHES, fk.FK_LAUNCHES)
    made = [a - b for a, b in zip(after, before)]
    print(f"guard: on {last} with cuda:{torch.cuda.current_device()} "
          f"current, launches (K1, raw lookup, K2, layout, draw, limits, "
          f"FK) {made}: "
          f"K1 both paths and float64 bit-equal, K2 staged within "
          f"{KERNEL_RTOL} and tiled (float64) within {F64_KERNEL_RTOL}, "
          f"layout, lookup and draw words bit-equal to their plain "
          f"versions, limits and FK within {KERNEL_RTOL} / "
          f"{F64_KERNEL_RTOL}; two "
          f"steps there, costs finite {bool(torch.isfinite(costs).all())}")
    check(made == [5, 1, 4, 2, 1, 4, 4], f"guard: launches {made}")
    check(out.traj.device == last and bool(torch.isfinite(costs).all())
          and torch.cuda.current_device() == 0, "guard: the steps")


def cards_phase(torch, pt, card, ncards):
    """The port's BatchSolver over every card of the machine in one
    process (devices=[cuda:0, ..., cuda:N-1], its default), each part a
    replayed CUDA graph a step, against devices=[cuda:0]: config 1's
    B = 256 solve(100),
    config 3's seeded HMC batch (seeds arange(256)) with best_of_batch,
    each row bit-equal to one card and the step's kernels counted per card
    by the profiler (replica_solve);
    config 3's unseeded batch (unseeded_split); config 5 at B = 10,240,
    iterate(100), likewise; config 1's float64 B = 4 batch over two cards
    within F64_TRAJ_BAR of the CPU's float64; then solves/s for one card
    and for every card, in turns."""
    import numpy as np

    from or_cdchomp_tpu_torch.ops import sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     best_of_batch,
                                                     problem_batch_from_grid)

    devs = [torch.device("cuda", i) for i in range(ncards)]
    dev, f32 = devs[0], torch.float32
    _, run = bench_module(pt, f32, dev)
    eng = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, eng)
    default = BatchSolver(eng)
    print(f"cards: BatchSolver(engine) spreads over "
          f"{[str(d) for d in default.devices]}")
    check(default.devices == devs, f"cards: default devices "
          f"{default.devices}")
    del default
    one = BatchSolver(eng, devices=[dev])
    ref = one.solve(probs, N_ITER)
    many, got, _, _ = replica_solve(
        torch, sdf_lookup, selfcol,
        lambda: BatchSolver(eng, devices=devs),
        lambda s: s.solve(probs, N_ITER), N_ITER + 1,
        f"cards, config 1 solve({N_ITER}) at B={BATCH}", N_ITER, probs)
    same_solve(torch, "cards, config 1", got[:2], ref[:2])

    eng3, probs3 = seeded_hmc_batch(pt, f32, dev)
    one3 = BatchSolver(eng3, devices=[dev])
    ref3 = one3.solve(probs3, N_ITER)
    many3, got3, launches3, _ = replica_solve(
        torch, sdf_lookup, selfcol,
        lambda: BatchSolver(eng3, devices=devs),
        lambda s: s.solve(probs3, N_ITER), N_ITER + 1,
        f"cards, config 3 seeded solve({N_ITER}) at B={BATCH}", N_ITER,
        probs3)
    check(launches3["draw"] == ncards * N_ITER,
          f"cards, config 3: {launches3['draw']} draw launches")
    same_solve(torch, "cards, config 3 seeded", got3[:2], ref3[:2])
    idx, idx1 = best_of_batch(*got3[:2])[1], best_of_batch(*ref3[:2])[1]
    print(f"cards, config 3: best_of_batch index {int(idx)} (one card "
          f"{int(idx1)}), {launches3['draw']} draw launches")
    check(int(idx) == int(idx1), "cards, config 3: best index")
    unseeded_split(torch, pt, dev, devs, "cards, config 3 unseeded")

    starts5, goals5 = bench_endpoints(BATCH_POD)
    probs5 = problem_batch_from_grid(run.problem, starts5, goals5, eng)
    ref5 = one.iterate(probs5, N_ITER)
    _, got5, _, _ = replica_solve(
        torch, sdf_lookup, selfcol, lambda: many,
        lambda s: s.iterate(probs5, N_ITER), N_ITER,
        f"cards, config 5 iterate({N_ITER}) at B={BATCH_POD}", N_ITER, probs5)
    check(bool(torch.isfinite(got5[1]).all()), "cards, config 5: costs")
    same_solve(torch, "cards, config 5", (got5[0], got5[1][-1]),
               (ref5[0], ref5[1][-1]))
    del got5, ref5

    f64, cpu = torch.float64, torch.device("cpu")
    cache = CACHE_DIR / "f64_cards.dat"
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache.unlink(missing_ok=True)
    s4, g4 = bench_endpoints(F64_BATCH)
    outs = []
    for where in (dev, cpu):                       # the card first
        mod, robot = config1_world(pt, f64, where)
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.04,
                                 cache_filename=str(cache),
                                 require_cache=bool(outs))
        robot.enabled = True
        r64 = mod.runs[mod.create(**run_kw())]
        p64 = problem_batch_from_grid(r64.problem, s4, g4, r64.engine)
        if where == cpu:
            outs.append(BatchSolver(r64.engine).iterate(p64, N_ITER)[0])
            continue
        _, (o64, _), _, _ = replica_solve(
            torch, sdf_lookup, selfcol,
            lambda: BatchSolver(r64.engine, devices=devs[:2]),
            lambda s: s.iterate(p64, N_ITER), N_ITER,
            f"cards, float64 B={F64_BATCH} over two cards", N_ITER, p64)
        outs.append(o64)
    d = float((outs[0].traj.cpu() - outs[1].traj).abs().max())
    print(f"cards, float64 B={F64_BATCH} over two cards (K1<double>, K2 "
          f"tiled): max |Δtraj| against the CPU float64 {d} (bar "
          f"{F64_TRAJ_BAR})")
    check(d <= F64_TRAJ_BAR, f"cards, float64: max |Δtraj| {d}")

    walls = in_turns(torch, {
        "one card": lambda: one.iterate(probs, N_ITER),
        f"{ncards} cards (the default)": lambda: many.iterate(probs, N_ITER)},
        CARD_REPS)
    print_rates(walls, BATCH, f"cards, config 1 iterate({N_ITER}) at "
                f"B={BATCH}", card)
    walls = in_turns(torch, {
        "one card": lambda: one3.solve(probs3, N_ITER),
        f"{ncards} cards (the default)": lambda: many3.solve(probs3, N_ITER)},
        CARD_REPS)
    print_rates(walls, BATCH, f"cards, config 3 seeded solve({N_ITER}) at "
                f"B={BATCH}", card)
    walls = in_turns(torch, {
        "one card": lambda: one.iterate(probs5, N_ITER),
        f"{ncards} cards (the default)": lambda: many.iterate(probs5,
                                                              N_ITER)},
        CARD_REPS)
    print_rates(walls, BATCH_POD, f"cards, config 5 iterate({N_ITER}) at "
                f"B={BATCH_POD}", card)


def cards_main(ncards):
    """``chip_smoke.py --cards N``: on a machine of N >= 2 cards, the
    device-guard check on the last card, the one-process multi-card
    solves (cards_phase) and the same seeded batch over N processes, one
    per card (split_solve, the ``--split N`` reading)."""
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    check(torch.cuda.device_count() >= ncards >= 2,
          f"--cards {ncards} on {torch.cuda.device_count()} cards")
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.ops import kernels

    build_kernels(kernels)
    guard_phase(torch, pt, card, torch.device("cuda", ncards - 1))
    cards_phase(torch, pt, card, ncards)
    res, wall3 = split_solve(torch, pt, card, torch.device("cuda", 0), ncards)
    slowest = max(r["wall_s"] for r in res)
    print(f"--split {ncards} reading: config 3's seeded B={BATCH} solve("
          f"{N_ITER}) + all_hosts_best over {ncards} processes, slowest "
          f"rank {slowest} s (first call), {BATCH / slowest} solves/s; one "
          f"process on one card {wall3} s (first call) on {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def build_kernels(kernels):
    """Build the kernel library, printing its time and ptxas's report."""
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")


def fk_main():
    """``chip_smoke.py --fk``: the build (with ptxas's report) and the FK
    kernel's phase alone (fk_phase), with config 4's floating base."""
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.ops import kernels
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    build_kernels(kernels)
    mod, run = bench_module(pt, torch.float32, torch.device("cuda"))
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine)
    entries = fk_phase(torch, pt, card, mod, run, probs)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    run4 = config4_run(pt, torch.float32, torch.device("cuda"))
    starts4, goals4 = run_endpoints(run4, BATCH)
    probs4 = problem_batch_from_grid(run4.problem, starts4, goals4,
                                     run4.engine)
    entries.append(fk_entry(torch, "fk_soa_config4", run4.engine.fk,
                            probs4.traj, None, card))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def jtmap_main():
    """``chip_smoke.py --jtmap``: the build (with ptxas's report) and the
    Jᵀ map kernel alone: jtmap_phase, then config 4's floating base (its
    totals written), the tray's 125 active spheres (config 1 holding the
    grab phase's tray) and config 1 in float64, each at B = 256."""
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.ops import kernels
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    build_kernels(kernels)
    dev = torch.device("cuda")

    def batch(run, ends):
        return problem_batch_from_grid(run.problem, *ends, run.engine)

    mod, run = bench_module(pt, torch.float32, dev)
    entries = jtmap_phase(torch, pt, card, run,
                          batch(run, bench_endpoints(BATCH)))
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    run4 = config4_run(pt, torch.float32, dev)
    entries.append(jtmap_entry(torch, "jtmap_config4", run4.engine,
                               batch(run4, run_endpoints(run4, BATCH)),
                               card))
    grab_tray(pt, mod)
    run_t = mod.runs[mod.create(**run_kw())]
    check(run_t.engine.n_spheres_active == 125,
          f"tray: {run_t.engine.n_spheres_active} active spheres")
    entries.append(jtmap_entry(torch, "jtmap_tray", run_t.engine,
                               batch(run_t, bench_endpoints(BATCH)), card))
    _, run64 = bench_module(pt, torch.float64, dev)
    entries.append(jtmap_entry(torch, "jtmap_f64", run64.engine,
                               batch(run64, bench_endpoints(BATCH)), card))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def split_main(nranks):
    """``chip_smoke.py --split N``: split_solve alone over N ranks, one per
    card where the machine has N cards (NCCL), else sharing them (gloo)."""
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.ops import kernels

    kernels.library()              # built once here; the ranks only load
    split_solve(torch, pt, card, torch.device("cuda"), nranks)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    if not (ROOT / "or_cdchomp_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(or_cdchomp_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)

    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.chomp.solver import RecordingDraw, ReplayDraw
    from or_cdchomp_tpu_torch.ops import kernels, limits, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     best_of_batch,
                                                     problem_batch_from_grid)

    # -- build ----------------------------------------------------------------
    build_kernels(kernels)

    # -- the flagship setup on the card ---------------------------------------
    dev = torch.device("cuda")
    f32 = torch.float32
    t0 = time.perf_counter()
    mod1, run = bench_module(pt, f32, dev)
    engine = run.engine
    starts, goals = bench_endpoints(BATCH)
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)
    torch.cuda.synchronize()
    print(f"setup (SDF build, create, batch): "
          f"{time.perf_counter() - t0:.2f} s")
    fields = engine.fields
    check(tuple(fields.data.shape) == (1, 12, 16, 12),
          f"field stack {tuple(fields.data.shape)}")

    # -- kernels against their plain versions, at the main path's shapes ------
    _, x_mov, vel, acc = cost_soa.sphere_kinematics(engine.spec, engine.fk,
                                                    probs)
    m, S, B = x_mov.shape[1:]
    check((m, S, B) == (N_POINTS - 2, 15, BATCH),
          f"sphere tensors {(m, S, B)}")
    results = []

    rng = np.random.default_rng(1)
    F, mx, my, mz = fields.data.shape
    Q = m * S * B
    sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
    nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                  np.array([mx, my, mz]) - 1).astype(np.int32)
    largs = (fields.data, torch.as_tensor(sub, device=dev),
             torch.as_tensor(nbr, device=dev))
    got = torch.stack(sdf_lookup.sdf_cell_lookup(*largs))
    want = torch.stack(sdf_lookup.sdf_cell_lookup_ref(*largs))
    err = compare(torch, "sdf_cell_lookup", got, want, exact=True)
    cold = cold_ring(largs)         # timed from device memory, as bound
    t = timings(torch, lambda: sdf_lookup.sdf_cell_lookup(*cold()),
                lambda: sdf_lookup.sdf_cell_lookup_ref(*cold()))
    del cold
    # bytes: the field, sub and nbr read once, the 4 values written once
    bound = 4 * (F * mx * my * mz + 2 * F * Q * 3 + 4 * F * Q) \
        / HBM_BYTES_PER_S * 1e3
    print(f"sdf_cell_lookup (raw contract, Q={Q}, not on the main path): "
          f"exact, max_abs_err {err}, inputs cold, per call {t[0]:.4f} "
          f"ms vs plain {t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms, "
          f"bound {bound} ms (bytes)")

    oargs = obstacle_args(engine, probs, x_mov, vel, acc)
    k1_launch(torch, sdf_lookup, oargs, "config 1")
    err = check_obstacle(torch, sdf_lookup, oargs, "obstacle")
    t = time_obstacle(torch, sdf_lookup, oargs, "obstacle")
    # no single PyTorch call computes it: grid_sample interpolates
    # trilinearly, not with libcd's one-sided 4-cell rule
    results.append(kernel_entry(
        "obstacle", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs),
        sdf_lookup.obstacle_flops(m, S, B, F)))

    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    sargs = (x_mov, vel, xo, *engine.pairs, probs.epsilon_self,
             probs.obs_factor_self)
    P = engine.pairs[0].shape[0]
    SI = xo.shape[1]
    check((P, SI) == (207, 1), f"pair table size {P}, inactive spheres {SI}")
    info = selfcol.launch_info(S, SI)
    print(f"selfcol launch: {info['threads']} threads, "
          f"{info['smem_bytes']} B dynamic shared memory per block, "
          f"{info['blocks_per_sm']} blocks per SM, {info['registers']} "
          f"registers, {info['local_bytes']} B local (spill) per thread")
    votes, near, taken, reach = selfcol.vote_stats(
        x_mov, xo, *engine.pairs, probs.epsilon_self)
    print(f"selfcol skips on the flagship batch: of {votes} (point, pair, "
          f"32-problem warp) votes {near} pass the box test "
          f"({near / votes:.4f}) and {taken} are taken ({taken / votes:.4f}), "
          f"so the warp vote skips {(votes - taken) / votes:.4f}; "
          f"{reach} of {m * P * B} (point, pair, problem) in reach")
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    err = max(compare(torch, "selfcol net", net_k, net_r),
              compare(torch, "selfcol cost", c_k, c_r))
    again = selfcol.selfcol_pairs(*sargs)
    check(torch.equal(again[0], net_k) and torch.equal(again[1], c_k),
          "selfcol: two launches on the same inputs differ")
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"selfcol: max_abs_err {err}, per call {t[0]:.4f} ms vs plain "
          f"{t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms")
    # no single PyTorch call computes it (a pair gather, the hinge and two
    # index_add_ scatters at the least)
    results.append(kernel_entry(
        "selfcol", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, S, SI, B, P), selfcol.flops(m, B, P, reach)))
    for r in results:
        print(f"{r['name']}: device {r['ms']} ms, bound {r['bound_ms']} ms "
              f"({r['bound_by']}), share {r['bound_share']:.4f} on {card}")

    # the limits kernel at config 1's shape, rows pushed out of their limits
    T1 = probs.traj[:, 1:-1]
    lo1, hi1 = probs.jlimit_lower, probs.jlimit_upper
    results.append(limits_entry(torch, "limit_repair",
                                pushed_out(torch, T1, lo1, hi1), lo1, hi1,
                                engine.Ainv, card, max_ill=0))

    # the FK kernel at configs 1 and 5's shapes and the float64 check's
    entries_fk = fk_phase(torch, pt, card, mod1, run, probs)
    # the Jᵀ map kernel at configs 1 and 5's shapes
    entries_fk += jtmap_phase(torch, pt, card, run, probs)

    # -- the main path --------------------------------------------------------
    counts_zero(sdf_lookup, selfcol)
    solver = BatchSolver(engine)
    t0 = time.perf_counter()
    out, costs = solver.iterate(probs, N_ITER)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = dict(counts(sdf_lookup, selfcol), limit_repair=limits.LAUNCHES)
    print(f"main path: {N_ITER} iterations at B={BATCH} in {first_wall:.3f} s "
          f"(first call, the step's capture included), launches {launches}")
    check_launches(counts(sdf_lookup, selfcol), N_ITER, "config 1",
                   steps=N_ITER)
    from or_cdchomp_tpu_torch.ops import jtmap

    check(jtmap.JT_LAUNCHES == N_ITER, f"config 1: the Jᵀ map kernel "
          f"launched {jtmap.JT_LAUNCHES} times, expected {N_ITER}")
    for r in entries_fk:
        if r["name"] == "jtmap":
            r["launches"] = jtmap.JT_LAUNCHES
    for r in results + entries_fk[:1]:
        r["launches"] = launches[r["name"]]
    check(tuple(costs.shape) == (N_ITER, BATCH, 3), f"costs {costs.shape}")
    check(tuple(out.traj.shape) == (BATCH, N_POINTS, 7), "trajectory shape")
    check(bool(torch.isfinite(costs).all()), "non-finite costs")
    check(bool(torch.isfinite(out.traj).all()), "non-finite trajectories")
    c0 = float(costs[0, :, 0].mean())
    c1 = float(costs[-1, :, 0].mean())
    print(f"mean total cost: first iteration {c0:.6f}, last {c1:.6f}")
    check(c1 < c0, "the mean total cost did not fall")

    step_profile(torch, engine, probs, "config 1", card)

    # -- warm wall of the flagship solve, before the CPU phases: the CPU's
    # worker threads slow a host-bound loop for seconds after a CPU solve
    wall, walls = warm_walls(torch, lambda: solver.iterate(probs, N_ITER), 7)
    print(f"flagship iterate({N_ITER}) at B={BATCH}: median warm wall "
          f"{wall} s of {walls}, {BATCH / wall} solves/s on {card}")
    graph_check(torch, "config 1", engine, probs, card)

    # -- config 1 over two replicas on this card ------------------------------
    entry_layout = devices_phase(torch, pt, card, dev, engine, probs)

    # -- config 2: three SDFs, self-collision weights, moved base -------------
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    for old in CACHE_DIR.glob("sdf_*.dat"):
        old.unlink()
    t0 = time.perf_counter()
    _, run2 = config2_module(pt, f32, dev)
    eng2 = run2.engine
    probs2 = problem_batch_from_grid(run2.problem, starts, goals, eng2)
    torch.cuda.synchronize()
    f2 = eng2.fields
    sizes2 = f2.sizes.cpu().numpy()
    print(f"config 2 setup (3 SDF builds + cache writes, create, batch): "
          f"{time.perf_counter() - t0:.2f} s; field stack "
          f"{tuple(f2.data.shape)}, true sizes {sizes2.tolist()}")
    check(f2.data.shape[0] == 3
          and tuple(f2.data.shape[1:]) == tuple(sizes2.max(axis=0)),
          f"config 2 field stack {tuple(f2.data.shape)}")
    _, x2, v2, a2 = cost_soa.sphere_kinematics(eng2.spec, eng2.fk, probs2)
    m2, S2, B2 = x2.shape[1:]
    # on the path's own inputs the hinge is idle: the arm stays outside
    # the three field boxes.  So K1 is also held with the sphere cloud
    # moved into the fields, a 1 m hinge width and field 0, 1 or 2
    # disabled in every fourth problem: every lookup, the min-select
    # over the three padded fields and field_enabled then reach the
    # cost and the gradient
    oargs2 = obstacle_args(eng2, probs2, x2, v2, a2)
    k1_launch(torch, sdf_lookup, oargs2, "config 2")
    err = check_obstacle(torch, sdf_lookup, oargs2, "obstacle F=3",
                         hinge=False)
    wide = moved_in_args(torch, oargs2, probs2)
    err = max(err, check_obstacle(
        torch, sdf_lookup, wide,
        "obstacle F=3, moved in, 1 m hinge, fields off"))
    t = time_obstacle(torch, sdf_lookup, oargs2, "obstacle F=3")
    time_obstacle(torch, sdf_lookup, wide, "obstacle F=3, moved in")
    F2, mx2, my2, mz2 = f2.data.shape
    entry_f3 = kernel_entry(
        "obstacle_f3", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        k1_bytes(sdf_lookup, oargs2),
        sdf_lookup.obstacle_flops(m2, S2, B2, F2))
    print(f"obstacle F=3: device {entry_f3['ms']} ms, bound "
          f"{entry_f3['bound_ms']} ms ({entry_f3['bound_by']}), share "
          f"{entry_f3['bound_share']:.4f} on {card}")
    xo2 = probs2.inactive_pos.permute(2, 1, 0).contiguous()
    sargs2 = (x2, v2, xo2, *eng2.pairs, probs2.epsilon_self,
              probs2.obs_factor_self)
    net_k, c_k = selfcol.selfcol_pairs(*sargs2)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs2)
    err2 = max(compare(torch, "config 2 selfcol net", net_k, net_r),
               compare(torch, "config 2 selfcol cost", c_k, c_r))
    print(f"config 2 selfcol: max_abs_err {err2} (rtol {KERNEL_RTOL})")
    init2 = torch.stack(eng2.final_costs_batch(probs2), dim=-1).mean(0)
    initial2 = float(init2[0])

    counts_zero(sdf_lookup, selfcol)
    solver2 = BatchSolver(eng2)
    t0 = time.perf_counter()
    out2, fin2, done2 = solver2.solve(probs2, N_ITER)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches2 = counts(sdf_lookup, selfcol)
    print(f"config 2: solve({N_ITER}) + final costs at B={BATCH} in "
          f"{first_wall:.3f} s (first call), launches {launches2} "
          f"(expected {N_ITER} + 1 each)")
    check_launches(launches2, N_ITER + 1, "config 2",
                   steps=N_ITER)
    entry_f3["launches"] = launches2["obstacle"]
    check(done2 == N_ITER and tuple(fin2.shape) == (BATCH, 3),
          f"config 2: done {done2}, finals {tuple(fin2.shape)}")
    check(bool(torch.isfinite(fin2).all())
          and bool(torch.isfinite(out2.traj).all()),
          "config 2: non-finite costs or trajectories")
    final2 = float(fin2[:, 0].mean())
    print(f"config 2 mean (total, obstacle + self, smoothness) cost: before "
          f"{init2.tolist()}, after {fin2.mean(0).tolist()}")
    check(final2 < initial2, "config 2: the mean total cost did not fall")
    wall, walls = warm_walls(torch, lambda: solver2.solve(probs2, N_ITER),
                             WARM_REPS)
    print(f"config 2 solve({N_ITER}) at B={BATCH}: median warm wall {wall} s "
          f"of {walls}, {BATCH / wall} solves/s on {card}")

    # -- config 3: HMC, best of the batch -------------------------------------
    t0 = time.perf_counter()
    run3 = config3_run(pt, f32, dev)
    eng3 = run3.engine
    check(eng3.spec.use_hmc and eng3.spec.use_momentum, "config 3 flags")
    probs3 = problem_batch_from_grid(run3.problem, starts, goals, eng3)
    torch.cuda.synchronize()
    print(f"config 3 setup: {time.perf_counter() - t0:.2f} s")
    rec, dues = RecordingDraw(eng3.draw, N_CHECK), []
    eng3.draw = due_tally(rec, dues)
    counts_zero(sdf_lookup, selfcol)
    solver3 = BatchSolver(eng3)
    t0 = time.perf_counter()
    out3, fin3, done3 = solver3.solve(probs3, N_ITER)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches3 = counts(sdf_lookup, selfcol)
    eng3.draw = rec.inner
    print(f"config 3: solve({N_ITER}) + final costs at B={BATCH} in "
          f"{first_wall:.3f} s (first call), launches {launches3} "
          f"(expected {N_ITER} + 1 each), {len(rec.z)} draws")
    check_launches(launches3, N_ITER + 1, "config 3",
                   steps=N_ITER)
    check(len(rec.z) == N_ITER, f"config 3: {len(rec.z)} draws")
    check(bool(torch.isfinite(fin3).all())
          and bool(torch.isfinite(out3.traj).all()),
          "config 3: non-finite costs or trajectories")
    check(bool(dues[0].all()),
          "config 3: not every problem resampled at iteration 0")
    check(bool((out3.resample_iter >= N_ITER).all()),
          "config 3: a resample iteration was passed over")
    n_res = torch.stack(dues).sum(0).cpu().numpy()
    check(int(n_res.max()) >= 2, "config 3: no problem resampled twice")
    hist = {int(k): int((n_res == k).sum()) for k in np.unique(n_res)}
    print(f"config 3 resamples per problem (count: problems): {hist}")
    best, idx = best_of_batch(out3, fin3)
    best_cost = float(fin3[idx, 0])
    check(best_cost == float(fin3[:, 0].min()),
          "config 3: best_of_batch did not pick the least total")
    check(torch.equal(best.traj, out3.traj[idx]), "config 3: best problem")
    print(f"config 3 best of batch: index {int(idx)}, total cost "
          f"{best_cost:.6f} (mean {float(fin3[:, 0].mean()):.6f})")
    wall, walls = warm_walls(torch, lambda: solver3.solve(probs3, N_ITER),
                             WARM_REPS)
    print(f"config 3 solve({N_ITER}) at B={BATCH}: median warm wall {wall} s "
          f"of {walls}, {BATCH / wall} solves/s on {card}")

    # -- config 4: floating base, everyn TSR ----------------------------------
    out4, starts4, goals4, entries4 = config4_phase(torch, pt, card, dev)

    # -- config 5: config 1 at 10,240 problems --------------------------------
    starts5, goals5 = bench_endpoints(BATCH_POD)
    probs5 = problem_batch_from_grid(run.problem, starts5, goals5, engine)
    solver.iterate(probs5, 1)                          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts_zero(sdf_lookup, selfcol)
    t0 = time.perf_counter()
    out5, costs5 = solver.iterate(probs5, N_ITER)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    launches5 = counts(sdf_lookup, selfcol)
    peak = torch.cuda.max_memory_allocated()
    print(f"config 5: iterate({N_ITER}) at B={BATCH_POD}: wall {wall5} s, "
          f"{BATCH_POD / wall5} solves/s, peak device memory {peak} B "
          f"({peak / 2**30:.3f} GiB), launches {launches5} on {card}")
    check_launches(launches5, N_ITER, "config 5",
                   steps=N_ITER)
    entries_fk[1]["launches"] = launches5["fk_soa"]
    check(bool(torch.isfinite(costs5).all())
          and bool(torch.isfinite(out5.traj).all()),
          "config 5: non-finite costs or trajectories")
    print(f"config 5 mean total cost: first iteration "
          f"{float(costs5[0, :, 0].mean()):.6f}, last "
          f"{float(costs5[-1, :, 0].mean()):.6f}")
    # both kernels against their plain versions at config 5's shapes
    # (B = 10,240: 40 times the flagship grid), on its own inputs
    _, x5, v5, a5 = cost_soa.sphere_kinematics(engine.spec, engine.fk, probs5)
    check(tuple(x5.shape[1:]) == (N_POINTS - 2, 15, BATCH_POD),
          f"config 5 sphere tensors {tuple(x5.shape)}")
    oargs5 = obstacle_args(engine, probs5, x5, v5, a5)
    k1_launch(torch, sdf_lookup, oargs5, "config 5")
    err_k1 = check_obstacle(torch, sdf_lookup, oargs5, "config 5 obstacle")
    t = time_obstacle(torch, sdf_lookup, oargs5, "config 5 obstacle")
    entry_b5 = kernel_entry(
        "obstacle_b10240", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err_k1, t,
        k1_bytes(sdf_lookup, oargs5),
        sdf_lookup.obstacle_flops(m, S, BATCH_POD, F))
    entry_b5["launches"] = launches5["obstacle"]
    print(f"config 5 obstacle: device {entry_b5['ms']} ms, bound "
          f"{entry_b5['bound_ms']} ms ({entry_b5['bound_by']}), share "
          f"{entry_b5['bound_share']:.4f} on {card}")
    xo5 = probs5.inactive_pos.permute(2, 1, 0).contiguous()
    sargs5 = (x5, v5, xo5, *engine.pairs, probs5.epsilon_self,
              probs5.obs_factor_self)
    net_k, c_k = selfcol.selfcol_pairs(*sargs5)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs5)
    err5 = max(compare(torch, "config 5 selfcol net", net_k, net_r),
               compare(torch, "config 5 selfcol cost", c_k, c_r))
    print(f"config 5 selfcol: max_abs_err {err5} (rtol {KERNEL_RTOL})")
    graph_check(torch, f"config 5 (B={BATCH_POD})", engine, probs5, card)
    del probs5, costs5, x5, v5, a5, oargs5, xo5, sargs5, t
    del net_k, c_k, net_r, c_r

    # -- the libcd math library and K1's raw lookup on its path ---------------
    entries_libcd = libcd_phase(torch, pt, card, dev, engine, probs, eng2,
                                probs2)

    # -- the module commands, and a grabbed tray (K2 at S = 126) --------------
    entry_split, f64_check_launches = module_phase(torch, pt, card, dev, out,
                                                   out5)
    entries_fk[2]["launches"] = f64_check_launches
    del out5
    entry_grab, entry_layout_grab = grab_phase(torch, pt, card, dev)
    entries_front = front_door_phase(torch, pt, card, dev)
    entries_long = long_phase(torch, pt, card, dev)
    entries_mesh = mesh_phase(torch, pt, card, dev)
    entry_draw = seeded_phase(torch, pt, card, dev)
    distributed_phase(torch, pt, card, dev)
    checkpoint_phase(torch, pt, card, dev)
    profile_phase(torch, pt, card, dev)
    entries_f64 = float64_phase(torch, pt, card, dev)
    scripts_phase(card)

    # -- the same solves on the CPU in float64 (plain versions) ---------------
    cpu, f64 = "cpu", torch.float64
    t0 = time.perf_counter()
    _, run64 = bench_module(pt, f64, cpu)
    p64 = problem_batch_from_grid(run64.problem, starts[:N_CHECK],
                                  goals[:N_CHECK], run64.engine)
    out64, _ = BatchSolver(run64.engine).iterate(p64, N_ITER)
    dtraj = max_dtraj(out, out64)
    print(f"CPU float64 re-solve of {N_CHECK} problems: max |Δtraj| {dtraj} "
          f"(bar {TRAJ_BAR}), {time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"max |Δtraj| {dtraj} > {TRAJ_BAR}")

    # config 2 reads the card's fields from the cache files, so the two
    # solves share their fields to the bit
    t0 = time.perf_counter()
    _, run2_64 = config2_module(pt, f64, cpu, require_cache=True)
    p64 = problem_batch_from_grid(run2_64.problem, starts[:N_CHECK],
                                  goals[:N_CHECK], run2_64.engine)
    out64, fin64, _ = BatchSolver(run2_64.engine).solve(p64, N_ITER)
    dtraj = max_dtraj(out2, out64)
    dfin = float((fin2[:N_CHECK].double().cpu() - fin64).abs().max())
    print(f"config 2 CPU float64 re-solve of {N_CHECK} problems: max "
          f"|Δtraj| {dtraj} (bar {TRAJ_BAR}), max |Δfinal cost| {dfin}, "
          f"{time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"config 2: max |Δtraj| {dtraj} > {TRAJ_BAR}")

    # config 3 on the CPU fed the card's draws, float64 and float32: the
    # two CPU solves apart are momentum's own float32 drift
    cpu_outs = []
    for dtype in (f64, f32):
        t0 = time.perf_counter()
        run3c = config3_run(pt, dtype, cpu)
        run3c.engine.draw = ReplayDraw(rec.z, rec.u)
        p3c = problem_batch_from_grid(run3c.problem, starts[:N_CHECK],
                                      goals[:N_CHECK], run3c.engine)
        out3c, _, _ = BatchSolver(run3c.engine).solve(p3c, N_ITER)
        dtraj = max_dtraj(out3, out3c)
        same_sched = torch.equal(out3.resample_iter[:N_CHECK].cpu(),
                                 out3c.resample_iter)
        print(f"config 3 CPU {dtype} re-solve of {N_CHECK} problems, same "
              f"draws: max |Δtraj| {dtraj} (bar {TRAJ_BAR}), same resample "
              f"schedule {same_sched}, {time.perf_counter() - t0:.2f} s")
        check(dtraj <= TRAJ_BAR,
              f"config 3 ({dtype}): max |Δtraj| {dtraj} > {TRAJ_BAR}")
        cpu_outs.append(out3c.traj.double())
    print(f"config 3 CPU float32 against CPU float64, same draws: max "
          f"|Δtraj| {float((cpu_outs[1] - cpu_outs[0]).abs().max())}")

    # config 4 reads the card's field from its cache file
    t0 = time.perf_counter()
    run4_64 = config4_run(pt, f64, cpu, require_cache=True)
    p64 = problem_batch_from_grid(run4_64.problem, starts4[:N_CHECK],
                                  goals4[:N_CHECK], run4_64.engine)
    out64, _ = BatchSolver(run4_64.engine).iterate(p64, N_ITER)
    dtraj = max_dtraj(out4, out64)
    print(f"config 4 CPU float64 re-solve of {N_CHECK} problems: max "
          f"|Δtraj| {dtraj} (bar {TRAJ_BAR}), "
          f"{time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"config 4: max |Δtraj| {dtraj} > {TRAJ_BAR}")

    results += [entry_layout, entry_f3, *entries4, entry_b5, *entries_libcd,
                entry_split, entry_grab, entry_layout_grab, *entries_front,
                *entries_long, *entries_mesh, entry_draw, *entries_f64,
                *entries_fk]
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--dist-child"]:
            sys.exit(dist_child(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5]))
        if sys.argv[1:2] == ["--split"]:
            sys.exit(split_main(int(sys.argv[2])))
        if sys.argv[1:2] == ["--cards"]:
            sys.exit(cards_main(int(sys.argv[2])))
        if sys.argv[1:2] == ["--script"]:
            sys.exit(script_child(sys.argv[2]))
        if sys.argv[1:2] == ["--fk"]:
            sys.exit(fk_main())
        if sys.argv[1:2] == ["--jtmap"]:
            sys.exit(jtmap_main())
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
