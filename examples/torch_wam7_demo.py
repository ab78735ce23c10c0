"""End-to-end WAM7 demo on the PyTorch / CUDA port — examples/wam7_demo.py
through or_cdchomp_tpu_torch, on the card by default.

The reference demo (scripts/test_wam7.py:17-93) loads a WAM with sphere
annotations into an OpenRAVE env with a table and a mug, computes a
cached distance field, runs 100 CHOMP iterations, and executes the
collision-checked trajectory.  This script does the same against the
analytic world model, then additionally solves a 64-problem batch in
one batched step loop.

Run:  python examples/torch_wam7_demo.py  [--batch 64] [--n-iter 100]
          [--n-points 101] [--device cuda] [--dtype float32]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

# the field's cache file, in the package's ignored build directory
CACHE_FILE = (Path(__file__).resolve().parent.parent / "or_cdchomp_tpu_torch"
              / "build" / "sdf_cache" / "wam7_demo_sdf.npy")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=101)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args(argv)

    import torch
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.api import KinBody, Robot
    from or_cdchomp_tpu_torch.parallel.batch import (
        BatchSolver, best_of_batch, problem_batch_from_grid)

    device = torch.device(args.device)
    print("devices: " + (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)))

    # --- world (test_wam7.py:23-38; feasible endpoints — see
    # benchmarks/configs.py GOAL1) ---
    mod = pt.CHOMPModule(dtype=getattr(torch, args.dtype), device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = Robot(
        "wam", pt.wam7(),
        q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(robot)

    # --- distance field (test_wam7.py:76-79) ---
    robot.enabled = False
    t0 = time.time()
    CACHE_FILE.parent.mkdir(parents=True, exist_ok=True)
    mod.computedistancefield(kinbody="table", cube_extent=0.04,
                             cache_filename=str(CACHE_FILE))
    robot.enabled = True
    print(f"computedistancefield: {time.time() - t0:.2f}s")

    # --- single solve (test_wam7.py:82-84) ---
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    t0 = time.time()
    traj = mod.runchomp(robot="wam", adofgoal=goal, n_iter=args.n_iter,
                        lambda_=100.0, obs_factor=500.0,
                        n_points=args.n_points,
                        no_collision_exception=True)
    print(f"runchomp({args.n_iter} iters): {time.time() - t0:.2f}s, "
          f"duration {traj.duration:.2f}s, in_collision={traj.in_collision}")

    # --- batched solve: many seeds/goals at once ---
    h = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                   obs_factor=500.0, n_points=args.n_points)
    run = mod.runs[h]
    rng = np.random.default_rng(0)
    starts = np.tile(robot.q_active, (args.batch, 1)) \
        + 0.02 * rng.normal(size=(args.batch, 7))
    goals = np.tile(goal, (args.batch, 1)) \
        + 0.02 * rng.normal(size=(args.batch, 7))
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    solver = BatchSolver(run.engine)
    probs_dev = solver.shard(probs)
    out, costs = solver.iterate(probs_dev, args.n_iter)   # first call
    sync()
    t0 = time.time()
    out, costs = solver.iterate(probs_dev, args.n_iter)
    sync()
    dt = time.time() - t0
    finals = run.engine.final_costs_batch(out)
    best, idx = best_of_batch(out, torch.stack(finals, dim=-1))
    print(f"batch of {args.batch}: {dt:.2f}s warm "
          f"({args.batch / dt:.1f} solves/s), best problem {int(idx)} "
          f"cost {float(finals[0][int(idx)]):.4f}")
    mod.destroy(run=h)
    return dict(traj=traj.positions, in_collision=traj.in_collision,
                batch_traj=out.traj.double().cpu().numpy(),
                finals=torch.stack(finals, dim=-1).double().cpu().numpy(),
                best=int(idx), warm_s=dt)


if __name__ == "__main__":
    main()
