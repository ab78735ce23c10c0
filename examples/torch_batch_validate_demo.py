"""Fleet workflow demo on the PyTorch / CUDA port —
examples/batch_validate_demo.py through or_cdchomp_tpu_torch, on the
card by default: solve a batch, validate the whole batch on the device,
keep the best feasible trajectory.

The reference plans and validates one run at a time
(orcdchomp_mod.cpp:2854-3011); this is the batched production loop:

  1. solve B perturbed problems in one batched step loop
  2. retime + strictly collision-re-check ALL of them in one
     `gettraj_batch` call (FK + sphere tests on the device)
  3. filter to feasible, pick the lowest-cost survivor

Run:  python examples/torch_batch_validate_demo.py [--batch 256]
          [--n-iter 100] [--n-points 101] [--device cuda]
          [--dtype float32]
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np

# the field's cache file, in the package's ignored build directory
CACHE_FILE = (Path(__file__).resolve().parent.parent / "or_cdchomp_tpu_torch"
              / "build" / "sdf_cache" / "demo_sdf_table.npy")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
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
        BatchSolver, problem_batch_from_grid)

    device = torch.device(args.device)
    mod = pt.CHOMPModule(dtype=getattr(torch, args.dtype), device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    robot = Robot("wam", pt.wam7(), q_active=start.copy())
    mod.add_robot(robot)
    robot.enabled = False
    CACHE_FILE.parent.mkdir(parents=True, exist_ok=True)
    mod.computedistancefield(kinbody="table", cube_extent=0.04,
                             cache_filename=str(CACHE_FILE))
    robot.enabled = True
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    run = mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                     obs_factor=500.0, n_points=args.n_points)
    rn = mod.runs[run]

    B = args.batch
    rng = np.random.default_rng(0)
    starts = np.tile(start, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    goals = np.tile(goal, (B, 1)) + 0.02 * rng.normal(size=(B, 7))
    probs = problem_batch_from_grid(rn.problem, starts, goals, rn.engine)

    solver = BatchSolver(rn.engine)
    probs = solver.shard(probs)
    t0 = time.time()
    probs, costs = solver.iterate(probs, args.n_iter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_solve = time.time() - t0
    final = costs[-1, :, 0].double().cpu().numpy()   # costs: (n_iter, B, 3)

    t0 = time.time()
    trajs, in_col = mod.gettraj_batch(run=run, probs=probs)
    t_check = time.time() - t0

    ok = ~in_col
    print(f"solved {B} problems in {t_solve:.2f}s, validated in "
          f"{t_check:.2f}s (both first calls)")
    print(f"feasible: {int(ok.sum())}/{B}")
    b = None
    if ok.any():
        b = int(np.flatnonzero(ok)[np.argmin(final[ok])])
        best = trajs[b]
        print(f"best feasible: problem {b}, final cost {final[b]:.3f}, "
              f"duration {best.duration:.2f}s, "
              f"{len(best.times)} waypoints")
    mod.destroy(run=run)
    return dict(traj=probs.traj.double().cpu().numpy(), final=final,
                in_collision=in_col, best=b,
                positions=np.stack([t.positions for t in trajs]))


if __name__ == "__main__":
    main()
