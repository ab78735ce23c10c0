"""Canonical end-to-end drive of the PyTorch / CUDA port: drive.py's
calls through or_cdchomp_tpu_torch.

Builds the table's field, runs runchomp, then create + iterate cold and
warm and destroy, on the card in float32 unless told otherwise.

Run:  python drive_torch.py [--device cuda] [--dtype float32]
                            [--n-points 101] [--n-iter 100]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.api import KinBody, Robot


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    ap.add_argument("--n-points", type=int, default=101)
    ap.add_argument("--n-iter", type=int, default=100)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    t0 = time.time()
    mod = pt.CHOMPModule(dtype=getattr(torch, args.dtype), device=device)
    mod.add_kinbody(KinBody('table', pt.Scene.build(
        boxes=[((0.75, 0.0, 0.35, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    r = Robot('wam', pt.wam7(),
              q_active=np.array([2.5, -1.8, 0, 2.0, 0, 0.2, 0]))
    mod.add_robot(r)
    r.enabled = False
    mod.computedistancefield(kinbody='table', cube_extent=0.04)
    r.enabled = True
    print(f"[{time.time()-t0:.1f}s] field built", flush=True)
    traj = mod.runchomp(robot='wam', n_iter=args.n_iter, lambda_=100.0,
                        obs_factor=500.0, n_points=args.n_points,
                        adofgoal=[0.4, 0.6, 0.1, 1.3, 0, -0.5, 0])
    print(f"[{time.time()-t0:.1f}s] runchomp done; "
          f"traj points={traj.positions.shape} "
          f"in_collision={traj.in_collision}", flush=True)
    h = mod.create(robot='wam', adofgoal=[0.4, 0.6, 0.1, 1.3, 0, -0.5, 0],
                   n_points=args.n_points, lambda_=100.0, obs_factor=500.0)
    cost = [0.0]
    mod.iterate(run=h, n_iter=args.n_iter, cost=cost)
    print(f"[{time.time()-t0:.1f}s] final cost {cost[0]:.3f} "
          f"(expect ~26.5 at 101 points, 100 iterations)", flush=True)
    t1 = time.time()
    mod.iterate(run=h, n_iter=args.n_iter)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    warm = time.time() - t1
    print(f"warm iterate({args.n_iter}): {warm:.2f}s", flush=True)
    run_traj = mod.runs[h].problem.traj.double().cpu().numpy()
    mod.destroy(run=h)
    print("DRIVE OK", flush=True)
    return dict(traj=traj.positions, in_collision=traj.in_collision,
                cost=cost[0], run_traj=run_traj, warm_s=warm)


if __name__ == "__main__":
    main()
