"""WAM7 demo with TRIANGLE-MESH obstacles on the PyTorch / CUDA port —
examples/wam7_mesh_demo.py through or_cdchomp_tpu_torch, on the card by
default.

The reference's flagship scenario loads trimesh environment geometry
(`rolly-table.iv` + `mug3.iv`, scripts/test_wam7.py:22-28) and
voxelizes it by probe-cube collision checks
(orcdchomp_mod.cpp:495-525).  This demo reproduces that scene CLASS:
the table (top + pedestal) and the mug are closed triangle meshes fed
through the mesh voxelizer (13-axis triangle-cube SAT; interiors
closed by the flood-fill pass), then solved and collision-re-checked
against the exact winding-number signed mesh distance.

Run:  python examples/torch_wam7_mesh_demo.py  [--n-iter 100]
          [--n-points 101] [--device cuda] [--dtype float32]
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iter", type=int, default=100)
    ap.add_argument("--n-points", type=int, default=101)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args(argv)

    import torch
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.api import KinBody, Robot
    from or_cdchomp_tpu_torch.ops.voxelize import box_trimesh, cylinder_trimesh

    device = torch.device(args.device)
    print("devices: " + (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)))

    # the verified-feasible config-1 scene, as closed triangle meshes
    top_v, top_f = box_trimesh((0.25, 0.4, 0.02))
    leg_v, leg_f = box_trimesh((0.08, 0.08, 0.25))
    mug_v, mug_f = cylinder_trimesh(0.04, 0.06, n=24)
    mod = pt.CHOMPModule(dtype=getattr(torch, args.dtype), device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), top_v, top_f),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), leg_v, leg_f)])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mug_v, mug_f)])))
    robot = Robot("wam", pt.wam7(),
                  q_active=np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
    mod.add_robot(robot)

    t0 = time.time()
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    print(f"[{time.time()-t0:.1f}s] mesh SDF built "
          f"({int(np.prod(mod.sdfs[0].grid.sizes))} cells, "
          f"{mod.sdfs[0].grid.sizes})")

    goal = [0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0]
    traj = mod.runchomp(robot="wam", n_iter=args.n_iter, lambda_=100.0,
                        obs_factor=500.0, n_points=args.n_points,
                        adofgoal=goal, no_collision_exception=True)
    print(f"[{time.time()-t0:.1f}s] solved {args.n_iter} iterations, "
          f"{traj.positions.shape[0]} points, "
          f"in_collision={traj.in_collision}")
    assert not traj.in_collision, "mesh-scene solve ended in collision"
    print("MESH DEMO OK")
    return dict(traj=traj.positions, in_collision=traj.in_collision)


if __name__ == "__main__":
    main()
