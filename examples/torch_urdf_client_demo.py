"""Migration demo on the PyTorch / CUDA port — examples/urdf_client_demo.py
through or_cdchomp_tpu_torch, on the card by default: URDF robot +
orcdchomp sphere XML + string transport.

Shows the full reference-style workflow against the port:

 1. load a robot from URDF (replacing OpenRAVE robot XML / COLLADA),
 2. attach a sphere collision model from the reference's
    ``<orcdchomp><spheres>`` XML format (orcdchomp_kdata parity),
 3. drive everything through SendCommand strings with the bound python
    client (orcdchomp.py parity) — the exact calling style of
    scripts/test_wam7.py, minus OpenRAVE.

Run:  python examples/torch_urdf_client_demo.py [--n-iter 150]
          [--n-points 61] [--device cuda] [--dtype float32]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

URDF = """
<robot name="planar3">
  <link name="base"/>
  <link name="l1"/> <link name="l2"/> <link name="l3"/>
  <joint name="j1" type="continuous">
    <parent link="base"/> <child link="l1"/>
    <origin xyz="0 0 0.1"/> <axis xyz="0 0 1"/>
    <limit velocity="2.0"/>
  </joint>
  <joint name="j2" type="revolute">
    <parent link="l1"/> <child link="l2"/>
    <origin xyz="0.4 0 0"/> <axis xyz="0 0 1"/>
    <limit lower="-2.8" upper="2.8" velocity="2.0"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="l2"/> <child link="l3"/>
    <origin xyz="0.35 0 0"/> <axis xyz="0 0 1"/>
    <limit lower="-2.8" upper="2.8" velocity="2.0"/>
  </joint>
</robot>
"""

# the reference's kinbody sphere annotation format
# (scripts/barrettwam_withspheres.robot.xml:22-46 style)
SPHERES_XML = """
<orcdchomp>
  <spheres>
    <sphere link="l1" pos="0.0 0.0 0.0" radius="0.08"/>
    <sphere link="l1" pos="0.2 0.0 0.0" radius="0.08"/>
    <sphere link="l2" pos="0.0 0.0 0.0" radius="0.07"/>
    <sphere link="l2" pos="0.18 0.0 0.0" radius="0.07"/>
    <sphere link="l3" pos="0.0 0.0 0.0" radius="0.06"/>
    <sphere link="l3" pos="0.15 0.0 0.0" radius="0.05"/>
  </spheres>
</orcdchomp>
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-iter", type=int, default=150)
    ap.add_argument("--n-points", type=int, default=61)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args(argv)

    import torch
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch import client
    from or_cdchomp_tpu_torch.api import KinBody, Robot
    from or_cdchomp_tpu_torch.models.kdata import parse_spheres_xml
    from or_cdchomp_tpu_torch.models.urdf import parse_urdf

    model = parse_urdf(URDF, use_collision_spheres=False)
    model = model.with_spheres(parse_spheres_xml(SPHERES_XML))

    world = pt.CHOMPModule(dtype=getattr(torch, args.dtype),
                           device=args.device)
    # the straight-line sweep grazes this pillar by ~2 cm; CHOMP bends
    # the arm's elbow to clear it
    world.add_kinbody(KinBody("pillar", pt.Scene.build(
        cylinders=[((0.95, -0.15, 0.1, 0, 0, 0, 1), 0.06, 0.12)])))
    world.add_robot(Robot("planar3", model,
                          q_active=np.array([0.4, 0.3, -0.2])))

    # reference-style client: everything below is command strings
    mod = client.SendCommandModule(world)
    client.bind(mod)

    world.robots["planar3"].enabled = False
    mod.computedistancefield(kinbody="pillar", cube_extent=0.04)
    world.robots["planar3"].enabled = True

    print("spheres:", [(n, np.round(c, 3).tolist(), r)
                       for n, c, r in world.viewspheres(robot="planar3")][:3],
          "…")

    raw = mod.runchomp(robot="planar3", adofgoal=[-0.8, 0.5, 0.4],
                       n_iter=args.n_iter, lambda_=50.0, obs_factor=500.0,
                       n_points=args.n_points)  # collision check raises
    traj = json.loads(raw)
    qs = np.asarray(traj["positions"])
    print(f"planned {qs.shape[0]} collision-free waypoints over "
          f"{traj['times'][-1]:.2f}s; "
          f"start {np.round(qs[0], 3).tolist()} → "
          f"goal {np.round(qs[-1], 3).tolist()}")
    return dict(positions=qs, times=np.asarray(traj["times"]),
                in_collision=False)


if __name__ == "__main__":
    main()
