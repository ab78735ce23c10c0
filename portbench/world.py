"""Build the program's world from a configuration file.

A configuration (``configs/<name>.json``) holds the robot (links,
joints, spheres, active joints, base pose, start), the obstacle bodies
(boxes and cylinders), the field to compute, create's keyword arguments
and the solve's iterations, dtype and endpoint spread.  ``build`` hands
them to the port's module through its public calls, as a user's script
does: ``CHOMPModule``, ``add_kinbody``, ``add_robot``,
``computedistancefield`` (the field built on the device from the scene,
with no cache file) and ``create``.  The plain reference reads the same
file (reference/chomp.py) and builds nothing of the program.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np


def load(path):
    """The configuration file as a dict."""
    return json.loads(Path(path).read_text())


def robot_model(cfg):
    """The configuration's robot as the port's ``RobotModel``, its
    active joints selected (the others frozen at 0)."""
    from or_cdchomp_tpu_torch.models.robot import RobotModel

    r = cfg["robot"]
    spheres = [(s[0], tuple(s[1]), s[2]) for s in r["spheres"]]
    model = RobotModel.from_joints(r["name"], r["links"], r["joints"],
                                   spheres=spheres, ee_link=r["ee_link"],
                                   ee_origin=r["ee_origin"])
    return model.set_active(r["active"])


def create_kwargs(cfg):
    """create's keyword arguments of the configuration (arrays as numpy,
    the TSR as the port's ``TSR``)."""
    import or_cdchomp_tpu_torch as pt

    kw = dict(cfg["create"])
    for key in ("adofgoal", "basegoal"):
        if key in kw:
            kw[key] = np.asarray(kw[key], dtype=np.float64)
    if "everyn_tsr" in kw:
        t = kw["everyn_tsr"]
        kw["everyn_tsr"] = pt.TSR(T0w=np.asarray(t["T0w"], np.float64),
                                  Twe=np.asarray(t["Twe"], np.float64),
                                  Bw=np.asarray(t["Bw"], np.float64))
    return kw


@dataclasses.dataclass
class World:
    cfg: dict
    module: object      # CHOMPModule
    robot: object       # api.Robot
    run: object         # api.Run of the configuration's create
    kwargs: dict        # create's keyword arguments


def build(cfg, device, dtype=None):
    """The configuration's world on ``device``: the module with its
    bodies and robot, the field computed, and one run created (its
    engine is the one every later create of this shape takes from the
    module's cache)."""
    import torch

    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.api import KinBody, Robot

    dtype = dtype or getattr(torch, cfg["dtype"])
    mod = pt.CHOMPModule(dtype=dtype, device=device)
    for b in cfg["bodies"]:
        scene = pt.Scene.build(
            boxes=[(tuple(p), tuple(h)) for p, h in b["boxes"]],
            cylinders=[(tuple(p), r, h) for p, r, h in b["cylinders"]])
        mod.add_kinbody(KinBody(b["name"], scene))
    r = cfg["robot"]
    robot = mod.add_robot(Robot("robot", robot_model(cfg),
                                pose=np.asarray(r["pose"], np.float64),
                                q_active=np.asarray(r["start"], np.float64)))
    robot.enabled = False
    f = cfg["field"]
    mod.computedistancefield(kinbody=f["kinbody"],
                             cube_extent=f["cube_extent"],
                             aabb_padding=f["aabb_padding"])
    robot.enabled = True
    kw = create_kwargs(cfg)
    h = mod.create(robot="robot", **kw)
    return World(cfg=cfg, module=mod, robot=robot, run=mod.runs[h],
                 kwargs=kw)
