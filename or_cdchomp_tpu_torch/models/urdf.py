# Copied from or_cdchomp_tpu/models/urdf.py (host numpy; shared copy pending de-duplication).
"""URDF (subset) → RobotModel loader.

The reference gets robot kinematics from OpenRAVE, which loads robots
from OpenRAVE XML / COLLADA; users attach the orcdchomp sphere model
via the ``<orcdchomp><spheres>`` kinbody tag (orcdchomp_kdata.cpp:65-98).
This module gives the port an equivalent standalone ingestion
path: parse the ubiquitous URDF format directly into a
:class:`~or_cdchomp_tpu_torch.models.robot.RobotModel`.

Supported subset (everything CHOMP kinematics needs):
 - ``<link name=.../>``
 - ``<joint type=revolute|continuous|prismatic|fixed>`` with
   ``<origin xyz rpy/>``, ``<axis xyz/>``,
   ``<limit lower upper velocity/>``
 - sphere collision models from either
   (a) ``<collision><geometry><sphere radius=.../>`` elements with
       their ``<origin xyz/>`` (native URDF spheres), or
   (b) an orcdchomp ``<spheres>`` block (models/kdata.py) passed
       separately.

Joints of unsupported types (planar, floating) raise — the floating
base is modeled by the solver itself (ChompSpec.floating_base), not by
the URDF.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from or_cdchomp_tpu_torch.models.robot import RobotModel

_SUPPORTED = {"revolute", "continuous", "prismatic", "fixed"}


def _floats(text, n, default=None):
    if text is None:
        return np.asarray(default, dtype=np.float64)
    vals = [float(v) for v in text.replace(",", " ").split()]
    if len(vals) != n:
        raise ValueError(f"expected {n} numbers, got {text!r}")
    return np.asarray(vals, dtype=np.float64)


def _quat_from_rpy(rpy):
    """URDF fixed-axis roll-pitch-yaw → quaternion (x, y, z, w).

    URDF convention: R = Rz(yaw) · Ry(pitch) · Rx(roll).
    """
    r2, p2, y2 = 0.5 * rpy[0], 0.5 * rpy[1], 0.5 * rpy[2]
    cr, sr = np.cos(r2), np.sin(r2)
    cp, sp = np.cos(p2), np.sin(p2)
    cy, sy = np.cos(y2), np.sin(y2)
    return np.array([
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
        cr * cp * cy + sr * sp * sy,
    ])


def _origin_pose(el):
    """<origin xyz rpy/> element → pose7 (identity when absent)."""
    if el is None:
        return np.array([0, 0, 0, 0, 0, 0, 1.0])
    xyz = _floats(el.get("xyz"), 3, default=(0.0, 0.0, 0.0))
    rpy = _floats(el.get("rpy"), 3, default=(0.0, 0.0, 0.0))
    return np.concatenate([xyz, _quat_from_rpy(rpy)])


def parse_urdf(text: str, *, use_collision_spheres: bool = True,
               ee_link: str | None = None) -> RobotModel:
    """Parse a URDF document string into a RobotModel.

    Args:
      text: URDF XML.
      use_collision_spheres: collect ``<collision>`` sphere geometries
        as the CHOMP sphere model (links with no spheres contribute no
        collision geometry, exactly like an un-annotated link in the
        reference's kdata model).
      ee_link: end-effector link name for TSR constraints; defaults to
        the last link in topological order.

    Returns a RobotModel with all movable joints active (use
    :meth:`RobotModel.set_active` to freeze a subset).
    """
    root = ET.fromstring(text)
    if root.tag != "robot":
        raise ValueError("not a URDF document (root tag must be <robot>)")
    name = root.get("name", "urdf_robot")

    link_els = {el.get("name"): el for el in root.findall("link")}
    if not link_els:
        raise ValueError("URDF has no links")

    joints = []
    children = {}
    parents = {}
    for jel in root.findall("joint"):
        jtype = jel.get("type")
        if jtype not in _SUPPORTED:
            raise ValueError(f"unsupported URDF joint type {jtype!r}")
        parent = jel.find("parent").get("link")
        child = jel.find("child").get("link")
        if parent not in link_els or child not in link_els:
            raise ValueError(f"joint {jel.get('name')!r} references "
                             f"unknown link")
        lim = jel.find("limit")
        if jtype == "continuous":
            limits = None
            jt = "revolute"
        else:
            jt = jtype
            limits = None
            if lim is not None and jt != "fixed":
                limits = (float(lim.get("lower", "-inf") or "-inf"),
                          float(lim.get("upper", "inf") or "inf"))
        max_vel = 1.0
        if lim is not None and lim.get("velocity"):
            max_vel = float(lim.get("velocity"))
        axis_el = jel.find("axis")
        axis = (_floats(axis_el.get("xyz"), 3) if axis_el is not None
                else np.array([1.0, 0.0, 0.0]))  # URDF default axis = x
        joints.append(dict(
            name=jel.get("name"), parent=parent, child=child, type=jt,
            origin=_origin_pose(jel.find("origin")),
            axis=axis, limits=limits, max_vel=max_vel,
        ))
        children.setdefault(parent, []).append(child)
        parents[child] = parent

    # root link = the one that is never a child
    roots = [n for n in link_els if n not in parents]
    if len(roots) != 1:
        raise ValueError(f"URDF must have exactly one root link, "
                         f"found {roots}")

    # topological order by BFS from the root
    order = [roots[0]]
    frontier = [roots[0]]
    while frontier:
        nxt = []
        for p in frontier:
            for c in children.get(p, []):
                order.append(c)
                nxt.append(c)
        frontier = nxt
    if len(order) != len(link_els):
        orphans = set(link_els) - set(order)
        raise ValueError(f"links unreachable from root: {sorted(orphans)}")

    spheres = []
    if use_collision_spheres:
        for lname in order:
            for col in link_els[lname].findall("collision"):
                geo = col.find("geometry")
                if geo is None:
                    continue
                sph = geo.find("sphere")
                if sph is None:
                    continue
                pose = _origin_pose(col.find("origin"))
                spheres.append((lname, tuple(pose[:3]),
                                float(sph.get("radius"))))

    return RobotModel.from_joints(
        name, order, joints, spheres=spheres,
        ee_link=ee_link if ee_link is not None else order[-1])


def load_urdf(path: str, **kw) -> RobotModel:
    """Parse a URDF file from disk."""
    with open(path) as f:
        return parse_urdf(f.read(), **kw)
