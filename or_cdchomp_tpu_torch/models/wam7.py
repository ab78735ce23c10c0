# Copied from or_cdchomp_tpu/models/wam7.py (host numpy; shared copy pending de-duplication).
"""Built-in Barrett WAM 7-DOF + BarrettHand model with the reference
sphere collision fixture.

The reference repository ships only the sphere annotations
(scripts/barrettwam_withspheres.robot.xml:22-46); the underlying
kinematics live in OpenRAVE's external data files
(robots/wam7.kinbody.xml / barretthand.kinbody.xml), which are not part
of the reference tree.  This module reconstructs the chain from
Barrett's published WAM geometry (shoulder height 0.346 m, upper arm
0.55 m with 0.045 m elbow jog, forearm 0.3 m, wrist-to-palm 0.06 m,
tool plate +0.22 m) so that every sphere attachment from the fixture
lands on the matching body segment.  Finger links use nominal
BarrettHand dimensions; finger joints are inactive in the reference
workload (active DOFs = arm only, test_wam7.py:52) and are frozen at
their current values.

Joint limits/velocities follow the Barrett WAM specs (same values
OpenRAVE's wam7 model uses, loaded by orcdchomp_mod.cpp:2638-2660).
"""

from __future__ import annotations

import numpy as np

from or_cdchomp_tpu_torch.models.robot import RobotModel

# the 16-sphere fixture, verbatim from
# scripts/barrettwam_withspheres.robot.xml:22-46
WAM7_SPHERES = (
    ("wam0", (0.22, 0.14, 0.346), 0.15),
    ("wam2", (0.0, 0.0, 0.2), 0.06),
    ("wam2", (0.0, 0.0, 0.3), 0.06),
    ("wam2", (0.0, 0.0, 0.4), 0.06),
    ("wam2", (0.0, 0.0, 0.5), 0.06),
    ("wam3", (0.0, 0.0, 0.0), 0.06),
    ("wam4", (0.0, 0.0, 0.2), 0.06),
    ("wam4", (0.0, 0.0, 0.1), 0.06),
    ("wam4", (0.0, 0.0, 0.3), 0.06),
    ("wam6", (0.0, 0.0, 0.1), 0.06),
    ("Finger0-1", (0.05, -0.01, 0.0), 0.04),
    ("Finger1-1", (0.05, -0.01, 0.0), 0.04),
    ("Finger2-1", (0.05, -0.01, 0.0), 0.04),
    ("Finger0-2", (0.05, 0.0, 0.0), 0.04),
    ("Finger1-2", (0.05, 0.0, 0.0), 0.04),
    ("Finger2-2", (0.05, 0.0, 0.0), 0.04),
)

_ID = (0, 0, 0, 0, 0, 0, 1)


def _pose(x, y, z, q=(0, 0, 0, 1)):
    return (x, y, z) + tuple(q)


# rotate -90deg about z: used to aim finger2's +x along +y
_QZ90 = (0.0, 0.0, np.sin(np.pi / 4), np.cos(np.pi / 4))


def wam7(active="arm") -> RobotModel:
    """Construct the WAM7+hand model.

    active: 'arm' (the 7 arm joints, matching
    r.SetActiveDOFs(m.GetArmIndices()) in test_wam7.py:52), 'all', or an
    explicit list of joint names.
    """
    links = [
        "wam0", "wam1", "wam2", "wam3", "wam4", "wam5", "wam6", "wam7",
        "handbase",
        "Finger0-1", "Finger0-2",
        "Finger1-1", "Finger1-2",
        "Finger2-1", "Finger2-2",
    ]
    deg = np.pi / 180.0
    joints = [
        dict(name="J1", parent="wam0", child="wam1",
             origin=_pose(0, 0, 0.346), axis=(0, 0, 1),
             limits=(-2.6, 2.6), max_vel=1.5708),
        dict(name="J2", parent="wam1", child="wam2",
             origin=_ID, axis=(0, 1, 0),
             limits=(-1.96, 1.96), max_vel=1.5708),
        dict(name="J3", parent="wam2", child="wam3",
             origin=_pose(0, 0, 0.55), axis=(0, 0, 1),
             limits=(-2.73, 2.73), max_vel=2.0944),
        dict(name="J4", parent="wam3", child="wam4",
             origin=_pose(0.045, 0, 0), axis=(0, 1, 0),
             limits=(-0.86, 3.13), max_vel=2.0944),
        dict(name="J5", parent="wam4", child="wam5",
             origin=_pose(-0.045, 0, 0.3), axis=(0, 0, 1),
             limits=(-4.79, 1.3), max_vel=4.1888),
        dict(name="J6", parent="wam5", child="wam6",
             origin=_ID, axis=(0, 1, 0),
             limits=(-1.57, 1.57), max_vel=4.1888),
        dict(name="J7", parent="wam6", child="wam7",
             origin=_pose(0, 0, 0.06), axis=(0, 0, 1),
             limits=(-3.0, 3.0), max_vel=1.0472),
        # hand (dummyhand fixed joint, barrettwam_withspheres.robot.xml:14-19)
        dict(name="dummyhand", parent="wam7", child="handbase",
             type="fixed", origin=_ID),
        # fingers: knuckle on palm face (z=0.0754), curl about local y
        dict(name="JF1", parent="handbase", child="Finger0-1",
             origin=_pose(0.025, 0, 0.0754), axis=(0, 1, 0),
             limits=(0.0, 2.44), max_vel=2.0),
        dict(name="JF1tip", parent="Finger0-1", child="Finger0-2",
             origin=_pose(0.07, 0, 0), axis=(0, 1, 0),
             limits=(0.0, 0.84), max_vel=2.0),
        dict(name="JF2", parent="handbase", child="Finger1-1",
             origin=_pose(-0.025, 0, 0.0754), axis=(0, 1, 0),
             limits=(0.0, 2.44), max_vel=2.0),
        dict(name="JF2tip", parent="Finger1-1", child="Finger1-2",
             origin=_pose(0.07, 0, 0), axis=(0, 1, 0),
             limits=(0.0, 0.84), max_vel=2.0),
        dict(name="JF3", parent="handbase", child="Finger2-1",
             origin=_pose(0, 0.05, 0.0754, _QZ90), axis=(0, 1, 0),
             limits=(0.0, 2.44), max_vel=2.0),
        dict(name="JF3tip", parent="Finger2-1", child="Finger2-2",
             origin=_pose(0.07, 0, 0), axis=(0, 1, 0),
             limits=(0.0, 0.84), max_vel=2.0),
    ]
    model = RobotModel.from_joints(
        "BarrettWAM", links, joints, spheres=WAM7_SPHERES,
        ee_link="wam7", ee_origin=_pose(0, 0, 0.22),
    )
    if active == "all":
        return model
    if active == "arm":
        active = ["J1", "J2", "J3", "J4", "J5", "J6", "J7"]
    return model.set_active(active)
