# Copied from or_cdchomp_tpu/utils/np_pose.py (host numpy; shared copy pending de-duplication).
"""Host-side float64 pose7 helpers (problem construction only).

The device-side batched versions live in ops/quat.py; these mirror the
same libcd semantics (kin.c:116-326) in plain numpy for one-off host
work: rooting SDFs, folding frozen joints, building trajectories.
"""

from __future__ import annotations

import numpy as np

POSE_ID = np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])


def rotate(q, v):
    qx, qy, qz, qw = q
    x, y, z = v
    qx2, qy2, qz2, qw2 = qx * qx, qy * qy, qz * qz, qw * qw
    xy, xz, xw = qx * qy, qx * qz, qx * qw
    yz, yw, zw = qy * qz, qy * qw, qz * qw
    return np.array([
        x * (qx2 - qy2 - qz2 + qw2) + 2 * y * (xy - zw) + 2 * z * (xz + yw),
        2 * x * (xy + zw) + y * (-qx2 + qy2 - qz2 + qw2) + 2 * z * (yz - xw),
        2 * x * (xz - yw) + 2 * y * (yz + xw) + z * (-qx2 - qy2 + qz2 + qw2),
    ])


def compose(pab, pbc):
    pab = np.asarray(pab, dtype=np.float64)
    pbc = np.asarray(pbc, dtype=np.float64)
    ax, ay, az, aw = pab[3:]
    bx, by, bz, bw = pbc[3:]
    q = np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])
    return np.concatenate([rotate(pab[3:], pbc[:3]) + pab[:3], q])


def invert(pose):
    pose = np.asarray(pose, dtype=np.float64)
    qinv = np.array([-pose[3], -pose[4], -pose[5], pose[6]])
    return np.concatenate([-rotate(qinv, pose[:3]), qinv])


def apply(pab, pos):
    pab = np.asarray(pab, dtype=np.float64)
    return rotate(pab[3:], np.asarray(pos, dtype=np.float64)) + pab[:3]


def normalize(pose):
    pose = np.asarray(pose, dtype=np.float64).copy()
    pose[3:] /= np.linalg.norm(pose[3:])
    return pose
