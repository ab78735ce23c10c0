"""Batched pose7 algebra on tensors (counterpart of
or_cdchomp_tpu/ops/quat.py).

Only what the SDF build needs (``pose_apply``, ``pose_invert``,
``quat_to_R``) and the floating base's renormalisation
(``quat_normalize``, ``pose_normalize``).  A pose is
``[x, y, z, qx, qy, qz, qw]`` on the last axis; the quaternion order is
(x, y, z, w) as in libcd (kin.c:116-420).
"""

from __future__ import annotations

import torch


def _rot_matrix(q):
    """R(q) (..., 3, 3) in the pure quadratic sandwich form
    (kin.c:389-420), exact for unit q."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz, ww = x * x, y * y, z * z, w * w
    xy, xz, xw = x * y, x * z, x * w
    yz, yw, zw = y * z, y * w, z * w
    rows = [
        [xx - yy - zz + ww, 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), -xx + yy - zz + ww, 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), -xx - yy + zz + ww],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by quaternion(s) q."""
    return torch.einsum("...ab,...b->...a", _rot_matrix(q), v)


def pose_apply(pab, pos_bc):
    """pos_ac = R_ab · pos_bc + t_ab (kin.c:214-245)."""
    return quat_rotate(pab[..., 3:], pos_bc) + pab[..., :3]


def pose_invert(pose):
    """Inverse pose(s) (kin.c:289-326)."""
    qinv = torch.cat([-pose[..., 3:6], pose[..., 6:7]], dim=-1)
    return torch.cat([-quat_rotate(qinv, pose[..., :3]), qinv], dim=-1)


def quat_to_R(q):
    """Unit quaternion(s) → rotation matrix (..., 3, 3), the 1−2(...)
    form of kin.c:348-368."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, xw = x * y, x * z, x * w
    yz, yw, zw = y * z, y * w, z * w
    one = torch.ones_like(x)
    rows = [
        [one - 2 * (yy + zz), 2 * (xy - zw), 2 * (xz + yw)],
        [2 * (xy + zw), one - 2 * (xx + zz), 2 * (yz - xw)],
        [2 * (xz - yw), 2 * (yz + xw), one - 2 * (xx + yy)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_normalize(q):
    """Unit-normalize quaternion(s) (kin.c:55-62)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def pose_normalize(pose):
    """Normalize the quaternion part of pose(s) (kin.c:64-70)."""
    return torch.cat([pose[..., :3], quat_normalize(pose[..., 3:])], dim=-1)
