"""Batched quaternion / pose7 algebra on tensors (counterpart of
or_cdchomp_tpu/ops/quat.py, libcd's cd_kin layer, kin.c:33-844).

A pose is ``[x, y, z, qx, qy, qz, qw]`` on the last axis; the quaternion
order is (x, y, z, w) as in libcd.  Every function broadcasts over the
leading axes and follows its inputs' device and dtype; the functions
that make a tensor from nothing (``quat_identity``, ``pose_identity``,
``pose_from_pos_quat(None, None)``) take ``dtype`` and ``device``.

Products and rotations are written component by component
(``unbind`` / ``stack``); the JAX package's einsum structure tensors
exist for XLA's CPU dispatch and are not carried over.  Branches are
``torch.where`` selections with the JAX package's conditions.
"""

from __future__ import annotations

import math

import numpy as np
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


def _hamilton(a, b):
    """Components of a ⊗ b from two (x, y, z, w) component sequences
    (tensors or floats) (kin.c:117-136)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return [aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz]


def _floats(const):
    """A numpy / list constant as Python floats (no device copy)."""
    return [float(v) for v in np.asarray(const, dtype=np.float64).ravel()]


def quat_identity(dtype=torch.float32, device="cuda"):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def pose_identity(dtype=torch.float32, device="cuda"):
    return torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype=dtype,
                        device=device)


def quat_normalize(q):
    """Unit-normalize quaternion(s) (kin.c:55-62)."""
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def pose_normalize(pose):
    """Normalize the quaternion part of pose(s) (kin.c:64-70)."""
    return torch.cat([pose[..., :3], quat_normalize(pose[..., 3:])], dim=-1)


def quat_flip_closerto(q, target):
    """Negate q where −q is closer (L2) to target (kin.c:72-90)."""
    d_orig = torch.sum((q - target) ** 2, dim=-1, keepdim=True)
    d_flip = torch.sum((-q - target) ** 2, dim=-1, keepdim=True)
    return torch.where(d_flip < d_orig, -q, q)


def pose_flip_closerto(pose, target):
    """Quaternion-flip pose(s) toward target pose(s) (kin.c:92-115)."""
    q = quat_flip_closerto(pose[..., 3:], target[..., 3:])
    return torch.cat([pose[..., :3], q], dim=-1)


def quat_compose(qab, qbc):
    """Hamilton product q_ac = q_ab ⊗ q_bc (kin.c:117-136)."""
    return torch.stack(_hamilton(qab.unbind(-1), qbc.unbind(-1)), dim=-1)


def quat_rotate(q, v):
    """Rotate 3-vector(s) v by quaternion(s) q (kin.c:389-420)."""
    return torch.einsum("...ab,...b->...a", _rot_matrix(q), v)


def quat_rotate_const(q, v_const):
    """Rotate a constant 3-vector (numpy or a list) by quaternion(s) q;
    the constant enters as Python floats."""
    vx, vy, vz = _floats(v_const)
    R = _rot_matrix(q)
    return R[..., 0] * vx + R[..., 1] * vy + R[..., 2] * vz


def quat_compose_const(q, k_const):
    """q ⊗ k for a constant quaternion k (numpy or a list)."""
    return torch.stack(_hamilton(q.unbind(-1), _floats(k_const)), dim=-1)


def pose_compose(pab, pbc):
    """pose_ac = pose_ab ∘ pose_bc (kin.c:138-212)."""
    q = quat_compose(pab[..., 3:], pbc[..., 3:])
    pos = quat_rotate(pab[..., 3:], pbc[..., :3]) + pab[..., :3]
    return torch.cat([pos, q], dim=-1)


def pose_apply(pab, pos_bc):
    """pos_ac = R_ab · pos_bc + t_ab (kin.c:214-245)."""
    return quat_rotate(pab[..., 3:], pos_bc) + pab[..., :3]


def pose_rotate_vec(pab, vec_bc):
    """Rotate free vector(s) by the pose's rotation (kin.c:247-271)."""
    return quat_rotate(pab[..., 3:], vec_bc)


def quat_invert(q):
    """Conjugate of unit quaternion(s) (kin.c:273-287)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def pose_invert(pose):
    """Inverse pose(s) (kin.c:289-326)."""
    qinv = quat_invert(pose[..., 3:])
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


def quat_from_R(R):
    """Rotation matrix (..., 3, 3) → unit quaternion(s): the four
    candidate solutions, the one of the largest denominator selected
    (the trace if positive, else the largest diagonal term), normalised
    (kin.c:422-508; the JAX package's rule, quat.py:228-264)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def denom(t):
        return torch.sqrt(torch.clamp(t, min=1e-12)) * 2

    s = denom(tr + 1.0)                                    # s = 4·qw
    qw = torch.stack([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      0.25 * s], -1)
    s = denom(1.0 + m00 - m11 - m22)
    qx = torch.stack([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s], -1)
    s = denom(1.0 + m11 - m00 - m22)
    qy = torch.stack([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                      (m02 - m20) / s], -1)
    s = denom(1.0 + m22 - m00 - m11)
    qz = torch.stack([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                      (m10 - m01) / s], -1)
    use_w = (tr > 0.0)[..., None]
    x_max = ((m00 > m11) & (m00 > m22))[..., None]
    y_max = (m11 > m22)[..., None]
    q = torch.where(use_w, qw,
                    torch.where(x_max, qx, torch.where(y_max, qy, qz)))
    return quat_normalize(q)


def pose_to_H(pose):
    """Pose(s) → homogeneous matrix (..., 4, 4) (kin.c:470-508)."""
    top = torch.cat([quat_to_R(pose[..., 3:]), pose[..., :3, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(top[..., :1, :3]),
                        torch.ones_like(top[..., :1, :1])], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def pose_from_H(H):
    """Homogeneous matrix (..., 4, 4) → pose(s)."""
    return torch.cat([H[..., :3, 3], quat_from_R(H[..., :3, :3])], dim=-1)


def pose_from_dR(d, R):
    """Position + rotation matrix → pose (kin.c:510-517)."""
    return torch.cat([d, quat_from_R(R)], dim=-1)


def _like(x, ref):
    """x (a float or tensor) as a tensor in ref's dtype and device."""
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def quat_from_axisangle(axis, angle):
    """so(3) exp map (kin.c:532-543)."""
    a2 = 0.5 * _like(angle, axis)
    return torch.cat([torch.sin(a2)[..., None] * axis,
                      torch.cos(a2)[..., None]], dim=-1)


def quat_to_axisangle(q):
    """Unit quaternion → (axis, angle) (kin.c:519-530); the axis is
    (1, 0, 0) where |sin(angle/2)| < 1e-12."""
    a2 = torch.arccos(torch.clamp(q[..., 3], -1.0, 1.0))
    s = torch.sin(a2)
    small = (torch.abs(s) < 1e-12)[..., None]
    axis = q[..., :3] / torch.where(small, 1.0, s[..., None])
    ex = torch.zeros_like(axis)
    ex[..., 0] = 1.0
    return torch.where(small, ex, axis), 2.0 * a2


def quat_to_ypr(q):
    """Quaternion → yaw-pitch-roll with the ±0.49999 gimbal-lock guards
    (kin.c:587-615)."""
    qx, qy, qz, qw = q.unbind(-1)
    sinp2 = qw * qy - qz * qx
    yaw_n = torch.atan2(2.0 * (qw * qz + qx * qy),
                        1.0 - 2.0 * (qy * qy + qz * qz))
    pitch_n = torch.asin(torch.clamp(2.0 * sinp2, -1.0, 1.0))
    roll_n = torch.atan2(2.0 * (qw * qx + qy * qz),
                         1.0 - 2.0 * (qx * qx + qy * qy))
    at = torch.atan2(qx, qw)
    hi = sinp2 > 0.49999
    lo = sinp2 < -0.49999
    yaw = torch.where(hi, -2.0 * at, torch.where(lo, 2.0 * at, yaw_n))
    pitch = torch.where(hi, math.pi / 2.0,
                        torch.where(lo, -math.pi / 2.0, pitch_n))
    roll = torch.where(hi | lo, 0.0, roll_n)
    return torch.stack([yaw, pitch, roll], dim=-1)


def pose_to_xyzypr(pose):
    """Pose → [x y z yaw pitch roll] (kin.c:617-646)."""
    return torch.cat([pose[..., :3], quat_to_ypr(pose[..., 3:])], dim=-1)


def quat_to_ypr_J(q):
    """d(yaw, pitch, roll)/d(qx, qy, qz, qw): (..., 3, 4), without
    gimbal-lock handling, as the reference (kin.c:648-678)."""
    qx, qy, qz, qw = q.unbind(-1)
    nu = 2.0 * (qw * qz + qx * qy)
    de = 1.0 - 2.0 * (qy * qy + qz * qz)
    den = de * de + nu * nu
    a, b = de / den, nu / den
    Jy = torch.stack([a * (2 * qy), a * (2 * qx) - b * (-4 * qy),
                      a * (2 * qw) - b * (-4 * qz), a * (2 * qz)], dim=-1)
    asq = 2.0 * (qw * qy - qz * qx)
    inv = 1.0 / torch.sqrt(torch.clamp(1.0 - asq * asq, min=1e-12))
    Jp = torch.stack([inv * 2 * (-qz), inv * 2 * qw, inv * 2 * (-qx),
                      inv * 2 * qy], dim=-1)
    nu2 = 2.0 * (qw * qx + qy * qz)
    de2 = 1.0 - 2.0 * (qx * qx + qy * qy)
    den2 = de2 * de2 + nu2 * nu2
    a2, b2 = de2 / den2, nu2 / den2
    Jr = torch.stack([a2 * (2 * qw) - b2 * (-4 * qx),
                      a2 * (2 * qz) - b2 * (-4 * qy), a2 * (2 * qy),
                      a2 * (2 * qx)], dim=-1)
    return torch.stack([Jy, Jp, Jr], dim=-2)


def pose_to_xyzypr_J(pose):
    """d(xyzypr)/d(pose7): (..., 6, 7) = [[I3, 0], [0, quat_to_ypr_J]]
    (kin.c:680-715)."""
    Jq = quat_to_ypr_J(pose[..., 3:])
    eye = torch.eye(3, dtype=pose.dtype, device=pose.device)
    top = torch.cat([eye.expand(Jq.shape[:-2] + (3, 3)),
                     torch.zeros_like(Jq)], dim=-1)
    bottom = torch.cat([torch.zeros_like(Jq[..., :3]), Jq], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def quat_from_ypr(ypr):
    """Yaw-pitch-roll → quaternion (kin.c:717-731)."""
    half = 0.5 * ypr
    cy2, cp2, cr2 = torch.cos(half).unbind(-1)
    sy2, sp2, sr2 = torch.sin(half).unbind(-1)
    return torch.stack([-sy2 * sp2 * cr2 + cy2 * cp2 * sr2,
                        cy2 * sp2 * cr2 + sy2 * cp2 * sr2,
                        -cy2 * sp2 * sr2 + sy2 * cp2 * cr2,
                        sy2 * sp2 * sr2 + cy2 * cp2 * cr2], dim=-1)


def pose_from_xyzypr(xyzypr):
    """[x y z yaw pitch roll] → pose (kin.c:733-752)."""
    return torch.cat([xyzypr[..., :3], quat_from_ypr(xyzypr[..., 3:])],
                     dim=-1)


def axisangle_rotate(axis, angle, v):
    """Rotate vector(s) v about ``axis`` by ``angle`` (Rodrigues,
    kin.c:545-560)."""
    angle = _like(angle, v)
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    return (v * c + torch.linalg.cross(axis, v, dim=-1) * s
            + axis * (torch.sum(axis * v, dim=-1, keepdim=True) * (1.0 - c)))


def axisangle_to_R(axis, angle):
    """Axis-angle → rotation matrix (..., 3, 3) (kin.c:562-583)."""
    return quat_to_R(quat_from_axisangle(axis, angle))


def pose_to_dR(pose):
    """Pose → (position (..., 3), rotation matrix (..., 3, 3))
    (kin.c:470-508)."""
    return pose[..., :3], quat_to_R(pose[..., 3:])


def pose_to_pos_quat(pose):
    """Pose → (pos (..., 3), quat (..., 4)) (kin.c:754-761)."""
    return pose[..., :3], pose[..., 3:]


def pose_from_pos_quat(pos=None, quat=None, dtype=torch.float32,
                       device="cuda"):
    """(pos, quat) → pose, either part defaulting to the identity
    (kin.c:762-770); ``dtype`` and ``device`` serve only when both are
    None."""
    if pos is None and quat is None:
        return pose_identity(dtype, device)
    if pos is None:
        pos = quat.new_zeros(quat.shape[:-1] + (3,))
    if quat is None:
        quat = pos.new_zeros(pos.shape[:-1] + (4,))
        quat[..., 3] = 1.0
    return torch.cat([pos, quat], dim=-1)


def pose_from_op(from_pos, to_pos):
    """Pose at ``from_pos`` whose +Z axis points at ``to_pos``; returns
    (pose, length) (kin.c:772-786)."""
    return pose_from_op_diff(from_pos, to_pos - from_pos)


def pose_from_op_diff(from_pos, to_diff):
    """Pose at ``from_pos`` with +Z along ``to_diff``; returns (pose,
    ‖to_diff‖).  The frame is completed by X from e2 × Z where
    |z_x| > 0.9, else by Y from Z × e1 (kin.c:788-844)."""
    length = torch.linalg.vector_norm(to_diff, dim=-1)
    z = to_diff / length[..., None]
    zx, zy, zz = z.unbind(-1)
    zero = torch.zeros_like(zz)
    len_a = torch.sqrt(zz * zz + zx * zx)
    xa = torch.stack([zz / len_a, zero, -zx / len_a], dim=-1)
    ya = torch.linalg.cross(z, xa, dim=-1)
    len_b = torch.sqrt(zz * zz + zy * zy)
    yb = torch.stack([zero, zz / len_b, -zy / len_b], dim=-1)
    xb = torch.linalg.cross(yb, z, dim=-1)
    use_a = (torch.abs(zx) > 0.9)[..., None]
    R = torch.stack([torch.where(use_a, xa, xb), torch.where(use_a, ya, yb),
                     z], dim=-1)
    return pose_from_dR(from_pos, R), length
