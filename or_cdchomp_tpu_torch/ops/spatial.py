"""6-D spatial (motion / force) vector algebra on tensors (counterpart of
or_cdchomp_tpu/ops/spatial.py, libcd's cd_spatial layer,
spatial.c:33-669), and the small pose-algebra matrices of the TSR chain
stacked over a batch.

The module-level functions are libcd's: motion / force transforms and
their inverses, the spatial inertia transform, the se(3) exponential map,
point shifts, the pose-velocity Jacobian and its inverse, inertia from /
to the centre of mass, v × Iv, the spring-damper wrench and the cross
matrices.  Spatial vectors are [angular(3); linear(3)]; every function
broadcasts over leading axes, follows its inputs' device and dtype, and
selects at singularities with ``torch.where`` as the JAX package does.

:class:`SpatialMats` serves the TSR chain and the floating base's Jᵀ
block.  The JAX package writes those matrices entry by entry, one (C, B)
array per entry (``constraints._mm_ll``), which suits TPU vector lanes.
In eager PyTorch every entry would be one or more kernel launches, so
there each matrix is one tensor (..., r, c), built from a source vector
(..., s) by one gather and one sign multiply, and matrices chain with
``torch.matmul``.  The gather and sign tables live on the device, so
building a matrix copies nothing from the host and never synchronises.
Entry formulas follow spatial.c and kin.c as the JAX package has them;
sums may run in another order.

Quaternions are (x, y, z, w), poses [x, y, z, qx, qy, qz, qw].
"""

from __future__ import annotations

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops.quat import (
    pose_invert, quat_compose, quat_from_axisangle, quat_from_R, quat_invert,
    quat_rotate, quat_to_R)
from or_cdchomp_tpu_torch.utils.profiling import to_device

# Each table is a list of rows; an entry is a source name, optionally
# with a leading '-', or "0" / "1".  The source vector of a table lists
# the names in its order.

# L(a) with a ⊗ b = L(a)·b (kin.c:116-136)
_QLEFT_SRC = ("x", "y", "z", "w")
_QLEFT = [["w", "-z", "y", "x"],
          ["z", "w", "-x", "y"],
          ["-y", "x", "w", "z"],
          ["-x", "-y", "-z", "w"]]

# [v]× with [v]×·u = v × u
_SKEW_SRC = ("0", "x", "y", "z")
_SKEW = [["0", "-z", "y"],
         ["z", "0", "-x"],
         ["-y", "x", "0"]]

# pose_jac's angular rows over (x y z qx qy qz qw), from 2q
# (spatial.c:295-337)
_ANG_SRC = ("0", "x2", "y2", "z2", "w2")
_ANG = [["0", "0", "0", "w2", "-z2", "y2", "-x2"],
        ["0", "0", "0", "z2", "w2", "-x2", "-y2"],
        ["0", "0", "0", "-y2", "x2", "w2", "-z2"]]

# pose_jac_inverse from the position and q/2 (spatial.c:339-375), 7×6
_JINV_SRC = ("0", "1", "px", "py", "pz", "xd2", "yd2", "zd2", "wd2")
_JINV = [["0", "pz", "-py", "1", "0", "0"],
         ["-pz", "0", "px", "0", "1", "0"],
         ["py", "-px", "0", "0", "0", "1"],
         ["wd2", "zd2", "-yd2", "0", "0", "0"],
         ["-zd2", "wd2", "xd2", "0", "0", "0"],
         ["yd2", "-xd2", "wd2", "0", "0", "0"],
         ["-xd2", "-yd2", "-zd2", "0", "0", "0"]]

# Bw-row order is (x y z roll pitch yaw); xyzypr order is
# (x y z yaw pitch roll): dims 3..5 flip via 8-i (orcdchomp_mod.cpp:1413)
_DIM_MAP = (0, 1, 2, 5, 4, 3)

# pose_to_xyzypr_J [[I3, 0], [0, Jq]] (kin.c:648-678), its rows taken in
# Bw order; Jq's rows (yaw, pitch, roll) from :meth:`SpatialMats.ypr`
_YPRJ_SRC = ("0", "1", "y0", "y1", "y2", "y3", "p0", "p1", "p2", "p3",
             "r0", "r1", "r2", "r3")
_XYZYPR_J = [["1", "0", "0", "0", "0", "0", "0"],
             ["0", "1", "0", "0", "0", "0", "0"],
             ["0", "0", "1", "0", "0", "0", "0"],
             ["0", "0", "0", "y0", "y1", "y2", "y3"],
             ["0", "0", "0", "p0", "p1", "p2", "p3"],
             ["0", "0", "0", "r0", "r1", "r2", "r3"]]
_YPRJ = [_XYZYPR_J[i] for i in _DIM_MAP]

# xyzypr's angles (kin.c:587-615) and their derivatives (kin.c:648-678),
# yaw and roll side by side: nu = 2(w·a + b·c), de = 1 − 2(b² + c²) with
# (a, b, c) = (z, x, y) for yaw and (x, y, z) for roll.  Picks of q:
_YPR_Q = ("x", "y", "z", "w")
_YPR_PICK = [["z", "x", "x", "y", "y", "z", "y", "x", "z", "y"]]
# d(yaw, pitch, roll)/dq = A·(2·P) − Bn·(−4·Q), rows yaw, pitch, roll
# (A = de/den, Bn = nu/den for yaw and roll; A = 1/cos(pitch), Bn = 0)
_YPR_EXT = ("0", "x", "y", "z", "w")
_YPR_P = [["y", "x", "w", "z"], ["-z", "w", "-x", "y"], ["w", "z", "y", "x"]]
_YPR_Q0 = [["0", "y", "z", "0"], ["0", "0", "0", "0"], ["x", "y", "0", "0"]]

# rotation matrix of q in the 1 − 2(…) form (kin.c:348-368) from the
# outer product q qᵀ flattened (index 4i + j):
# R = K + S·(o[I1] + S2·o[I2])
_XX, _XY, _XZ, _XW, _YY, _YZ, _YW, _ZZ, _ZW = 0, 1, 2, 3, 5, 6, 7, 10, 11
_ROT = [  # (I1, I2, S2, S, K) of R00 R01 R02 R10 … R22
    (_YY, _ZZ, 1.0, -2.0, 1.0), (_XY, _ZW, -1.0, 2.0, 0.0),
    (_XZ, _YW, 1.0, 2.0, 0.0),
    (_XY, _ZW, 1.0, 2.0, 0.0), (_XX, _ZZ, 1.0, -2.0, 1.0),
    (_YZ, _XW, -1.0, 2.0, 0.0),
    (_XZ, _YW, -1.0, 2.0, 0.0), (_YZ, _XW, 1.0, 2.0, 0.0),
    (_XX, _YY, 1.0, -2.0, 1.0),
]


def _gather_table(rows, src):
    """(index, sign) numpy arrays of a table over its source names."""
    idx, sign = [], []
    for row in rows:
        for e in row:
            neg = e.startswith("-")
            name = e[1:] if neg else e
            idx.append(src.index(name))
            sign.append(-1.0 if neg else 1.0)
    return np.asarray(idx), np.asarray(sign)


class SpatialMats:
    """The gather tables of the stacked small matrices on one device.
    Every method takes batched tensors (..., ·) and returns (..., r, c)
    or (..., k); the leading axes broadcast as in ``torch.matmul``."""

    def __init__(self, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype

        def table(rows, src):
            idx, sign = _gather_table(rows, src)
            return (to_device(idx, device=self.device),
                    to_device(sign, dtype=dtype, device=self.device),
                    (len(rows), len(rows[0])))

        self._qleft = table(_QLEFT, _QLEFT_SRC)
        self._skew = table(_SKEW, _SKEW_SRC)
        self._ang = table(_ANG, _ANG_SRC)
        self._jinv = table(_JINV, _JINV_SRC)
        self._yprj = table(_YPRJ, _YPRJ_SRC)
        self._ypr_pick = table(_YPR_PICK, _YPR_Q)
        self._ypr_p = table(_YPR_P, _YPR_EXT)
        self._ypr_q = table(_YPR_Q0, _YPR_EXT)
        rot = np.asarray(_ROT)

        def col(i, dt):
            return to_device(rot[:, i].astype(dt), device=self.device)

        self._rot = (col(0, np.int64), col(1, np.int64),
                     col(2, np.float64).to(dtype), col(3, np.float64).to(dtype),
                     col(4, np.float64).to(dtype))
        # [I3 | 0] over pose_jac's 7 columns: the linear rows' identity
        self._lin_eye = torch.eye(3, 7, dtype=dtype, device=self.device)

    @staticmethod
    def _build(tab, src):
        idx, sign, shape = tab
        return (src.index_select(-1, idx) * sign).unflatten(-1, shape)

    @staticmethod
    def _with_zero(v, one=False):
        """[0, (1,) v] along the last axis."""
        parts = [torch.zeros_like(v[..., :1])]
        if one:
            parts.append(torch.ones_like(v[..., :1]))
        return torch.cat(parts + [v], dim=-1)

    def qleft(self, q):
        """L(q) (..., 4, 4): q ⊗ b = L(q)·b."""
        return self._build(self._qleft, q)

    def rot(self, q):
        """R(q) (..., 3, 3) in the 1 − 2(…) form (kin.c:348-368); equal
        to the two-cross sandwich of ops/soa.qrot for any q."""
        i1, i2, s2, s, k = self._rot
        o = (q[..., :, None] * q[..., None, :]).flatten(-2)
        t = torch.addcmul(o.index_select(-1, i1), o.index_select(-1, i2), s2)
        return torch.addcmul(k, t, s).unflatten(-1, (3, 3))

    def skew(self, v):
        """[v]× (..., 3, 3)."""
        return self._build(self._skew, self._with_zero(v))

    def pose_jac(self, pose):
        """World spatial velocity per pose7 derivative (..., 6, 7), rows
        0-2 angular, 3-5 linear (spatial.c:295-337): the linear rows are
        [I3 | 0] + [p]× · (angular rows)."""
        ang = self._build(self._ang, self._with_zero(2.0 * pose[..., 3:]))
        lin = torch.matmul(self.skew(pose[..., :3]), ang) + self._lin_eye
        return torch.cat([ang, lin], dim=-2)

    def pose_jac_inverse(self, pos, q):
        """(..., 7, 6) of a pose given as position and quaternion
        (spatial.c:339-375)."""
        src = torch.cat([pos, 0.5 * q], dim=-1)
        return self._build(self._jinv, self._with_zero(src, one=True))

    def xm(self, pos, R):
        """Xm of a pose from its position and rotation matrix
        (spatial.c:71-102): [[R, 0], [[p]×R, R]] (..., 6, 6)."""
        top = torch.cat([R, torch.zeros_like(R)], dim=-1)
        bottom = torch.cat([torch.matmul(self.skew(pos), R), R], dim=-1)
        return torch.cat([top, bottom], dim=-2)

    def ypr(self, q):
        """xyzypr's angles of q (..., 4) with the reference's gimbal guards
        (kin.c:587-615) and their derivatives (kin.c:648-678), the JAX
        package's expressions (constraints.py:384-418) with yaw and roll
        computed side by side.  Returns ((roll, pitch, yaw) (...,) each,
        d(yaw, pitch, roll)/dq (..., 3, 4))."""
        qx, qy, qz, qw = q.unbind(-1)
        g = self._build(self._ypr_pick, q)[..., 0, :]
        qza, qxb, qyc, qyb, qzc = g.split(2, dim=-1)   # [yaw, roll] each
        w = q[..., 3:]
        nu = 2.0 * (w * qza + qxb * qyc)
        de = 1.0 - 2.0 * (qyb * qyb + qzc * qzc)
        yaw_n, roll_n = torch.atan2(nu, de).unbind(-1)
        asq = 2.0 * (qw * qy - qz * qx)                # 2·sin(pitch)
        pitch_n = torch.asin(torch.clamp(asq, -1.0, 1.0))
        at = torch.atan2(qx, qw)
        hi = asq > 2 * 0.49999
        lo = asq < -2 * 0.49999
        yaw = torch.where(hi, -2.0 * at, torch.where(lo, 2.0 * at, yaw_n))
        pitch = torch.where(hi, np.pi / 2.0,
                            torch.where(lo, -np.pi / 2.0, pitch_n))
        roll = torch.where(hi | lo, 0.0, roll_n)

        den = de * de + nu * nu
        inv = 1.0 / torch.sqrt(torch.clamp(1.0 - asq * asq, min=1e-12))
        a = torch.stack([de[..., 0] / den[..., 0], inv,
                         de[..., 1] / den[..., 1]], dim=-1)
        b = torch.stack([nu[..., 0] / den[..., 0], torch.zeros_like(inv),
                         nu[..., 1] / den[..., 1]], dim=-1)
        ext = self._with_zero(q)
        jac = (a[..., None] * (2.0 * self._build(self._ypr_p, ext))
               - b[..., None] * (-4.0 * self._build(self._ypr_q, ext)))
        return (roll, pitch, yaw), jac

    def ypr_jac(self, jq):
        """pose_to_xyzypr_J (..., 6, 7) with its rows in Bw order
        (x y z roll pitch yaw), from d(yaw, pitch, roll)/dq (..., 3, 4)."""
        src = jq.flatten(-2)
        return self._build(self._yprj, self._with_zero(src, one=True))


# ---- libcd's cd_spatial (spatial.c:33-669) ---------------------------------

def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _t(m):
    return m.transpose(-1, -2)


def _blocks(tl, tr, bl, br):
    """[[tl, tr], [bl, br]] from four (..., 3, 3) blocks."""
    return torch.cat([torch.cat([tl, tr], dim=-1),
                      torch.cat([bl, br], dim=-1)], dim=-2)


def cross_mat(v):
    """Skew-symmetric matrix [v]× (..., 3, 3) (spatial.c:610-637)."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.unflatten(-1, (3, 3))


def xm_from_pose(pose):
    """Spatial motion transform [[R, 0], [[r]×R, R]] (..., 6, 6) of a
    pose (spatial.c:71-102)."""
    R = quat_to_R(pose[..., 3:])
    rxR = cross_mat(pose[..., :3]) @ R
    return _blocks(R, torch.zeros_like(R), rxR, R)


def _unskew(m):
    """v from [v]× (averaging the antisymmetric pair)."""
    return 0.5 * torch.stack([m[..., 2, 1] - m[..., 1, 2],
                              m[..., 0, 2] - m[..., 2, 0],
                              m[..., 1, 0] - m[..., 0, 1]], dim=-1)


def xm_to_pose(xm):
    """Pose of a spatial motion transform: r from [r]× = BL·Rᵀ, the
    quaternion from the top-left R (spatial.c:33-51)."""
    R = xm[..., 0:3, 0:3]
    r = _unskew(xm[..., 3:6, 0:3] @ _t(R))
    return torch.cat([r, quat_from_R(R)], dim=-1)


def xf_from_pose(pose):
    """Spatial force transform [[R, [r]×R], [0, R]] (..., 6, 6) of a
    pose (spatial.c:105-135)."""
    R = quat_to_R(pose[..., 3:])
    rxR = cross_mat(pose[..., :3]) @ R
    return _blocks(R, rxR, torch.zeros_like(R), R)


def xf_to_pose(xf):
    """Pose of a spatial force transform (spatial.c:53-69)."""
    R = xf[..., 0:3, 0:3]
    r = _unskew(xf[..., 0:3, 3:6] @ _t(R))
    return torch.cat([r, quat_from_R(R)], dim=-1)


def inertia_x(pose_ab, inertia_b):
    """A 6×6 spatial inertia from frame b to frame a:
    I_a = Xm_baᵀ · I_b · Xm_ba (spatial.c:137-149)."""
    xm_ba = xm_from_pose(pose_invert(pose_ab))
    return _t(xm_ba) @ (inertia_b @ xm_ba)


def _series(w2, coeffs):
    """Σ_k coeffs[k] · w2^k (the small-angle Taylor series)."""
    out = torch.full_like(w2, coeffs[0])
    for k, c in enumerate(coeffs[1:], start=1):
        out = out + c * w2 ** k
    return out


def pose_from_spavel_unittime(spavel):
    """se(3) exponential map: twist → pose after unit time
    (spatial.c:152-198); below ‖w‖² = 1e-7 by Taylor series."""
    w, v = spavel[..., :3], spavel[..., 3:]
    w2 = torch.sum(w * w, dim=-1)
    wdotv = torch.sum(w * v, dim=-1)
    small = w2 < 1e-7

    c_cross_s = _series(w2, (0.5, -1 / 24.0, 1 / 720.0, -1 / 40320.0))
    c_v_s = _series(w2, (1.0, -1 / 6.0, 1 / 120.0, -1 / 5040.0))
    c_w_s = _series(w2, (1 / 6.0, -1 / 120.0, 1 / 5040.0,
                         -1 / 362880.0)) * wdotv
    qv_s = _series(w2, (0.5, -1 / 48.0, 1 / 3840.0, -1 / 645120.0))
    qw_s = _series(w2, (1.0, -1 / 8.0, 1 / 384.0, -1 / 46080.0))
    q_small = torch.cat([qv_s[..., None] * w, qw_s[..., None]], dim=-1)

    w2_safe = torch.where(small, 1.0, w2)
    th = torch.sqrt(w2_safe)
    c_cross_e = (1.0 - torch.cos(th)) / w2_safe
    c_v_e = torch.sin(th) / th
    c_w_e = (1.0 - c_v_e) * wdotv / w2_safe
    q_exact = quat_from_axisangle(w / th[..., None], th)

    c_cross = torch.where(small, c_cross_s, c_cross_e)[..., None]
    c_v = torch.where(small, c_v_s, c_v_e)[..., None]
    c_w = torch.where(small, c_w_s, c_w_e)[..., None]
    q = torch.where(small[..., None], q_small, q_exact)
    pos = c_cross * _cross(w, v) + c_v * v + c_w * w
    return torch.cat([pos, q], dim=-1)


def H_from_spavel_unittime(spavel):
    """se(3) exp map as a homogeneous matrix, H = I + S + s2·S² + s3·S³
    with S the 4×4 screw matrix (spatial.c:200-248)."""
    w = spavel[..., :3]
    w2 = torch.sum(w * w, dim=-1)
    small = w2 < 1e-7
    w2_safe = torch.where(small, 1.0, w2)
    th = torch.sqrt(w2_safe)
    s2 = torch.where(small,
                     _series(w2, (0.5, -1 / 24.0, 1 / 720.0, -1 / 40320.0)),
                     (1.0 - torch.cos(th)) / w2_safe)
    s3 = torch.where(small,
                     _series(w2, (1 / 6.0, -1 / 120.0, 1 / 5040.0,
                                  -1 / 362880.0)),
                     (th - torch.sin(th)) / (th * w2_safe))
    top = torch.cat([cross_mat(w), spavel[..., 3:, None]], dim=-1)
    S = torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)
    S2 = S @ S
    eye = torch.eye(4, dtype=S.dtype, device=S.device)
    return (eye + S + s2[..., None, None] * S2
            + s3[..., None, None] * (S @ S2))


def x_invert(x):
    """Invert a spatial transform by transposing each 3×3 block
    (spatial.c:251-268)."""
    blocks = x.reshape(x.shape[:-2] + (2, 3, 2, 3))
    return blocks.transpose(-1, -3).reshape(x.shape)


def v_to_pos(vel, pos):
    """A spatial velocity re-expressed at a point: lin += w × pos
    (spatial.c:270-274)."""
    w = vel[..., :3]
    return torch.cat([w, vel[..., 3:] + _cross(w, pos)], dim=-1)


def v_from_pos(vel, pos):
    """The inverse point shift: lin += pos × w (spatial.c:276-280)."""
    w = vel[..., :3]
    return torch.cat([w, vel[..., 3:] + _cross(pos, w)], dim=-1)


def f_to_pos(force, pos):
    """Spatial force point shift: ang += f × pos (spatial.c:282-286)."""
    f = force[..., 3:]
    return torch.cat([force[..., :3] + _cross(f, pos), f], dim=-1)


def f_from_pos(force, pos):
    """The inverse force shift: ang += pos × f (spatial.c:288-292)."""
    f = force[..., 3:]
    return torch.cat([force[..., :3] + _cross(pos, f), f], dim=-1)


def _rows(rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def pose_jac(pose):
    """World spatial velocity per pose7 derivative (..., 6, 7), rows 0-2
    angular, 3-5 linear (spatial.c:295-337)."""
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    qx, qy, qz, qw = (2.0 * pose[..., 3:]).unbind(-1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return _rows([
        [zero, zero, zero, qw, -qz, qy, -qx],
        [zero, zero, zero, qz, qw, -qx, -qy],
        [zero, zero, zero, -qy, qx, qw, -qz],
        [one, zero, zero, -z * qz - y * qy, -z * qw + y * qx,
         z * qx + y * qw, z * qy - y * qz],
        [zero, one, zero, z * qw + x * qy, -z * qz - x * qx,
         z * qy - x * qw, -z * qx + x * qz],
        [zero, zero, one, -y * qw + x * qz, y * qz + x * qw,
         -y * qy - x * qx, y * qx - x * qy],
    ])


def pose_jac_inverse(pose):
    """Pose7 rates per world spatial velocity (..., 7, 6)
    (spatial.c:339-375)."""
    x, y, z = pose[..., 0], pose[..., 1], pose[..., 2]
    qx, qy, qz, qw = (0.5 * pose[..., 3:]).unbind(-1)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return _rows([
        [zero, z, -y, one, zero, zero],
        [-z, zero, x, zero, one, zero],
        [y, -x, zero, zero, zero, one],
        [qw, qz, -qy, zero, zero, zero],
        [-qz, qw, qx, zero, zero, zero],
        [qy, -qx, qw, zero, zero, zero],
        [-qx, -qy, -qz, zero, zero, zero],
    ])


def inertia_from_com(mass, com, Icom):
    """6×6 spatial inertia from the mass, the COM offset and the
    rotational inertia about the COM (spatial.c:377-423)::

        [ Icom + m·[c]×[c]×ᵀ   m·[c]× ]
        [ m·[c]×ᵀ              m·I    ]

    ``mass`` and ``Icom`` may be numbers or arrays; they take ``com``'s
    dtype and device."""
    com = torch.as_tensor(com)
    mass = torch.as_tensor(mass, dtype=com.dtype, device=com.device)
    Icom = torch.as_tensor(Icom, dtype=com.dtype, device=com.device)
    cx = cross_mat(com)
    m_ = mass[..., None, None]
    tl = Icom + m_ * (cx @ _t(cx))
    eye = torch.eye(3, dtype=tl.dtype, device=tl.device)
    return _blocks(tl, m_ * cx, m_ * _t(cx), (m_ * eye).expand(tl.shape))


def inertia_to_com(inertia):
    """(mass, com, Icom) of a 6×6 spatial inertia (spatial.c:425-461;
    the reference's ``-+`` on Icom[0][0] parses as a subtraction, and so
    it is here)."""
    mass = (inertia[..., 3, 3] + inertia[..., 4, 4]
            + inertia[..., 5, 5]) / 3.0
    com = (_unskew(inertia[..., 0:3, 3:6])
           + _unskew(_t(inertia[..., 3:6, 0:3]))) / (2.0 * mass[..., None])
    cx = cross_mat(com)
    Icom = inertia[..., 0:3, 0:3] - mass[..., None, None] * (cx @ _t(cx))
    return mass, com, Icom


def inertia_sphere_solid(pos, mass, radius):
    """Spatial inertia of a solid sphere at ``pos`` (spatial.c:463-471);
    ``mass`` and ``radius`` take ``pos``'s dtype and device."""
    pos = torch.as_tensor(pos)
    mass = torch.as_tensor(mass, dtype=pos.dtype, device=pos.device)
    radius = torch.as_tensor(radius, dtype=pos.dtype, device=pos.device)
    Ielem = 0.4 * mass * radius * radius
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    return inertia_from_com(mass, pos, Ielem[..., None, None] * eye)


def vxIv(v, I):
    """Velocity-product bias force v ×* (I·v) (spatial.c:473-482):
    [w × (Iv)_ang + vlin × (Iv)_lin ; w × (Iv)_lin]."""
    Iv = torch.einsum("...ij,...j->...i", I, v)
    w, vlin = v[..., :3], v[..., 3:]
    ang = _cross(w, Iv[..., :3]) + _cross(vlin, Iv[..., 3:])
    return torch.cat([ang, _cross(w, Iv[..., 3:])], dim=-1)


def spring_damper(pose, vel, pose_ref, vel_ref=None,
                  Klin=0.0, Blin=0.0, Kang=0.0, Bang=0.0):
    """Spatial PD spring-damper wrench [torque; force] at the world
    origin pulling ``pose`` toward ``pose_ref`` (spatial.c:484-608).
    ``vel`` / ``vel_ref`` are world spatial velocities at the origin;
    the reference accumulates into its ``force`` argument, here the
    increment is returned."""
    p, q = pose[..., :3], pose[..., 3:]
    w = vel[..., :3]
    # the body point's linear velocity v + w × p (spatial.c:517-519)
    v_at_body = vel[..., 3:] + _cross(w, p)
    rp, rq = pose_ref[..., :3], pose_ref[..., 3:]
    if vel_ref is None:
        rw = torch.zeros_like(w)
        rv_at_body = torch.zeros_like(v_at_body)
    else:
        rw = vel_ref[..., :3]
        rv_at_body = vel_ref[..., 3:] + _cross(rw, rp)

    # orientation error as a world-frame rotation vector
    q_err = quat_compose(quat_invert(rq), q)
    qw = torch.clamp(q_err[..., 3], -1.0, 1.0)
    sin_half = torch.sqrt(torch.clamp(1.0 - qw * qw, min=0.0))
    tiny = sin_half < 1e-12
    scale = torch.where(tiny, 0.0, 2.0 * torch.arccos(qw)
                        / torch.where(tiny, 1.0, sin_half))
    aa_world = quat_rotate(rq, scale[..., None] * q_err[..., :3])

    f = -Klin * (p - rp) - Blin * (v_at_body - rv_at_body)
    n = -Kang * aa_world - Bang * (w - rw) + _cross(p, f)
    return torch.cat([n, f], dim=-1)


def mat_crossf(v):
    """Spatial force cross matrix [v ×*] = [[[w]×, [v]×], [0, [w]×]]
    (..., 6, 6) (spatial.c:643-669)."""
    wx, vx = cross_mat(v[..., :3]), cross_mat(v[..., 3:])
    return _blocks(wx, vx, torch.zeros_like(wx), wx)


def mat_crossm(v):
    """Spatial motion cross matrix [v ×] = [[[w]×, 0], [[v]×, [w]×]]
    (..., 6, 6), the dual of :func:`mat_crossf` (crossf = −crossmᵀ)."""
    wx, vx = cross_mat(v[..., :3]), cross_mat(v[..., 3:])
    return _blocks(wx, torch.zeros_like(wx), vx, wx)
