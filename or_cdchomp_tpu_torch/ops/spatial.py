"""Small pose-algebra matrices stacked over a batch (counterpart of the
parts of or_cdchomp_tpu/ops/spatial.py and ops/quat.py that the TSR
chain and the floating base's Jᵀ block use).

The JAX package writes these matrices entry by entry, one (C, B) array
per entry (``constraints._mm_ll``), which suits TPU vector lanes.  In
eager PyTorch every entry would be one or more kernel launches, so here
each matrix is one tensor (..., r, c), built from a source vector
(..., s) by one gather and one sign multiply, and matrices chain with
``torch.matmul``.  The gather and sign tables live on the device
(:class:`SpatialMats`), so building a matrix copies nothing from the
host and never synchronises.  Entry formulas follow spatial.c and
kin.c as the JAX package has them; sums may run in another order.

Quaternions are (x, y, z, w), poses [x, y, z, qx, qy, qz, qw].
"""

from __future__ import annotations

import numpy as np
import torch

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
            return (torch.as_tensor(idx, device=self.device),
                    torch.as_tensor(sign, dtype=dtype, device=self.device),
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
            return torch.as_tensor(rot[:, i].astype(dt), device=self.device)

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
