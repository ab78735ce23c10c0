"""Structure-of-arrays quaternion/vector primitives for the batched
cost path.

The step carries every x/y/z (or quaternion) component as its own slice
of a (c, ..., B) tensor with the problem batch last: the layout the FK
kernel writes (csrc/fk.cu) and K1, K2 and the Jᵀ map read, so a warp's
threads load consecutive problems.  These operators take one such
vec3 or quat as anything whose iteration yields its components: a
(c, ...) tensor (iterated along its first axis, each component a view)
or a tuple of tensors, mutually broadcastable, and return a tuple.
Formulas mirror ops/quat.py (Hamilton conventions of kin.c:116-271);
``qrot`` uses the two-cross sandwich v' = v + w·t + q×t, t = 2(q×v) —
identical to the pure quadratic form for unit quaternions
(kin.c:389-420).  The operators are the JAX package's
(or_cdchomp_tpu/ops/soa.py), unchanged.
"""

from __future__ import annotations


# ---- vec3 ------------------------------------------------------------------

def cross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def norm2(a):
    return a[0] * a[0] + a[1] * a[1] + a[2] * a[2]


# ---- quat ------------------------------------------------------------------

def qmul(a, b):
    """Hamilton product (kin.c:116-136)."""
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz)


def qmul_const(a, k):
    """a ⊗ k with k a constant length-4 (x,y,z,w) of Python/numpy
    scalars — constants fold at trace time."""
    kx, ky, kz, kw = (float(k[0]), float(k[1]), float(k[2]), float(k[3]))
    ax, ay, az, aw = a
    return (aw * kx + ax * kw + ay * kz - az * ky,
            aw * ky - ax * kz + ay * kw + az * kx,
            aw * kz + ax * ky - ay * kx + az * kw,
            aw * kw - ax * kx - ay * ky - az * kz)


def qrot(q, v):
    """Rotate vec3 v by unit quat q: v + w·t + q×t with t = 2(q×v)."""
    qv = (q[0], q[1], q[2])
    w = q[3]
    t = scale(cross(qv, v), 2.0)
    return add(add(v, scale(t, w)), cross(qv, t))


def qrot_const(q, v):
    """Rotate a *constant* vec3 (Python/numpy scalars) by quat arrays."""
    vc = (float(v[0]), float(v[1]), float(v[2]))
    qv = (q[0], q[1], q[2])
    w = q[3]
    tx = 2.0 * (qv[1] * vc[2] - qv[2] * vc[1])
    ty = 2.0 * (qv[2] * vc[0] - qv[0] * vc[2])
    tz = 2.0 * (qv[0] * vc[1] - qv[1] * vc[0])
    return (vc[0] + w * tx + (qv[1] * tz - qv[2] * ty),
            vc[1] + w * ty + (qv[2] * tx - qv[0] * tz),
            vc[2] + w * tz + (qv[0] * ty - qv[1] * tx))
