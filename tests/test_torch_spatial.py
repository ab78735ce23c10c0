"""The port's spatial algebra (or_cdchomp_tpu_torch/ops/spatial.py, libcd's
cd_spatial) against the JAX package's (or_cdchomp_tpu/ops/spatial.py):
the same seeded numpy inputs through both, float64 on the CPU, within
rtol 1e-12 and atol 1e-12 (ROADMAP's bar for pure math).  The inputs
mirror tests/test_spatial.py's cases: random unit-quaternion poses, the
identity pose and axis-aligned rotations, twists in the se(3) map's
exact and small-angle branches and the zero twist, the spring-damper
with and without a reference velocity and at its reference, and
inertias built from a mass, a centre of mass and a positive-definite
rotational inertia.  The module-level pose Jacobians are also held to
``SpatialMats``' gather-table form, the TSR chain's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.ops import spatial as js
from or_cdchomp_tpu_torch.ops import spatial as ts

RTOL = ATOL = 1e-12
RNG = np.random.default_rng(11)
N = 12


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


H = np.sqrt(0.5)
QUATS = np.concatenate([_unit(RNG.normal(size=(N - 4, 4))),
                        [[0, 0, 0, 1.0], [1.0, 0, 0, 0], [0, H, 0, H],
                         [0, 0, H, -H]]])
POSES = np.concatenate([RNG.normal(size=(N, 3)), QUATS], axis=-1)
POSES2 = np.concatenate([RNG.normal(size=(N, 3)),
                         _unit(RNG.normal(size=(N, 4)))], axis=-1)
VECS = RNG.normal(size=(N, 3))
SIX = RNG.normal(size=(N, 6))
SIX2 = RNG.normal(size=(N, 6))
MATS6 = RNG.normal(size=(N, 6, 6))
# twists: exact branch, small-angle branch (‖w‖² < 1e-7), zero
TWISTS = np.concatenate([RNG.normal(size=(N - 3, 6)),
                         [[1e-5, -2e-5, 1e-5, 0.3, -0.1, 0.2],
                          [0, 0, 0, 1.0, 2.0, 3.0], np.zeros(6)]])
MASS = RNG.uniform(0.5, 3.0, size=N)
A = RNG.normal(size=(N, 3, 3))
ICOM = A @ np.swapaxes(A, -1, -2) + 3.0 * np.eye(3)


def _inertias():
    return np.array(js.inertia_from_com(jnp.asarray(MASS),
                                        jnp.asarray(VECS),
                                        jnp.asarray(ICOM)))


def _xm(p):
    return np.array(js.xm_from_pose(jnp.asarray(p)))


def _xf(p):
    return np.array(js.xf_from_pose(jnp.asarray(p)))


CASES = {
    "cross_mat": lambda: (VECS,),
    "xm_from_pose": lambda: (POSES,),
    "xm_to_pose": lambda: (_xm(POSES),),
    "xf_from_pose": lambda: (POSES,),
    "xf_to_pose": lambda: (_xf(POSES),),
    "inertia_x": lambda: (POSES, _inertias()),
    "pose_from_spavel_unittime": lambda: (TWISTS,),
    "H_from_spavel_unittime": lambda: (TWISTS,),
    "x_invert": lambda: (MATS6,),
    "v_to_pos": lambda: (SIX, VECS),
    "v_from_pos": lambda: (SIX, VECS),
    "f_to_pos": lambda: (SIX, VECS),
    "f_from_pos": lambda: (SIX, VECS),
    "pose_jac": lambda: (POSES,),
    "pose_jac_inverse": lambda: (POSES,),
    "inertia_from_com": lambda: (MASS, VECS, ICOM),
    "inertia_to_com": lambda: (_inertias(),),
    "inertia_sphere_solid": lambda: (VECS, MASS, RNG.uniform(0.1, 0.5,
                                                              size=N)),
    "vxIv": lambda: (SIX, _inertias()),
    "mat_crossf": lambda: (SIX,),
    "mat_crossm": lambda: (SIX,),
}


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in _flat(o)]
    return [np.asarray(out.numpy() if isinstance(out, torch.Tensor)
                       else out)]


def close(got, want):
    got, want = _flat(got), _flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    args = CASES[name]()
    got = getattr(ts, name)(*(torch.as_tensor(a) for a in args))
    want = getattr(js, name)(*(jnp.asarray(a) for a in args))
    close(got, want)


@pytest.mark.parametrize("with_ref", [True, False])
def test_spring_damper_matches_jax(with_ref):
    """Random poses and velocities, and a pose at its reference (the
    zero-rotation guard), with the keyword gains and with the defaults."""
    pose = np.concatenate([POSES, POSES2[:1]])
    pref = np.concatenate([POSES2, POSES2[:1]])
    vel = np.concatenate([SIX, SIX[:1]])
    vref = np.concatenate([SIX2, SIX2[:1]]) if with_ref else None
    t = [None if a is None else torch.as_tensor(a)
         for a in (pose, vel, pref, vref)]
    j = [None if a is None else jnp.asarray(a)
         for a in (pose, vel, pref, vref)]
    gains = dict(Klin=10.0, Blin=2.0, Kang=5.0, Bang=0.5)
    close(ts.spring_damper(*t, **gains), js.spring_damper(*j, **gains))
    close(ts.spring_damper(*t), js.spring_damper(*j))


def test_pose_jacobians_match_spatial_mats():
    mats = ts.SpatialMats("cpu", torch.float64)
    p = torch.as_tensor(POSES)
    close(mats.pose_jac(p), ts.pose_jac(p))
    close(mats.pose_jac_inverse(p[:, :3], p[:, 3:]), ts.pose_jac_inverse(p))
    close(mats.skew(p[:, :3]), ts.cross_mat(p[:, :3]))


def test_follows_input_dtype():
    p = torch.as_tensor(POSES, dtype=torch.float32)
    for out in (ts.xm_to_pose(ts.xm_from_pose(p)),
                ts.inertia_sphere_solid(p[:, :3], 2.0, 0.5),
                ts.pose_from_spavel_unittime(p[:, :6])):
        assert out.dtype == torch.float32


def test_chip_smoke_libcd_table_on_cpu():
    """chip_smoke's libcd phase table (every new quat / spatial function,
    float32 against the port's float64) run here on the CPU at 2,048
    inputs: it covers every such function and stays within its bar."""
    import chip_smoke as cs
    from or_cdchomp_tpu.ops import quat as jq

    worst = cs.libcd_math(torch, np, "cpu", n=2048)
    new = {n for n in dir(jq) if callable(getattr(jq, n))
           and not n.startswith("_") and n not in (
               "quat_normalize", "pose_normalize", "quat_rotate",
               "pose_apply", "pose_invert", "quat_to_R")}
    new |= {n for n in dir(js) if callable(getattr(js, n))
            and getattr(getattr(js, n), "__module__", "") == js.__name__
            and not n.startswith("_")}
    assert set(worst) == new
    assert max(worst.values()) <= cs.LIBCD_BAR
