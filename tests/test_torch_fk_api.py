"""The port's per-problem FK (CompiledFK.red_poses … fk_spheres, layout
(..., n_dof)) against the JAX package's CompiledFK, float64 on the CPU,
within rtol 1e-12 and atol 1e-12 (the same float64 chain, summed in
another order): the WAM7 under a base quaternion not of unit norm, with
and without a sphere subset (tests/test_fk.py's active-first order), the
WAM7 with every DOF active, and a small chain with a prismatic joint.
``sphere_positions_red`` is also held to the port's own ``fk_soa`` on
the same configurations (a unit base quaternion: the two FK forms round
the non-unit case differently, as in the JAX package)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.models import robot as jrobot
from or_cdchomp_tpu.models.wam7 import wam7 as jax_wam7
from or_cdchomp_tpu_torch.models import robot as trobot
from or_cdchomp_tpu_torch.models.wam7 import wam7

RTOL = ATOL = 1e-12
RNG = np.random.default_rng(14)
# a base quaternion of norm 1.05, as config 2's is not of unit norm
BASE = np.array([0.3, -0.2, 0.1, 0.0, 0.0, 0.40181760, 0.96906900])


def close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def _slider(pkg):
    """base → revolute (z) → prismatic (x) → fixed tool → revolute (y),
    spheres on every link; unit joint-origin quaternions."""
    s1, c1 = np.sin(np.pi / 8), np.cos(np.pi / 8)
    s2, c2 = np.sin(0.2), np.cos(0.2)
    joints = [
        dict(name="j0", parent="base", child="l1", type="revolute",
             origin=[0, 0, 0.2, 0, 0, 0, 1], axis=[0, 0, 1]),
        dict(name="j1", parent="l1", child="l2", type="prismatic",
             origin=[0.1, 0, 0, 0, 0, s1, c1],
             axis=[1, 0, 0], limits=(-0.5, 0.5)),
        dict(name="j2", parent="l2", child="tool", type="fixed",
             origin=[0, 0.05, 0.1, s2, 0, 0, c2]),
        dict(name="j3", parent="tool", child="l4", type="revolute",
             origin=[0, 0, 0.1, 0, 0, 0, 1], axis=[0, 1, 0]),
    ]
    spheres = [("base", [0, 0, 0.05], 0.05), ("l1", [0.05, 0, 0], 0.04),
               ("l2", [0.1, 0.02, 0], 0.03), ("tool", [0, 0, 0.03], 0.02),
               ("l4", [0.02, 0, 0.1], 0.02)]
    return pkg.RobotModel.from_joints(
        "slider", ["base", "l1", "l2", "tool", "l4"], joints, spheres)


ACTIVE_FIRST = np.array([3, 1, 2, 9, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15])
CASES = {
    "wam7": (lambda: wam7(), lambda: jax_wam7(), None),
    "wam7_subset": (lambda: wam7(), lambda: jax_wam7(), ACTIVE_FIRST),
    "wam7_all": (lambda: wam7("all"), lambda: jax_wam7("all"), None),
    "slider": (lambda: _slider(trobot), lambda: _slider(jrobot), None),
}


def _pair(case):
    tmodel, jmodel, subset = CASES[case]
    t = trobot.CompiledFK(tmodel(), dtype=torch.float64, device="cpu",
                          sphere_subset=subset)
    j = jrobot.CompiledFK(jmodel(), dtype=jnp.float64, sphere_subset=subset)
    return t, j


def _q(fk, batch=(3, 4)):
    return RNG.uniform(-2.0, 2.0, size=batch + (fk.n_dof,))


@pytest.mark.parametrize("case", sorted(CASES))
def test_poses_and_spheres_match_jax(case):
    t, j = _pair(case)
    q = _q(t)
    base = np.broadcast_to(BASE, q.shape[:-1] + (7,))
    tq, tb, jq, jb = (torch.as_tensor(q), torch.as_tensor(base.copy()),
                      jnp.asarray(q), jnp.asarray(base))
    red, anchors = t.red_poses(tq, tb)
    jred, janchors = j.red_poses(jq, jb)
    close(red, jred)
    close(anchors, janchors)
    lp, la = t.link_poses(tq, tb)
    jlp, jla = j.link_poses(jq, jb)
    close(lp, jlp)
    close(la, janchors)
    for link in range(t.n_links):
        close(t.link_pose_red(red, link), j.link_pose_red(jred, link))
    close(t.sphere_positions(lp), j.sphere_positions(jlp))
    close(t.sphere_positions_red(red), j.sphere_positions_red(jred))
    close(t.sphere_positions_jit(tq, tb), j.sphere_positions_jit(jq, jb))
    # the identity base by default
    close(t.link_poses(tq)[0], j.link_poses(jq)[0])


@pytest.mark.parametrize("case", sorted(CASES))
def test_jacobians_match_jax(case):
    t, j = _pair(case)
    q = _q(t)
    base = np.broadcast_to(BASE, q.shape[:-1] + (7,)).copy()
    x, jac, lp = t.fk_spheres(torch.as_tensor(q), torch.as_tensor(base))
    jx, jjac, jlp = j.fk_spheres(jnp.asarray(q), jnp.asarray(base))
    close(x, jx)
    close(jac, jjac)
    close(lp, jlp)
    _, anchors = t.red_poses(torch.as_tensor(q), torch.as_tensor(base))
    _, janchors = j.red_poses(jnp.asarray(q), jnp.asarray(base))
    close(t.sphere_jacobians(anchors, x), j.sphere_jacobians(janchors, jx))
    w = RNG.normal(size=tuple(x.shape))
    close(t.apply_sphere_jacT(anchors, x, torch.as_tensor(w)),
          j.apply_sphere_jacT(janchors, jx, jnp.asarray(w)))
    # Σ_s J(s)ᵀ w_s equals the contraction with the explicit Jacobians
    close(t.apply_sphere_jacT(anchors, x, torch.as_tensor(w)),
          torch.einsum("...sci,...sc->...i", jac, torch.as_tensor(w)))
    pt = RNG.normal(size=q.shape[:-1] + (3,))
    mask = RNG.uniform(size=q.shape[:-1] + (t.n_dof,)) < 0.6
    close(t.point_jacobian(anchors, torch.as_tensor(pt),
                           torch.as_tensor(mask)),
          j.point_jacobian(janchors, jnp.asarray(pt), jnp.asarray(mask)))


@pytest.mark.parametrize("case", ["wam7", "wam7_subset", "slider"])
def test_sphere_positions_red_matches_fk_soa(case):
    """The port's two FK forms on the same configurations: fk_soa
    (batch last, the step's) and red_poses + sphere_positions_red."""
    t, _ = _pair(case)
    n_points, B = 5, 6
    qT = RNG.uniform(-2.0, 2.0, size=(n_points, t.n_dof, B))
    q = RNG.normal(size=(B, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    pos = RNG.normal(size=(B, 3)) * 0.3
    out = t.fk_soa(torch.as_tensor(qT), tuple(torch.as_tensor(pos.T)),
                   tuple(torch.as_tensor(q.T)))
    base = torch.as_tensor(np.concatenate([pos, q], axis=1))[:, None]
    red, anchors = t.red_poses(torch.as_tensor(qT.transpose(2, 0, 1)), base)
    x = t.sphere_positions_red(red)                     # (B, n_points, S, 3)
    close(x.permute(3, 1, 2, 0), out.x)
    close(anchors[..., :3].permute(3, 1, 2, 0), out.anch_pos)
    w = torch.as_tensor(RNG.normal(size=tuple(x.shape)))
    g = t.apply_sphere_jacT(anchors, x, w)              # (B, n_points, D)
    g_soa = t.apply_sphere_jacT_soa(out.anch_pos, out.axis_w, out.x,
                                    w.permute(3, 1, 2, 0))
    close(g.permute(1, 2, 0), g_soa)


def test_follows_fk_dtype_and_device():
    fk = trobot.CompiledFK(wam7(), dtype=torch.float32, device="cpu")
    x, jac, lp = fk.fk_spheres(np.zeros((2, 7)))
    assert x.dtype == jac.dtype == lp.dtype == torch.float32
    assert tuple(x.shape) == (2, 16, 3) and tuple(jac.shape) == (2, 16, 3, 7)
