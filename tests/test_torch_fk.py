"""The port's robot model and batched FK against the JAX package:
wam7() arrays, fk_soa (every FkSoA field) and apply_sphere_jacT_soa
(suffix-cumsum and mask paths), float64 on CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.models.robot import CompiledFK as JaxFK
from or_cdchomp_tpu.models.wam7 import wam7 as jax_wam7
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.models.wam7 import wam7

RTOL = 1e-12   # the same float64 arithmetic, up to summation order
ATOL = 1e-13


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("active", ["arm", "all"])
def test_wam7_arrays_equal(active):
    a, b = wam7(active), jax_wam7(active)
    for f in ("parent", "origin", "jtype", "axis", "dof_index", "q_frozen",
              "dof_limits_lower", "dof_limits_upper", "dof_max_vel",
              "sphere_link", "sphere_pos", "sphere_radius"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.n_dof == b.n_dof and a.link_names == b.link_names
    np.testing.assert_array_equal(a.sphere_same_link(), b.sphere_same_link())
    np.testing.assert_array_equal(a.sphere_active_mask(),
                                  b.sphere_active_mask())


def _fk_pair(active="arm", subset=None):
    model = wam7(active)
    jfk = JaxFK(jax_wam7(active), dtype=jnp.float64, sphere_subset=subset)
    tfk = CompiledFK(model, dtype=torch.float64, device="cpu",
                     sphere_subset=subset)
    return model, jfk, tfk


def _inputs(rng, model, n_points, B):
    lo = np.maximum(model.dof_limits_lower, -3.0)
    hi = np.minimum(model.dof_limits_upper, 3.0)
    qT = rng.uniform(lo, hi, size=(n_points, B, model.n_dof))
    qT = np.ascontiguousarray(np.transpose(qT, (0, 2, 1)))
    pos = rng.normal(size=(3, B)) * 0.3
    q = rng.normal(size=(4, B))
    q /= np.linalg.norm(q, axis=0)
    return qT, pos, q


@pytest.mark.parametrize("active,subset", [
    ("arm", None),
    ("arm", np.array([3, 1, 2, 9, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15])),
    ("all", None),
])
def test_fk_soa_matches_jax(active, subset):
    rng = np.random.default_rng(11)
    model, jfk, tfk = _fk_pair(active, subset)
    qT, pos, q = _inputs(rng, model, 9, 3)
    j = jfk.fk_soa(jnp.asarray(qT), tuple(jnp.asarray(c) for c in pos),
                   tuple(jnp.asarray(c) for c in q))
    t = tfk.fk_soa(torch.as_tensor(qT), tuple(torch.as_tensor(c) for c in pos),
                   tuple(torch.as_tensor(c) for c in q))
    for field in ("x", "anch_pos", "anch_q", "axis_w", "red_pos", "red_q"):
        for cj, ct in zip(getattr(j, field), getattr(t, field)):
            assert tuple(ct.shape) == tuple(cj.shape), field
            _close(ct, cj)


@pytest.mark.parametrize("path", ["suffix", "mask"])
def test_apply_sphere_jacT_soa_matches_jax(path):
    rng = np.random.default_rng(5)
    model, jfk, tfk = _fk_pair()
    assert jfk._jt_suffix is not None and tfk._jt_suffix is not None
    if path == "mask":   # the general masked reduction (branching chains)
        jfk._jt_suffix = None
        tfk._jt_suffix = None
    m, D, S, B = 9, model.n_dof, len(tfk.sphere_subset), 3
    anch = rng.normal(size=(3, m, D, B))
    axw = rng.normal(size=(3, m, D, B))
    x = rng.normal(size=(3, m, S, B))
    w = rng.normal(size=(3, m, S, B))
    gj = jfk.apply_sphere_jacT_soa(*(tuple(jnp.asarray(c) for c in a)
                                     for a in (anch, axw, x, w)))
    gt = tfk.apply_sphere_jacT_soa(*(tuple(torch.as_tensor(c) for c in a)
                                     for a in (anch, axw, x, w)))
    assert tuple(gt.shape) == (m, D, B)
    _close(gt, gj)
