"""The port's pose / quaternion algebra (or_cdchomp_tpu_torch/ops/quat.py)
against the JAX package's (or_cdchomp_tpu/ops/quat.py): the same seeded
numpy inputs through both, float64 on the CPU, within rtol 1e-12 and
atol 1e-12 (ROADMAP's bar for pure math).  The inputs mirror
tests/test_quat.py's cases: random unit quaternions, the identity and a
near-identity rotation, axis-aligned half turns and quarter turns, and
pitches beside the gimbal lock (at it, 1e-6 off it, and 0.05 rad off it
for the Jacobians, whose 1/cos(pitch) would amplify a last-bit
difference past the bar nearer to it).  The ypr angles and Jacobians are
also held to ``SpatialMats.ypr`` / ``ypr_jac``, the TSR chain's form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.ops import quat as jq
from or_cdchomp_tpu_torch.ops import quat as tq
from or_cdchomp_tpu_torch.ops.spatial import SpatialMats

RTOL = ATOL = 1e-12
RNG = np.random.default_rng(10)


def _unit(a):
    return a / np.linalg.norm(a, axis=-1, keepdims=True)


def _ypr_quats(ypr):
    return np.array(jq.quat_from_ypr(jnp.asarray(np.asarray(ypr))))


H = np.sqrt(0.5)
SPECIAL = np.array([
    [0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, -1.0],       # identity, both signs
    _unit(np.array([1e-3, -2e-3, 5e-4, 1.0])).tolist(),  # near identity
    [1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0], [0.0, 0.0, 1.0, 0.0],
    [H, 0.0, 0.0, H], [0.0, H, 0.0, H], [0.0, 0.0, H, -H],
])
QUATS = np.concatenate([
    _unit(RNG.normal(size=(16, 4))), SPECIAL,
    _ypr_quats([[0.3, np.pi / 2 - 0.05, -0.2], [-1.1, -np.pi / 2 + 0.05,
                                                 0.4]])])
# at the gimbal lock and 1e-6 from it: the angles' guarded branches
GIMBAL = _ypr_quats([[0.3, np.pi / 2, 0.1], [-0.7, -np.pi / 2, 0.2],
                     [0.3, np.pi / 2 - 1e-6, 0.1],
                     [0.2, -np.pi / 2 + 1e-6, -0.3]])
N = len(QUATS)


def _poses(q):
    return np.concatenate([RNG.normal(size=(len(q), 3)), q], axis=-1)


POSES = _poses(QUATS)
POSES2 = _poses(QUATS[::-1].copy())
VECS = RNG.normal(size=(N, 3))
AXES = np.concatenate([_unit(RNG.normal(size=(N - 3, 3))),
                       np.eye(3)])
ANGLES = np.concatenate([RNG.uniform(-3.0, 3.0, size=N - 2), [0.0, 1e-3]])
YPRS = np.concatenate([RNG.uniform(-3.0, 3.0, size=(N - 2, 3)),
                       [[0.3, np.pi / 2, 0.1], [0.0, 0.0, 0.0]]])


def _R(q):
    return np.array(jq.quat_to_R(jnp.asarray(q)))


def _H(p):
    return np.array(jq.pose_to_H(jnp.asarray(p)))


# the |z_x| > 0.9 branch of pose_from_op and its other branch, and a
# direction on each axis
TO = np.concatenate([RNG.normal(size=(N - 4, 3)),
                     [[5.0, 0.01, 0.0], [0.0, 0.0, 2.0], [0.0, -3.0, 0.0],
                      [1.0, 2.0, 1.0]]])

# name: the numpy arguments (float64 arrays become tensors, others pass
# as they are); names ending in _const take a numpy constant
CASES = {
    "quat_flip_closerto": lambda: (QUATS, -QUATS[::-1].copy()),
    "pose_flip_closerto": lambda: (POSES, POSES2),
    "quat_compose": lambda: (QUATS, QUATS[::-1].copy()),
    "quat_rotate_const": lambda: (QUATS, np.array([0.3, -0.2, 0.7])),
    "quat_compose_const": lambda: (QUATS, _unit(np.array([0.1, 0.2, -0.3,
                                                          0.9]))),
    "pose_compose": lambda: (POSES, POSES2),
    "pose_rotate_vec": lambda: (POSES, VECS),
    "quat_invert": lambda: (QUATS,),
    "quat_from_R": lambda: (_R(QUATS),),
    "pose_to_H": lambda: (POSES,),
    "pose_from_H": lambda: (_H(POSES),),
    "pose_from_dR": lambda: (VECS, _R(QUATS)),
    "quat_from_axisangle": lambda: (AXES, ANGLES),
    "quat_to_axisangle": lambda: (QUATS,),
    "quat_to_ypr": lambda: (np.concatenate([QUATS, GIMBAL]),),
    "pose_to_xyzypr": lambda: (_poses(np.concatenate([QUATS, GIMBAL])),),
    "quat_to_ypr_J": lambda: (QUATS,),
    "pose_to_xyzypr_J": lambda: (POSES,),
    "quat_from_ypr": lambda: (YPRS,),
    "pose_from_xyzypr": lambda: (np.concatenate([VECS, YPRS], axis=-1),),
    "axisangle_rotate": lambda: (AXES, ANGLES, VECS),
    "axisangle_to_R": lambda: (AXES, ANGLES),
    "pose_to_dR": lambda: (POSES,),
    "pose_to_pos_quat": lambda: (POSES,),
    "pose_from_pos_quat": lambda: (VECS, QUATS),
    "pose_from_op": lambda: (VECS, TO),
    "pose_from_op_diff": lambda: (VECS, TO),
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


def _run(name, args):
    """(port's output, JAX's output); a *_const function's last argument
    stays numpy."""
    n = len(args) - name.endswith("_const")
    targs = [torch.as_tensor(a) for a in args[:n]] + list(args[n:])
    jargs = [jnp.asarray(a) for a in args[:n]] + list(args[n:])
    return getattr(tq, name)(*targs), getattr(jq, name)(*jargs)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    got, want = _run(name, CASES[name]())
    close(got, want)


@pytest.mark.parametrize("name", ["quat_identity", "pose_identity"])
def test_identities(name):
    got = getattr(tq, name)(dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    close(got, getattr(jq, name)(jnp.float64))


@pytest.mark.parametrize("which", ["both", "pos", "quat"])
def test_pose_from_pos_quat_defaults(which):
    pos = None if which in ("both", "pos") else torch.as_tensor(VECS)
    quat = None if which in ("both", "quat") else torch.as_tensor(QUATS)
    got = tq.pose_from_pos_quat(pos, quat, dtype=torch.float64,
                                device="cpu")
    want = jq.pose_from_pos_quat(
        None if pos is None else jnp.asarray(VECS),
        None if quat is None else jnp.asarray(QUATS), jnp.float64)
    close(got, want)


def test_flip_rule_on_ties_and_signs():
    """A quaternion is negated only where −q is strictly closer: not on
    the tie q·t = 0 (row 1)."""
    q = np.array([[0.0, 0.0, 0.0, 1.0], [0.0, 0.0, 0.0, 1.0],
                  [1.0, 0.0, 0.0, 0.0]])
    t = np.array([[0.0, 0.0, 0.0, -1.0], [0.0, 0.0, 1.0, 0.0],
                  [-H, 0.0, 0.0, H]])
    got = tq.quat_flip_closerto(torch.as_tensor(q), torch.as_tensor(t))
    close(got, jq.quat_flip_closerto(jnp.asarray(q), jnp.asarray(t)))
    np.testing.assert_array_equal(got.numpy(), [[0, 0, 0, -1.0],
                                                [0, 0, 0, 1.0], [-1, 0, 0, 0]])


def test_ypr_and_jacobian_match_spatial_mats():
    """quat_to_ypr, quat_to_ypr_J and pose_to_xyzypr_J against the TSR
    chain's SpatialMats.ypr / ypr_jac (rows in Bw order x y z roll pitch
    yaw)."""
    mats = SpatialMats("cpu", torch.float64)
    q = torch.as_tensor(np.concatenate([QUATS, GIMBAL]))
    (roll, pitch, yaw), jac = mats.ypr(q)
    close(torch.stack([yaw, pitch, roll], dim=-1), tq.quat_to_ypr(q))
    qs = torch.as_tensor(QUATS)
    jq_t = tq.quat_to_ypr_J(qs)
    close(mats.ypr(qs)[1], jq_t)
    bw = mats.ypr_jac(jq_t)
    close(bw, tq.pose_to_xyzypr_J(torch.as_tensor(POSES))[..., [0, 1, 2, 5,
                                                               4, 3], :])


def test_const_forms_equal_tensor_forms():
    """quat_rotate_const / quat_compose_const equal quat_rotate /
    quat_compose with the constant as a tensor."""
    q = torch.as_tensor(QUATS)
    v, k = np.array([0.3, -0.2, 0.7]), _unit(np.array([0.1, 0.2, -0.3,
                                                         0.9]))
    close(tq.quat_rotate_const(q, v), tq.quat_rotate(q, torch.as_tensor(v)))
    close(tq.quat_compose_const(q, k),
          tq.quat_compose(q, torch.as_tensor(k)))


def test_follows_input_dtype():
    q = torch.as_tensor(QUATS, dtype=torch.float32)
    for out in (tq.quat_to_ypr_J(q), tq.quat_from_R(tq.quat_to_R(q)),
                tq.pose_from_op(q[:, :3], q[:, 1:])[0]):
        assert out.dtype == torch.float32
