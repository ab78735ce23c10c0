"""Robots and inputs of the FK kernel's tests (tests/test_torch_fk_kernel.py
on the CPU, tests/test_torch_fk_gpu.py on the card): no JAX here."""

import numpy as np
import torch

from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.models.urdf import parse_urdf
from or_cdchomp_tpu_torch.models.wam7 import wam7

# base → revolute → prismatic → fixed tool → revolute, and a second
# revolute branch off l1 (its parent is not the slot walked last);
# spheres on every link, the base and the fixed tool too
URDF_BRANCH = """
<robot name="branch">
  <link name="base">
    <collision><origin xyz="0 0 0.05"/><geometry><sphere radius="0.05"/></geometry></collision>
  </link>
  <link name="l1">
    <collision><origin xyz="0.05 0 0"/><geometry><sphere radius="0.04"/></geometry></collision>
  </link>
  <link name="l2">
    <collision><origin xyz="0.1 0.02 0"/><geometry><sphere radius="0.03"/></geometry></collision>
  </link>
  <link name="tool">
    <collision><origin xyz="0 0 0.03"/><geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <link name="l4">
    <collision><origin xyz="0.02 0 0.1"/><geometry><sphere radius="0.02"/></geometry></collision>
    <collision><origin xyz="0.02 0.01 0.2"/><geometry><sphere radius="0.02"/></geometry></collision>
  </link>
  <link name="thumb">
    <collision><origin xyz="0 0.04 0"/><geometry><sphere radius="0.01"/></geometry></collision>
  </link>
  <joint name="j0" type="revolute">
    <parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.2"/><axis xyz="0 0 1"/>
    <limit lower="-2.0" upper="2.0" velocity="1.0"/>
  </joint>
  <joint name="j1" type="prismatic">
    <parent link="l1"/><child link="l2"/>
    <origin xyz="0.1 0 0" rpy="0 0 0.7853981633974483"/><axis xyz="1 0 0"/>
    <limit lower="-0.5" upper="0.5" velocity="1.0"/>
  </joint>
  <joint name="j2" type="fixed">
    <parent link="l2"/><child link="tool"/>
    <origin xyz="0 0.05 0.1" rpy="0.4 0 0"/>
  </joint>
  <joint name="j3" type="revolute">
    <parent link="tool"/><child link="l4"/>
    <origin xyz="0 0 0.1"/><axis xyz="0 1 0"/>
    <limit lower="-2.0" upper="2.0" velocity="1.0"/>
  </joint>
  <joint name="j4" type="revolute">
    <parent link="l1"/><child link="thumb"/>
    <origin xyz="0 0.1 0.05" rpy="0 0.3 0"/><axis xyz="0 0.6 0.8"/>
    <limit lower="-1.0" upper="1.0" velocity="1.0"/>
  </joint>
</robot>
"""

# the WAM7 spheres in the engine's active-first order
ACTIVE_FIRST = np.array([3, 1, 2, 9, 4, 5, 6, 7, 8, 10, 11, 12, 13, 14, 15])

ROBOTS = {
    "wam7": lambda: (wam7(), None),
    "wam7_all_subset": lambda: (wam7("all"), ACTIVE_FIRST),
    "wam7_frozen": lambda: (wam7().set_active(
        [0, 2, 4], q_current=[0.3, -0.4, 0.2, 1.1, -0.5, 0.6, 0.1]), None),
    "urdf_prismatic": lambda: (parse_urdf(URDF_BRANCH), None),
    "no_dof": lambda: (wam7().set_active([]), None),
}


def make_fk(robot, dtype, device):
    model, subset = ROBOTS[robot]()
    return CompiledFK(model, dtype=dtype, sphere_subset=subset,
                      device=device)


def with_spheres(n_spheres, dtype, device):
    """The WAM7 with ``n_spheres`` more spheres on random links: a table
    of some 16 n_spheres bytes in float32."""
    model = wam7()
    rng = np.random.default_rng(n_spheres)
    rows = [(model.link_names[int(rng.integers(len(model.link_names)))],
             tuple(rng.normal(size=3) * 0.1), 0.02)
            for _ in range(n_spheres)]
    fk = CompiledFK(model.with_spheres(rows), dtype=dtype, device=device)
    assert len(fk.sphere_subset) == len(model.sphere_radius) + n_spheres
    return fk


def inputs(fk, n_points, B, base, dtype, device, seed=0):
    """(qT, base_pos, base_q) as the port's callers hand them to fk_soa:
    qT a permuted view of a (B, n_points, n) trajectory; the base
    per problem ("fixed", (B,) columns of a (B, 7) pose, as
    sphere_kinematics), per point ("floating", the first 7 columns of the
    trajectory), or one pose ("scalar", 0-d, as the trajectory check)."""
    rng = np.random.default_rng(seed)
    model = fk.model
    lo = np.maximum(model.dof_limits_lower, -3.0)
    hi = np.minimum(model.dof_limits_upper, 3.0)
    q = rng.uniform(lo, hi, size=(B, n_points, model.n_dof))
    pose = np.concatenate([rng.normal(size=(B, n_points, 3)) * 0.3,
                           rng.normal(size=(B, n_points, 4))], axis=-1)
    pose[..., 3:] /= np.linalg.norm(pose[..., 3:], axis=-1, keepdims=True)
    kw = dict(dtype=dtype, device=device)
    if base == "floating":
        traj = torch.as_tensor(np.concatenate([pose, q], axis=-1), **kw)
        Tt = traj.permute(1, 2, 0)                      # (n_points, n, B)
        return (Tt[:, 7:], tuple(Tt[:, i] for i in range(3)),
                tuple(Tt[:, i] for i in range(3, 7)))
    qT = torch.as_tensor(q, **kw).permute(1, 2, 0)
    if base == "fixed":
        bp = torch.as_tensor(pose[:, 0], **kw)          # (B, 7)
        return (qT, tuple(bp[:, i] for i in range(3)),
                tuple(bp[:, i] for i in range(3, 7)))
    bp = torch.as_tensor(pose[0, 0], **kw)              # (7,)
    return qT, tuple(bp[:3]), tuple(bp[3:])


FIELDS = ("x", "anch_pos", "anch_q", "axis_w", "red_pos", "red_q")


def max_err(got, want):
    """max |got − want| over the six outputs of two FkSoA-like tuples
    (a NaN counts as infinite), after checking that each component has
    the same shape."""
    err = 0.0
    for f, g, w in zip(FIELDS, got, want):
        assert len(g) == len(w), f
        for gc, wc in zip(g, w):
            assert tuple(gc.shape) == tuple(wc.shape), f
            if gc.numel():
                d = (gc.double() - wc.double()).abs()
                err = max(err, float(d.nan_to_num(float("inf")).max()))
    return err
