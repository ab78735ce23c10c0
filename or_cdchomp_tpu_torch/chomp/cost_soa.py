"""Batched (structure-of-arrays) obstacle + self-collision cost
(counterpart of or_cdchomp_tpu/chomp/cost_soa.py, fixed-base path).

The per-iteration callback pair of the reference (sphere_cost_pre
orcdchomp_mod.cpp:968-1132, sphere_cost 1134-1327) for the whole problem
batch at once: every x/y/z component is its own slice of a (3, ...)
tensor and the problem batch is the last axis, which is the layout the
two kernels read with coalesced loads.  The obstacle phase runs kernel
K1 (ops/sdf_lookup.py), the self-collision phase kernel K2
(ops/selfcol.py).
"""

from __future__ import annotations

import torch

from or_cdchomp_tpu_torch.ops.sdf_lookup import obstacle
from or_cdchomp_tpu_torch.ops.selfcol import selfcol_pairs


def _obstacle_soa(fields, radii, probs, x, vel, acc):
    """SoA obstacle cost and workspace gradient (chomp/cost.py
    obstacle_cost_grad semantics, orcdchomp_mod.cpp:1134-1246).

    x, vel, acc: (3, m, S, B); radii (S,); probs batched.  Returns
    (c_obs (B,), wgrad (3, m, S, B) with the ‖ẋ‖ scale).
    """
    cost, wgrad = obstacle(
        x, vel, acc, fields.data, fields.sizes, fields.lengths,
        probs.pose_gsdf_world, probs.pose_world_gsdf, probs.field_enabled,
        radii, probs.epsilon, probs.obs_factor)
    return cost.sum(dim=(0, 1)), wgrad


def _selfcol_soa(pairs, probs, x_i, vel):
    """SoA all-pairs self-collision (chomp/cost.py
    self_collision_cost_grad semantics, orcdchomp_mod.cpp:1249-1317):
    active spheres against active and inactive ones, same-link pairs
    excluded through the engine's pair table.

    x_i, vel: (3, m, Sa, B).  Returns (c_self (B,), net (3, m, Sa, B)).
    """
    pair_i, pair_j, rsum = pairs
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()   # (3, SI, B)
    net, cost = selfcol_pairs(x_i, vel, xo, pair_i, pair_j, rsum,
                              probs.epsilon_self, probs.obs_factor_self)
    return cost.sum(dim=(0, 1)), net


def sphere_kinematics(spec, fk, probs):
    """FK of a fixed-base batch and the finite-difference workspace
    velocities / accelerations of the spheres at the moving points
    (sphere_cost_pre, orcdchomp_mod.cpp:968-1132).

    Returns (fk_out, x_mov, vel, acc), the last three (3, m, S, B).
    """
    dt = spec.dt
    Tt = probs.traj.permute(1, 2, 0)                    # (n_points, n, B)
    base = probs.robot_pose
    fk_out = fk.fk_soa(Tt, tuple(base[:, i] for i in range(3)),
                       tuple(base[:, i] for i in range(3, 7)))
    X = torch.stack(fk_out.x)                           # (3, n_points, S, B)
    x_mov = X[:, 1:-1].contiguous()
    vel = (X[:, 2:] - X[:, :-2]) / (2.0 * dt)
    acc = (X[:, :-2] - 2.0 * X[:, 1:-1] + X[:, 2:]) / (dt * dt)
    return fk_out, x_mov, vel, acc


def total_cost_grad_batched(spec, fk, fields, pairs, radii_act, probs,
                            want_grad=True):
    """Obstacle + self-collision cost and configuration-space gradient
    of a fixed-base batch (cost_soa.py:637-698, 744-746).

    Returns (cost (B,), G (B, m, n)), averaged over the moving points
    (chomp.c:489-492).  ``want_grad=False`` (the cost report) skips the
    Jᵀ map and returns G None; the kernels run either way.
    """
    fk_out, x_mov, vel, acc = sphere_kinematics(spec, fk, probs)
    c_obs, w_obs = _obstacle_soa(fields, radii_act, probs, x_mov, vel, acc)
    c_self, w_self = _selfcol_soa(pairs, probs, x_mov, vel)
    if not want_grad:
        return (c_obs + c_self) / spec.m, None

    w = w_obs + w_self
    anch_mov = tuple(c[1:-1] for c in fk_out.anch_pos)
    axw_mov = tuple(c[1:-1] for c in fk_out.axis_w)
    G = fk.apply_sphere_jacT_soa(anch_mov, axw_mov, tuple(x_mov), tuple(w))
    G = G.permute(2, 0, 1) / spec.m                     # (B, m, n)
    return (c_obs + c_self) / spec.m, G

