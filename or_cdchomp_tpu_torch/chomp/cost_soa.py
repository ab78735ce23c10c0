"""Batched (structure-of-arrays) obstacle + self-collision cost
(counterpart of or_cdchomp_tpu/chomp/cost_soa.py).

The per-iteration callback pair of the reference (sphere_cost_pre
orcdchomp_mod.cpp:968-1132, sphere_cost 1134-1327) for the whole problem
batch at once: every x/y/z component is its own slice of a (3, ...)
tensor and the problem batch is the last axis, which is the layout the
two kernels read with coalesced loads.  The obstacle phase runs kernel
K1 (ops/sdf_lookup.py), the self-collision phase kernel K2
(ops/selfcol.py).  A floating base takes its pose from the first 7
columns of each trajectory point and adds the base's Jᵀ block to the
gradient.
"""

from __future__ import annotations

import torch

from or_cdchomp_tpu_torch.ops.sdf_lookup import obstacle
from or_cdchomp_tpu_torch.ops.selfcol import selfcol_pairs
from or_cdchomp_tpu_torch.utils.profiling import phase

# damping of the floating base's gradient block (chomp/cost.py:42)
_BASE_JAC_DAMP = 0.01


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


def mov_lo(spec):
    """The first moving point: 0 under start_tsr (the start point moves),
    else 1 (solver.py:215-224, orcdchomp_mod.cpp:1040-1046)."""
    return 0 if spec.start_tsr else 1


def sphere_kinematics(spec, fk, probs):
    """FK of a batch and the finite-difference workspace velocities /
    accelerations of the spheres at the moving points (sphere_cost_pre,
    orcdchomp_mod.cpp:968-1132).  A fixed base is the problem's
    robot_pose; a floating one is each point's traj[..., :7]
    (cost_soa.py:652-656).  Under start_tsr point 0 moves too: its
    velocity is the one-sided difference and its acceleration repeats
    point 1's (chomp/cost.py:89-110).

    Returns (fk_out, x_mov, vel, acc), the last three (3, m, S, B).
    Phases ``fk`` and ``pre_velsaccs`` (cost_soa.py:652-666).
    """
    dt = spec.dt
    Tt = probs.traj.permute(1, 2, 0)                    # (n_points, n, B)
    with phase("fk"):
        if spec.floating_base:
            fk_out = fk.fk_soa(Tt[:, 7:], tuple(Tt[:, i] for i in range(3)),
                               tuple(Tt[:, i] for i in range(3, 7)))
        else:
            base = probs.robot_pose
            fk_out = fk.fk_soa(Tt, tuple(base[:, i] for i in range(3)),
                               tuple(base[:, i] for i in range(3, 7)))
    with phase("pre_velsaccs"):
        X = torch.stack(fk_out.x)                       # (3, n_points, S, B)
        vel = (X[:, 2:] - X[:, :-2]) / (2.0 * dt)
        acc = (X[:, :-2] - 2.0 * X[:, 1:-1] + X[:, 2:]) / (dt * dt)
        if spec.start_tsr:
            x_mov = X[:, :-1].contiguous()
            vel = torch.cat([(X[:, 1:2] - X[:, :1]) / dt, vel], dim=1)
            acc = torch.cat([acc[:, :1], acc], dim=1)
        else:
            x_mov = X[:, 1:-1].contiguous()
    return fk_out, x_mov, vel, acc


def _base_jacT(fk, probs, lo, m, x_mov, w):
    """The floating base's block of G (orcdchomp_mod.cpp:1050-1086,
    cost_soa.py:699-743): damp·pose_jac(base)ᵀ·[Σ_s x×w; Σ_s w] per
    moving point (points lo .. lo + m − 1), with pose_jac stacked as
    (B, m, 6, 7).  x_mov, w (3, m, S, B).  Returns (B, m, 7)."""
    xw = torch.linalg.cross(x_mov, w, dim=0)
    s = torch.cat([xw, w]).sum(dim=2).permute(2, 1, 0)      # (B, m, 6)
    Jsp = fk.mats.pose_jac(probs.traj[:, lo:lo + m, :7])
    return _BASE_JAC_DAMP * torch.matmul(s[..., None, :], Jsp)[..., 0, :]


def total_cost_grad_batched(spec, fk, fields, pairs, radii_act, probs,
                            want_grad=True):
    """Obstacle + self-collision cost and configuration-space gradient
    of a batch (cost_soa.py:637-746).

    Returns (cost (B,), G (B, m, n), fk_out), averaged over the moving
    points (chomp.c:489-492); fk_out feeds the constraint evaluation.
    ``want_grad=False`` (the cost report) skips the Jᵀ map and returns
    G None; the kernels run either way.  Phases as in JAX
    (cost_soa.py:649-690): ``callback_pre`` (``fk``, ``pre_velsaccs``),
    ``obstacle`` (K1's launch), ``selfcol`` (K2's), ``jtmap``.
    """
    with phase("callback_pre"):
        fk_out, x_mov, vel, acc = sphere_kinematics(spec, fk, probs)
    with phase("obstacle"):
        c_obs, w_obs = _obstacle_soa(fields, radii_act, probs, x_mov, vel,
                                     acc)
    with phase("selfcol"):
        c_self, w_self = _selfcol_soa(pairs, probs, x_mov, vel)
    if not want_grad:
        return (c_obs + c_self) / spec.m, None, fk_out

    with phase("jtmap"):
        w = w_obs + w_self
        lo, m = mov_lo(spec), spec.m
        anch_mov = tuple(c[lo:lo + m] for c in fk_out.anch_pos)
        axw_mov = tuple(c[lo:lo + m] for c in fk_out.axis_w)
        G = fk.apply_sphere_jacT_soa(anch_mov, axw_mov, tuple(x_mov),
                                     tuple(w))
        G = G.permute(2, 0, 1)                          # (B, m, n_arm)
        if spec.floating_base:
            G = torch.cat([_base_jacT(fk, probs, lo, m, x_mov, w), G],
                          dim=-1)
    return (c_obs + c_self) / spec.m, G / spec.m, fk_out

