"""Analytic scene primitives and cell-cube occupancy (counterpart of
or_cdchomp_tpu/ops/voxelize.py).

Boxes, spheres and cylinders; a triangle mesh raises NotImplementedError.
Occupancy is a batched cell-cube-vs-primitive overlap test over all
cells × primitives — the replacement for the reference's probe-cube
collision sweep (orcdchomp_mod.cpp:495-525):

 - oriented box vs cell cube: exact 15-axis SAT
 - sphere vs cell cube: exact closest-point distance
 - cylinder vs cell cube: inscribed/circumscribed sphere bounds, then 96
   alternating projections between the solid cube and solid cylinder for
   the thin shell of undecided cells (hit within 1e-4 m)

The same primitives give exact signed point distances
(``scene_distance``), which the trajectory validity check uses (the
replacement for gettraj's sampled CheckCollision pass,
orcdchomp_mod.cpp:2958-3006).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops.quat import pose_apply, pose_invert, quat_to_R


class Scene(NamedTuple):
    """Static analytic obstacle set (tensors, any may be empty).  Poses
    give the primitive frame in the scene (kinbody) frame."""

    box_pose: torch.Tensor       # (Nb, 7)
    box_half: torch.Tensor       # (Nb, 3)
    sphere_center: torch.Tensor  # (Ns, 3)
    sphere_radius: torch.Tensor  # (Ns,)
    cyl_pose: torch.Tensor       # (Nc, 7), axis = local +z
    cyl_radius: torch.Tensor     # (Nc,)
    cyl_half: torch.Tensor       # (Nc,) half-height

    @classmethod
    def build(cls, boxes=(), spheres=(), cylinders=(), meshes=(),
              dtype=torch.float32):
        """boxes: [(pose7, half_extents)], spheres: [(center, radius)],
        cylinders: [(pose7, radius, half_height)]."""
        if meshes:
            raise NotImplementedError("meshes: triangle-mesh scenes are "
                                      "not ported yet")

        def arr(rows, *shape):
            a = np.asarray(rows, dtype=np.float64).reshape(len(rows), *shape)
            return torch.as_tensor(a, dtype=dtype)

        return cls(arr([b[0] for b in boxes], 7),
                   arr([b[1] for b in boxes], 3),
                   arr([s[0] for s in spheres], 3),
                   arr([s[1] for s in spheres]),
                   arr([c[0] for c in cylinders], 7),
                   arr([c[1] for c in cylinders]),
                   arr([c[2] for c in cylinders]))

    def to(self, device=None, dtype=None):
        return Scene(*(t.to(device=device, dtype=dtype) for t in self))

    def bounding_spheres(self):
        """(centers (N, 3), radii (N,)) float64 numpy covering every
        primitive — sphere primitives exactly, boxes/cylinders by their
        circumscribed spheres.  Used when a grabbed body's geometry
        becomes robot collision spheres (orcdchomp_mod.cpp:2200-2208
        analog)."""
        def host(t):
            return t.cpu().numpy().astype(np.float64)

        sc, sr = host(self.sphere_center), host(self.sphere_radius)
        bp, bh = host(self.box_pose), host(self.box_half)
        cp, cr, ch = (host(self.cyl_pose), host(self.cyl_radius),
                      host(self.cyl_half))
        centers = [*sc, *bp[:, :3], *cp[:, :3]]
        radii = [*sr, *np.linalg.norm(bh, axis=1), *np.sqrt(cr ** 2 + ch ** 2)]
        if not centers:
            return np.zeros((0, 3)), np.zeros((0,))
        return np.stack(centers), np.asarray(radii)


def sd_box(p_local, half):
    """Signed distance of local-frame point(s) to a centred box."""
    q = torch.abs(p_local) - half
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    return outside + inside


def sd_cylinder(p_local, radius, half):
    """Signed distance to a z-aligned centred cylinder."""
    dr = torch.linalg.norm(p_local[..., :2], dim=-1) - radius
    dz = torch.abs(p_local[..., 2]) - half
    q = torch.stack([dr, dz], dim=-1)
    outside = torch.linalg.norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.max(q, dim=-1).values, max=0.0)
    return outside + inside


def scene_distance(scene: Scene, p):
    """Min signed distance from point(s) p (..., 3) to all primitives of
    ``scene`` (in its frame); +inf for an empty scene."""
    dists = []
    if scene.box_pose.shape[0]:
        pl = pose_apply(pose_invert(scene.box_pose), p[..., None, :])
        dists.append(torch.amin(sd_box(pl, scene.box_half), dim=-1))
    if scene.sphere_center.shape[0]:
        d = torch.linalg.norm(p[..., None, :] - scene.sphere_center, dim=-1)
        dists.append(torch.amin(d - scene.sphere_radius, dim=-1))
    if scene.cyl_pose.shape[0]:
        pl = pose_apply(pose_invert(scene.cyl_pose), p[..., None, :])
        dists.append(torch.amin(
            sd_cylinder(pl, scene.cyl_radius, scene.cyl_half), dim=-1))
    if not dists:
        return torch.full(p.shape[:-1], float("inf"), dtype=p.dtype,
                          device=p.device)
    return torch.amin(torch.stack(dists), dim=0)


def _obb_aabb_overlap(center, half_aabb, box_pose, box_half):
    """Exact SAT between axis-aligned cubes (at ``center`` (..., 3), half
    extent ``half_aabb``) and oriented boxes (Nb, 7) → (..., Nb) bool."""
    R = quat_to_R(box_pose[..., 3:])                 # (Nb, 3, 3) box→world
    t = box_pose[..., :3] - center[..., None, :]     # (..., Nb, 3)
    absR = torch.abs(R) + 1e-7
    a = half_aabb
    b = box_half

    # world axes: |t·e_i| <= a + Σ_j b_j |R_ij|
    ra = a + torch.einsum("...bij,...bj->...bi", absR, b.expand(t.shape))
    sep_w = torch.any(torch.abs(t) > ra, dim=-1)

    # box axes: |t·R_:,j| <= b_j + Σ_i a |R_ij|
    t_in_box = torch.einsum("...bij,...bi->...bj", R, t)
    a3 = torch.full(t[..., 0, :].shape, a, dtype=t.dtype, device=t.device)
    rb = b + torch.einsum("...bij,...i->...bj", absR, a3)
    sep_b = torch.any(torch.abs(t_in_box) > rb, dim=-1)

    # cross axes e_i × R_:,j
    sep_c = torch.zeros_like(sep_w)
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            tl = t[..., i2] * R[..., i1, j] - t[..., i1] * R[..., i2, j]
            ra_c = a * absR[..., i2, j] + a * absR[..., i1, j]
            rb_c = (b[..., j1] * absR[..., i, j2]
                    + b[..., j2] * absR[..., i, j1])
            sep_c = sep_c | (torch.abs(tl) > ra_c + rb_c)
    return ~(sep_w | sep_b | sep_c)


_AP_ITERS = 96     # alternating projections for undecided cylinder cells
_AP_TOL = 1e-4     # metres: contact classification tolerance


def _cyl_cube_overlap(centers, e, cyl_pose, cyl_radius, cyl_half):
    """Axis-aligned cube (half extent e) vs cylinder overlap, centers
    (..., 3) in the scene frame → (..., Nc) bool."""
    inv = pose_invert(cyl_pose)
    c_l = pose_apply(inv, centers[..., None, :])       # (..., Nc, 3)
    sd = sd_cylinder(c_l, cyl_radius, cyl_half)
    accept = sd <= e
    reject = sd > e * math.sqrt(3.0)
    Rt = quat_to_R(inv[..., 3:])                       # (Nc, 3, 3)

    def proj_box(q):
        u = torch.einsum("...cji,...cj->...ci", Rt, q - c_l)
        u = torch.clamp(u, -e, e)
        return c_l + torch.einsum("...cij,...cj->...ci", Rt, u)

    def proj_cyl(p):
        z = torch.minimum(torch.maximum(p[..., 2], -cyl_half), cyl_half)
        rxy = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
        s = torch.where(rxy > cyl_radius,
                        cyl_radius / torch.clamp(rxy, min=1e-30), 1.0)
        return torch.stack([p[..., 0] * s, p[..., 1] * s, z], dim=-1)

    q = proj_cyl(c_l)
    for _ in range(_AP_ITERS):
        q = proj_cyl(proj_box(q))
    dist = torch.linalg.norm(proj_box(q) - q, dim=-1)
    return accept | (~reject & (dist <= _AP_TOL))


def voxelize_scene(scene: Scene, centers, cube_extent):
    """Occupancy of probe cubes at ``centers`` (..., 3) in the scene
    frame (orcdchomp_mod.cpp:495-525 with analytic primitives)."""
    occ = torch.zeros(centers.shape[:-1], dtype=torch.bool,
                      device=centers.device)
    if scene.box_pose.shape[0]:
        hit = _obb_aabb_overlap(centers, cube_extent, scene.box_pose,
                                scene.box_half)
        occ = occ | torch.any(hit, dim=-1)
    if scene.sphere_center.shape[0]:
        d = scene.sphere_center - centers[..., None, :]
        closest = torch.clamp(d, -cube_extent, cube_extent)
        dist = torch.linalg.norm(d - closest, dim=-1)
        occ = occ | torch.any(dist <= scene.sphere_radius, dim=-1)
    if scene.cyl_pose.shape[0]:
        hit = _cyl_cube_overlap(centers, cube_extent, scene.cyl_pose,
                                scene.cyl_radius, scene.cyl_half)
        occ = occ | torch.any(hit, dim=-1)
    return occ
