"""Kinematic trees with batched FK and the Jacobian-transpose map
(counterpart of or_cdchomp_tpu/models/robot.py).

``RobotModel`` and its host-side float64 helpers are copied from the JAX
package (shared copy pending de-duplication).  ``CompiledFK`` ports the
structure-of-arrays FK (``fk_soa``) and Jᵀ map (``apply_sphere_jacT_soa``)
of the batched cost path, and the per-problem FK of the API surface
(``red_poses`` … ``fk_spheres``, layout (..., n_dof), pose algebra from
ops/quat.py) to tensors; the static chain analysis (``__init__`` /
``_reduced_chain``) is the same; ``sphere_positions_np`` walks the same
chain in float64 numpy for host-side callers.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import fk as fk_kernel
from or_cdchomp_tpu_torch.ops import jtmap as jt_kernel
from or_cdchomp_tpu_torch.ops import quat as qt
from or_cdchomp_tpu_torch.ops import soa
from or_cdchomp_tpu_torch.ops.spatial import SpatialMats
from or_cdchomp_tpu_torch.utils.profiling import to_device

FIXED, REVOLUTE, PRISMATIC = 0, 1, 2
_POSE_ID = np.array([0, 0, 0, 0, 0, 0, 1.0])
_JTYPES = {"fixed": FIXED, "revolute": REVOLUTE, "hinge": REVOLUTE,
           "prismatic": PRISMATIC, "slider": PRISMATIC}


def _pose_compose64(pab, pbc):
    """Pure-numpy float64 pose compose."""
    qab = pab[3:]
    qbc = pbc[3:]
    ax, ay, az, aw = qab
    bx, by, bz, bw = qbc
    q = np.array([
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
        aw * bw - ax * bx - ay * by - az * bz,
    ])
    pos = _rotate64(qab, pbc[:3]) + pab[:3]
    return np.concatenate([pos, q])


def _rotate64(q, v):
    qx, qy, qz, qw = q
    x, y, z = v
    qx2, qy2, qz2, qw2 = qx * qx, qy * qy, qz * qz, qw * qw
    xy, xz, xw = qx * qy, qx * qz, qx * qw
    yz, yw, zw = qy * qz, qy * qw, qz * qw
    return np.array([
        x * (qx2 - qy2 - qz2 + qw2) + 2 * y * (xy - zw) + 2 * z * (xz + yw),
        2 * x * (xy + zw) + y * (-qx2 + qy2 - qz2 + qw2) + 2 * z * (yz - xw),
        2 * x * (xz - yw) + 2 * y * (yz + xw) + z * (-qx2 - qy2 + qz2 + qw2),
    ])


def _motion_pose64(jtype, axis, value):
    if jtype == REVOLUTE:
        a2 = 0.5 * value
        q = np.concatenate([np.sin(a2) * axis, [np.cos(a2)]])
        return np.concatenate([np.zeros(3), q])
    if jtype == PRISMATIC:
        return np.concatenate([axis * value, [0.0, 0.0, 0.0, 1.0]])
    return np.array([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])


@dataclasses.dataclass(frozen=True)
class RobotModel:
    """Static robot description (host-side numpy; hashable by identity).

    ``dof_index[i]`` is the active-DOF column of link i's joint, or -1
    when the joint is fixed/frozen.  Frozen joints carry their value in
    ``q_frozen`` and are folded into ``origin`` by :meth:`set_active`.
    """

    name: str
    link_names: tuple
    joint_names: tuple           # joint into link i ('' for base)
    parent: np.ndarray           # (L,) int, parent[0] = -1
    origin: np.ndarray           # (L, 7) float64
    jtype: np.ndarray            # (L,) int
    axis: np.ndarray             # (L, 3) float64 (unit, in joint frame)
    dof_index: np.ndarray        # (L,) int
    q_frozen: np.ndarray         # (L,) float64
    n_dof: int
    dof_limits_lower: np.ndarray  # (n_dof,)
    dof_limits_upper: np.ndarray
    dof_max_vel: np.ndarray       # (n_dof,) for retiming
    sphere_link: np.ndarray       # (S,) int
    sphere_pos: np.ndarray        # (S, 3)
    sphere_radius: np.ndarray     # (S,)
    ee_link: int = -1             # end-effector link (active manipulator)
    ee_origin: Optional[np.ndarray] = None  # (7,) tool pose in ee link

    # ----- construction ----------------------------------------------------

    @classmethod
    def from_joints(cls, name, links, joints, spheres=(), ee_link=None,
                    ee_origin=None):
        """Build from declarative lists.

        links: sequence of link names (first = base).
        joints: dict-like rows with keys
          name, parent, child, type, origin (7 or None), axis (3),
          limits (lo, hi) or None, max_vel (optional).
        spheres: rows (link_name, pos3, radius).
        """
        link_idx = {n: i for i, n in enumerate(links)}
        L = len(links)
        parent = np.full(L, -1, dtype=np.int64)
        origin = np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0]), (L, 1))
        jtype = np.zeros(L, dtype=np.int64)
        axis = np.tile(np.array([0.0, 0.0, 1.0]), (L, 1))
        jnames = [""] * L
        limits = {}
        max_vels = {}
        dof_index = np.full(L, -1, dtype=np.int64)
        ndof = 0
        for j in joints:
            ci = link_idx[j["child"]]
            parent[ci] = link_idx[j["parent"]]
            jnames[ci] = j["name"]
            jtype[ci] = _JTYPES[j.get("type", "revolute")]
            if j.get("origin") is not None:
                origin[ci] = np.asarray(j["origin"], dtype=np.float64)
            if j.get("axis") is not None:
                a = np.asarray(j["axis"], dtype=np.float64)
                axis[ci] = a / np.linalg.norm(a)
            if jtype[ci] != FIXED:
                dof_index[ci] = ndof
                limits[ndof] = j.get("limits") or (-np.inf, np.inf)
                max_vels[ndof] = j.get("max_vel", 1.0)
                ndof += 1
        # verify topological ordering
        for i in range(1, L):
            if parent[i] < 0 or parent[i] >= i:
                raise ValueError(f"links must be topologically ordered; "
                                 f"link {links[i]} has parent index {parent[i]}")
        lo = np.array([limits[d][0] for d in range(ndof)], dtype=np.float64)
        hi = np.array([limits[d][1] for d in range(ndof)], dtype=np.float64)
        mv = np.array([max_vels[d] for d in range(ndof)], dtype=np.float64)
        sl = np.array([link_idx[s[0]] for s in spheres], dtype=np.int64)
        sp = np.array([s[1] for s in spheres], dtype=np.float64).reshape(-1, 3)
        sr = np.array([s[2] for s in spheres], dtype=np.float64)
        return cls(
            name=name, link_names=tuple(links), joint_names=tuple(jnames),
            parent=parent, origin=origin, jtype=jtype, axis=axis,
            dof_index=dof_index, q_frozen=np.zeros(L), n_dof=ndof,
            dof_limits_lower=lo, dof_limits_upper=hi, dof_max_vel=mv,
            sphere_link=sl, sphere_pos=sp, sphere_radius=sr,
            ee_link=link_idx[ee_link] if ee_link is not None else -1,
            ee_origin=(np.asarray(ee_origin, dtype=np.float64)
                       if ee_origin is not None else None),
        )

    @property
    def dof_names(self):
        inv = {}
        for i in range(len(self.link_names)):
            d = self.dof_index[i]
            if d >= 0:
                inv[int(d)] = self.joint_names[i]
        return tuple(inv[d] for d in range(self.n_dof))

    def set_active(self, active: Sequence, q_current=None) -> "RobotModel":
        """Freeze all DOFs except ``active`` (names or indices) at
        ``q_current`` (full config, defaults to zeros), renumbering the
        remaining DOFs.  Mirrors OpenRAVE SetActiveDOFs +
        orcdchomp's frozen-inactive-joint semantics.
        """
        names = self.dof_names
        active_ids = []
        for a in active:
            active_ids.append(names.index(a) if isinstance(a, str) else int(a))
        q_current = (np.zeros(self.n_dof) if q_current is None
                     else np.asarray(q_current, dtype=np.float64))

        L = len(self.link_names)
        new_dof = np.full(L, -1, dtype=np.int64)
        new_frozen = self.q_frozen.copy()
        remap = {old: new for new, old in enumerate(active_ids)}
        for i in range(L):
            d = int(self.dof_index[i])
            if d < 0:
                continue
            if d in remap:
                new_dof[i] = remap[d]
            else:
                new_frozen[i] = q_current[d]
        lo = self.dof_limits_lower[active_ids]
        hi = self.dof_limits_upper[active_ids]
        mv = self.dof_max_vel[active_ids]
        return dataclasses.replace(
            self, dof_index=new_dof, q_frozen=new_frozen,
            n_dof=len(active_ids), dof_limits_lower=lo, dof_limits_upper=hi,
            dof_max_vel=mv,
        )

    def with_spheres(self, rows) -> "RobotModel":
        """Append collision spheres; rows: (link_name, pos3, radius).
        Used for grabbed-body geometry re-rooted to the grabbing link
        (orcdchomp_mod.cpp:2200-2208)."""
        if not rows:
            return self
        link_idx = {n: i for i, n in enumerate(self.link_names)}
        sl = np.concatenate([self.sphere_link,
                             np.array([link_idx[r[0]] for r in rows])])
        sp = np.concatenate([self.sphere_pos,
                             np.asarray([r[1] for r in rows],
                                        dtype=np.float64).reshape(-1, 3)])
        sr = np.concatenate([self.sphere_radius,
                             np.asarray([r[2] for r in rows],
                                        dtype=np.float64)])
        return dataclasses.replace(self, sphere_link=sl, sphere_pos=sp,
                                   sphere_radius=sr)

    def select_spheres(self, idx) -> "RobotModel":
        """Keep only the spheres at ``idx`` (release of a grabbed body)."""
        idx = np.asarray(idx)
        return dataclasses.replace(
            self, sphere_link=self.sphere_link[idx],
            sphere_pos=self.sphere_pos[idx],
            sphere_radius=self.sphere_radius[idx])

    # ----- static analysis -------------------------------------------------

    def folded(self):
        """Fold frozen joints into origin poses; returns
        (origin (L,7) with frozen motion composed in, is_active (L,) bool).
        """
        L = len(self.link_names)
        origin = self.origin.copy()
        active = np.zeros(L, dtype=bool)
        for i in range(L):
            if self.dof_index[i] >= 0:
                active[i] = True
            elif self.jtype[i] != FIXED:
                m = _motion_pose64(int(self.jtype[i]), self.axis[i],
                                   float(self.q_frozen[i]))
                origin[i] = _pose_compose64(origin[i], m)
        return origin, active

    def ancestor_dof_mask(self):
        """(L, n_dof) bool: does active DOF d affect link i?
        (the DoesAffect test, orcdchomp_mod.cpp:2270-2272)"""
        L = len(self.link_names)
        mask = np.zeros((L, self.n_dof), dtype=bool)
        for i in range(L):
            j = i
            while j > 0:
                d = int(self.dof_index[j])
                if d >= 0:
                    mask[i, d] = True
                j = int(self.parent[j])
        return mask

    def sphere_active_mask(self):
        """(S,) bool: sphere affected by an active DOF."""
        return self.ancestor_dof_mask()[self.sphere_link].any(axis=1)

    def sphere_same_link(self):
        """(S, S) bool: spheres on the same link (self-collision skip,
        orcdchomp_mod.cpp:1256)."""
        return self.sphere_link[:, None] == self.sphere_link[None, :]

    def sphere_adjacent_link(self):
        """(S, S) bool: same link OR links connected through only fixed
        /frozen joints OR parent-child — the pairs a hard self-collision
        *check* must ignore (OpenRAVE's adjacency filtering; the soft
        epsilon_self cost intentionally keeps parent-child pairs)."""
        L = len(self.link_names)
        # map each link to its nearest "articulated root": walk up
        # through fixed/frozen joints
        art = np.arange(L)
        for i in range(L):
            j = i
            while j > 0 and self.dof_index[j] < 0:
                j = int(self.parent[j])
            art[i] = j

        def art_parent(i):
            j = int(self.parent[i])
            while j > 0 and self.dof_index[j] < 0:
                j = int(self.parent[j])
            return j if i > 0 else -1

        adj = np.zeros((L, L), dtype=bool)
        for i in range(L):
            ai = art[i]
            for j in range(L):
                aj = art[j]
                if ai == aj:
                    adj[i, j] = True
                elif art_parent(ai) == aj or art_parent(aj) == ai:
                    adj[i, j] = True
        return adj[self.sphere_link][:, self.sphere_link]


class FkSoA(NamedTuple):
    """Structure-of-arrays FK outputs (see CompiledFK.fk_soa): each one
    (c, n_points, ·, B) tensor, components leading and the batch last,
    as the FK kernel writes it and K1, K2 and the Jᵀ map read it.
    Iterating a field yields its c components, so ops/soa.py's operators
    take a field as a vec3 or quat."""

    x: torch.Tensor          # (3, n_points, S, B) sphere world centres
    anch_pos: torch.Tensor   # (3, n_points, D, B) joint frames, pre-motion
    anch_q: torch.Tensor     # (4, n_points, D, B)
    axis_w: torch.Tensor     # (3, n_points, D, B) world joint axes
    red_pos: torch.Tensor    # (3, n_points, n_red, B) reduced link poses
    red_q: torch.Tensor      # (4, n_points, n_red, B)


def _reduced_chain(model, origin64, subset):
    """Fold every fixed/frozen joint into per-link constant offsets so FK
    walks only *active* joints (robot.py:386-442): each link pose is
    pose(red(l)) ∘ off(l) with red(l) its nearest ancestor-or-self with
    an active joint, and sphere offsets are pre-folded.  Returns (chain,
    n_red, per-link reduced slot (L,), per-link offset off(l) (L, 7),
    per-sphere reduced slot (S,), folded sphere offsets (S, 3))."""
    L = len(model.link_names)
    ID = np.array([0, 0, 0, 0, 0, 0, 1.0])
    red_slot = np.zeros(L, dtype=np.int64)
    off = np.tile(ID, (L, 1))
    chain = []
    next_slot = 1
    for i in range(1, L):
        p = int(model.parent[i])
        d = int(model.dof_index[i])
        if d >= 0:
            K = _pose_compose64(off[p], origin64[i])
            chain.append(dict(
                dof=d, parent_slot=int(red_slot[p]),
                jtype=int(model.jtype[i]),
                axis=np.asarray(model.axis[i], dtype=np.float64),
                K=K,
                rot_id=bool(np.allclose(K[3:], ID[3:], atol=1e-14)),
                pos_zero=bool(np.allclose(K[:3], 0.0, atol=1e-14))))
            red_slot[i] = next_slot
            next_slot += 1
        else:
            off[i] = _pose_compose64(off[p], origin64[i])
            red_slot[i] = red_slot[p]
    sl = model.sphere_link[subset]
    folded = np.stack(
        [_rotate64(off[li, 3:], model.sphere_pos[subset][k])
         + off[li, :3] for k, li in enumerate(sl)]) \
        if len(sl) else np.zeros((0, 3))
    slot = (np.asarray(red_slot[sl]) if len(sl)
            else np.zeros((0,), np.int64))
    return (chain, next_slot, red_slot, off, slot,
            np.asarray(folded, dtype=np.float64))


def _red_poses_np(chain, q, base_pose):
    """The reduced chain's world poses (base first, then one per active
    joint) at one configuration, float64 numpy."""
    q = np.asarray(q, dtype=np.float64)
    red = [np.asarray(base_pose, dtype=np.float64)]
    for e in chain:
        anchor = _pose_compose64(red[e["parent_slot"]], e["K"])
        red.append(_pose_compose64(
            anchor, _motion_pose64(e["jtype"], e["axis"], q[e["dof"]])))
    return red


def sphere_positions_np(model, q, base_pose):
    """World centres (S, 3) of every sphere of ``model`` at one
    configuration q (n_dof,) under ``base_pose`` (7,), float64 numpy:
    the JAX package's host FK (robot.py:731-738), whose rotations take
    the quadratic sandwich form.  For a base quaternion that is not of
    unit norm this differs from :meth:`CompiledFK.fk_soa`'s form, as in
    the JAX package."""
    chain, _, _, _, slot, folded = _reduced_chain(
        model, model.folded()[0], np.arange(len(model.sphere_link)))
    red = _red_poses_np(chain, q, base_pose)
    return np.array([_rotate64(red[s][3:], f) + red[s][:3]
                     for s, f in zip(slot, folded)]).reshape(-1, 3)


def link_poses_np(model, q, base_pose):
    """World poses (L, 7) of every link of ``model`` at one configuration
    q (n_dof,) under ``base_pose`` (7,), float64 numpy: each link is its
    reduced slot's pose composed with its constant offset (the JAX
    package's ``CompiledFK.link_poses``, robot.py:498-512)."""
    chain, _, red_slot, off, _, _ = _reduced_chain(
        model, model.folded()[0], np.arange(len(model.sphere_link)))
    red = _red_poses_np(chain, q, base_pose)
    return np.stack([_pose_compose64(red[s], off[i])
                     for i, s in enumerate(red_slot)])


class CompiledFK:
    """FK over a RobotModel with frozen joints folded in.  The static
    chain structure is analysed once at construction; the per-call
    functions are plain tensor code on ``device``."""

    def __init__(self, model: RobotModel, dtype=torch.float32,
                 sphere_subset=None, device="cuda"):
        """sphere_subset: optional index array selecting (and ordering)
        the spheres this FK computes — the engine uses the active-first
        order (orcdchomp_mod.cpp:2265-2299).  The JAX signature, then
        the port's ``device``."""
        self.model = model
        self.dtype = dtype
        self.device = torch.device(device)
        origin64, _ = model.folded()
        self._jtype = [int(t) for t in model.jtype]
        self._dof = [int(d) for d in model.dof_index]
        self.n_dof = model.n_dof
        self.n_links = len(model.link_names)
        self._dof_link = [0] * model.n_dof
        for i, d in enumerate(self._dof):
            if d >= 0:
                self._dof_link[d] = i
        subset = (np.arange(len(model.sphere_link)) if sphere_subset is None
                  else np.asarray(sphere_subset))
        self.sphere_subset = subset
        # (S, n_dof) DOF-affects-sphere mask
        mask = model.ancestor_dof_mask()[model.sphere_link[subset]]
        self._sphere_dof_mask_np = np.asarray(mask)
        # suffix structure of the mask (serial chains): when every
        # sphere's affected-dof set is a prefix [0, k_s), sorting spheres
        # by k_s makes each dof's affected-sphere set a suffix of the
        # sorted order, so the masked sums of the Jᵀ map collapse to one
        # reverse cumsum over spheres plus D row picks
        self._jt_suffix = None
        S, D = mask.shape
        if S and D:
            k = mask.sum(axis=1)
            if np.all(mask == (np.arange(D)[None, :] < k[:, None])):
                order = np.argsort(k, kind="stable")
                start = np.searchsorted(k[order], np.arange(D), side="right")
                self._jt_suffix = (order, start)
        self._jtype_per_dof_np = np.asarray(
            [self._jtype[self._dof_link[d]] for d in range(model.n_dof)])
        (self._chain, self.n_red, red_slot, off, self._sphere_red_slot_np,
         self._sphere_folded_np) = _reduced_chain(model, origin64, subset)
        # the chain and the spheres as the FK kernel reads them
        self._fk_table_np = fk_kernel.pack_table(
            self._chain, self.n_red, self._sphere_red_slot_np,
            self._sphere_folded_np)
        # per link: its reduced slot and constant offset, a link's pose
        # being red_pose[_red_slot[l]] ∘ _off64[l] (robot.py:421-426); the
        # TSR path reads the end-effector link's
        self._red_slot = [int(r) for r in red_slot]
        self._off64 = off
        self._off_id = [bool(np.allclose(o, _POSE_ID, atol=1e-14))
                        for o in off]
        # the end effector's constant pose in its reduced slot,
        # off(ee) ∘ ee_origin folded into one (None if the identity)
        self._ee_offset_np = None
        if model.ee_link >= 0:
            eo = self._off64[model.ee_link]
            if model.ee_origin is not None:
                eo = _pose_compose64(eo, np.asarray(model.ee_origin,
                                                    dtype=np.float64))
            if not np.allclose(eo, _POSE_ID, atol=1e-14):
                self._ee_offset_np = eo
        self._to_device()

    def _on(self, device):
        """A copy of this FK with its tables on ``device``."""
        fk = copy.copy(self)
        fk.device = torch.device(device)
        fk._to_device()
        return fk

    def _to_device(self):
        dev, dt = self.device, self.dtype
        self.sphere_radius = to_device(
            self.model.sphere_radius[self.sphere_subset], dtype=dt,
            device=dev)
        self._sphere_slot = to_device(self._sphere_red_slot_np,
                                      dtype=torch.long, device=dev)
        # folded sphere offsets as (S, 1) columns: broadcast over batch
        self._sphere_folded = tuple(
            to_device(self._sphere_folded_np[:, c:c + 1], dtype=dt,
                      device=dev) for c in range(3))
        self.fk_table = to_device(self._fk_table_np, dtype=dt, device=dev)
        if self._jt_suffix is not None:
            order, start = self._jt_suffix
            identity = np.array_equal(order, np.arange(len(order)))
            self._jt_order = (None if identity
                              else to_device(order, device=dev))
            self._jt_start = to_device(start, device=dev)
        self._jt_mask = to_device(
            self._sphere_dof_mask_np[None, :, :, None], dtype=dt, device=dev)
        self._jt_rev = to_device(
            (self._jtype_per_dof_np == REVOLUTE)[None, :, None], device=dev)
        # the chain's structure as the Jᵀ map kernel reads it
        self.jt_table = to_device(
            jt_kernel.pack_table(self._jt_suffix, self._sphere_dof_mask_np,
                                 self._jtype_per_dof_np),
            dtype=torch.int32, device=dev)
        # the TSR chain's constants: stacked small-matrix tables, the
        # end effector's offset (position, quaternion) and its DOF mask
        self.mats = SpatialMats(dev, dt)
        self.ee_offset = None if self._ee_offset_np is None else (
            to_device(self._ee_offset_np[:3], dtype=dt, device=dev),
            to_device(self._ee_offset_np[3:], dtype=dt, device=dev))
        self.ee_dof_mask_np = self.model.ancestor_dof_mask()[
            self.model.ee_link]
        self.ee_dof_mask = to_device(self.ee_dof_mask_np, device=dev)
        # the per-problem FK's tables: per link its reduced slot and
        # offset, per sphere its link, offset, reduced slot and folded
        # offset, per DOF its joint axis (in the joint frame), revolute
        # or not, and which spheres it moves
        model, subset = self.model, self.sphere_subset
        self._red_slot_links = to_device(self._red_slot, device=dev)
        self._off_p = to_device(self._off64[:, :3], dtype=dt, device=dev)
        self._off_q = to_device(self._off64[:, 3:], dtype=dt, device=dev)
        self._sphere_link = to_device(model.sphere_link[subset],
                                      dtype=torch.long, device=dev)
        self._sphere_pos = to_device(model.sphere_pos[subset],
                                     dtype=dt, device=dev)
        self._sphere_folded_pos = to_device(self._sphere_folded_np,
                                            dtype=dt, device=dev)
        self._dof_axis = to_device(
            model.axis[self._dof_link].reshape(-1, 3), dtype=dt, device=dev)
        self._dof_rev = to_device(self._jtype_per_dof_np == REVOLUTE,
                                  dtype=torch.bool, device=dev)
        self._sphere_dof_mask = to_device(self._sphere_dof_mask_np,
                                          device=dev)

    # ----- per-problem FK (layout (..., n_dof); robot.py:444-738) ----------

    def red_poses(self, q, base_pose=None):
        """World poses of the reduced (active-joint) chain.  q: (...,
        n_dof).  Returns (red (..., n_red, 7), anchors (..., n_dof, 7)):
        red[..., 0, :] the base pose, then one per active joint; anchors
        are the joint frames before the joint's motion."""
        q = to_device(q, dtype=self.dtype, device=self.device)
        batch = q.shape[:-1]
        if base_pose is None:
            base_pose = qt.pose_identity(self.dtype, self.device)
        base_pose = to_device(base_pose, dtype=self.dtype,
                              device=self.device)
        half = 0.5 * q
        s, c = torch.sin(half), torch.cos(half)
        red = [base_pose.expand(batch + (7,))]
        anchors = [None] * self.n_dof
        for e in self._chain:
            parent = red[e["parent_slot"]]
            pq, ppos = parent[..., 3:], parent[..., :3]
            aq = pq if e["rot_id"] else qt.quat_compose_const(pq, e["K"][3:])
            apos = ppos if e["pos_zero"] else \
                ppos + qt.quat_rotate_const(pq, e["K"][:3])
            d = e["dof"]
            anchors[d] = torch.cat([apos, aq], dim=-1)
            ax = e["axis"]
            if e["jtype"] == REVOLUTE:
                sd = s[..., d]
                mq = torch.stack([sd * float(ax[0]), sd * float(ax[1]),
                                  sd * float(ax[2]), c[..., d]], dim=-1)
                pose = torch.cat([apos, qt.quat_compose(aq, mq)], dim=-1)
            else:  # prismatic
                step = qt.quat_rotate_const(aq, ax) * q[..., d, None]
                pose = torch.cat([apos + step, aq], dim=-1)
            red.append(pose)
        anchors = (torch.stack(anchors, dim=-2) if self.n_dof
                   else q.new_zeros(batch + (0, 7)))
        return torch.stack(red, dim=-2), anchors

    def link_pose_red(self, red, link):
        """Pose of one link from the reduced poses: its slot's pose
        composed with the link's constant offset."""
        rp = red[..., self._red_slot[link], :]
        if self._off_id[link]:
            return rp
        off = self._off64[link]
        pq = rp[..., 3:]
        pos = rp[..., :3] + qt.quat_rotate_const(pq, off[:3])
        return torch.cat([pos, qt.quat_compose_const(pq, off[3:])], dim=-1)

    def _reconstruct_links(self, red):
        """All L link poses (..., L, 7) from the reduced chain."""
        rp = red.index_select(-2, self._red_slot_links)
        pq = rp[..., 3:]
        q = qt.quat_compose(pq, self._off_q)
        pos = rp[..., :3] + qt.quat_rotate(pq, self._off_p)
        return torch.cat([pos, q], dim=-1)

    def link_poses(self, q, base_pose=None):
        """World poses of all links.  q: (..., n_dof); returns (poses
        (..., L, 7), anchors (..., n_dof, 7))."""
        red, anchors = self.red_poses(q, base_pose)
        return self._reconstruct_links(red), anchors

    def sphere_positions(self, link_poses):
        """World sphere centres (..., S, 3) from link poses."""
        lp = link_poses.index_select(-2, self._sphere_link)
        return qt.pose_apply(lp, self._sphere_pos)

    def sphere_positions_red(self, red):
        """World sphere centres (..., S, 3) from the reduced poses (the
        sphere offsets folded through the frozen subtrees)."""
        rp = red.index_select(-2, self._sphere_slot)
        return qt.pose_apply(rp, self._sphere_folded_pos)

    def point_jacobian(self, anchors, x, link_mask):
        """Position Jacobian (..., 3, n_dof) of world point(s) x (..., 3)
        over the active DOFs: axis_w × (x − origin_w) for a revolute
        joint, axis_w for a prismatic one, 0 where ``link_mask`` (...,
        n_dof) says the DOF does not move the point's link.  anchors:
        (..., n_dof, 7) joint world frames before motion."""
        axis_w = qt.quat_rotate(anchors[..., 3:], self._dof_axis)
        rel = x[..., None, :] - anchors[..., :3]
        col = torch.where(self._dof_rev[:, None],
                          torch.linalg.cross(axis_w, rel, dim=-1), axis_w)
        col = torch.where(link_mask[..., None], col, 0.0)
        return col.transpose(-1, -2)

    def sphere_jacobians(self, anchors, sphere_x):
        """Jacobians of all spheres (..., S, 3, n_dof); sphere_x: (..., S,
        3) world sphere centres."""
        return self.point_jacobian(anchors[..., None, :, :], sphere_x,
                                   self._sphere_dof_mask)

    def apply_sphere_jacT(self, anchors, sphere_x, w):
        """G = Σ_s J(s)ᵀ w_s (..., n_dof) without a Jacobian: the leading
        axes flattened into the batch axis of
        :meth:`apply_sphere_jacT_soa`.  anchors: (..., n_dof, 7);
        sphere_x, w: (..., S, 3)."""
        lead = torch.broadcast_shapes(anchors.shape[:-2], sphere_x.shape[:-2],
                                      w.shape[:-2])
        axis_w = qt.quat_rotate(anchors[..., 3:], self._dof_axis)

        def soa_cols(t):      # (..., K, 3) → 3 of (1, K, N), batch last
            t = t.expand(lead + t.shape[-2:]).reshape(-1, *t.shape[-2:])
            return tuple(t.permute(2, 1, 0)[:, None])

        g = self.apply_sphere_jacT_soa(soa_cols(anchors[..., :3]),
                                       soa_cols(axis_w), soa_cols(sphere_x),
                                       soa_cols(w))             # (1, D, N)
        return g[0].T.reshape(lead + (self.n_dof,))

    def fk_spheres(self, q, base_pose=None):
        """One call: (sphere_x (..., S, 3), jac (..., S, 3, n_dof),
        link_poses (..., L, 7))."""
        red, anchors = self.red_poses(q, base_pose)
        x = self.sphere_positions_red(red)
        return (x, self.sphere_jacobians(anchors, x),
                self._reconstruct_links(red))

    def sphere_positions_jit(self, q, base_pose):
        """Sphere centres (..., S, 3) for host-side callers: the name of
        the JAX package's jitted call, here a plain call (no
        ``torch.compile``)."""
        red, _ = self.red_poses(q, base_pose)
        return self.sphere_positions_red(red)

    # ----- structure-of-arrays (batch-last) cost path ----------------------

    def fk_soa(self, qT, base_pos, base_q):
        """SoA FK over a batched trajectory (robot.py:601-673).

        qT: (n_points, n_dof, B) joint values, batch last.
        base_pos / base_q: vec3 / quat component tuples broadcastable to
        (n_points, B) — (B,) for a fixed per-problem base.

        Returns an FkSoA whose fields are each one contiguous (c,
        n_points, ·, B) tensor: x sphere world centres (·=S); anch_pos /
        anch_q joint frames pre-motion (·=D); axis_w world joint axes
        (·=D); red_pos / red_q reduced-chain link poses (·=n_red).

        A CPU tensor runs the plain version :meth:`fk_soa_plain`; a CUDA
        tensor launches the FK kernel once (ops/fk.py: its inputs of the
        FK's dtype, any strides; the six fields views of its one output
        buffer) or raises.
        """
        if qT.device.type == "cpu":
            return self.fk_soa_plain(qT, base_pos, base_q)
        return FkSoA(*fk_kernel.fk_soa(
            self.fk_table, self.n_dof, len(self.sphere_subset), qT,
            base_pos, base_q))

    def fk_soa_plain(self, qT, base_pos, base_q):
        """Plain PyTorch version of :meth:`fk_soa` (same contract; any
        device): the chain walked with ops/soa.py's operators."""
        n_points, _, B = qT.shape
        half = 0.5 * qT
        s = torch.sin(half)
        c = torch.cos(half)

        red = [(base_pos, base_q)]
        anch = [None] * self.n_dof
        axis_w = [None] * self.n_dof
        for e in self._chain:
            ppos, pq = red[e["parent_slot"]]
            K = e["K"]
            aq = pq if e["rot_id"] else soa.qmul_const(pq, K[3:])
            apos = ppos if e["pos_zero"] else \
                soa.add(ppos, soa.qrot_const(pq, K[:3]))
            d = e["dof"]
            anch[d] = (apos, aq)
            ax = e["axis"]
            axis_w[d] = soa.qrot_const(aq, ax)
            if e["jtype"] == REVOLUTE:
                sd, cd = s[:, d, :], c[:, d, :]
                mq = (sd * float(ax[0]), sd * float(ax[1]),
                      sd * float(ax[2]), cd)
                red.append((apos, soa.qmul(aq, mq)))
            else:  # prismatic
                step = soa.scale(axis_w[d], qT[:, d, :])
                red.append((soa.add(apos, step), aq))

        full = (n_points, B)
        dtype = qT.dtype

        def stack_mid(items, nc):       # (nc, n_points, len(items), B)
            if not items:  # n_dof == 0: no joints, empty middle axis
                return torch.zeros((nc, n_points, 0, B), dtype=dtype,
                                   device=qT.device)
            return torch.stack([torch.stack(
                [torch.broadcast_to(it[ci], full) for it in items], dim=1)
                for ci in range(nc)])

        red_pos = stack_mid([r[0] for r in red], 3)
        red_q = stack_mid([r[1] for r in red], 4)
        # sphere world centres from the reduced poses (offsets pre-folded):
        # every sphere at once, gathered by its reduced-chain slot
        rp = red_pos.index_select(2, self._sphere_slot)
        rq = red_q.index_select(2, self._sphere_slot)
        x = torch.stack(soa.add(soa.qrot(rq, self._sphere_folded), rp))
        return FkSoA(
            x=x,
            anch_pos=stack_mid([a[0] for a in anch], 3),
            anch_q=stack_mid([a[1] for a in anch], 4),
            axis_w=stack_mid(axis_w, 3),
            red_pos=red_pos,
            red_q=red_q)

    def apply_sphere_jacT_soa(self, anchors_pos, axis_w, x, w):
        """SoA G = Σ_s J(s)ᵀ w_s without materialising a Jacobian
        (robot.py:675-721): w·(a×(x−o)) = a·(x×w) − a·(o×Σw).

        anchors_pos / axis_w: vec3 of (m, D, B); x / w: vec3 of
        (m, S, B), each a (3, m, ·, B) tensor or a tuple of its
        components.  Returns (m, D, B).
        """
        xw = soa.cross(x, w)
        comp = torch.stack((*xw, *w))                       # (6, m, S, B)
        if self._jt_suffix is not None:
            # suffix sums over the sorted spheres, then each dof's
            # suffix-start row: O(m·S·B) instead of O(m·S·D·B)
            so = comp if self._jt_order is None else \
                comp.index_select(2, self._jt_order)
            suf = torch.flip(torch.cumsum(torch.flip(so, (2,)), dim=2), (2,))
            suf = torch.cat([suf, torch.zeros_like(suf[:, :, :1])], dim=2)
            red = suf.index_select(2, self._jt_start)       # (6, m, D, B)
        else:
            red = torch.sum(comp[:, :, :, None, :] * self._jt_mask[None],
                            dim=2)
        sum_xw = tuple(red[:3])
        sum_w = tuple(red[3:])
        oxw = soa.cross(anchors_pos, sum_w)
        g_rev = soa.dot(axis_w, soa.sub(sum_xw, oxw))
        if np.all(self._jtype_per_dof_np == REVOLUTE):
            return g_rev
        g_pri = soa.dot(axis_w, sum_w)
        return torch.where(self._jt_rev, g_rev, g_pri)
