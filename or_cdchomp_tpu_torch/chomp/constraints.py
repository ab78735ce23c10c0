"""TSR (Task Space Region) trajectory constraints and the goal-set
projection (counterpart of or_cdchomp_tpu/chomp/constraints.py,
batch-native path).

A constraint pins selected xyz-ypr components of the pose of a virtual
object in a TSR frame (con_tsr orcdchomp_mod.cpp:1330-1497,
con_everyn_tsr 1500-1657):

    value = select(xyzypr( T0w⁻¹ ∘ pose_ee ∘ Twe⁻¹ ))
    J     = select( xyzypr_J · pose_jac⁻¹ · Xm(T0w⁻¹) · J_spatial )

A dimension is constrained when both its Bw bounds are exactly zero
(orcdchomp_mod.cpp:2466-2518).  Each step projects the update onto the
constraints' tangent (chomp.c:553-600): solve the (J A⁻¹ Jᵀ)-weighted
system over all enabled rows and push the correction back through A⁻¹.

The evaluation runs over the whole problem batch with every small
matrix stacked as one (B, C, r, c) tensor (ops/spatial.SpatialMats),
not entry by entry as the JAX package writes it for TPU lanes.  The
projection solves the system densely (Cholesky, two triangular solves)
or with the O(C) quasiseparable scan (:func:`_sss_solve`), by the fixed
rule of :func:`use_sss`.  The per-problem chain ``eval_tsr_all`` of the
JAX package belongs to its per-problem (AoS) step, which is not ported.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp import metric as metric_mod

# The dense solve holds B·(C·k)² elements in each of JJᵀ, J A⁻¹ Jᵀ and
# its factor; beyond 2²⁷ (512 MiB each in float32) a uniform layout that
# the metric allows takes the quasiseparable scan, whose memory is
# O(B·C·n²).  Below that the dense solve wins by far: at config 4
# (B = 256, C·k = 98) it took ~1 ms per call on an H100 and the scan, a
# Python loop of ~3,400 small calls, 40-52 ms (PERF.md).
_DENSE_MAX_ELEMS = 1 << 27


def _runs(idx):
    """Maximal runs of consecutive integers in idx: [(start, stop), …]."""
    runs = []
    for i in idx:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    return runs


def _pick(t, dim, idx):
    """t indexed by the static integer list idx along dim: slices of its
    consecutive runs, concatenated — no index tensor is copied to the
    device."""
    runs = _runs([int(i) for i in idx])
    parts = [t.narrow(dim, a, b - a) for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=dim)


def _spd_solve(M, b):
    """Solve M x = b for symmetric positive-definite M (..., K, K), b
    (..., K) via Cholesky, as the JAX package does (constraints.py:59-71;
    J A⁻¹ Jᵀ is SPD when the reference's dgesv system is non-singular,
    chomp.c:579-581).  ``cholesky_ex`` checks nothing, so the solve never
    waits for the device; a factor that fails makes that problem's x
    NaN, which is what the JAX package returns."""
    L, info = torch.linalg.cholesky_ex(M)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]
    return torch.where((info != 0)[..., None], torch.nan, x)


def _chol_unrolled(S, k):
    """Cholesky of (..., k, k) blocks as k² unrolled scalar ops; entries
    are (...,) tensors."""
    L = [[None] * k for _ in range(k)]
    for i in range(k):
        for j in range(i + 1):
            acc = S[..., i, j]
            for t in range(j):
                acc = acc - L[i][t] * L[j][t]
            L[i][j] = torch.sqrt(acc) if i == j else acc / L[j][j]
    return L


def _fwd_sub(L, b, k):
    """y = L⁻¹ b, unrolled; b is a list of k tensors."""
    y = [None] * k
    for i in range(k):
        acc = b[i]
        for t in range(i):
            acc = acc - L[i][t] * y[t]
        y[i] = acc / L[i][i]
    return y


def _bwd_sub(L, b, k):
    """x = L⁻ᵀ b, unrolled."""
    x = [None] * k
    for i in reversed(range(k)):
        acc = b[i]
        for t in range(i + 1, k):
            acc = acc - L[t][i] * x[t]
        x[i] = acc / L[i][i]
    return x


def _sss_solve(J, h, alpha, beta):
    """Exact O(C) solve of (Ainv ∘ JJᵀ) x = h for the D=1 metric, batched
    over problems (constraints.py:110-179).

    The default metric's inverse is semiseparable, Ainv[a, b] =
    α_min(a,b)·β_max(a,b), so the system is block-quasiseparable and its
    Cholesky factor runs as a forward and a backward sweep over the C
    constraint points carrying an (n, n) accumulator; no (C·k)² matrix
    is built.  The sweeps are Python loops of small batched ops.

    J: (B, C, k, n); h: (B, C, k); alpha, beta: (C,) Python floats or
    float64 numpy.  Returns x (B, C, k).
    """
    B, C, k, n = J.shape
    opts = dict(dtype=J.dtype, device=J.device)
    P = torch.zeros((B, n, n), **opts)
    s = torch.zeros((B, n), **opts)
    saved = []
    for c in range(C):
        Jb, hb = J[:, c], h[:, c]                     # (B, k, n), (B, k)
        al, be = float(alpha[c]), float(beta[c])
        Vb = be * Jb                                  # (B, k, n)
        PV = torch.matmul(P, Vb.mT)                   # (B, n, k)
        JJ = torch.matmul(Jb, Jb.mT)                  # (B, k, k)
        VPV = torch.matmul(Vb, PV)
        S = al * be * JJ - VPV                        # Schur block
        L = _chol_unrolled(S, k)
        # Zᵀ = (Ubᵀ − P Vbᵀ) L⁻ᵀ, column-unrolled     (B, n, k)
        W = al * Jb.mT - PV
        Zcols = [None] * k
        for j in range(k):
            acc = W[..., j]
            for t in range(j):
                acc = acc - L[j][t][:, None] * Zcols[t]
            Zcols[j] = acc / L[j][j][:, None]
        ZT = torch.stack(Zcols, dim=-1)
        fb = hb - torch.matmul(Vb, s[..., None])[..., 0]
        yv = torch.stack(_fwd_sub(L, [fb[:, i] for i in range(k)], k),
                         dim=-1)                      # (B, k)
        s = s + torch.matmul(ZT, yv[..., None])[..., 0]
        P = P + torch.matmul(ZT, ZT.mT)
        saved.append((L, ZT, Vb, yv))

    t = torch.zeros((B, n), **opts)
    xs = [None] * C
    for c in reversed(range(C)):
        L, ZT, Vb, yv = saved[c]
        g = yv - torch.matmul(ZT.mT, t[..., None])[..., 0]      # (B, k)
        xv = torch.stack(_bwd_sub(L, [g[:, i] for i in range(k)], k),
                         dim=-1)
        t = t + torch.matmul(Vb.mT, xv[..., None])[..., 0]      # (B, n)
        xs[c] = xv
    return torch.stack(xs, dim=1)


class TSRConstraintSet(NamedTuple):
    """Static layout of all active TSR constraints: which moving point
    each pins and which of its 6 rows are enabled.  A problem's TSR
    frames live in ChompProblem (tsr_T0w_inv / tsr_Twe_inv, (C, 7))."""

    point_idx: tuple          # (C,) moving-point index per constraint
    enabled: tuple            # (C,) tuple of 6 bools each
    rows: tuple               # K static (constraint, dim) pairs

    @property
    def n_constraints(self):
        return len(self.point_idx)

    @property
    def k_total(self):
        return len(self.rows)

    @classmethod
    def build(cls, entries: Sequence):
        """entries: sequence of (point_idx, enabled6)."""
        point_idx = tuple(int(e[0]) for e in entries)
        enabled = tuple(tuple(bool(b) for b in e[1]) for e in entries)
        rows = tuple(
            (c, d) for c in range(len(entries)) for d in range(6)
            if enabled[c][d])
        return cls(point_idx=point_idx, enabled=enabled, rows=rows)


def tsr_enabled_from_bw(bw) -> tuple:
    """Enabled mask from a 6×2 Bw bound array: dim constrained iff both
    bounds are 0.0 (orcdchomp_mod.cpp:2466-2518)."""
    bw = np.asarray(bw, dtype=float).reshape(6, 2)
    return tuple(bool(bw[i, 0] == 0.0 and bw[i, 1] == 0.0) for i in range(6))


def _compose(mats, pos, q, pos_b, q_b):
    """(pos, q) ∘ (pos_b, q_b) on stacked poses: p + R(q)·p_b, q ⊗ q_b."""
    pos = pos + torch.matmul(mats.rot(q), pos_b[..., None])[..., 0]
    q = torch.matmul(mats.qleft(q), q_b[..., None])[..., 0]
    return pos, q


def eval_tsr_all_soa(spec, fk, probs, T_full, cons: TSRConstraintSet,
                     fk_out):
    """Value and Jacobian of every constraint over a problem batch
    (constraints.py:326-510): the same math as the JAX package's, with
    each small matrix a stacked (B, C, r, c) tensor.

    probs: batched ChompProblem; T_full (B, n_points, n); fk_out: FkSoA
    of ``fk.fk_soa`` on T_full.  Returns (val (B, C, 6), jac
    (B, C, 6, n)), rows in Bw order.
    """
    mats = fk.mats
    off = 0 if spec.start_tsr else 1
    rows = [p + off for p in cons.point_idx]
    ee = fk.model.ee_link
    slot = fk._red_slot[ee]

    # end-effector pose at the constraint points, (B, C, 3) and (B, C, 4)
    pos, q = (_pick(t, 1, rows)[:, :, slot].permute(2, 1, 0)
              for t in (fk_out.red_pos, fk_out.red_q))
    if fk.ee_offset is not None:           # off(ee) ∘ ee_origin, folded
        pos, q = _compose(mats, pos, q, *fk.ee_offset)
    twe, t0w = probs.tsr_Twe_inv, probs.tsr_T0w_inv           # (B, C, 7)
    pos, q = _compose(mats, pos, q, twe[..., :3], twe[..., 3:])
    R0 = mats.rot(t0w[..., 3:])
    pos = t0w[..., :3] + torch.matmul(R0, pos[..., None])[..., 0]
    q = torch.matmul(mats.qleft(t0w[..., 3:]), q[..., None])[..., 0]

    (roll, pitch, yaw), jq = mats.ypr(q)
    val = torch.cat([pos, torch.stack([roll, pitch, yaw], dim=-1)], dim=-1)

    # spatial Jacobian of the ee link about the world origin, (B, C, 6, n)
    arm = None
    if fk.n_dof:
        aw, ow = (_pick(t, 1, rows).permute(1, 2, 3, 0)         # (C, D, B, 3)
                  for t in (fk_out.axis_w, fk_out.anch_pos))
        lin = torch.linalg.cross(aw, -ow, dim=-1)               # a × (0 − o)
        zero = torch.zeros_like(aw)
        rev = fk._jt_rev.view(-1, 1, 1)                         # (D, 1, 1)
        col = torch.where(rev, torch.cat([aw, lin], dim=-1),
                          torch.cat([zero, aw], dim=-1))        # (C, D, B, 6)
        if not fk.ee_dof_mask_np.all():    # DOFs that do not move the ee
            col = torch.where(fk.ee_dof_mask.view(-1, 1, 1), col, 0.0)
        arm = col.permute(2, 0, 3, 1)                           # (B, C, 6, D)
    if spec.floating_base:
        base = mats.pose_jac(_pick(T_full, 1, rows)[..., :7])   # (B, C, 6, 7)
        spajac = base if arm is None else torch.cat([base, arm], dim=-1)
    else:
        spajac = arm

    # to_ypr · jac_inv · Xm(table←world) · spajac
    # (orcdchomp_mod.cpp:1466-1481), rows already in Bw order
    chain = torch.matmul(mats.ypr_jac(jq), mats.pose_jac_inverse(pos, q))
    chain = torch.matmul(chain, mats.xm(t0w[..., :3], R0))
    return val, torch.matmul(chain, spajac)


def use_sss(spec, cons: TSRConstraintSet, B):
    """The projection's solve for a uniform constraint layout: the
    quasiseparable scan where the metric allows it (D = 1, both
    endpoints fixed, C ≥ 4 sorted points) and the dense system
    B·(C·k)² would exceed ``_DENSE_MAX_ELEMS``; the dense Cholesky
    otherwise."""
    pts = np.asarray(cons.point_idx)
    C = len(pts)
    k = sum(cons.enabled[0])
    ok = (metric_mod.sep_eligible(spec.D, not spec.start_tsr)
          and C >= 4 and bool(np.all(np.diff(pts) >= 0)))
    return ok and B * (C * k) ** 2 > _DENSE_MAX_ELEMS


class ProjectionOps(NamedTuple):
    """Device constants of the projection for one constraint layout
    (JAX's ``ainv_block`` / ``ainv_cols``, constant-folded there): A⁻¹
    at the points of the system's rows, A⁻¹'s columns there, and the
    quasiseparable generators α_p = dt²(p+1), β_p = m − p (float64
    numpy)."""

    ainv_block: torch.Tensor   # (K', K'): Ainv[pts][:, pts]
    ainv_cols: torch.Tensor    # (m, K'): Ainv[:, pts]
    alpha: np.ndarray          # (C,)
    beta: np.ndarray           # (C,)

    @classmethod
    def build(cls, spec, cons: TSRConstraintSet, engine):
        """From the engine's ``ainv_block`` / ``ainv_cols`` (the dense
        A⁻¹'s entries, or the semiseparable closed form's: no m×m tensor
        is needed).  The points are the constraint points for a uniform
        layout, one per enabled row for a mixed one."""
        pts = np.asarray(cons.point_idx)
        if len(set(cons.enabled)) != 1:
            pts = np.asarray([pts[c] for c, _ in cons.rows])
        cp = np.asarray(cons.point_idx, dtype=np.float64)
        return cls(ainv_block=engine.ainv_block(pts).contiguous(),
                   ainv_cols=engine.ainv_cols(pts).contiguous(),
                   alpha=(spec.dt * spec.dt) * (cp + 1.0),
                   beta=float(spec.m) - cp)


def project_constraints(spec, cons: TSRConstraintSet, ops: ProjectionOps,
                        lambda_, AG, T_mov, val, jac):
    """Goal-set CHOMP constraint projection over a problem batch
    (chomp.c:553-600; JAX constraints.py:512-594, vmapped there).

    lambda_ (B,); AG, T_mov (B, m, n); val (B, C, 6); jac (B, C, 6, n).
    Returns the correction (B, m, n) to add to the trajectory.
    """
    if cons.k_total == 0:
        return torch.zeros_like(T_mov)
    B = T_mov.shape[0]
    pts = cons.point_idx
    C = cons.n_constraints
    inv_lam = (1.0 / lambda_)[:, None]                          # (B, 1)

    if len(set(cons.enabled)) == 1:
        # every constraint enables the same dims: rows stay in (C, k)
        dims = [d for d in range(6) if cons.enabled[0][d]]
        k = len(dims)
        h0 = _pick(val, 2, dims)                                # (B, C, k)
        J = _pick(jac, 2, dims)                                 # (B, C, k, n)
        AGp = _pick(AG, 1, pts)                                 # (B, C, n)
        # h += −(1/λ) J · AG[pt]  (chomp.c:563-565)
        h = h0 - inv_lam[..., None] * torch.matmul(J, AGp[..., None])[..., 0]
        if use_sss(spec, cons, B):
            x = _sss_solve(J, h, ops.alpha, ops.beta)           # (B, C, k)
        else:
            # JAJT[(a,i),(b,j)] = Ainv[pt_a, pt_b] · (J_ai · J_bj)
            # (chomp.c:568-575)
            Jf = J.reshape(B, C * k, -1)
            JJt = torch.matmul(Jf, Jf.mT).view(B, C, k, C, k)
            JAJT = (JJt * ops.ainv_block[:, None, :, None]).reshape(
                B, C * k, C * k)
            x = _spd_solve(JAJT, h.reshape(B, C * k)).view(B, C, k)
        # T −= Σ_c Ainv[:, pt_c] ⊗ (J_cᵀ x_c)  (chomp.c:593-599)
        delta = torch.matmul(x[..., None, :], J)[..., 0, :]     # (B, C, n)
        return -torch.matmul(ops.ainv_cols, delta)

    # mixed enabled masks: one system row per enabled (constraint, dim)
    flat = [c * 6 + d for c, d in cons.rows]
    h = _pick(val.reshape(B, C * 6), 1, flat)                   # (B, K)
    J = _pick(jac.reshape(B, C * 6, -1), 1, flat)               # (B, K, n)
    AGr = _pick(AG, 1, [pts[c] for c, _ in cons.rows])          # (B, K, n)
    h = h - inv_lam * (J * AGr).sum(-1)
    JAJT = torch.matmul(J, J.mT) * ops.ainv_block
    x = _spd_solve(JAJT, h)                                     # (B, K)
    return -torch.matmul(ops.ainv_cols, x[..., None] * J)
