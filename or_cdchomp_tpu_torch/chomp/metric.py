# Copied from or_cdchomp_tpu/chomp/metric.py (host numpy; shared copy pending de-duplication); the
# semiseparable operators are its torch counterparts.
"""Smoothness metric construction: K/E stacks, A, A⁻¹, B, trC, Kvels.

Mirrors cd_chomp's metric init exactly (chomp.c:239-340 add_KEs,
chomp.c:342-403 init, chomp.c:348-386 velocity operator), with the same
endpoint conventions:

 - ``inits``/``finals`` default to *present with zero values* for every
   derivative order (cd_chomp_create allocates zero vectors,
   chomp.c:131-141); the caller overrides order-0 with the fixed start
   and goal configurations (orcdchomp_mod.cpp:2567-2580), and
   ``inits[0]`` is absent when the start point itself is optimized
   (start_tsr mode).
 - A = Σ_d (w_d / n_d) K_dᵀ K_d with w = [0,…,0,1] (chomp.c:127-128),
   B = Σ_d (w_d / n_d) K_dᵀ E_d,  trC = ½ Σ_d (w_d/n_d) tr(E_dᵀE_d).

Everything here runs once per problem *shape* on the host in float64
(the reference uses LAPACK dgetrf/dgetri, chomp.c:392-403) and is cast
to the device dtype afterwards.  A and A⁻¹ depend only on
(m, dt, D, endpoint presence) — not on the endpoint *values* — so they
are shared across every problem in a batch; B and trC depend on the
endpoint values and are built as small batched matmuls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class MetricOperators(NamedTuple):
    """Host-side (numpy, float64) metric operators for one problem shape."""

    A: np.ndarray        # (m, m)
    Ainv: np.ndarray     # (m, m)
    Kvels: np.ndarray    # (m, m)
    Ks: tuple            # per-order K_d, each (n_d, m)
    Es_base: tuple       # per-order matrices that build E, see build_B_trC
    num_derivs: tuple    # per-order n_d
    wds: np.ndarray      # (D,)
    dt: float
    m: int
    D: int
    has_init0: bool
    has_final0: bool


def _diff_matrix(n_out, n_in, dt, has_init, has_final):
    """Finite-difference matrix of one derivative order.

    (chomp.c:271-296: optional endpoint rows + interior two-point rows.)
    Returns (diff (n_out, n_in), e_init_row or None, e_final_row or None)
    where e rows give the coefficient applied to the init/final vector.
    """
    diff = np.zeros((n_out, n_in))
    row = 0
    e_init = None
    e_final = None
    if has_init:
        diff[0, 0] = 1.0 / dt
        e_init = 0  # E[0] += -init/dt
        row = 1
    for i in range(n_in - 1):
        diff[row + i, i] = -1.0 / dt
        diff[row + i, i + 1] = 1.0 / dt
    if has_final:
        diff[n_out - 1, n_in - 1] = -1.0 / dt
        e_final = n_out - 1  # E[last] += +final/dt
    return diff, e_init, e_final


def build_metric(
    m: int,
    dt: float,
    D: int = 1,
    has_init0: bool = True,
    has_final0: bool = True,
) -> MetricOperators:
    """Build A, A⁻¹, Kvels and the per-order K/E scaffolding.

    ``has_init0=False`` corresponds to start_tsr mode (the start point
    is a moving point; orcdchomp_mod.cpp:2569-2572).  Higher-order
    endpoints (d ≥ 1) are always present with zero values, matching
    cd_chomp_create's allocation (chomp.c:131-141).
    """
    wds = np.array([0.0] * (D - 1) + [1.0]) if D > 0 else np.zeros(0)

    has_init = [has_init0] + [True] * max(0, D - 1)
    has_final = [has_final0] + [True] * max(0, D - 1)

    Ks = []
    diffs = []
    e_rows = []  # (init_row, final_row) per order
    num_derivs = []
    nd_prev = m
    for d in range(D):
        n_out = nd_prev - 1 + int(has_init[d]) + int(has_final[d])
        diff, ei, ef = _diff_matrix(n_out, nd_prev, dt, has_init[d], has_final[d])
        K = diff if d == 0 else diff @ Ks[d - 1]
        Ks.append(K)
        diffs.append(diff)
        e_rows.append((ei, ef))
        num_derivs.append(n_out)
        nd_prev = n_out

    A = np.zeros((m, m))
    for d in range(D):
        A += (wds[d] / num_derivs[d]) * (Ks[d].T @ Ks[d])
    Ainv = np.linalg.inv(A)

    # velocity operator (chomp.c:348-386)
    Kvels = np.zeros((m, m))
    for i in range(m):
        if i == 0:
            if has_init0:
                if m > 1:
                    Kvels[0, 1] = 0.5 / dt
            else:
                Kvels[0, 0] = -1.0 / dt
                if m > 1:
                    Kvels[0, 1] = 1.0 / dt
        elif i < m - 1:
            Kvels[i, i + 1] = 0.5 / dt
            Kvels[i, i - 1] = -0.5 / dt
        else:
            if has_final0:
                Kvels[i, i - 1] = -0.5 / dt
            else:
                Kvels[i, i] = 1.0 / dt
                Kvels[i, i - 1] = -1.0 / dt

    return MetricOperators(
        A=A,
        Ainv=Ainv,
        Kvels=Kvels,
        Ks=tuple(Ks),
        Es_base=tuple(zip(diffs, e_rows)),
        num_derivs=tuple(num_derivs),
        wds=wds,
        dt=dt,
        m=m,
        D=D,
        has_init0=has_init0,
        has_final0=has_final0,
    )


# ---------------------------------------------------------------------------
# Semiseparable metric (D = 1, both endpoints fixed — the default).
#
# A = T/(dt²·M) with T = tridiag(−1, 2, −1) and M = m + 1, whose inverse
# is known in closed form:
#
#     Ainv[p, q] = dt² · (p+1) · (m−q)   for p ≤ q (0-indexed), symmetric
#
# so A⁻¹·G is two cumulative sums, O(m·n), and no m×m matrix exists.
# The torch operators below work on (..., m, n) tensors on any device.
# ---------------------------------------------------------------------------

SEP_MIN_M = 256   # auto-switch threshold of the semiseparable metric


def sep_eligible(D: int, has_init0: bool, has_final0: bool = True) -> bool:
    """The closed form holds for the default first-order metric with
    both endpoints present (w = [1], chomp.c:127-128)."""
    return D == 1 and has_init0 and has_final0


def _weights(m, like):
    """(j + 1, m − j) as (m, 1) columns in ``like``'s dtype and device."""
    j = torch.arange(m, dtype=like.dtype, device=like.device)
    return (j + 1.0)[:, None], (m - j)[:, None]


def sep_solve(G, dt):
    """A⁻¹ · G for the default metric via two cumsums.  G: (..., m, n)."""
    up, down = _weights(G.shape[-2], G)
    c1 = torch.cumsum(up * G, dim=-2)             # Σ_{j≤p} (j+1)·G_j
    cb = torch.cumsum(down * G, dim=-2)
    s_after = cb[..., -1:, :] - cb                # Σ_{j>p} (m−j)·G_j
    return (dt * dt) * (down * c1 + up * s_after)


def sep_apply_A(X, dt):
    """A · X for the default metric: the tridiag(−1, 2, −1)/(dt²·M)
    stencil with zero virtual endpoints.  X: (..., m, n)."""
    m = X.shape[-2]
    zero = torch.zeros_like(X[..., :1, :])
    up = torch.cat([X[..., 1:, :], zero], dim=-2)
    dn = torch.cat([zero, X[..., :-1, :]], dim=-2)
    return (2.0 * X - up - dn) / (dt * dt * (m + 1))


def sep_ainv_entries(p, q, m, dt):
    """Analytic Ainv[p, q] (0-indexed, broadcastable integer tensors or
    numpy arrays; float64 out, a tensor for tensors)."""
    if isinstance(p, torch.Tensor) or isinstance(q, torch.Tensor):
        lo, hi = torch.minimum(p, q), torch.maximum(p, q)
        return (dt * dt) * (lo.double() + 1.0) * (m - hi).double()
    lo, hi = np.minimum(p, q), np.maximum(p, q)
    return (dt * dt) * (lo + 1.0) * (m - hi)


def sep_B_trC(m, dt, init0, final0, n):
    """Closed-form B and trC for the default metric (host numpy).

    B has only its endpoint rows nonzero: B[0] = −init/(dt²·M),
    B[m−1] += −final/(dt²·M) (chomp.c:319-323 specialized to D=1)."""
    s = 1.0 / (dt * dt * (m + 1))
    B = np.zeros((m, n))
    B[0] += -s * np.asarray(init0, dtype=float)
    B[m - 1] += -s * np.asarray(final0, dtype=float)
    trC = 0.5 * s * (np.sum(np.square(init0)) + np.sum(np.square(final0)))
    return B, float(trC)


def sep_Evels(m, dt, init0, final0, n):
    """Velocity-operator affine part (host numpy; the closed form of
    build_Evels with both endpoints present)."""
    E = np.zeros((m, n))
    E[0] = -0.5 / dt * np.asarray(init0, dtype=float)
    E[m - 1] = 0.5 / dt * np.asarray(final0, dtype=float)
    return E


def build_E_stack(ops: MetricOperators, init0, final0, n: int):
    """Per-order E_d matrices given order-0 endpoint values.

    init0/final0: (n,) arrays or None (absent endpoint).  Higher-order
    endpoint values are zero (see module docstring).  Returns a list of
    E_d, each (n_d, n).  (chomp.c:275-308)
    """
    Es = []
    E_prev = None
    for d in range(ops.D):
        diff, (ei, ef) = ops.Es_base[d]
        nd = diff.shape[0]
        E = np.zeros((nd, n))
        if d == 0:
            if ei is not None and init0 is not None:
                E[ei] += -np.asarray(init0, dtype=float) / ops.dt
            if ef is not None and final0 is not None:
                E[ef] += np.asarray(final0, dtype=float) / ops.dt
        else:
            # zero-valued higher-order endpoints contribute nothing of
            # their own; propagate prior E through diff (chomp.c:305-308)
            E += diff @ E_prev
        if d > 0:
            pass
        E_prev = E
        Es.append(E)
    return Es


def build_B_trC(ops: MetricOperators, init0, final0, n: int):
    """B = Σ (w_d/n_d) K_dᵀ E_d and trC = ½ Σ (w_d/n_d) tr(E_dᵀ E_d).

    (chomp.c:319-330)
    """
    Es = build_E_stack(ops, init0, final0, n)
    B = np.zeros((ops.m, n))
    trC = 0.0
    for d in range(ops.D):
        s = ops.wds[d] / ops.num_derivs[d]
        B += s * (ops.Ks[d].T @ Es[d])
        trC += 0.5 * s * np.trace(Es[d].T @ Es[d])
    return B, trC


def affine_generators(ops: MetricOperators):
    """Closed-form generators of the endpoint-affine metric terms.

    Every E_d is *linear* in (init0, final0): E_0 carries −init0/dt and
    +final0/dt on its endpoint rows (chomp.c:275-303) and higher orders
    propagate through the diff matrices only (zero-valued higher-order
    endpoints, chomp.c:131-141).  Writing E_d = ai_d ⊗ init0 +
    af_d ⊗ final0 gives

        B    = binit ⊗ init0 + bfinal ⊗ final0,
        trC  = c_ii·‖init0‖² + c_if·(init0·final0) + c_ff·‖final0‖²,

    with binit = Σ_d s_d K_dᵀ ai_d (likewise bfinal) and the c scalars
    from the ai/af inner products — so a whole problem batch builds its
    B/trC as two outer products + three dot products instead of P
    independent K/E stack evaluations (the round-3 host loop).

    Returns (binit (m,), bfinal (m,), c_ii, c_if, c_ff).
    """
    m = ops.m
    binit = np.zeros(m)
    bfinal = np.zeros(m)
    c_ii = c_if = c_ff = 0.0
    ai = af = None
    for d in range(ops.D):
        diff, (ei, ef) = ops.Es_base[d]
        nd = diff.shape[0]
        if d == 0:
            ai = np.zeros(nd)
            af = np.zeros(nd)
            if ei is not None:
                ai[ei] = -1.0 / ops.dt
            if ef is not None:
                af[ef] = 1.0 / ops.dt
        else:
            ai = diff @ ai
            af = diff @ af
        s = ops.wds[d] / ops.num_derivs[d]
        binit += s * (ops.Ks[d].T @ ai)
        bfinal += s * (ops.Ks[d].T @ af)
        c_ii += 0.5 * s * float(ai @ ai)
        c_if += s * float(ai @ af)
        c_ff += 0.5 * s * float(af @ af)
    return binit, bfinal, c_ii, c_if, c_ff


def build_Evels(ops: MetricOperators, init0, final0, n: int):
    """Velocity-operator affine part (chomp.c:348-386)."""
    E = np.zeros((ops.m, n))
    if ops.has_init0 and init0 is not None:
        E[0] = -0.5 / ops.dt * np.asarray(init0, dtype=float)
    if ops.has_final0 and final0 is not None:
        E[ops.m - 1] = 0.5 / ops.dt * np.asarray(final0, dtype=float)
    return E
