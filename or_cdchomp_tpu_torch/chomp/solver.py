"""The CHOMP covariant-update solver over a problem batch (counterpart of
or_cdchomp_tpu/chomp/solver.py, batch-native path).

One step (cd_chomp_iterate, chomp.c:430-683, with the HMC resampling of
mod::iterate, orcdchomp_mod.cpp:2752-2768) on a (B,)-batched problem:

 0. HMC: draw, then resample the momentum where due      (solver.py:253-274)
 1. workspace kinematics + obstacle/self cost gradient   (callbacks)
 2. G += A·T + B                                         (chomp.c:515-522)
 3. AG = A⁻¹·G, or leapfrog momentum accumulation        (chomp.c:524-548)
 4. TSR constraint projection                            (chomp.c:553-600)
 5. T −= (1/λ)·AG                                        (chomp.c:604-605)
 6. joint-limit repair loop (≤1000 rounds)               (chomp.c:608-655)
 7. smoothness cost on the updated trajectory            (chomp.c:660-677)
 8. floating base: renormalise each point's base quaternion

The metric is dense (m×m A/A⁻¹ matmuls shared across the batch) or, for
long trajectories, semiseparable (chomp/metric.py: a stencil and two
cumsums, no m×m tensor), by the JAX engine's ``metric_mode`` rule;
iterations are a Python loop.  The HMC resample is split into a random
draw (``HmcDraw``, ``SeededDraw`` for a batch with per-problem seeds, or
any callable of the same contract) and a deterministic update
(``hmc_resample``), so that a test can replay another implementation's
random numbers.  Under start_tsr the start
point moves (the window of moving points begins at 0), and an
``extra_cost`` hook (create's start_cost) adds its cost and gradient to
every problem through ``torch.func.vmap``.  The per-problem entry
points ``step``, ``iterate`` and ``costs_only`` are this batch step at
B = 1.
"""

from __future__ import annotations

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.chomp import metric as metric_mod
from or_cdchomp_tpu_torch.chomp.constraints import (
    ProjectionOps, TSRConstraintSet, eval_tsr_all_soa, project_constraints)
from or_cdchomp_tpu_torch.chomp.problem import as_batch, first
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.ops import draw as draw_ops
from or_cdchomp_tpu_torch.ops.quat import pose_normalize
from or_cdchomp_tpu_torch.ops.selfcol import pair_table
from or_cdchomp_tpu_torch.utils.profiling import phase

_MAX_LIMIT_FIXES = 1000  # chomp.c:608
_HMC_U_MIN = 1e-12       # lower end of the uniform draw (solver.py:270)


class HmcDraw:
    """The default HMC draw source: a ``torch.Generator`` on one device,
    seeded once.  Called once per applied step with the (B,)-batched
    problem, for every problem whether or not any resamples; returns
    ``z`` (B, m, n) standard normal and ``u`` (B,) uniform in
    [1e-12, 1), in the problem's dtype on its device.  Draws on the
    device's own generator, so no host sync."""

    def __init__(self, seed=0, device="cuda"):
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(int(seed))

    def state(self):
        """The generator's state, for a checkpoint (checkpoint.py):
        {"device": the generator's device type, "rng": a CPU uint8
        tensor}.  :meth:`load_state` of a draw on the same device type
        continues the same stream."""
        return {"device": self.generator.device.type,
                "rng": self.generator.get_state()}

    def load_state(self, state):
        """Set the generator to a :meth:`state`; raises ValueError if it
        was taken on another device type (a CPU generator's state is not
        a CUDA one's)."""
        if state["device"] != self.generator.device.type:
            raise ValueError(
                f"HMC draw state of a {state['device']} generator cannot "
                f"load into a {self.generator.device.type} one")
        self.generator.set_state(state["rng"])

    def __call__(self, probs):
        opts = dict(dtype=probs.AG.dtype, device=probs.AG.device,
                    generator=self.generator)
        z = torch.randn(probs.AG.shape, **opts)
        u = torch.rand(probs.AG.shape[:1], **opts)
        return z, u * (1.0 - _HMC_U_MIN) + _HMC_U_MIN


class SeededDraw:
    """The draw source of a batch built with per-problem seeds
    (``problem_batch_from_grid(..., seeds=...)``): problem p at its own
    iteration i draws ``z`` and ``u`` from Philox4x32-10 keyed by
    ``hmc_seed[p]`` at counters that hold i (ops/draw.py), one kernel
    launch for the batch on the card.  So p's draws are the same whatever
    batch it sits in and whatever the other rows do; they are not the
    JAX package's ``jax.random`` numbers.  Stateless: the step chooses it
    for any batch whose ``hmc_seed`` is set."""

    def __call__(self, probs):
        _, m, n = probs.AG.shape
        return draw_ops.hmc_draw(probs.hmc_seed, probs.iteration, m, n,
                                 probs.AG.dtype)


class RecordingDraw:
    """A draw source that passes ``inner``'s draws on and keeps a copy of
    the first ``n`` problems' ``z`` and ``u`` (all with ``n`` None) in
    the lists ``z`` and ``u``, one entry per call, on their device (no
    sync).  :class:`ReplayDraw` replays them, on another device or dtype
    too."""

    def __init__(self, inner, n=None):
        self.inner, self.n = inner, n
        self.z, self.u = [], []

    def __call__(self, probs):
        z, u = self.inner(probs)
        self.z.append(z[:self.n].clone())
        self.u.append(u[:self.n].clone())
        return z, u


class ReplayDraw:
    """A draw source that returns the recorded draws ``z[i]``, ``u[i]`` of
    its i-th call, cast to the problem's dtype and device."""

    def __init__(self, z, u):
        self.z, self.u, self.calls = z, u, 0

    def __call__(self, probs):
        opts = dict(dtype=probs.AG.dtype, device=probs.AG.device)
        z, u = self.z[self.calls], self.u[self.calls]
        self.calls += 1
        return z.to(**opts), u.to(**opts)


SEEDED_DRAW = SeededDraw()


def hmc_resample(probs, z, u):
    """The deterministic part of the HMC resample
    (orcdchomp_mod.cpp:2754-2768, JAX solver.py:253-274), per problem:
    where ``iteration == resample_iter``, AG = z/√α with
    α = 100·e^{0.02·iteration}, ``leapfrog_first`` is set, and the next
    resample lies 1 + ⌊−ln u / hmc_resample_lambda⌋ iterations on.
    Returns (AG, resample_iter, leapfrog_first)."""
    it = probs.iteration
    alpha = 100.0 * torch.exp(0.02 * it.to(z.dtype))
    do = it == probs.resample_iter
    AG = torch.where(do[:, None, None], z / torch.sqrt(alpha)[:, None, None],
                     probs.AG)
    leap = probs.leapfrog_first | do
    gap = 1 + torch.floor(-torch.log(u) / probs.hmc_resample_lambda
                          ).to(torch.int32)
    nxt = torch.where(do, it + gap, probs.resample_iter)
    return AG, nxt, leap


class ChompEngine:
    """Static solver context on one device: spec + robot + fields + metric
    (``metric_mode`` "dense" or "sep", chosen by "auto" as in JAX) +
    constraint layout + the extra-cost hook.  One
    engine serves every problem that shares its static structure;
    problems are batched along a leading axis.

    ``extra_cost`` (JAX solver.py:226-236, chomp.c:495-501) is a hook of
    one problem, ``hook(T_mov (m, n)) → (cost (), grad (m, n))`` on
    tensors, added after the 1/m scaling to the cost and the gradient
    of every step and to the final cost report; the batch applies it
    with ``torch.func.vmap``."""

    # steps a module run (api.CHOMPModule.iterate) takes between reads of
    # its costs to the host (solver.py:593)
    ITER_CHUNK = 16

    def __init__(self, spec, model, fields, dtype=torch.float32,
                 device="cuda", metric_ops=None, seed=0, cons=None,
                 extra_cost=None, metric_mode="auto"):
        # the JAX engine's metric choice (solver.py:74-95): "auto" takes
        # the semiseparable metric from SEP_MIN_M moving points on where
        # it holds (D = 1, both endpoints fixed; start_tsr frees the
        # start point, so it keeps the dense metric at any m)
        sep_ok = metric_mod.sep_eligible(spec.D, not spec.start_tsr)
        if metric_mode == "auto":
            metric_mode = ("sep" if sep_ok and spec.m >= metric_mod.SEP_MIN_M
                           else "dense")
        if metric_mode not in ("dense", "sep"):
            raise ValueError(f"metric_mode must be auto, dense or sep, not "
                             f"{metric_mode!r}")
        if metric_mode == "sep" and not sep_ok:
            raise ValueError("semiseparable metric requires D=1 with both "
                             "endpoints fixed (no start_tsr)")
        self.metric_mode = metric_mode
        self.spec = spec
        self.dtype = dtype
        self.device = torch.device(device)
        self.fields = fields
        self.extra_cost = extra_cost
        self.mov_lo = cost_soa.mov_lo(spec)
        # HMC draw source of the batch drivers; a caller may replace it
        # with any callable of the same contract (a recorder, or a replay
        # of given draws).  A module run carries its own (api.Run.draw),
        # so runs that share a cached engine share no random state.
        self.draw = HmcDraw(seed, device)
        # the semiseparable metric holds no m×m tensor (A, Ainv None)
        self.metric_ops = self.A = self.Ainv = None
        if metric_mode == "dense":
            if metric_ops is None:
                metric_ops = metric_mod.build_metric(
                    spec.m, spec.dt, D=spec.D, has_init0=not spec.start_tsr)
            self.metric_ops = metric_ops
            self.A = torch.as_tensor(metric_ops.A, dtype=dtype, device=device)
            self.Ainv = torch.as_tensor(metric_ops.Ainv, dtype=dtype,
                                        device=device)
        self.cons = cons if cons is not None else TSRConstraintSet.build(())
        # A⁻¹ at the constraint points, on the device once
        # (solver.py:132-149)
        self.proj_ops = (ProjectionOps.build(spec, self.cons, self)
                         if self.cons.k_total else None)

        # active-block-first sphere order (orcdchomp_mod.cpp:2265-2299);
        # a floating base moves every sphere (orcdchomp_mod.cpp:2273)
        act = (np.ones(len(model.sphere_link), dtype=bool)
               if spec.floating_base else model.sphere_active_mask())
        order = np.concatenate([np.where(act)[0], np.where(~act)[0]])
        self._sphere_order = order
        n_act = int(act.sum())
        radii = model.sphere_radius[order]
        self.radii_act = torch.as_tensor(radii[:n_act], dtype=dtype,
                                         device=device)
        same = model.sphere_same_link()[order][:, order][:n_act, :]
        pi, pj, rsum = pair_table(same, radii[:n_act], radii)
        self.pairs = (torch.as_tensor(pi, device=device),
                      torch.as_tensor(pj, device=device),
                      torch.as_tensor(rsum, dtype=dtype, device=device))
        self.n_spheres_active = n_act
        # FK restricted to the active spheres, in active-first order
        self.fk = CompiledFK(model, dtype=dtype, device=device,
                             sphere_subset=order[:n_act])

    # -- metric ------------------------------------------------------------

    def apply_A_b(self, X):
        """A · X for X (B, m, n): a matmul, or the tridiagonal stencil
        under sep."""
        if self.metric_mode == "sep":
            return metric_mod.sep_apply_A(X, self.spec.dt)
        return torch.matmul(self.A, X)

    def solve_A_b(self, G):
        """A⁻¹ · G for G (B, m, n): a matmul, or two cumsums under sep."""
        if self.metric_mode == "sep":
            return metric_mod.sep_solve(G, self.spec.dt)
        return torch.matmul(self.Ainv, G)

    def apply_A(self, X):
        """A · X for one problem's X (m, n) (JAX solver.py:118): the
        operator of :meth:`apply_A_b`, which also broadcasts over a
        batch."""
        return self.apply_A_b(X)

    def solve_A(self, G):
        """A⁻¹ · G for one problem's G (m, n) (JAX solver.py:125)."""
        return self.solve_A_b(G)

    def _ainv_host(self, rows, cols):
        """Ainv[rows][:, cols] as float64 numpy (integer index arrays)."""
        if self.metric_mode == "sep":
            return metric_mod.sep_ainv_entries(rows[:, None], cols[None, :],
                                               self.spec.m, self.spec.dt)
        return self.metric_ops.Ainv[np.ix_(rows, cols)]

    def ainv_block(self, pts):
        """Ainv[pts, pts] (K, K) on the device in the engine's dtype, for
        the constraint-projection system (JAX solver.py:132-140)."""
        pts = np.asarray(pts, dtype=np.int64)
        return torch.as_tensor(self._ainv_host(pts, pts), dtype=self.dtype,
                               device=self.device)

    def ainv_cols(self, pts):
        """Ainv[:, pts] (m, K) on the device in the engine's dtype, for
        spreading constraint corrections (JAX solver.py:142-149)."""
        pts = np.asarray(pts, dtype=np.int64)
        return torch.as_tensor(
            self._ainv_host(np.arange(self.spec.m), pts), dtype=self.dtype,
            device=self.device)

    def build_affine(self, init0, final0, n):
        """(B, trC, Evels) of one problem's endpoint values
        (chomp.c:319-330, 348-386), float64 numpy; ``init0`` is None
        under start_tsr.  Closed forms under sep."""
        m, dt = self.spec.m, self.spec.dt
        if self.metric_mode == "sep":
            B, trC = metric_mod.sep_B_trC(m, dt, init0, final0, n)
            return B, trC, metric_mod.sep_Evels(m, dt, init0, final0, n)
        ops = self.metric_ops
        B, trC = metric_mod.build_B_trC(ops, init0, final0, n)
        Ev = metric_mod.build_Evels(ops, init0, final0, n)
        return B, trC, Ev

    def build_affine_batch(self, inits, finals, n):
        """Vectorised :meth:`build_affine` over (P, n) endpoints: the
        metric terms are linear in the endpoints
        (metric.affine_generators, or their closed form under sep).
        Under start_tsr the start point moves, so ``inits`` (which may be
        None) adds nothing.  Returns float64 numpy (B (P, m, n), trC (P,),
        Evels (P, m, n))."""
        m, dt = self.spec.m, self.spec.dt
        finals = np.asarray(finals, dtype=np.float64)
        P = finals.shape[0]
        if self.metric_mode == "sep":
            s = 1.0 / (dt * dt * (m + 1))
            binit, bfinal = np.zeros(m), np.zeros(m)
            binit[0] = bfinal[m - 1] = -s
            c_ii, c_if, c_ff = 0.5 * s, 0.0, 0.5 * s
        else:
            binit, bfinal, c_ii, c_if, c_ff = metric_mod.affine_generators(
                self.metric_ops)
        B = bfinal[None, :, None] * finals[:, None, :]
        trC = c_ff * np.sum(finals * finals, axis=1)
        Ev = np.zeros((P, m, n))
        Ev[:, m - 1] = 0.5 / dt * finals
        if not self.spec.start_tsr:
            inits = np.asarray(inits, dtype=np.float64)
            B = B + binit[None, :, None] * inits[:, None, :]
            trC = (trC + c_ii * np.sum(inits * inits, axis=1)
                   + c_if * np.sum(inits * finals, axis=1))
            Ev[:, 0] = -0.5 / dt * inits
        return B, trC, Ev

    # -- trajectory rows (JAX solver.py:213-223) ------------------------------

    def get_T_mov(self, traj):
        """The moving points (m, n) of a trajectory (n_points, n): rows
        from ``mov_lo`` (1, or 0 under start_tsr)."""
        return traj[..., self.mov_lo:self.mov_lo + self.spec.m, :]

    def set_T_mov(self, traj, T_mov):
        """A copy of ``traj`` with its moving points replaced by T_mov."""
        lo, hi = self.mov_lo, self.mov_lo + self.spec.m
        return torch.cat([traj[..., :lo, :], T_mov, traj[..., hi:, :]],
                         dim=-2)

    # -- joint limits --------------------------------------------------------

    def _limit_repair_batched(self, T, lo, hi):
        """Batched joint-limit repair (chomp.c:608-655): each problem
        repairs its own worst violation per round (first index on ties,
        as jnp.argmax); rounds continue while any problem still violates,
        up to 1000.

        A Python loop with one host sync per round (``pred.any()``), so
        every step pays at least one sync; the masked fixed-budget form
        that CUDA graphs need is later work.
        """
        B = T.shape[0]
        lo = lo[:, None, :]
        hi = hi[:, None, :]
        for _ in range(_MAX_LIMIT_FIXES):
            Gj = torch.where(T < lo, lo - T, 0.0) + \
                torch.where(T > hi, hi - T, 0.0)
            Gf = Gj.reshape(B, -1)
            amax = torch.argmax(torch.abs(Gf), dim=1, keepdim=True)  # (B, 1)
            gmax = torch.gather(Gf, 1, amax)[:, 0]
            pred = torch.abs(gmax) > 0.0
            if not bool(pred.any()):   # such a round would change nothing
                break
            GjA = self.solve_A_b(Gj)
            denom = torch.gather(GjA.reshape(B, -1), 1, amax)[:, 0]
            scale = 1.01 * gmax / torch.where(denom == 0.0, 1.0, denom)
            T_new = T + scale[:, None, None] * GjA
            T = torch.where(pred[:, None, None], T_new, T)
        return T

    # -- the extra-cost hook ------------------------------------------------

    def _extra(self, T_mov):
        """The hook's (cost (B,), grad (B, m, n)) over the batch, through
        ``torch.func.vmap`` (JAX: vmap of the per-problem step)."""
        try:
            return torch.func.vmap(self.extra_cost)(T_mov)
        except (RuntimeError, ValueError) as e:
            name = getattr(self.extra_cost, "__qualname__",
                           repr(self.extra_cost))
            raise type(e)(
                f"extra_cost hook {name} cannot run under torch.func.vmap "
                f"over the problem batch: {e}") from e

    # -- the step ------------------------------------------------------------

    def step_batched(self, probs, draw=None):
        """One CHOMP iteration over a (B,)-batched problem.  Returns
        (next_probs, costs (B, 3)) — [total, obstacle, smoothness], the
        obstacle cost measured on the incoming trajectory, smoothness on
        the updated one (chomp.c:475-491, 658-677).  ``draw`` is the HMC
        draw source: by default :class:`SeededDraw` for a batch with
        per-problem seeds, :attr:`draw` otherwise; a run passes its own."""
        spec = self.spec
        lo, hi = self.mov_lo, self.mov_lo + spec.m
        lam = probs.lambda_                                 # (B,)
        T_mov = probs.traj[:, lo:hi]                        # (B, m, n)

        AG, resample_iter, leap = (probs.AG, probs.resample_iter,
                                   probs.leapfrog_first)
        if spec.use_hmc:
            if draw is None:
                draw = self.draw if probs.hmc_seed is None else SEEDED_DRAW
            AG, resample_iter, leap = hmc_resample(probs, *draw(probs))

        # phase ranges mirror the reference's DEBUG_TIMING taxonomy
        # (chomp.h:95-100, orcdchomp_mod.cpp:2835-2847) and the JAX
        # step's scopes (solver.py:446-529); utils/profiling.py reads them
        with phase("callbacks"):
            c_obs, G, fk_out = cost_soa.total_cost_grad_batched(
                spec, self.fk, self.fields, self.pairs, self.radii_act,
                probs)
            if self.extra_cost is not None:
                # after the 1/m scaling (chomp.c:495-501)
                ce, Ge = self._extra(T_mov)
                c_obs, G = c_obs + ce, G + Ge
        with phase("smoothgrad"):
            G = G + self.apply_A_b(T_mov) + probs.B
            if spec.use_momentum:
                # leapfrog: a half step on first use (chomp.c:533-548)
                scale = torch.where(leap, 0.5, 1.0).to(lam.dtype) / lam
                AG = AG + scale[:, None, None] * self.solve_A_b(G)
                leap = torch.zeros_like(leap)
            else:
                AG = self.solve_A_b(G)
        if self.cons.k_total:
            with phase("constraint"):
                val, jac = eval_tsr_all_soa(spec, self.fk, probs, probs.traj,
                                            self.cons, fk_out)
                T_mov = T_mov + project_constraints(
                    spec, self.cons, self.proj_ops, lam, AG, T_mov, val, jac)
        T_mov = T_mov - AG / lam[:, None, None]
        with phase("limits"):
            T_mov = self._limit_repair_batched(T_mov, probs.jlimit_lower,
                                               probs.jlimit_upper)
        with phase("smoothcost"):
            # on the pre-renormalisation trajectory (chomp.c:660-677)
            c_smooth = self.smooth_cost(probs, T_mov)

        traj = torch.cat([probs.traj[:, :lo], T_mov, probs.traj[:, hi:]],
                         dim=1)
        if spec.floating_base:
            # per-iteration quaternion renormalisation of every point
            # (orcdchomp_mod.cpp:2805-2808, solver.py:537-540)
            traj = torch.cat([pose_normalize(traj[..., :7]), traj[..., 7:]],
                             dim=-1)
        new_probs = probs.replace(traj=traj, AG=AG,
                                  resample_iter=resample_iter,
                                  leapfrog_first=leap,
                                  iteration=probs.iteration + 1)
        costs = torch.stack([c_obs + c_smooth, c_obs, c_smooth], dim=-1)
        return new_probs, costs

    def iterate_batched(self, probs, n_iter: int, draw=None):
        """n_iter steps (``draw`` as in :meth:`step_batched`); returns
        (probs, costs (B, n_iter, 3))."""
        costs = []
        for _ in range(n_iter):
            probs, c = self.step_batched(probs, draw)
            costs.append(c)
        if not costs:
            B = probs.traj.shape[0]
            return probs, probs.traj.new_zeros((B, 0, 3))
        return probs, torch.stack(costs, dim=1)

    # -- per-problem entry points (JAX solver.py:244, 304, 578) --------------

    def step(self, prob, draw=None):
        """One iteration of one problem: :meth:`step_batched` at B = 1.
        Returns (next_prob, (total, obstacle, smoothness)), 0-d each."""
        probs, costs = self.step_batched(as_batch(prob), draw)
        return first(probs), tuple(costs[0])

    def iterate(self, prob, n_iter: int, draw=None):
        """n_iter iterations of one problem; returns (prob, costs
        (n_iter, 3))."""
        probs, costs = self.iterate_batched(as_batch(prob), n_iter, draw)
        return first(probs), costs[0]

    def costs_only(self, prob):
        """The cost report of one problem without an update:
        (total, obstacle, smoothness), 0-d each."""
        return tuple(c[0] for c in self.final_costs_batch(as_batch(prob)))

    # -- final costs ---------------------------------------------------------

    def smooth_cost(self, prob, T_mov):
        """tr(½TᵀAT + BᵀT) + trC (chomp.c:660-677, JAX solver.py:238) of
        one problem, T_mov (m, n), or per problem of a batch, (B, m, n)."""
        AT = self.apply_A_b(T_mov)
        return (0.5 * torch.sum(T_mov * AT, dim=(-2, -1))
                + torch.sum(prob.B * T_mov, dim=(-2, -1)) + prob.trC)

    def final_costs_batch(self, probs):
        """The cost report of the current trajectories without an update
        (cd_chomp_iterate with do_iteration=0, orcdchomp_mod.cpp:
        2830-2831; JAX ``vmap(costs_only)``): (total, obstacle,
        smoothness), each (B,).  Runs the SoA cost path, so K1 and K2
        launch once each; the extra-cost hook's cost is in the obstacle
        term, as in the step.  The step's phase ranges, ``callbacks``
        (without ``jtmap``) and ``smoothcost``."""
        T_mov = probs.traj[:, self.mov_lo:self.mov_lo + self.spec.m]
        with phase("callbacks"):
            c_obs, _, _ = cost_soa.total_cost_grad_batched(
                self.spec, self.fk, self.fields, self.pairs, self.radii_act,
                probs, want_grad=False)
            if self.extra_cost is not None:
                c_obs = c_obs + self._extra(T_mov)[0]
        with phase("smoothcost"):
            c_smooth = self.smooth_cost(probs, T_mov)
        return c_obs + c_smooth, c_obs, c_smooth

    def constraint_values(self, probs):
        """The enabled constraint rows' values (B, K) at the current
        trajectories, in ``cons.rows`` order: zero where a constraint
        holds.  Runs the FK, not the kernels."""
        fk_out = cost_soa.sphere_kinematics(self.spec, self.fk, probs)[0]
        val, _ = eval_tsr_all_soa(self.spec, self.fk, probs, probs.traj,
                                  self.cons, fk_out)
        flat = [c * 6 + d for c, d in self.cons.rows]
        return val.reshape(val.shape[0], -1)[:, flat]
