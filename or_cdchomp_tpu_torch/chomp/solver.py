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
on a card, ``iterate_batched`` replays the step as a CUDA graph (the
counterpart of JAX's ``jit`` of a ``lax.scan``; :class:`StepGraph`), on
the CPU it is a Python loop.  The HMC resample is split into a random
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

import collections
import copy
import dataclasses
import functools

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.chomp import metric as metric_mod
from or_cdchomp_tpu_torch.chomp.constraints import (
    ProjectionOps, TSRConstraintSet, eval_tsr_all_soa, project_constraints)
from or_cdchomp_tpu_torch.chomp.problem import ChompProblem, as_batch, first
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.ops import draw as draw_ops
from or_cdchomp_tpu_torch.ops import kernels, limits
from or_cdchomp_tpu_torch.ops.quat import pose_normalize
from or_cdchomp_tpu_torch.ops.selfcol import (PairLayout, pair_layout,
                                              pair_table)
from or_cdchomp_tpu_torch.utils import profiling
from or_cdchomp_tpu_torch.utils.profiling import phase, to_device

_HMC_U_MIN = 1e-12       # lower end of the uniform draw (solver.py:270)
# captured steps (StepGraph) an engine keeps, one per batch signature; the
# least recently used goes first
GRAPH_CACHE_MAX = 4


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


def _numpy_sum(x):
    """``np.sum(x, axis=-1)``'s value, summed in numpy's pairwise order
    (numpy's ``pairwise_sum``: blocks of at most 128 in eight running
    sums, shorter runs in turn), so that it rounds alike on any device;
    ``torch.sum`` orders its sums otherwise.  A sum of zeros may differ
    from numpy's in its sign."""
    n = x.shape[-1]
    if n > 128:
        half = n // 2 - (n // 2) % 8
        return _numpy_sum(x[..., :half]) + _numpy_sum(x[..., half:])
    if n < 8:
        s = x[..., 0]
        for i in range(1, n):
            s = s + x[..., i]
        return s
    r = [x[..., j] for j in range(8)]
    i = 8
    while i < n - n % 8:
        r = [r[j] + x[..., i + j] for j in range(8)]
        i += 8
    s = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        s = s + x[..., k]
    return s


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
    with ``torch.func.vmap``.

    The parameters are the JAX engine's, in its order, then the port's
    own: ``device`` and ``seed`` (of the batch drivers' HMC draws).  A
    given ``A`` and ``Ainv`` replace the dense metric's matrices (JAX
    solver.py:85-94); the semiseparable metric ignores them."""

    # steps a module run (api.CHOMPModule.iterate) takes between reads of
    # its costs to the host (solver.py:593)
    ITER_CHUNK = 16

    def __init__(self, spec, model, fields, A=None, Ainv=None, cons=None,
                 extra_cost=None, dtype=torch.float32, metric_ops=None,
                 metric_mode="auto", device="cuda", seed=0):
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
        self._seed = seed
        # the semiseparable metric holds no m×m tensor (A, Ainv None)
        self.metric_ops = self.A = self.Ainv = None
        if metric_mode == "dense":
            if metric_ops is None:
                metric_ops = metric_mod.build_metric(
                    spec.m, spec.dt, D=spec.D, has_init0=not spec.start_tsr)
            self.metric_ops = metric_ops
            # a given A and Ainv (both) replace the metric's, as in JAX
            # (solver.py:85-94); build_affine still reads metric_ops
            if A is None or Ainv is None:
                A, Ainv = metric_ops.A, metric_ops.Ainv
            self._ainv64 = (Ainv.detach().double().cpu().numpy()
                            if isinstance(Ainv, torch.Tensor)
                            else np.asarray(Ainv, dtype=np.float64))
            self.A = to_device(A, dtype=dtype, device=device)
            self.Ainv = to_device(Ainv, dtype=dtype, device=device)
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
        self.radii_act = to_device(radii[:n_act], dtype=dtype, device=device)
        same = model.sphere_same_link()[order][:, order][:n_act, :]
        pi, pj, rsum = pair_table(same, radii[:n_act], radii)
        pairs = (torch.as_tensor(pi), torch.as_tensor(pj),
                 torch.as_tensor(rsum, dtype=dtype))
        # K2's tiled path reads the table through its layout, built here
        # once (on the host, from the host table), as the Pallas kernel
        # compiles its pair matrices in
        layout = pair_layout(*pairs, n_act, len(radii))
        self.pairs = tuple(to_device(t, device=device) for t in pairs)
        self.pair_layout = PairLayout(*(to_device(t, device=device)
                                        for t in layout))
        self.n_spheres_active = n_act
        # FK restricted to the active spheres, in active-first order
        self.fk = CompiledFK(model, dtype=dtype, device=device,
                             sphere_subset=order[:n_act])

    # -- replicas on other devices -------------------------------------------

    def _replica(self, device, slot=0):
        """This engine on ``device``, for a BatchSolver that spreads a
        batch over several devices: a copy of its device state (the field
        stack, the FK, the pair table, the active radii, the dense
        metric's A and A⁻¹, the projection constants and an HmcDraw of
        the same seed) with the same spec, dtype, metric and extra_cost
        hook.  Its pair layout is built there (the layout kernel on a
        card).  ``slot`` tells replicas on one device apart, each with
        its own copies; the engine itself is slot 0 of its own device.
        Built once and cached on the engine by (device, slot)."""
        device = torch.device(device)
        if device == self.radii_act.device and slot == 0:
            return self
        cache = self.__dict__.setdefault("_replicas", {})
        if (device, slot) in cache:
            return cache[(device, slot)]

        def mv(t):
            return t.to(device, copy=True)

        rep = copy.copy(self)
        del rep.__dict__["_replicas"]
        rep.__dict__.pop("_graphs", None)     # a replica captures its own
        rep.__dict__.pop("_rows", None)       # and its own row constants
        rep.device = device
        rep.fields = type(self.fields)(**{
            f.name: mv(getattr(self.fields, f.name))
            for f in dataclasses.fields(self.fields)})
        if self.A is not None:
            rep.A, rep.Ainv = mv(self.A), mv(self.Ainv)
        rep.radii_act = mv(self.radii_act)
        rep.pairs = tuple(mv(t) for t in self.pairs)
        rep.pair_layout = pair_layout(*rep.pairs, self.n_spheres_active,
                                      len(self._sphere_order))
        if self.proj_ops is not None:
            rep.proj_ops = ProjectionOps.build(self.spec, self.cons, rep)
        rep.fk = self.fk._on(device)
        rep.draw = HmcDraw(self._seed, device)
        cache[(device, slot)] = rep
        return rep

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
        return self._ainv64[np.ix_(rows, cols)]

    def ainv_block(self, pts):
        """Ainv[pts, pts] (K, K) on the device in the engine's dtype, for
        the constraint-projection system (JAX solver.py:132-140)."""
        pts = np.asarray(pts, dtype=np.int64)
        return to_device(self._ainv_host(pts, pts), dtype=self.dtype,
                         device=self.device)

    def ainv_cols(self, pts):
        """Ainv[:, pts] (m, K) on the device in the engine's dtype, for
        spreading constraint corrections (JAX solver.py:142-149)."""
        pts = np.asarray(pts, dtype=np.int64)
        return to_device(
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

    def _affine_generators(self):
        """(binit (m,), bfinal (m,), c_ii, c_if, c_ff) of the metric's
        endpoint-affine terms, float64 numpy (metric.affine_generators,
        or their closed form under sep)."""
        if self.metric_mode == "sep":
            m, dt = self.spec.m, self.spec.dt
            s = 1.0 / (dt * dt * (m + 1))
            binit, bfinal = np.zeros(m), np.zeros(m)
            binit[0] = bfinal[m - 1] = -s
            return binit, bfinal, 0.5 * s, 0.0, 0.5 * s
        return metric_mod.affine_generators(self.metric_ops)

    def build_affine_batch(self, inits, finals, n):
        """Vectorised :meth:`build_affine` over (P, n) endpoints: the
        metric terms are linear in the endpoints
        (metric.affine_generators, or their closed form under sep).
        Under start_tsr the start point moves, so ``inits`` (which may be
        None) adds nothing.  Returns float64 numpy (B (P, m, n), trC (P,),
        Evels (P, m, n)).  :meth:`build_affine_rows` is its counterpart on
        the engine's device."""
        m, dt = self.spec.m, self.spec.dt
        finals = np.asarray(finals, dtype=np.float64)
        P = finals.shape[0]
        binit, bfinal, c_ii, c_if, c_ff = self._affine_generators()
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

    def _row_consts(self):
        """The constants of a batch's rows, float64 on the engine's
        device, made at its first batch and kept: the straight line's
        weights ``1 - a`` and ``a`` (1, n_points, 1), ``a`` being
        ``np.linspace(0, 1, n_points)`` (``torch.linspace`` differs from
        it in the last bit), and :meth:`_affine_generators` with binit
        and bfinal shaped (1, m, 1)."""
        consts = self.__dict__.get("_rows")
        if consts is None:
            a = np.linspace(0.0, 1.0, self.spec.n_points)[None, :, None]
            binit, bfinal, *cs = self._affine_generators()
            consts = self._rows = tuple(
                to_device(x, dtype=torch.float64, device=self.device)
                for x in (1 - a, a, binit[None, :, None],
                          bfinal[None, :, None])) + tuple(cs)
        return consts

    def straight_lines(self, starts, goals):
        """The straight lines ``(1 - a)·starts + a·goals`` (P, n_points, n)
        of float64 (P, n) endpoint tensors on the engine's device, as the
        numpy expression rounds them."""
        oma, a = self._row_consts()[:2]
        return oma * starts[:, None, :] + a * goals[:, None, :]

    def build_affine_rows(self, inits, finals):
        """:meth:`build_affine_batch` of float64 (P, n) endpoint tensors on
        the engine's device, there and in float64: (B (P, m, n), trC (P,),
        Evels (P, m, n)), bit-equal to it (each operation in its order,
        the sums over n in numpy's pairwise order).  ``inits`` adds
        nothing under start_tsr."""
        m, dt = self.spec.m, self.spec.dt
        _, _, binit, bfinal, c_ii, c_if, c_ff = self._row_consts()
        B = bfinal * finals[:, None, :]
        Ev = finals.new_zeros((finals.shape[0], m, finals.shape[1]))
        Ev[:, m - 1] = 0.5 / dt * finals
        if self.spec.start_tsr:
            return B, c_ff * _numpy_sum(finals * finals), Ev
        B = B + binit * inits[:, None, :]
        ff, ii, if_ = _numpy_sum(torch.stack(
            (finals * finals, inits * inits, inits * finals)))
        Ev[:, 0] = -0.5 / dt * inits
        return B, c_ff * ff + c_ii * ii + c_if * if_, Ev

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
        """Batched joint-limit repair (chomp.c:608-655, ops/limits.py):
        each problem repairs its own worst violation per round (first index
        on ties, as jnp.argmax), up to 1000 rounds.  A CPU batch runs the
        plain version, a CUDA one the kernel (each problem's block loops on
        the card until its row is clean: no host sync), any other device
        raises."""
        metric = self.Ainv if self.metric_mode == "dense" else self.spec.dt
        return limits.limit_repair(T, lo, hi, metric)

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
        return self._step(probs, self._draws(probs, draw))

    def _draws(self, probs, draw):
        """The step's HMC draws ``(z, u)`` from ``draw`` (or the default
        source, as :meth:`step_batched` says), None without HMC."""
        if not self.spec.use_hmc:
            return None
        if draw is None:
            draw = self.draw if probs.hmc_seed is None else SEEDED_DRAW
        return draw(probs)

    def _step(self, probs, zu):
        """:meth:`step_batched` on given draws ``zu`` (None without HMC):
        the part of the step that a CUDA graph captures."""
        spec = self.spec
        lo, hi = self.mov_lo, self.mov_lo + spec.m
        lam = probs.lambda_                                 # (B,)
        T_mov = probs.traj[:, lo:hi]                        # (B, m, n)

        AG, resample_iter, leap = (probs.AG, probs.resample_iter,
                                   probs.leapfrog_first)
        if zu is not None:
            AG, resample_iter, leap = hmc_resample(probs, *zu)

        # phase ranges mirror the reference's DEBUG_TIMING taxonomy
        # (chomp.h:95-100, orcdchomp_mod.cpp:2835-2847) and the JAX
        # step's scopes (solver.py:446-529); utils/profiling.py reads them
        with phase("callbacks"):
            c_obs, G, fk_out = cost_soa.total_cost_grad_batched(
                spec, self.fk, self.fields, (*self.pairs, self.pair_layout),
                self.radii_act, probs)
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
        (probs, costs (B, n_iter, 3)).

        On a card each step is a replay of one CUDA graph of the step
        (:meth:`stepper`, :class:`StepGraph`), the counterpart of JAX's
        ``jit`` of a ``lax.scan``: no host sync and a few launches a step.
        The draw source runs eagerly before each replay.  The first call
        for a batch of this shape runs its first step eagerly, then
        captures the step that the later ones replay; a step that cannot
        be captured (a host sync or a host→device copy, in an
        ``extra_cost`` hook too) raises, naming the cause, and nothing runs
        eagerly in its place.  The replays keep the float32 matmul
        precision in force at the capture (PyTorch's TF32 setting), as
        the eager step uses the one in force at each call.  On the CPU the
        steps are :meth:`step_batched` calls."""
        B = probs.traj.shape[0]
        costs = probs.traj.new_empty((B, n_iter, 3))
        if n_iter == 0:
            return probs, costs
        run = self.stepper(probs)
        for i in range(n_iter):
            run.step(self, draw, costs[:, i])
        return run.result(probs), costs

    def stepper(self, probs):
        """Steps of the batch ``probs``: an object whose ``step(engine,
        draw, costs)`` takes one step of this engine (writing its (B, 3)
        costs into ``costs``) and whose ``result(probs)`` is the batch
        after them.  On a card it is this engine's :class:`StepGraph` for
        the batch's leaf shapes, captured at its first step and kept (at most
        ``GRAPH_CACHE_MAX`` per engine, the least recently used dropped;
        they go with the engine, which holds no reference cycle, so an
        engine the module's cache evicts and no run holds frees its graphs'
        memory pools at once).  One engine runs one batch of a shape at a
        time.  Elsewhere it calls :meth:`step_batched`."""
        if probs.traj.device.type != "cuda":
            return _EagerSteps(probs)
        key = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in probs.leaves().items())
        graphs = self.__dict__.setdefault("_graphs",
                                          collections.OrderedDict())
        graph = graphs.pop(key, None)
        if graph is None:
            graph = StepGraph(self, probs)
        else:
            graph.load(probs)
        graphs[key] = graph
        while len(graphs) > GRAPH_CACHE_MAX:
            graphs.popitem(last=False)
            profiling.count("graph.evict")
        return graph

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
                self.spec, self.fk, self.fields,
                (*self.pairs, self.pair_layout), self.radii_act, probs,
                want_grad=False)
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


# -- iterations as replays of a captured step --------------------------------

class _EagerSteps:
    """:meth:`ChompEngine.stepper` off the card: step_batched calls."""

    def __init__(self, probs):
        self.probs = probs

    def step(self, engine, draw, costs):
        zu = None
        if engine.spec.use_hmc:
            with phase("step.draw"):
                zu = engine._draws(self.probs, draw)
        self.probs, c = engine._step(self.probs, zu)
        with phase("step.costs"):
            costs.copy_(c)

    def result(self, probs):
        """The batch after the steps (``probs``, the batch they started
        from, is not needed here)."""
        return self.probs


class StepGraph:
    """One engine's step captured in a CUDA graph on static buffers (the
    counterpart of JAX's ``jit`` of the scan body): the batch's leaves
    (``leaves``) and, with HMC, the draws ``z`` and ``u`` (``zu``).  A
    replay reads them, writes the next state back into them and its
    (B, 3) costs into ``costs``, in one launch from the host.

    The draw source stays outside the graph: it keeps host state (a
    recording, a replay counter, a generator's offset) that a replay would
    not advance, so each step calls it eagerly and copies its ``z`` and
    ``u`` into ``zu``.  The first :meth:`step` runs that step eagerly on
    a side stream (a hook may make its constants there), and then
    captures the step in torch.cuda's sync debug mode "error" (a host
    sync raises at its own line); every later one replays.  The capture
    keeps the float32 matmul precision in force when it ran (TF32 or
    not), whatever the setting at a replay.  The launches counted while
    capturing (``records``) are counted again at each replay
    (ops/kernels.py).  Replays need the engine's card current;
    :meth:`step` makes it so.  ``node_map`` (utils/profiling.py NodeMap)
    charges each node of the graph a profiler reports to the step's
    innermost phase open when it was captured (None where the capture's
    nodes could not be read); a recorded replay hands it to the
    recording.  Spans: ``step.draw`` (with HMC), ``step.replay`` (the
    host's ``graph.replay()`` call) and ``step.costs``."""

    def __init__(self, engine, probs):
        self.device = probs.traj.device
        self.leaves = {k: v.clone(memory_format=torch.contiguous_format)
                       for k, v in probs.leaves().items()}
        self.probs = ChompProblem(**self.leaves)
        self.zu = None
        if engine.spec.use_hmc:
            self.zu = (torch.empty_like(self.probs.AG),
                       self.probs.AG.new_empty(self.probs.AG.shape[:1]))
        self.graph = self.records = self.costs = self.node_map = None
        self.changed = ()

    def load(self, probs):
        """Copy the batch ``probs`` (same leaf shapes) into the buffers."""
        for k, v in probs.leaves().items():
            self.leaves[k].copy_(v)

    def _store(self, new):
        """Copy the leaves of ``new`` that the step replaced into the
        buffers; returns their names."""
        changed = []
        for k, v in new.leaves().items():
            if v is not self.leaves[k]:
                self.leaves[k].copy_(v)
                changed.append(k)
        return tuple(changed)

    def step(self, engine, draw, costs):
        """One step of ``engine`` (the one this graph was made for): the
        draw, then a replay (or, the first time, the step run eagerly and
        then captured); its costs into ``costs``."""
        with torch.cuda.device(self.device):
            zu = None
            if engine.spec.use_hmc:
                with phase("step.draw"):
                    zu = engine._draws(self.probs, draw)
                    if self.graph is not None:
                        self.zu[0].copy_(zu[0])
                        self.zu[1].copy_(zu[1])
            if self.graph is None:
                self._capture(engine, zu, costs)
                return
            with phase("step.replay", None, self.node_map):
                self.graph.replay()
            with phase("step.costs"):
                costs.copy_(self.costs)
        kernels.replay_counts(self.records)

    def _capture(self, engine, zu, costs):
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        what = "running the step eagerly before its capture"
        try:
            with torch.cuda.stream(side):
                new, c = engine._step(self.probs, zu)
                self.changed = self._store(new)
                costs.copy_(c)
                del new, c
            cur.wait_stream(side)
            what = "capturing the step"
            with kernels.recording() as records, \
                    torch.cuda.graph(graph, stream=side), \
                    profiling.node_map(
                        functools.partial(kernels.capture_nodes, side),
                        self.device.index) as nodes:
                # a host sync raises here, at its own line, before it
                # reaches the capture
                mode = torch.cuda.get_sync_debug_mode()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    new, c = engine._step(self.probs, self.zu)
                    self._store(new)
                finally:
                    torch.cuda.set_sync_debug_mode(mode)
                node_map = nodes.finish()
        except RuntimeError as e:
            raise RuntimeError(
                f"iterate_batched: the step on {self.device} cannot run as a "
                f"CUDA graph ({what} failed): {e}.  A step must make no host "
                f"sync and copy nothing from the host (an extra_cost hook "
                f"included); there is no eager fallback on the card") from e
        self.graph, self.records, self.costs = graph, records, c
        self.node_map = node_map
        profiling.count("graph.capture")

    def result(self, probs):
        """The batch after the steps: copies of the leaves the step
        replaces, ``probs``' own tensors for the others."""
        return ChompProblem(**{
            k: self.leaves[k].clone() if k in self.changed else v
            for k, v in probs.leaves().items()})
