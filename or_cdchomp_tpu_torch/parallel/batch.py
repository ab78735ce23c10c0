"""Batched CHOMP solves, on one or several devices or split across ranks
(counterpart of or_cdchomp_tpu/parallel/batch.py).

``problem_batch_from_grid`` broadcasts a template problem to a (P,)
batch with per-problem straight-line trajectories and metric affine
terms (``stack_problems`` stacks given problems, ``pad_problems`` pads a
batch to a multiple); ``BatchSolver`` runs the batch-native step on it:
a fixed number of steps (``iterate``, ``iterate_masked``), a
convergence-checked chunk (``iterate_until``) or a chunked solve
(``solve``).  In one process it spreads the batch over every card of
the host (or the devices it is given), each step a replayed CUDA graph
per card; with a ``DeviceMesh`` it
holds one rank's rows of a global batch (parallel/multihost.py).
``best_of_batch`` picks the lowest-cost problem of a batch.
"""

from __future__ import annotations

import contextlib
import math
import types
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem
from or_cdchomp_tpu_torch.parallel import multihost
from or_cdchomp_tpu_torch.utils import profiling
from or_cdchomp_tpu_torch.utils.profiling import command, phase, to_device


def stack_problems(problems) -> ChompProblem:
    """Stack a list of problems (equal leaf sets and shapes) into one
    batch along a new leading axis."""
    leaves = [p.leaves() for p in problems]
    return ChompProblem(**{k: torch.stack([d[k] for d in leaves])
                           for k in leaves[0]})


def pad_problems(probs: ChompProblem, multiple: int):
    """Pad the problem axis to a multiple (repeating the last row) so a
    ragged batch splits evenly; returns (padded, original P).  Slice
    results back with ``v[:P]`` on each leaf."""
    P_ = int(probs.traj.shape[0])
    pad = (-P_) % multiple
    if pad == 0:
        return probs, P_
    return ChompProblem(**{
        k: torch.cat([v, v[-1:].expand((pad,) + tuple(v.shape[1:]))])
        for k, v in probs.leaves().items()}), P_


# a batch's own leaves, made for each row; the template's are not kept
# (nor its own hmc_seed)
_ROW_LEAVES = frozenset(("traj", "B", "trC", "Evels", "AG", "resample_iter",
                         "leapfrog_first", "iteration", "hmc_seed"))


def _endpoints(x, device):
    """(P, n) endpoints (an array, a list or a tensor) as float64 on
    ``device``: one copy where they are on the host (an array is copied
    first, so a read-only one is never shared with a tensor)."""
    if not isinstance(x, torch.Tensor):
        x = np.array(x, dtype=np.float64)
    return to_device(x, dtype=torch.float64, device=device)


@command("batch.build")
def problem_batch_from_grid(problem: ChompProblem, starts, goals, engine,
                            metric_ops=None, seeds=None):
    """(P,)-batched problem on the engine's device and dtype: the
    template supplies fields, limits and weights; each row gets the
    straight line from starts[p] to goals[p] ((P, n) arrays), its own
    metric affine terms and a fresh HMC state (resample at iteration 0,
    leapfrog half step first).  Every leaf is a contiguous tensor.  Under
    start_tsr the start is a moving point: it seeds the line and adds no
    affine term.

    The JAX package's signature: ``metric_ops`` is accepted and unused
    there too (the engine's metric builds the affine terms).  ``seeds``
    ((P,) integers) gives each problem its own HMC stream: they are kept
    as the int64 leaf ``hmc_seed``, and the step then draws with
    ``SeededDraw``, so a problem's draws do not depend on its batch.
    With ``seeds=None`` (the JAX package then keys problem p with p,
    ``arange(P)``) the leaf stays None and the batch draws from the
    engine's draw source as one, as before; the JAX keys' numbers are
    not reproduced either way.

    Only the endpoints cross from the host: the rows (the lines, the
    affine terms) are built in float64 on the engine's device
    (:meth:`ChompEngine.straight_lines`, :meth:`ChompEngine.
    build_affine_rows`), bit-equal to the numpy expressions
    (:meth:`ChompEngine.build_affine_batch`), then cast to its dtype.

    Spans (utils/profiling.py): ``batch.build``, whose id the batch's
    ``batch.solve`` shares, and inside it ``build.rows`` (the endpoints'
    copies, the lines and affine terms in float64 on the device),
    ``build.expand`` (the template's leaves that stay, broadcast on the
    device) and ``build.copy`` (the rows cast into the batch's leaves,
    the seeds' copy).
    """
    dev, dtype = engine.device, engine.dtype
    with phase("build.rows"):
        starts, goals = (_endpoints(x, dev) for x in (starts, goals))
        P_, n = starts.shape
        trajs = engine.straight_lines(starts, goals)
        B, trC, Ev = engine.build_affine_rows(trajs[:, 0], trajs[:, -1])

    with phase("build.expand"):
        tmpl = problem.to(dev, dtype)
        batched = {k: v.expand((P_,) + tuple(v.shape)).contiguous()
                   for k, v in tmpl.leaves().items() if k not in _ROW_LEAVES}

    with phase("build.copy"):
        batched.update(traj=trajs.to(dtype), B=B.to(dtype),
                       trC=trC.to(dtype), Evels=Ev.to(dtype))
    batched.update(
        AG=torch.zeros((P_, engine.spec.m, n), dtype=dtype, device=dev),
        resample_iter=torch.zeros(P_, dtype=torch.int32, device=dev),
        leapfrog_first=torch.ones(P_, dtype=torch.bool, device=dev),
        iteration=torch.zeros(P_, dtype=torch.int32, device=dev))
    if seeds is not None:
        seeds = np.asarray(seeds, dtype=np.int64).reshape(-1)
        if seeds.shape != (P_,):
            raise ValueError(f"seeds must have one entry per problem "
                             f"({P_}), not {seeds.shape[0]}")
        with phase("build.copy"):
            batched["hmc_seed"] = to_device(seeds, device=dev)
    out = ChompProblem(**batched)
    profiling.bind(out.traj, profiling.current_request())
    return out


class BatchSolver:
    """Runs batched solves for one ChompEngine, as one SoA step per
    device: the TPU build's problem-axis chunking (sized for its 128-lane
    vector tiles) has no counterpart here.

    **One process, several devices** (``mesh=None``).  ``devices`` (the
    port's own parameter) lists the devices the batch spreads over; by
    default, as JAX's mesh over every chip of ``jax.devices()`` (JAX
    batch.py:116-147), every visible card of a CUDA engine, its own
    first, and a CPU engine's device alone.  Each part's step on a card
    is one CUDA graph replay (``ChompEngine.stepper``) with no host sync,
    so the cards' steps, issued in turn from one thread, run side by
    side.  A list may repeat a device: each entry is a replica of its own
    (``ChompEngine._replica``, built here once per engine and device entry
    and cached on the engine).  Each call places the rows by JAX's
    ``shard`` rule: split evenly when the batch size B divides by the
    device count k, over the first gcd(B, k) devices when it does not, on
    the first device alone when the gcd is 1 (where JAX replicates the
    batch).  Each step then runs on every device in turn, on its rows and
    replica with its card current.  Results come back on the engine's
    device in the batch's order.  Every row steps on its own, so the result
    is the one-device result: bit-equal where each operation's rounding
    does not depend on the batch width.  An ``extra_cost`` hook runs on
    each device's rows: it must not capture tensors on a fixed card.

    HMC over several devices: a batch with per-problem seeds draws on each
    device's own rows (``SeededDraw``).  An unseeded batch draws the whole
    batch's ``z``, ``u`` once per step from the engine's draw source, as
    one device would, and each device takes its rows; the draw source sees
    a stand-in batch whose only leaf is ``AG`` (the package's sources read
    no other).

    **Several processes** (``mesh``, a ``torch.distributed.device_mesh.
    DeviceMesh``; ``devices`` must then be None): the mesh splits a global
    batch across ranks along ``axis`` (a name, or a tuple of every name of
    the mesh), and this solver holds this rank's rows on the engine's
    device (:meth:`shard`, or ``multihost.make_global_problems``) and
    steps them exchanging nothing, since each problem's step, its
    joint-limit repair included, depends on its own row alone.  The only
    collective is ``iterate_until``'s: one 4-byte all-reduce (MIN) of the
    converged flag per chunk, so every rank stops at the same chunk.

    ``chunk`` and ``min_chunks`` are the JAX signature's: there they cut
    a large batch into an XLA ``lax.map`` over chunks of problems, a
    scheduling knob of its compiled scan (JAX batch.py:96-113), and since
    every row steps on its own, the results are the same either way.
    Here nothing reads them: the attributes are read-only mirrors of
    JAX's, for code that inspects a solver."""

    chunk = property(lambda self: self._jax_knobs[0])
    min_chunks = property(lambda self: self._jax_knobs[1])

    def __init__(self, engine, mesh=None, axis="dp", chunk=128,
                 min_chunks=3, devices=None):
        if mesh is not None and devices is not None:
            raise ValueError("BatchSolver: give devices or a mesh, not "
                             "both (a rank steps its rows on the engine's "
                             "device)")
        self.engine = engine
        self._jax_knobs = (chunk, min_chunks)
        self.mesh = mesh
        self.group = None if mesh is None else _mesh_group(mesh, axis)
        self._home = home = engine.radii_act.device   # with its index
        if devices is None:
            devices = [home] if mesh is not None else _every_card(home)
        self.devices = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("BatchSolver: devices is empty")
        slots = {}
        self.replicas = []
        for d in self.devices:
            slots[d] = slots.get(d, -1) + 1
            self.replicas.append(engine._replica(d, slots[d]))

    def _placement(self, P):
        """JAX's ``shard`` rule for P rows over the devices: [(device
        index, first row, end row)] for the first gcd(P, k) of the k
        devices, P / gcd rows each; [(0, 0, P)] where the gcd is 1."""
        d = math.gcd(P, len(self.devices))
        if d <= 1:
            return [(0, 0, P)]
        size = P // d
        return [(i, i * size, (i + 1) * size) for i in range(d)]

    def shard(self, probs: ChompProblem) -> ChompProblem:
        """The batch on the engine's device, in its order; with a mesh,
        this rank's ``host_local_batch`` rows of the global batch
        ``probs``.  Over several devices, each call places the rows
        (:meth:`_placement`); ``solve`` takes the rows it is given and
        does not call this."""
        if self.mesh is not None:
            start, size = multihost.host_local_batch(
                int(probs.traj.shape[0]), self.group)
            probs = ChompProblem(**{k: v[start:start + size]
                                    for k, v in probs.leaves().items()})
        return probs.to(self._home)

    def _scatter(self, probs):
        """[(replica, its rows on its device, first row, end row)]."""
        P = int(probs.traj.shape[0])
        parts = []
        for i, lo, hi in self._placement(P):
            rows = probs if (lo, hi) == (0, P) else ChompProblem(
                **{k: v[lo:hi] for k, v in probs.leaves().items()})
            parts.append((self.replicas[i], rows.to(self.devices[i]), lo, hi))
        return parts

    def _gather(self, tensors):
        """The parts' tensors joined along axis 0 on the engine's
        device."""
        if len(tensors) == 1:
            return tensors[0].to(self._home)
        return torch.cat([t.to(self._home) for t in tensors])

    def _gather_problems(self, parts):
        return ChompProblem(**{
            k: self._gather([rows.leaves()[k] for _, rows, _, _ in parts])
            for k in parts[0][1].leaves()})

    def _whole_draw(self, parts):
        """For an unseeded HMC batch split over several parts, or on a
        replica: a function that draws the whole batch's ``z``, ``u`` once
        from the engine's draw source and returns each part's step draw
        source, a view of its rows on its device.  None otherwise (each
        step then chooses its own)."""
        eng, rows0 = self.engine, parts[0][1]
        if not (eng.spec.use_hmc and rows0.hmc_seed is None
                and (len(parts) > 1 or parts[0][0] is not eng)):
            return None
        _, m, n = rows0.AG.shape
        stand_in = types.SimpleNamespace(AG=torch.empty(
            (), dtype=rows0.AG.dtype, device=self._home).expand(
                parts[-1][3], m, n))

        def draw():
            z, u = eng.draw(stand_in)
            return [lambda probs, lo=lo, hi=hi: (
                z[lo:hi].to(probs.AG.device), u[lo:hi].to(probs.AG.device))
                for _, _, lo, hi in parts]
        return draw

    def _iterate_parts(self, parts, n_iter):
        """n_iter steps of every part: (parts, costs (rows, n_iter, 3) per
        part).  Each part steps through its replica's
        :meth:`ChompEngine.stepper` (on a card, one CUDA graph replay a
        step); several parts step in turn, one step each per round, from
        this thread.  A replay is one asynchronous launch, so the cards run
        side by side."""
        costs = [rows.traj.new_empty((hi - lo, n_iter, 3))
                 for _, rows, lo, hi in parts]
        if n_iter == 0:
            return parts, costs
        whole = self._whole_draw(parts)
        runs = [rep.stepper(rows) for rep, rows, _, _ in parts]
        for i in range(n_iter):
            draws = [None] * len(parts) if whole is None else whole()
            for run, (rep, *_), draw, c in zip(runs, parts, draws, costs):
                run.step(rep, draw, c[:, i])
        return [(rep, run.result(rows), lo, hi)
                for run, (rep, rows, lo, hi) in zip(runs, parts)], costs

    def iterate(self, probs: ChompProblem, n_iter: int):
        """n_iter batched steps.  Returns (problems, costs (n_iter, P, 3))."""
        parts, costs = self._iterate_parts(self._scatter(probs), n_iter)
        return (self._gather_problems(parts),
                self._gather(costs).transpose(0, 1))

    def iterate_masked(self, probs: ChompProblem, valid, chunk_size: int):
        """``chunk_size`` batched steps with the first ``valid`` applied.
        Returns (problems, costs (chunk_size, P, 3)); rows ≥ valid are
        unspecified.  Eager PyTorch needs no fixed-length executable, so
        only the ``valid`` steps run (rows ≥ valid are zeros)."""
        valid = min(max(int(valid), 0), chunk_size)
        probs, costs = self.iterate(probs, valid)
        if valid < chunk_size:
            pad = costs.new_zeros((chunk_size - valid,) + costs.shape[1:])
            costs = torch.cat([costs, pad])
        return probs, costs

    def _until(self, parts, valid, chunk_size, tol):
        """``iterate_until`` on placed parts: (parts, last costs per part,
        the converged flag of every row of every part and rank)."""
        if int(valid) < 1:
            raise ValueError("iterate_until needs valid >= 1")
        parts, costs = self._iterate_parts(parts,
                                           min(int(valid), chunk_size))
        lasts = [c[:, -1] for c in costs]
        flags = [torch.all(c[:, 0, 0] - c[:, -1, 0] < tol) for c in costs]
        converged = self._gather([f[None] for f in flags]).all()
        if self.mesh is not None:
            flag = multihost.comm_tensor(converged.to(torch.int32),
                                         self.group)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=self.group)
            converged = flag.to(converged.device) > 0
        return parts, lasts, converged

    def iterate_until(self, probs: ChompProblem, valid, chunk_size: int,
                      tol=0.0):
        """One convergence-checked chunk: ``valid`` (≥ 1) of
        ``chunk_size`` steps.  Returns (problems, last costs (P, 3),
        converged) where converged, a 0-d bool tensor, says every problem's
        total cost fell by less than ``tol`` from the chunk's first step
        to its last: the AND of every device's rows, on the engine's
        device; with a mesh, all-reduced over the mesh's ranks."""
        parts, lasts, converged = self._until(self._scatter(probs), valid,
                                              chunk_size, tol)
        return self._gather_problems(parts), self._gather(lasts), converged

    @command("batch.solve",
             lambda self, probs, *_, **__: profiling.request_of(probs.traj))
    def solve(self, probs: ChompProblem, n_iter: int, chunk: int = 10,
              tol: Optional[float] = None):
        """Up to n_iter steps in chunks of ``chunk``; with ``tol``, stops
        after the first chunk in which every problem converged (one host
        sync per chunk for that test, none without ``tol``; over several
        devices or ranks, every problem of every one).  The rows stay on
        their devices from the first chunk to the final costs, each
        device's from its replica's :meth:`ChompEngine.final_costs_batch`.
        Returns (problems, final costs (P, 3), steps done).

        Spans (utils/profiling.py): ``batch.solve``, in the request of
        the batch ``problem_batch_from_grid`` built, and inside it
        ``solve.scatter``, ``solve.final_costs`` and ``solve.gather``."""
        with phase("solve.scatter"):
            parts = self._scatter(probs)
        done = 0
        while done < n_iter:
            todo = min(chunk, n_iter - done)
            done += todo
            if tol is None:
                parts, _ = self._iterate_parts(parts, todo)
                continue
            parts, _, conv = self._until(parts, todo, chunk, tol)
            profiling.host_sync()
            if bool(conv):
                break
        finals = []
        with phase("solve.final_costs"):
            for rep, rows, _, _ in parts:
                with _current(rep.device):
                    finals.append(torch.stack(rep.final_costs_batch(rows), -1))
        with phase("solve.gather"):
            return self._gather_problems(parts), self._gather(finals), done


def _current(device):
    """A context with ``device`` current where it is a card."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _every_card(home):
    """JAX's default device list: every visible card, ``home`` first, for
    an engine on a card; ``home`` alone elsewhere."""
    if home.type != "cuda":
        return [home]
    return [home] + [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())
                     if i != home.index]


def _device(d):
    """``d`` as a torch.device, a CUDA one with its index."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _mesh_group(mesh, axis):
    """The process group of ``mesh`` along ``axis``: one dimension's, or
    for a tuple of every dimension's name a group of all its ranks."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    if names != tuple(mesh.mesh_dim_names):
        raise ValueError(f"axis {axis} must be one dimension of the mesh "
                         f"or all of {mesh.mesh_dim_names} in order")
    return dist.new_group(ranks=mesh.mesh.flatten().tolist())


def best_of_batch(probs: ChompProblem, final_costs):
    """The lowest-total-cost problem of the batch — the best-of-HMC-
    restarts reduction (BASELINE config 3).  Returns (problem, index):
    the first index on ties, and the first NaN row if any total is NaN
    (as ``jnp.argmin``)."""
    idx = torch.argmin(final_costs[..., 0])
    best = ChompProblem(**{k: v[idx] for k, v in probs.leaves().items()})
    return best, idx
