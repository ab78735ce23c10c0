"""The traffic of a cell: one general generator per driver kind, read
from a mix file (mixes/<name>.json).

Every unit's inputs come from the seed and the unit's index alone
(``endpoints``), so a run's inputs do not depend on how many units the
window holds, and the same seed gives the same inputs.  Two drivers:

- ``batch``: a closed loop of one caller.  Unit i is ``batch`` problems
  built by ``problem_batch_from_grid`` from seeded starts and goals,
  solved by ``BatchSolver.solve`` for the configuration's iterations
  with no early stop, and copied to the host (trajectories and final
  costs).  Spans: ``build``, ``solve``, ``fetch``.
- ``plan``: a closed loop of one caller (a fixed base).  Unit i moves
  the robot to a seeded start and runs the reference's runchomp as its
  four module commands, create (with a seeded goal), iterate, gettraj
  (with its collision check, reporting rather than raising) and
  destroy, each a span.
"""

from __future__ import annotations

import time

import numpy as np

WARM = -1          # the index of the set-up's unit (its own stream)


def endpoints(seed, i, start, goal, sigma, count, keep=None):
    """(starts, goals) (count, n) float64 of unit ``i``: ``start`` and
    ``goal`` (n,) plus sigma-scaled normal draws from the seed and the
    unit's index; the columns ``keep`` (a floating base's quaternion)
    are not moved."""
    rng = np.random.default_rng([seed % 2 ** 64, (i + 1) % 2 ** 32])
    n = len(start)
    s = np.tile(start, (count, 1)) + sigma * rng.normal(size=(count, n))
    g = np.tile(goal, (count, 1)) + sigma * rng.normal(size=(count, n))
    if keep is not None:
        s[:, keep] = start[keep]
        g[:, keep] = goal[keep]
    return s, g


def make(world, mix, seed, spans, devices):
    """The driver of the mix's kind."""
    kinds = {"batch": BatchTraffic, "plan": PlanTraffic}
    return kinds[mix["driver"]](world, mix, seed, spans, devices)


def _sync(devices):
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class BatchTraffic:
    """Closed-loop batches through ``BatchSolver``."""

    def __init__(self, world, mix, seed, spans, devices):
        from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

        self.world, self.seed, self.spans = world, seed, spans
        self.B = int(mix["batch"])
        self.check_rows = int(mix["check_rows"])
        self.n_iter = int(world.cfg["n_iter"])
        self.sigma = float(world.cfg["sigma"])
        traj = world.run.problem.traj.double().cpu().numpy()
        self.start, self.goal = traj[0], traj[-1]
        self.keep = (slice(3, 7) if world.run.spec.floating_base else None)
        self.devices = devices
        self.solver = BatchSolver(world.run.engine, devices=devices)
        self.parts = [(lo, hi) for _, lo, hi in
                      self.solver._placement(self.B)]
        self.records = []        # per unit: starts, goals, traj, finals
        self.times = []          # per unit: seconds, build to host

    @property
    def problems(self):
        return self.B * len(self.times)

    def inputs(self, i):
        return endpoints(self.seed, i, self.start, self.goal, self.sigma,
                         self.B, self.keep)

    def _solve(self, i):
        from or_cdchomp_tpu_torch.parallel.batch import \
            problem_batch_from_grid

        starts, goals = self.inputs(i)
        eng = self.world.run.engine
        with self.spans("build"):
            probs = problem_batch_from_grid(self.world.run.problem, starts,
                                            goals, eng)
        with self.spans("solve"):
            out, finals, done = self.solver.solve(probs, self.n_iter,
                                                  tol=None)
        with self.spans("fetch"):
            traj = out.traj.cpu().numpy()
            fin = finals.cpu().numpy()
        if done != self.n_iter:
            raise RuntimeError(f"the solve ran {done} of {self.n_iter} "
                               f"iterations")
        return starts, goals, traj, fin

    def warm(self):
        """One batch of the cell's shape (captures each card's step)."""
        self._solve(WARM)
        _sync(self.devices)

    def unit(self, i):
        t0 = time.perf_counter()
        rec = self._solve(i)
        self.times.append(time.perf_counter() - t0)
        self.records.append(rec)

    def picks(self, rng):
        """The rows the check compares: ``check_rows`` drawn from the seed
        over every unit, as many from each card's part.  [(unit, row)]."""
        per = max(1, self.check_rows // len(self.parts))
        out = []
        for lo, hi in self.parts:
            units = rng.integers(0, len(self.records), size=per)
            rows = rng.integers(lo, hi, size=per)
            out += list(zip(units.tolist(), rows.tolist()))
        return out

    def results(self, picks):
        """(starts, goals, trajectories, final costs) of the picks,
        float64."""
        cols = [np.stack([self.records[u][k][r] for u, r in picks])
                for k in range(4)]
        return [c.astype(np.float64) for c in cols]


class PlanTraffic:
    """Closed-loop requests through the module's commands."""

    def __init__(self, world, mix, seed, spans, devices):
        self.world, self.seed, self.spans = world, seed, spans
        self.check_requests = int(mix["check_requests"])
        cfg = world.cfg
        if world.kwargs.get("floating_base"):
            raise ValueError("the plan driver takes a fixed base")
        self.n_iter = int(cfg["n_iter"])
        self.sigma = float(cfg["sigma"])
        self.start = np.asarray(cfg["robot"]["start"], np.float64)
        self.goal = np.asarray(world.kwargs["adofgoal"], np.float64)
        self.devices = devices
        self.records = []        # per unit: start, goal, traj, verdict
        self.times = []

    @property
    def problems(self):
        return len(self.times)

    def _request(self, i):
        w = self.world
        s, g = endpoints(self.seed, i, self.start, self.goal, self.sigma, 1)
        w.robot.q_active = s[0].copy()
        mod = w.module
        with self.spans("create"):
            h = mod.create(robot=w.robot.name,
                           **dict(w.kwargs, adofgoal=g[0]))
        try:
            with self.spans("iterate"):
                mod.iterate(run=h, n_iter=self.n_iter)
            with self.spans("gettraj"):
                out = mod.gettraj(run=h, no_collision_exception=True,
                                  no_collision_details=True)
        finally:
            with self.spans("destroy"):
                mod.destroy(run=h)
        return s[0], g[0], out.positions, out.in_collision

    def warm(self):
        self._request(WARM)
        _sync(self.devices)

    def unit(self, i):
        t0 = time.perf_counter()
        rec = self._request(i)
        self.times.append(time.perf_counter() - t0)
        self.records.append(rec)

    def picks(self, rng):
        """``check_requests`` requests drawn from the seed."""
        k = min(self.check_requests, len(self.records))
        return rng.choice(len(self.records), size=k, replace=False).tolist()

    def results(self, picks):
        """(starts, goals, trajectories float64, verdicts bool)."""
        rec = [self.records[u] for u in picks]
        return (np.stack([r[0] for r in rec]), np.stack([r[1] for r in rec]),
                np.stack([r[2] for r in rec]).astype(np.float64),
                np.array([r[3] for r in rec]))
