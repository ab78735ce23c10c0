"""BatchSolver over several devices in one process, on the CPU at
float64: the rows each device holds against the JAX package's ``shard``
on its 8 virtual CPU devices, a split solve against JAX's sharded
``BatchSolver(engine).solve`` and against one device, seeded and
unseeded HMC split over 4 devices against one device, ``iterate_until``'s
flag as the AND over devices, an extra-cost hook on each device's rows,
the engine replicas, and the argument checks.  Repeated CPU entries
(``devices=["cpu"] * k``) make real replicas and a real split, the parts
stepped in turn."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import best_of_batch as jax_best_of

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.chomp import solver as solver_mod
from or_cdchomp_tpu_torch.chomp.solver import (HmcDraw, RecordingDraw,
                                               SeededDraw)
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver, best_of_batch,
                                                 problem_batch_from_grid)

from torch_parity import (GOAL, START, close, config1_module, jax_batch,
                          port_engine, port_probs, table_module)

RTOL = 1e-9
# a split solve's trajectories are bit-equal to one device's; its costs
# are held within this: the CPU's sum of the per-(point, sphere) costs,
# cost.sum(dim=(0, 1)) over an (m, S, B) tensor, reduces along the outer
# axes with B innermost, and its vectorised order depends on B
COST_RTOL = 1e-12
CPU8 = ["cpu"] * 8
HMC_KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
              n_points=9, use_hmc=True, hmc_resample_lambda=0.5)


@pytest.fixture(scope="module")
def setup():
    mod = config1_module(oc, dtype=jnp.float64)
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                              obs_factor=500.0, n_points=9)]
    return run, port_engine(run.engine), JaxBatchSolver(run.engine)


def _rows(shards, P):
    """{device: set of rows} of a JAX array sharded along axis 0."""
    out = {}
    for dev, idx in shards.sharding.devices_indices_map(shards.shape).items():
        out[dev] = set(range(P)[idx[0]])
    return out


@pytest.mark.parametrize("B", [16, 12, 7, 1])
def test_placement_matches_jax_shard(setup, B):
    """The rows each port device holds equal the rows each JAX device
    holds after ``shard`` (even over 8, the gcd sub-mesh of 4, and
    replicated where the gcd is 1, where the port's first device holds
    every row, as each JAX replica does); ``shard`` itself returns the
    batch in its order on the engine's device, and a call gathers every
    row back in order."""
    run, eng, jsolver = setup
    jprobs = jax_batch(run, B, seed=B)
    want = _rows(jsolver.shard(jprobs).traj, B)
    solver = BatchSolver(eng, devices=CPU8)
    place = {i: set(range(lo, hi)) for i, lo, hi in solver._placement(B)}
    devices = jax.devices()
    assert len(devices) == 8
    replicated = all(len(want.get(d, ())) == B for d in devices)
    assert replicated == (np.gcd(B, 8) == 1)
    for i, d in enumerate(devices):
        if replicated:
            assert place.get(i, set()) == (set(range(B)) if i == 0
                                           else set())
        else:
            assert place.get(i, set()) == want.get(d, set())
    probs = port_probs(jprobs)
    assert torch.equal(solver.shard(probs).traj, probs.traj)
    parts = solver._scatter(probs)
    assert [p[0] for p in parts] == [solver.replicas[i] for i in place]
    for rep, rows, lo, hi in parts:
        assert torch.equal(rows.traj, probs.traj[lo:hi])
    assert torch.equal(solver._gather_problems(parts).traj, probs.traj)


@pytest.fixture(scope="module")
def split_solve(setup):
    """JAX's 8-device BatchSolver(engine).solve of 16 problems (2 rows a
    device) and the port's with devices=["cpu"] * 8 and on one device,
    10 steps in chunks of 2 with a tol that stops them early."""
    run, eng, jsolver = setup
    jprobs = jax_batch(run, 16, seed=3)
    kw = dict(chunk=2, tol=0.05)
    jout = jsolver.solve(jprobs, 10, **kw)
    split = BatchSolver(eng, devices=CPU8).solve(port_probs(jprobs), 10,
                                                 **kw)
    one = BatchSolver(eng, devices=["cpu"]).solve(port_probs(jprobs), 10,
                                                  **kw)
    return jout, split, one


def test_split_solve_matches_jax_and_one_device(split_solve):
    (jout, jfin, jdone), (out, fin, done), (out1, fin1, done1) = split_solve
    assert done == jdone == done1
    assert 2 < done < 10                     # the AND stopped it early
    close(out.traj, jout.traj, RTOL)
    close(fin, jfin, RTOL)
    assert torch.equal(out.traj, out1.traj)
    assert torch.equal(out.iteration, out1.iteration)
    close(fin, fin1.numpy(), COST_RTOL)
    assert torch.equal(fin[:, 2], fin1[:, 2])     # smoothness: row sums


def test_best_of_split_batch_picks_jax_index(split_solve):
    (jout, jfin, _), (out, fin, _), _ = split_solve
    jbest, jidx = jax_best_of(jout, jfin)
    best, idx = best_of_batch(out, fin)
    assert int(idx) == int(jidx)
    close(best.traj, jbest.traj, RTOL)


def test_split_iterate_and_masked_match_one_device(setup):
    """iterate and iterate_masked over 4 devices (3 rows each): the rows
    back in order, bit-equal to one device, costs (n, P, 3)."""
    run, eng, _ = setup
    probs = port_probs(jax_batch(run, 12, seed=4))
    split, one = BatchSolver(eng, devices=["cpu"] * 4), BatchSolver(eng)
    out, costs = split.iterate(probs, 3)
    out1, costs1 = one.iterate(probs, 3)
    assert tuple(costs.shape) == (3, 12, 3)
    assert torch.equal(out.traj, out1.traj)
    close(costs, costs1.numpy(), COST_RTOL)
    out, costs = split.iterate_masked(probs, 2, 4)
    out1, costs1 = one.iterate_masked(probs, 2, 4)
    assert torch.equal(out.traj, out1.traj)
    assert tuple(costs.shape) == (4, 12, 3) and not costs[2:].any()


def test_iterate_until_flag_is_and_over_devices(setup):
    """Two devices: rows 0-3 already solved (30 steps), rows 4-7 fresh.
    With a tol between the two halves' largest cost drops, device 0's
    rows converge and device 1's do not: the flag is false, as on one
    device, and true for device 0's rows alone."""
    run, eng, _ = setup
    probs = port_probs(jax_batch(run, 8, seed=5))
    one = BatchSolver(eng)
    solved, _ = one.iterate(probs, 30)
    mixed = type(probs)(**{k: torch.cat([solved.leaves()[k][:4], v[4:]])
                           for k, v in probs.leaves().items()})
    _, costs = one.iterate(mixed, 2)
    drop = costs[0, :, 0] - costs[-1, :, 0]
    lo, hi = float(drop[:4].max()), float(drop[4:].max())
    assert lo < hi
    tol = 0.5 * (lo + hi)
    split = BatchSolver(eng, devices=["cpu"] * 2)
    assert [p[1:] for p in split._placement(8)] == [(0, 4), (4, 8)]
    out, last, conv = split.iterate_until(mixed, 2, 4, tol)
    assert conv.dtype == torch.bool and conv.dim() == 0 and not bool(conv)
    assert not bool(one.iterate_until(mixed, 2, 4, tol)[2])
    head = type(probs)(**{k: v[:4] for k, v in mixed.leaves().items()})
    assert bool(split.iterate_until(head, 2, 4, tol)[2])
    out1, last1, _ = one.iterate_until(mixed, 2, 4, tol)
    assert torch.equal(out.traj, out1.traj)
    close(last, last1.numpy(), COST_RTOL)


@pytest.fixture(scope="module")
def hmc_run():
    mod = table_module(pt, dtype=torch.float64, device="cpu")
    robot = mod.robots["wam"]
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    robot.enabled = True
    run = mod.runs[mod.create(**HMC_KW)]
    rng = np.random.default_rng(8)
    starts = START + 0.02 * rng.normal(size=(8, 7))
    goals = GOAL + 0.02 * rng.normal(size=(8, 7))
    return run, starts, goals


class KeyedDraw:
    """SeededDraw that keeps every row's draws by (seed, iteration)."""

    def __init__(self):
        self.seen = {}

    def __call__(self, probs):
        z, u = SeededDraw()(probs)
        for key, zz, uu in zip(zip(probs.hmc_seed.tolist(),
                                   probs.iteration.tolist()), z, u):
            assert key not in self.seen
            self.seen[key] = (zz.clone(), uu.clone())
        return z, u


def test_split_seeded_hmc_bit_equal_to_one_device(hmc_run, monkeypatch):
    """A seeded HMC batch over 4 devices: every row draws on its own
    device what it draws on one (by seed and iteration), the engine's
    draw source is never called, and the trajectories and resample
    schedule are bit-equal."""
    run, starts, goals = hmc_run
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine,
                                    seeds=np.arange(8) + 40)
    outs, draws = [], []
    calls, own = [], run.engine.draw
    run.engine.draw = lambda probs: calls.append(1)
    try:
        for devices in (["cpu"], ["cpu"] * 4):
            rec = KeyedDraw()
            monkeypatch.setattr(solver_mod, "SEEDED_DRAW", rec)
            outs.append(BatchSolver(run.engine, devices=devices).solve(
                probs, 6, chunk=4)[0])
            draws.append(rec.seen)
    finally:
        run.engine.draw = own
    assert not calls
    assert len(draws[0]) == 8 * 6 and draws[0].keys() == draws[1].keys()
    for key, (z, u) in draws[0].items():
        assert torch.equal(draws[1][key][0], z)
        assert torch.equal(draws[1][key][1], u)
    assert torch.equal(outs[0].traj, outs[1].traj)
    assert torch.equal(outs[0].resample_iter, outs[1].resample_iter)


@pytest.mark.parametrize("devices", [["cpu"] * 4, ["cpu"] * 3])
def test_split_unseeded_hmc_bit_equal_to_one_device(hmc_run, devices):
    """An unseeded HMC batch over 4 devices (2 rows each), and over 3,
    where gcd(8, 3) = 1 puts every row on the first device's replica:
    each step draws the whole batch once from the engine's draw source,
    as one device does, so the draws, the trajectories and the resample
    schedule are bit-equal to one device's."""
    run, starts, goals = hmc_run
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine)
    own = run.engine.draw
    outs, recs = [], []
    try:
        for devs in (["cpu"], devices):
            run.engine.draw = RecordingDraw(HmcDraw(11, "cpu"))
            outs.append(BatchSolver(run.engine, devices=devs).solve(
                probs, 6, chunk=4)[0])
            recs.append(run.engine.draw)
    finally:
        run.engine.draw = own
    assert len(recs[0].z) == len(recs[1].z) == 6
    for a, b in zip(recs[0].z + recs[0].u, recs[1].z + recs[1].u):
        assert torch.equal(a, b)
    assert tuple(recs[1].z[0].shape) == (8, 7, 7)
    assert int(outs[0].resample_iter.min()) > 0
    assert torch.equal(outs[0].traj, outs[1].traj)
    assert torch.equal(outs[0].resample_iter, outs[1].resample_iter)


def test_extra_cost_hook_runs_on_each_device_rows(setup):
    """An engine with an extra-cost hook, its batch over 4 devices: every
    replica keeps the hook, which runs once per step on each device's
    rows (4 calls a step against one), and the result is bit-equal to one
    device's, the hook's cost in it."""
    run, _, _ = setup
    eng = port_engine(run.engine)
    calls = []

    def hook(T):
        calls.append(1)
        return 0.5 * (T * T).sum(), T

    eng.extra_cost = hook
    probs = port_probs(jax_batch(run, 8, seed=6))
    outs = []
    for devices, want in ((["cpu"], 3), (["cpu"] * 4, 12)):
        calls.clear()
        solver = BatchSolver(eng, devices=devices)
        assert all(r.extra_cost is hook for r in solver.replicas)
        outs.append(solver.iterate(probs, 3))
        assert len(calls) == want
    (out, costs), (out1, costs1) = outs[1], outs[0]
    assert torch.equal(out.traj, out1.traj)
    close(costs, costs1.numpy(), COST_RTOL)
    eng.extra_cost = None
    plain = BatchSolver(eng).iterate(probs, 1)[1]
    assert bool((costs1[0, :, 1] > plain[0, :, 1]).all())


def test_replicas_are_copies_cached_on_the_engine(setup):
    """Each device entry gets a replica: the engine itself for the first
    entry of its own device, a copy for every other, built once per
    (device, entry) and kept on the engine; a replica holds its own
    tensors with the engine's values, its own pair layout equal to the
    engine's, and the engine's spec, dtype, metric and hook."""
    _, eng, _ = setup
    a = BatchSolver(eng, devices=["cpu"] * 3)
    b = BatchSolver(eng, devices=["cpu"] * 2)
    assert a.replicas[0] is eng and a.replicas[1] is not eng
    assert b.replicas == a.replicas[:2]
    rep = a.replicas[2]
    assert rep is not a.replicas[1]
    for x, y in ((rep.fields.data, eng.fields.data), (rep.A, eng.A),
                 (rep.Ainv, eng.Ainv), (rep.radii_act, eng.radii_act),
                 (rep.fk.sphere_radius, eng.fk.sphere_radius),
                 *zip(rep.pairs, eng.pairs),
                 *zip(rep.pair_layout, eng.pair_layout)):
        assert torch.equal(x, y) and x.data_ptr() != y.data_ptr()
    assert (rep.spec, rep.dtype, rep.metric_mode, rep.extra_cost) == (
        eng.spec, eng.dtype, eng.metric_mode, eng.extra_cost)
    assert isinstance(rep.draw, HmcDraw) and rep.draw is not eng.draw
    assert "_replicas" not in rep.__dict__


def test_devices_argument_checks(setup):
    """A CPU engine's default is its own device alone; devices with a
    mesh, or an empty list, raise ValueError."""
    _, eng, _ = setup
    solver = BatchSolver(eng)
    assert solver.devices == [torch.device("cpu")]
    assert solver.replicas == [eng]
    with pytest.raises(ValueError, match="devices or a mesh"):
        BatchSolver(eng, mesh=object(), devices=["cpu"])
    with pytest.raises(ValueError, match="empty"):
        BatchSolver(eng, devices=[])
