"""The port's multi-process layer on a gloo world of one process, float64
on the CPU (counterpart of tests/test_multihost.py and
tests/test_sharding_collectives.py): ``initialize``, ``pod_mesh`` shapes,
``host_local_batch`` against the JAX package's arithmetic,
``make_global_problems`` + a mesh ``BatchSolver`` + ``all_hosts_best``
against the plain solver (bit-equal) and the JAX package (1e-9), the
collectives a solve makes (counted by patching torch.distributed: none
per step, one per converged-checked chunk), ``stack_problems`` and
``pad_problems`` against JAX at rtol 0, and the cross-rank winner rule
against ``jnp.argmin`` (ties, NaN, an empty rank)."""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.parallel import multihost as jmh
from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver
from or_cdchomp_tpu.parallel.batch import pad_problems as jax_pad
from or_cdchomp_tpu.parallel.batch import stack_problems as jax_stack

from or_cdchomp_tpu_torch.parallel import multihost as mh
from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver, best_of_batch,
                                                 pad_problems, stack_problems)

from torch_parity import (GOAL, close, jax_batch, port_engine, port_probs,
                          table_module)

RTOL = 1e-9          # against the JAX package's solve
N_ITER = 4
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "broadcast", "broadcast_object_list",
               "reduce", "reduce_scatter", "reduce_scatter_tensor",
               "all_to_all", "all_to_all_single", "gather", "scatter",
               "barrier", "send", "recv", "isend", "irecv")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_initialize_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    was = dist.is_initialized()
    mh.initialize()
    assert dist.is_initialized() == was


def test_initialize_needs_every_argument():
    with pytest.raises(ValueError, match="together"):
        mh.initialize(coordinator_address="127.0.0.1:1", num_processes=2)


@pytest.mark.parametrize("local, n_dev, want", [
    (1, 1, "nccl"), (4, 4, "nccl"), (2, 4, "nccl"),
    (2, 1, "gloo"), (1, 0, "gloo"), (8, 4, "gloo")])
def test_choose_backend(local, n_dev, want):
    assert mh.choose_backend(local, n_dev) == want


@pytest.fixture(scope="module")
def world():
    """A gloo world of one process, and tests/test_multihost.py's scene
    (JAX module, run, B = 8 batch) with the port's engine and problems."""
    mh.initialize(coordinator_address=f"127.0.0.1:{_free_port()}",
                  num_processes=1, process_id=0)
    assert dist.get_backend() == "gloo"
    mod = table_module(oc, dtype=jnp.float64)
    mod.robots["wam"].enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.15)
    mod.robots["wam"].enabled = True
    run = mod.runs[mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                              obs_factor=500.0, n_points=9)]
    jprobs = jax_batch(run, 8, seed=3)
    yield run, jprobs, port_engine(run.engine), port_probs(jprobs)
    dist.destroy_process_group()


def test_pod_mesh_shapes(world):
    m1 = mh.pod_mesh()
    assert m1.mesh_dim_names == ("dp",) and tuple(m1.mesh.shape) == (1,)
    assert m1.device_type == "cpu"
    m2 = mh.pod_mesh(hosts_axis="hosts")
    assert m2.mesh_dim_names == ("hosts", "dp")
    assert tuple(m2.mesh.shape) == (1, 1)


@pytest.mark.parametrize("n, rank, total", [
    (1, 0, 37), (3, 0, 37), (3, 1, 37), (3, 2, 37), (4, 3, 8), (5, 4, 3)])
def test_host_local_batch_matches_jax(world, monkeypatch, n, rank, total):
    monkeypatch.setattr(jmh.jax, "process_count", lambda: n)
    monkeypatch.setattr(jmh.jax, "process_index", lambda: rank)
    want = jmh.host_local_batch(total)
    monkeypatch.setattr(mh.dist, "get_world_size", lambda group=None: n)
    monkeypatch.setattr(mh.dist, "get_rank", lambda group=None: rank)
    assert mh.host_local_batch(total) == want


def test_shard_takes_this_ranks_rows(world, monkeypatch):
    _, _, eng, probs = world
    solver = BatchSolver(eng, mesh=mh.pod_mesh())
    assert torch.equal(solver.shard(probs).traj, probs.traj)
    monkeypatch.setattr(mh.dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(mh.dist, "get_rank", lambda group=None: 1)
    rows = solver.shard(probs)
    for k, v in rows.leaves().items():
        assert torch.equal(v, getattr(probs, k)[3:6]), k


def test_global_problems_solve(world):
    """make_global_problems + a mesh solve with tol + all_hosts_best:
    bit-equal to the plain solver and best_of_batch, within 1e-9 of the
    JAX package's solve."""
    run, jprobs, eng, probs = world
    mesh = mh.pod_mesh()
    gprobs = mh.make_global_problems(probs, mesh)
    out, fin, done = BatchSolver(eng, mesh=mesh).solve(
        gprobs, N_ITER, chunk=2, tol=-1.0)
    best, idx = mh.all_hosts_best(out, fin)
    pout, pfin, pdone = BatchSolver(eng).solve(probs, N_ITER, chunk=2,
                                               tol=-1.0)
    pbest, pidx = best_of_batch(pout, pfin)
    assert done == pdone == N_ITER
    assert torch.equal(out.traj, pout.traj) and torch.equal(fin, pfin)
    assert int(idx) == int(pidx) and idx.dtype == torch.int64
    for k, v in pbest.leaves().items():
        assert torch.equal(getattr(best, k), v), k
    jout, jfin, _ = JaxBatchSolver(run.engine).solve(jprobs, N_ITER, chunk=2,
                                                     tol=-1.0)
    close(out.traj, jout.traj, RTOL)
    close(fin, jfin, RTOL)


def test_tuple_axis_solves_as_the_flat_mesh(world):
    _, _, eng, probs = world
    mesh2 = mh.pod_mesh(hosts_axis="hosts")
    out2, fin2, _ = BatchSolver(eng, mesh=mesh2, axis=("hosts", "dp")).solve(
        probs, N_ITER, chunk=2, tol=-1.0)
    out, fin, _ = BatchSolver(eng).solve(probs, N_ITER, chunk=2, tol=-1.0)
    assert torch.equal(out2.traj, out.traj) and torch.equal(fin2, fin)
    with pytest.raises(ValueError, match="dimension"):
        BatchSolver(eng, mesh=mesh2, axis=("dp", "hosts"))


@pytest.fixture
def counted(monkeypatch):
    """Every torch.distributed collective, counted by name."""
    calls = {}
    for name in COLLECTIVES:
        fn = getattr(dist, name)

        def wrap(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(dist, name, wrap)
    return calls


def test_steps_exchange_nothing(world, counted):
    _, _, eng, probs = world
    solver = BatchSolver(eng, mesh=mh.pod_mesh())
    solver.iterate(probs, 3)
    solver.iterate_masked(probs, 2, 3)
    solver.solve(probs, 4, chunk=2)                # no tol: no test
    assert counted == {}


def test_one_all_reduce_per_chunk(world, counted):
    _, _, eng, probs = world
    solver = BatchSolver(eng, mesh=mh.pod_mesh())
    _, _, conv = solver.iterate_until(probs, 2, 2, tol=1e9)
    assert bool(conv) and counted == {"all_reduce": 1}
    _, _, done = solver.solve(probs, 5, chunk=2, tol=-1.0)
    assert done == 5 and counted == {"all_reduce": 1 + 3}
    _, _, done = solver.solve(probs, 5, chunk=2, tol=1e9)
    assert done == 2 and counted == {"all_reduce": 1 + 3 + 1}


def test_all_hosts_best_collectives(world, counted):
    _, _, eng, probs = world
    fin = torch.stack(eng.final_costs_batch(probs), -1)
    mh.all_hosts_best(probs, fin)
    assert counted == {"all_gather": 1, "broadcast": 1}


@pytest.mark.parametrize("totals, want", [
    ([3.0, 1.0, 2.0, 1.0, 5.0, 1.0, 4.0, 6.0], 1),       # ties: first
    ([3.0, 1.0, 2.0, 0.5, np.nan, 1.0, 4.0, 6.0], 4),    # NaN wins
    ([np.nan, 1.0, np.nan, 0.5, 1.0, 1.0, 4.0, 6.0], 0)])
def test_all_hosts_best_rules_match_jax(world, totals, want):
    _, jprobs, _, probs = world
    fin = np.zeros((8, 3))
    fin[:, 0] = totals
    best, idx = mh.all_hosts_best(probs, torch.as_tensor(fin))
    assert int(idx) == int(jnp.argmin(jnp.asarray(fin[:, 0]))) == want
    for k, v in best.leaves().items():
        assert torch.equal(v, getattr(probs, k)[want]), k


@pytest.mark.parametrize("ranks", [
    [[3.0, 1.0], [2.0, 1.0, 0.5]],
    [[2.0, 1.0], [1.0, 3.0]],                  # a tie across ranks
    [[3.0, 1.0], [np.nan, 0.0]],
    [[1.0, np.nan], [np.nan, 0.0]],            # the lowest NaN index
    [[], [2.0, 1.0], [1.0]],                   # an empty rank
    [[5.0], [], [np.nan, 1.0], [0.0]],
    [[1.0, 1.0], [1.0], [1.0, 1.0]],
])
def test_pick_winner_matches_argmin(ranks):
    """The cross-rank rule on each rank's local best_of_batch, against
    jnp.argmin over the concatenated batch."""
    rows = []
    for c in ranks:
        if c:
            i = int(torch.argmin(torch.tensor(c)))
            rows.append([c[i], i, len(c)])
        else:
            rows.append([np.inf, 0, 0])
    _, g = mh.pick_winner(np.array(rows))
    assert g == int(jnp.argmin(jnp.asarray(sum(ranks, []))))


def test_stack_and_pad_match_jax(world):
    _, jprobs, _, probs = world
    singles = [jax.tree.map(lambda x, i=i: x[i], jprobs) for i in (0, 3, 5)]
    want = port_probs(jax_stack(singles))
    got = stack_problems([port_probs(s) for s in singles])
    for k, v in want.leaves().items():
        assert torch.equal(getattr(got, k), v), k
    for multiple in (3, 4, 8):
        jpad, jP = jax_pad(jprobs, multiple)
        tpad, tP = pad_problems(probs, multiple)
        assert tP == jP == 8
        want = port_probs(jpad)
        for k, v in want.leaves().items():
            assert torch.equal(getattr(tpad, k), v), k
    assert pad_problems(probs, 4)[0] is probs
