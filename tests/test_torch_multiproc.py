"""The port's multi-process solve (counterpart of tests/test_multiproc.py):
two OS processes (tests/torch_multiproc_child.py) join a gloo world, each
solves its rows [0, 4] / [4, 4] of a global batch of 8 with a mesh
BatchSolver and picks the global best with all_hosts_best.  Both ranks
must agree bit for bit; their rows must match the port's single-process
solve of the whole batch (rtol 1e-12) and, without HMC, the JAX
package's (1e-9, float64, on the JAX field's values).  With HMC on
per-row seeds arange(8) the rows match the port's single process only
(the port's seeded draws are not jax.random's)."""

import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from or_cdchomp_tpu.parallel.batch import BatchSolver as JaxBatchSolver

from or_cdchomp_tpu_torch.parallel.batch import BatchSolver, best_of_batch

from tests import multiproc_child as jc
from tests import torch_multiproc_child as tc
from torch_parity import close

TIMEOUT = 120        # s per child; the rendezvous itself times out at 60
PORT_RTOL = 1e-12    # the two-process rows against one process
JAX_RTOL = 1e-9      # against the JAX package's single-process solve


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_children(field_path, nprocs=2):
    port = _free_port()
    child = os.path.join(os.path.dirname(__file__), "torch_multiproc_child.py")
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, child, str(rank), str(nprocs), str(port),
         field_path],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for rank in range(nprocs)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=TIMEOUT)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"child {rank} failed rc={p.returncode}:\n{out[-4000:]}"
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        assert line, f"child {rank} produced no RESULT line:\n{out[-2000:]}"
        results[rank] = json.loads(line[-1][len("RESULT "):])
    return results


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX world of tests/multiproc_child.py, its field values saved
    for the children, and the two processes' results."""
    jmod, jrun, goal = jc.build_world(jnp)
    field = np.asarray(jmod.sdfs[0].grid.data)
    path = str(tmp_path_factory.mktemp("mp") / "field.npy")
    np.save(path, field)
    return jrun, field, _run_children(path)


def _single(field, hmc):
    """The port's single-process solve of the whole global batch."""
    mod = tc.build_module(field)
    engine, probs = tc.global_batch(mod, hmc)
    out, finals = tc.solve(BatchSolver(engine), probs, hmc)
    best, idx = best_of_batch(out, finals)
    return out, finals, best, idx


def test_world_and_rows(world):
    _, _, res = world
    for rank in (0, 1):
        assert res[rank]["world"] == 2 and res[rank]["mesh"] == [2]
    for case in ("plain", "hmc"):
        assert res[0][case]["local_rows"] == [0, 4]
        assert res[1][case]["local_rows"] == [4, 4]


@pytest.mark.parametrize("case", ["plain", "hmc"])
def test_ranks_agree_bitwise(world, case):
    _, _, res = world
    r0, r1 = res[0][case], res[1][case]
    assert r0["best_idx"] == r1["best_idx"]
    assert r0["best_traj"] == r1["best_traj"]          # floats, exactly
    assert r0["best_iteration"] == r1["best_iteration"] == tc.N_ITER


@pytest.mark.parametrize("case", ["plain", "hmc"])
def test_matches_port_single_process(world, case):
    _, field, res = world
    out, finals, best, idx = _single(field, case == "hmc")
    traj = np.concatenate([res[0][case]["traj"], res[1][case]["traj"]])
    fin = np.concatenate([res[0][case]["finals"], res[1][case]["finals"]])
    close(traj, out.traj.numpy(), PORT_RTOL)
    close(fin, finals.numpy(), PORT_RTOL)
    assert res[0][case]["best_idx"] == int(idx)
    close(np.array(res[0][case]["best_traj"]), best.traj.numpy(), PORT_RTOL)


def test_matches_jax_single_process(world):
    """Without HMC, the two ranks' rows against the JAX package's
    single-process solve of the same global batch on the same field."""
    jrun, _, res = world
    jprobs = jc.global_batch(jrun, jrun.engine, tc.GOAL, tc.GLOBAL_BATCH)
    jout, _ = JaxBatchSolver(jrun.engine, chunk=None).iterate(jprobs,
                                                              tc.N_ITER)
    jfin = np.stack([np.asarray(f) for f in
                     jrun.engine.final_costs_batch(jout)], axis=-1)
    traj = np.concatenate([res[0]["plain"]["traj"], res[1]["plain"]["traj"]])
    fin = np.concatenate([res[0]["plain"]["finals"],
                          res[1]["plain"]["finals"]])
    close(traj, np.asarray(jout.traj), JAX_RTOL)
    close(fin, jfin, JAX_RTOL)
    assert res[0]["plain"]["best_idx"] == int(np.argmin(jfin[:, 0]))

