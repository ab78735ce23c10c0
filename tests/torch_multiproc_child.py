"""Child process of the port's two-process test (tests/test_torch_multiproc.py),
the counterpart of tests/multiproc_child.py.  Each process joins a gloo
world through ``multihost.initialize`` (a local TCPStore, a 60 s timeout),
takes its ``host_local_batch`` rows of a global batch of 8 through
``make_global_problems``, solves them with a mesh ``BatchSolver`` and
picks the global best with ``all_hosts_best``: once without HMC
(``solve(tol=...)``, so the converged flag is all-reduced) and once with
HMC on per-row seeds ``arange(8)``.  Imports only the port; prints one
JSON line.

    python torch_multiproc_child.py <rank> <nprocs> <port> [field.npy]

``field.npy`` (optional): field values to use in place of the port's own
build (the JAX package's float32 EDT differs from the port's by an ulp on
some cells), so a solve can be held against the JAX package's.
"""

import json
import sys

import numpy as np

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0])
GLOBAL_BATCH = 8
N_ITER = 4
CHUNK = 2


def build_module(field=None):
    """tests/multiproc_child.py's world in the port, float64 on the CPU:
    a table at 0.6 m, its field at 0.12 m (or ``field``'s values)."""
    import torch

    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.api import KinBody, Robot

    mod = pt.CHOMPModule(dtype=torch.float64, device="cpu")
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = mod.add_robot(Robot("wam", pt.wam7(), q_active=START.copy()))
    r.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.12)
    r.enabled = True
    if field is not None:
        mod.sdfs[0].grid.data = torch.as_tensor(np.array(field))
        mod.clear_engine_cache()
    return mod


def endpoints(n):
    """tests/multiproc_child.py's global_batch endpoints: seed 0,
    σ = 0.01 around START and GOAL."""
    rng = np.random.default_rng(0)
    starts = np.tile(START, (n, 1)) + 0.01 * rng.normal(size=(n, 7))
    goals = np.tile(GOAL, (n, 1)) + 0.01 * rng.normal(size=(n, 7))
    return starts, goals


def global_batch(mod, hmc):
    """(engine, global batch of 8): without HMC as the JAX child builds
    it; with HMC (λ_resample 0.5) on per-row seeds arange(8)."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    kw = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
              n_points=8)
    if hmc:
        kw.update(use_hmc=True, hmc_resample_lambda=0.5)
    run = mod.runs[mod.create(**kw)]
    starts, goals = endpoints(GLOBAL_BATCH)
    seeds = np.arange(GLOBAL_BATCH) if hmc else None
    return run.engine, problem_batch_from_grid(run.problem, starts, goals,
                                               run.engine, seeds=seeds)


def solve(solver, probs, hmc):
    """The solve both sides run: HMC iterates N_ITER steps, the plain
    case solves with a tolerance that never stops it early."""
    import torch

    if hmc:
        probs, _ = solver.iterate(probs, N_ITER)
        finals = torch.stack(solver.engine.final_costs_batch(probs), -1)
        return probs, finals
    probs, finals, done = solver.solve(probs, N_ITER, chunk=CHUNK, tol=-1.0)
    assert done == N_ITER, done
    return probs, finals


def main():
    rank, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    field = np.load(sys.argv[4]) if len(sys.argv) > 4 else None

    import torch
    torch.set_num_threads(1)

    from or_cdchomp_tpu_torch.chomp.problem import ChompProblem
    from or_cdchomp_tpu_torch.parallel import multihost as mh
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

    mh.initialize(coordinator_address=f"127.0.0.1:{port}",
                  num_processes=nprocs, process_id=rank)
    import torch.distributed as dist
    assert dist.get_backend() == "gloo"
    assert dist.get_world_size() == nprocs

    mod = build_module(field)
    mesh = mh.pod_mesh()
    result = {"rank": rank, "world": dist.get_world_size(),
              "mesh": list(mesh.mesh.shape)}
    for hmc in (False, True):
        engine, probs_all = global_batch(mod, hmc)
        start, size = mh.host_local_batch(GLOBAL_BATCH)
        rows = ChompProblem(**{k: v[start:start + size]
                               for k, v in probs_all.leaves().items()})
        local = mh.make_global_problems(rows, mesh)
        solver = BatchSolver(engine, mesh=mesh)
        assert torch.equal(solver.shard(probs_all).traj, local.traj)
        out, finals = solve(solver, local, hmc)
        best, idx = mh.all_hosts_best(out, finals)
        result["hmc" if hmc else "plain"] = {
            "local_rows": [start, size],
            "best_idx": int(idx),
            "best_traj": best.traj.tolist(),
            "best_iteration": int(best.iteration),
            "traj": out.traj.tolist(),
            "finals": finals.tolist(),
        }
    dist.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
