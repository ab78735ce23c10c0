"""Multi-process execution over torch.distributed (counterpart of
or_cdchomp_tpu/parallel/multihost.py).

The reference is a single process with no distributed communication of
any kind (SURVEY.md §2.5).  The scale axis is the problem batch: each
process (rank) holds its own rows of a global batch on its own device,
runs the batch step on them, and the ranks meet only to agree that the
batch converged and to pick the best of it.

 - :func:`initialize` — ``init_process_group`` bring-up (idempotent).
 - :func:`pod_mesh` — a 1-d ``(dp,)`` or a 2-d ``(hosts, dp)``
   ``DeviceMesh`` over every rank.
 - :func:`host_local_batch` — this rank's (start, size) of a global batch.
 - :func:`make_global_problems` — this rank's rows on its device.
 - :func:`all_hosts_best` — the best of the global batch, on every rank.

The JAX package's sharded global array has no counterpart: a rank never
sees another rank's rows.  Rows are split contiguously in rank order
(:func:`host_local_batch`), so a row's global index is its rank's offset
(the row counts of the lower ranks) plus its local index;
:func:`all_hosts_best` derives the offsets from one ``all_gather``.

HMC across ranks: a batch built with ``seeds=None`` draws from one engine
generator as one batch, so splitting it changes the draws.  Build the
global batch with ``seeds=`` the global row indices (``arange(P)``, the
JAX package's default keys, or any per-row seeds): each row then draws
the same numbers whatever its rank or batch (``SeededDraw``).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem

DEFAULT_TIMEOUT = datetime.timedelta(seconds=60)


def choose_backend(local_ranks: int, n_devices: int) -> str:
    """NCCL where every rank of the host owns a CUDA device of its own;
    gloo on the CPU, or where ranks share a card (NCCL refuses two ranks
    on one GPU)."""
    return "nccl" if 0 < local_ranks <= n_devices else "gloo"


def _local_ranks(num_processes):
    """Ranks on this host: torchrun's LOCAL_WORLD_SIZE, else every rank
    (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Bring up the default process group; a no-op when one is already up
    and for a single process (no arguments and no torchrun environment).

    ``coordinator_address`` is "host:port" of rank 0's store (a
    ``TCPStore``); without it, torchrun's environment (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK) is read.  ``backend`` defaults to
    :func:`choose_backend`; under NCCL each rank takes the CUDA device
    of its local rank.  ``timeout`` bounds the rendezvous and every
    collective, so a rank that never arrives raises instead of hanging.
    """
    env = coordinator_address is None and num_processes is None
    if not env and (coordinator_address is None or num_processes is None
                    or process_id is None):
        raise ValueError("initialize needs coordinator_address, "
                         "num_processes and process_id together")
    if dist.is_initialized() or (env and "WORLD_SIZE" not in os.environ):
        return                          # already up, or a single process
    if env:
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
        init_method = "env://"
    else:
        init_method = f"tcp://{coordinator_address}"
    n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = _local_ranks(num_processes)
    if backend is None:
        backend = choose_backend(local, n_dev)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK",
                                                 process_id % local)))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def pod_mesh(axis: str = "dp", hosts_axis: Optional[str] = None):
    """A ``DeviceMesh`` over every rank of the default group.

    With ``hosts_axis=None``: a flat 1-d mesh ``(axis,)``; the problem
    batch is the only parallel axis.  With ``hosts_axis='hosts'``: a
    (hosts, ranks per host) mesh, the ranks per host from torchrun's
    LOCAL_WORLD_SIZE, else 1 (each process its own host, as the JAX
    package's (process_count, local devices) mesh with one device per
    process).  The mesh's device type is "cuda" under NCCL, "cpu" under
    gloo.
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("pod_mesh needs a process group: call "
                           "initialize() first")
    world = dist.get_world_size()
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if hosts_axis is None:
        return init_device_mesh(dev, (world,), mesh_dim_names=(axis,))
    local = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if world % local:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{local}")
    return init_device_mesh(dev, (world // local, local),
                            mesh_dim_names=(hosts_axis, axis))


def host_local_batch(global_batch: int, group=None) -> tuple:
    """(start, size) of this rank's slice of a global problem batch,
    splitting as evenly as possible (the first ranks get the remainder);
    over ``group``'s ranks, by default every rank."""
    if dist.is_initialized():
        n, rank = dist.get_world_size(group), dist.get_rank(group)
    else:
        n, rank = 1, 0
    base, rem = divmod(global_batch, n)
    size = base + (1 if rank < rem else 0)
    start = rank * base + min(rank, rem)
    return start, size


def make_global_problems(probs_local: ChompProblem, mesh=None, axis="dp"):
    """This rank's rows of a global batch (each rank passes only its own,
    :func:`host_local_batch`'s slice) on the rank's device: rows on the
    card go to the current CUDA device, CPU rows stay.  Torch has no
    global array: the rows stay this rank's, and their global offset is
    the row count of the lower ranks (:func:`all_hosts_best`).  ``mesh``
    and ``axis`` are the JAX signature's; no collective runs.

    For HMC, build the global batch with ``seeds=`` its global row
    indices before slicing (module docstring)."""
    dev = probs_local.traj.device
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return probs_local.to(dev)


def comm_tensor(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` where ``group``'s backend takes it: gloo on a CPU copy, NCCL
    on the card."""
    if dist.get_backend(group) == "gloo":
        return t.cpu()
    return t if t.is_cuda else t.cuda()


def pick_winner(gathered: np.ndarray) -> tuple:
    """(winning rank, global index) from the (ranks, 3) rows (local best
    total cost, local index, local row count) of :func:`all_hosts_best`'s
    gather.  As ``jnp.argmin`` over the global batch: the least cost,
    ties to the lowest global index, and a NaN wins at its lowest global
    index; a rank with no rows takes no part."""
    sizes = gathered[:, 2].astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    best = None
    for r in np.nonzero(sizes > 0)[0]:
        c, g = gathered[r, 0], int(offsets[r] + int(gathered[r, 1]))
        if np.isnan(c):
            return int(r), g                   # the lowest NaN index
        if best is None or c < best[0]:
            best = (c, int(r), g)
    if best is None:
        raise ValueError("all_hosts_best: the global batch is empty")
    return best[1], best[2]


def all_hosts_best(probs: ChompProblem, final_costs, group=None):
    """The global batch's best problem, on every rank: each rank takes its
    local ``best_of_batch`` of ``final_costs`` (its rows' (P, 3) report),
    one ``all_gather`` of (cost, local index, row count) picks the winner
    (:func:`pick_winner`), and the winning rank broadcasts that problem's
    leaves as one byte buffer.  Returns (problem, global index as a 0-d
    int64 tensor), both on ``probs``' device; bit-equal on every rank.
    Without a process group it is ``best_of_batch``."""
    from or_cdchomp_tpu_torch.parallel.batch import best_of_batch

    if not dist.is_initialized():
        return best_of_batch(probs, final_costs)
    dev = probs.traj.device
    P = probs.traj.shape[0]
    mine = torch.zeros(3, dtype=torch.float64)
    if P:
        best, idx = best_of_batch(probs, final_costs)
        leaves = best.leaves()
        mine[0] = final_costs[idx, 0].double().cpu()
        mine[1] = float(idx)
    else:
        mine[0] = float("inf")
        leaves = {k: torch.empty(v.shape[1:], dtype=v.dtype, device=dev)
                  for k, v in probs.leaves().items()}
    mine[2] = P
    mine = comm_tensor(mine, group)
    parts = [torch.empty_like(mine)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, mine, group=group)
    gathered = torch.stack(parts).cpu().numpy()
    winner, g = pick_winner(gathered)
    names = list(leaves)
    flat = [leaves[k].contiguous().reshape(-1).view(torch.uint8)
            for k in names]
    buf = comm_tensor(torch.cat(flat), group)
    dist.broadcast(buf, src=dist.get_global_rank(group or dist.group.WORLD,
                                                 winner), group=group)
    buf = buf.to(dev)
    out, lo = {}, 0
    for k, f in zip(names, flat):
        v = leaves[k]
        out[k] = buf[lo:lo + f.numel()].clone().view(v.dtype).reshape(
            v.shape)
        lo += f.numel()
    return ChompProblem(**out), torch.tensor(g, dtype=torch.int64,
                                             device=dev)
