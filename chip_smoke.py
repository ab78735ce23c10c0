"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Builds the two CUDA kernels from or_cdchomp_tpu_torch/csrc, holds each
against its plain PyTorch version at the flagship shapes, then drives
the main path once — the bench scene (WAM7 + hand, table + mug, one SDF)
through CHOMPModule, a batch of 256 perturbed problems, 100 iterations
of BatchSolver.iterate in float32 — checks it went through both kernels,
and holds the first 8 solves against the same API on the CPU in
float64.  Any failed phase exits non-zero.

    python3 chip_smoke.py

Prints the card (nvidia-smi name, power limit), the self-collision
kernel's launch (registers, spills, shared memory, resident blocks) and
its skip shares on the flagship batch, a JSON line of
per-kernel results (device time beside the bound: bytes over 3.35 TB/s
or operations over 67 TFLOP/s fp32, whichever is larger), and as its
last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_ITER = 100
N_POINTS = 101
BATCH = 256
N_CHECK = 8          # problems re-solved on the CPU in float64
TRAJ_BAR = 1e-3      # BASELINE bar: max |Δtraj| float32 card vs float64
KERNEL_RTOL = 1e-5   # kernel vs plain version, both float32 on the card
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (data sheet, 700 W)
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
START = [2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]
GOAL = [0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0]


class PhaseFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def bench_module(pt, dtype, device):
    """The bench.py scene through the port's API; returns (module, run)."""
    import numpy as np

    from or_cdchomp_tpu_torch.api import KinBody, Robot

    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = Robot("wam", pt.wam7(), q_active=np.array(START))
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    h = mod.create(robot="wam", adofgoal=np.array(GOAL), lambda_=100.0,
                   obs_factor=500.0, n_points=N_POINTS)
    return mod, mod.runs[h]


def bench_endpoints():
    """bench.py's seed-0 perturbed starts and goals, (BATCH, 7) each."""
    import numpy as np

    rng = np.random.default_rng(0)
    starts = np.tile(np.array(START), (BATCH, 1)) \
        + 0.02 * rng.normal(size=(BATCH, 7))
    goals = np.tile(np.array(GOAL), (BATCH, 1)) \
        + 0.02 * rng.normal(size=(BATCH, 7))
    return starts, goals


def time_ms(torch, fn, reps=20):
    """Median device time of fn over reps, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def device_ms(torch, fn, reps=20):
    """Device time per call of fn: the summed durations of the kernels it
    launches, from torch.profiler over reps calls (None if the profiler
    records no device activity)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    us = [e.device_time for e in prof.events() if e.device_type == cuda]
    return sum(us) / reps / 1e3 if us else None


def timings(torch, kernel, plain):
    """(kernel ms, plain ms) per call from CUDA events, and the same pair
    as device time from the profiler."""
    return (time_ms(torch, kernel), time_ms(torch, plain),
            device_ms(torch, kernel), device_ms(torch, plain))


def kernel_entry(name, source, replaces, err, t, nbytes, nflops):
    """One kernel's entry of the JSON line.  ms / plain_ms: device time
    per call (profiler; the CUDA-event time per call where the profiler
    saw no device activity); call_ms / plain_call_ms: CUDA-event time per
    call, host work of the wrapper included.  bound_ms: the larger of
    nbytes over the memory rate and nflops over the fp32 rate."""
    ms = t[2] if t[2] is not None else t[0]
    plain_ms = t[3] if t[3] is not None else t[1]
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = nflops / FP32_FLOPS_PER_S * 1e3
    bound = max(by_bytes, by_ops)
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound,
                bound_by="bytes" if by_bytes >= by_ops else "operations",
                bound_share=bound / ms, library_ms=None, call_ms=t[0],
                plain_call_ms=t[1], bytes=nbytes, flops=nflops)


def compare(torch, name, got, want, exact=False):
    """max |got − want|; raises unless equal (exact) or within
    rtol KERNEL_RTOL, atol KERNEL_RTOL·max|want|."""
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()) == bool(torch.isfinite(want).all()),
          f"{name}: non-finite values differ")
    err = float((got.double() - want.double()).abs().max())
    if exact:
        check(torch.equal(got, want), f"{name}: not bit-equal (max {err})")
        return err
    scale = float(want.double().abs().max())
    ok = torch.allclose(got.double(), want.double(), rtol=KERNEL_RTOL,
                        atol=KERNEL_RTOL * scale)
    check(bool(ok), f"{name}: max |err| {err} beyond rtol {KERNEL_RTOL}, "
          f"atol {KERNEL_RTOL}·{scale}")
    return err


def main():
    if not (ROOT / "or_cdchomp_tpu_torch").is_dir():
        print("chip_smoke.py: run it from a checkout of the repository "
              "(or_cdchomp_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)

    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import kernels, sdf_lookup, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    # -- build ----------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")

    # -- the flagship setup on the card ---------------------------------------
    dev = torch.device("cuda")
    f32 = torch.float32
    t0 = time.perf_counter()
    _, run = bench_module(pt, f32, dev)
    engine = run.engine
    starts, goals = bench_endpoints()
    probs = problem_batch_from_grid(run.problem, starts, goals, engine)
    torch.cuda.synchronize()
    print(f"setup (SDF build, create, batch): "
          f"{time.perf_counter() - t0:.2f} s")
    fields = engine.fields
    check(tuple(fields.data.shape) == (1, 12, 16, 12),
          f"field stack {tuple(fields.data.shape)}")

    # -- kernels against their plain versions, at the main path's shapes ------
    _, x_mov, vel, acc = cost_soa.sphere_kinematics(engine.spec, engine.fk,
                                                    probs)
    m, S, B = x_mov.shape[1:]
    check((m, S, B) == (99, 15, BATCH), f"sphere tensors {(m, S, B)}")
    results = []

    rng = np.random.default_rng(1)
    F, mx, my, mz = fields.data.shape
    Q = m * S * B
    sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
    nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                  np.array([mx, my, mz]) - 1).astype(np.int32)
    largs = (fields.data, torch.as_tensor(sub, device=dev),
             torch.as_tensor(nbr, device=dev))
    got = torch.stack(sdf_lookup.sdf_cell_lookup(*largs))
    want = torch.stack(sdf_lookup.sdf_cell_lookup_ref(*largs))
    err = compare(torch, "sdf_cell_lookup", got, want, exact=True)
    t = timings(torch, lambda: sdf_lookup.sdf_cell_lookup(*largs),
                lambda: sdf_lookup.sdf_cell_lookup_ref(*largs))
    # bytes: the field, sub and nbr read once, the 4 values written once
    bound = 4 * (F * mx * my * mz + 2 * F * Q * 3 + 4 * F * Q) \
        / HBM_BYTES_PER_S * 1e3
    print(f"sdf_cell_lookup (raw contract, Q={Q}, not on the main path): "
          f"exact, max_abs_err {err}, per call {t[0]:.4f} ms vs plain "
          f"{t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms, "
          f"bound {bound} ms (bytes)")

    oargs = (x_mov, vel, acc, fields.data, fields.sizes, fields.lengths,
             probs.pose_gsdf_world, probs.pose_world_gsdf,
             probs.field_enabled, engine.radii_act, probs.epsilon,
             probs.obs_factor)
    cost_k, grad_k, dirs_k = sdf_lookup.obstacle(*oargs, want_dirs=True)
    cost_r, grad_r, dirs_r = sdf_lookup.obstacle_ref(*oargs, want_dirs=True)
    agree = float((dirs_k == dirs_r).double().mean())
    check(agree == 1.0, f"obstacle: use_next agreement {agree}")
    err = max(compare(torch, "obstacle cost", cost_k, cost_r),
              compare(torch, "obstacle gradient", grad_k, grad_r))
    check(float(cost_r.abs().max()) > 0.0, "obstacle: no active hinge")
    t = timings(torch, lambda: sdf_lookup.obstacle(*oargs),
                lambda: sdf_lookup.obstacle_ref(*oargs))
    print(f"obstacle: use_next agreement {agree:.6f}, max_abs_err {err}, "
          f"per call {t[0]:.4f} ms vs plain {t[1]:.4f} ms, "
          f"device {t[2]} ms vs plain {t[3]} ms")
    # no single PyTorch call computes it: grid_sample interpolates
    # trilinearly, not with libcd's one-sided 4-cell rule
    results.append(kernel_entry(
        "obstacle", "or_cdchomp_tpu_torch/csrc/obstacle.cu",
        "or_cdchomp_tpu/ops/pallas_sdf.py:86", err, t,
        sdf_lookup.obstacle_traffic_bytes(m, S, B, F, mx, my, mz),
        sdf_lookup.obstacle_flops(m, S, B, F)))

    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    sargs = (x_mov, vel, xo, *engine.pairs, probs.epsilon_self,
             probs.obs_factor_self)
    P = engine.pairs[0].shape[0]
    SI = xo.shape[1]
    check((P, SI) == (207, 1), f"pair table size {P}, inactive spheres {SI}")
    info = selfcol.launch_info(S, SI)
    print(f"selfcol launch: {info['threads']} threads, "
          f"{info['smem_bytes']} B dynamic shared memory per block, "
          f"{info['blocks_per_sm']} blocks per SM, {info['registers']} "
          f"registers, {info['local_bytes']} B local (spill) per thread")
    votes, near, taken, reach = selfcol.vote_stats(
        x_mov, xo, *engine.pairs, probs.epsilon_self)
    print(f"selfcol skips on the flagship batch: of {votes} (point, pair, "
          f"32-problem warp) votes {near} pass the box test "
          f"({near / votes:.4f}) and {taken} are taken ({taken / votes:.4f}), "
          f"so the warp vote skips {(votes - taken) / votes:.4f}; "
          f"{reach} of {m * P * B} (point, pair, problem) in reach")
    net_k, c_k = selfcol.selfcol_pairs(*sargs)
    net_r, c_r = selfcol.selfcol_pairs_ref(*sargs)
    err = max(compare(torch, "selfcol net", net_k, net_r),
              compare(torch, "selfcol cost", c_k, c_r))
    again = selfcol.selfcol_pairs(*sargs)
    check(torch.equal(again[0], net_k) and torch.equal(again[1], c_k),
          "selfcol: two launches on the same inputs differ")
    t = timings(torch, lambda: selfcol.selfcol_pairs(*sargs),
                lambda: selfcol.selfcol_pairs_ref(*sargs))
    print(f"selfcol: max_abs_err {err}, per call {t[0]:.4f} ms vs plain "
          f"{t[1]:.4f} ms, device {t[2]} ms vs plain {t[3]} ms")
    # no single PyTorch call computes it (a pair gather, the hinge and two
    # index_add_ scatters at the least)
    results.append(kernel_entry(
        "selfcol", "or_cdchomp_tpu_torch/csrc/selfcol.cu",
        "or_cdchomp_tpu/ops/pallas_selfcol.py:197", err, t,
        selfcol.traffic_bytes(m, S, SI, B, P), selfcol.flops(m, B, P, reach)))
    for r in results:
        print(f"{r['name']}: device {r['ms']} ms, bound {r['bound_ms']} ms "
              f"({r['bound_by']}), share {r['bound_share']:.4f} on {card}")

    # -- the main path --------------------------------------------------------
    sdf_lookup.LAUNCHES = 0
    selfcol.LAUNCHES = 0
    solver = BatchSolver(engine)
    t0 = time.perf_counter()
    out, costs = solver.iterate(probs, N_ITER)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    launches = {"obstacle": sdf_lookup.LAUNCHES, "selfcol": selfcol.LAUNCHES}
    print(f"main path: {N_ITER} iterations at B={BATCH} in {first_wall:.3f} s "
          f"(first call), launches {launches}")
    for r in results:
        r["launches"] = launches[r["name"]]
        check(r["launches"] == N_ITER,
              f"{r['name']}: {r['launches']} launches, expected {N_ITER}")
    check(tuple(costs.shape) == (N_ITER, BATCH, 3), f"costs {costs.shape}")
    check(tuple(out.traj.shape) == (BATCH, N_POINTS, 7), "trajectory shape")
    check(bool(torch.isfinite(costs).all()), "non-finite costs")
    check(bool(torch.isfinite(out.traj).all()), "non-finite trajectories")
    c0 = float(costs[0, :, 0].mean())
    c1 = float(costs[-1, :, 0].mean())
    print(f"mean total cost: first iteration {c0:.6f}, last {c1:.6f}")
    check(c1 < c0, "the mean total cost did not fall")

    # -- warm wall of the flagship solve, before the CPU phase: the CPU's
    # worker threads slow a host-bound loop for seconds after a CPU solve
    walls = []
    for _ in range(7):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.iterate(probs, N_ITER)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    print(f"flagship iterate({N_ITER}) at B={BATCH}: median warm wall "
          f"{wall} s of {walls}, {BATCH / wall} solves/s on {card}")

    # -- the same solves on the CPU in float64 (plain versions) ---------------
    t0 = time.perf_counter()
    _, run64 = bench_module(pt, torch.float64, "cpu")
    p64 = problem_batch_from_grid(run64.problem, starts[:N_CHECK],
                                  goals[:N_CHECK], run64.engine)
    out64, _ = BatchSolver(run64.engine).iterate(p64, N_ITER)
    dtraj = float((out.traj[:N_CHECK].double().cpu() - out64.traj).abs().max())
    print(f"CPU float64 re-solve of {N_CHECK} problems: max |Δtraj| {dtraj} "
          f"(bar {TRAJ_BAR}), {time.perf_counter() - t0:.2f} s")
    check(dtraj <= TRAJ_BAR, f"max |Δtraj| {dtraj} > {TRAJ_BAR}")

    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseFailed as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
