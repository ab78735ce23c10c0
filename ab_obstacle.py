"""K1 against an earlier design of it, on one card, in one process.

    python3 ab_obstacle.py PARENT_CU [--reps N] [--rounds N] [--out DIR]

PARENT_CU is the obstacle.cu of the design to compare with, for example
the parent commit's ``or_cdchomp_tpu_torch/csrc/obstacle.cu`` unpacked
into a directory that .gitignore lists.  It must export the first
design's ``cdx_obstacle`` (the wrapper's arguments, no launch geometry).
It is built alone with the library's flags into
``or_cdchomp_tpu_torch/build/ab/`` and loaded with its own ctypes
handle; so is this tree's obstacle.cu, for its compiler report only
(its timed calls go through the package).

On the inputs of chip_smoke.py's configurations (config 1, F = 1;
config 2, F = 3, on its own inputs and with the sphere cloud moved in;
config 5, B = 10,240) it holds both designs bit-equal to obstacle_ref,
with and without the one-sided choices out (the solve's path), then
times them in turns (earlier, this, this, earlier; ``--rounds`` times),
each reading the profiler's device time per call over ``--reps`` calls
of the solve's path.  It prints each build's registers, spills and
shared memory (ptxas), the static SASS instruction count of each
obstacle kernel (cuobjdump, where the toolkit has it; the listings go
to ``DIR/ab_sass_<build>.txt``), this design's launch per input, and
one JSON line per input; the lines are also written to
``DIR/ab_obstacle.json`` (DIR defaults to the build directory).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent


def build(src, name, kernels):
    """nvcc ``src`` alone with the library's flags; returns (path,
    ptxas report)."""
    out = kernels._BUILD / "ab" / f"lib{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([kernels._nvcc(), *kernels._FLAGS, "-shared", "-o",
                          str(out), str(src)], capture_output=True, text=True)
    log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc {src} failed:\n{log}")
    return out, log


def ptxas_lines(log):
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling" in ln]


def sass_counts(lib, kernels, listing):
    """Static SASS instructions per obstacle kernel of ``lib`` (None when
    the toolkit has no cuobjdump); the listing goes to ``listing``."""
    tool = shutil.which("cuobjdump") or str(
        Path(kernels._nvcc()).with_name("cuobjdump"))
    if not Path(tool).exists():
        return None
    res = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True)
    listing.write_text(res.stdout)
    counts, name = {}, None
    for ln in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if "obstacle_kernel" in m.group(1) else None
            if name:
                counts[name] = 0
        elif name and re.search(r"/\*[0-9a-f]{4,}\*/", ln):
            counts[name] += 1
    return counts


def parent_call(torch, lib, args, want_dirs=False):
    """The earlier design's cdx_obstacle on the wrapper's arguments."""
    x, vel, acc, data, sizes, lengths, pgw, pwg, en, radii, eps, of = args
    _, m, S, B = x.shape
    F, mx, my, mz = data.shape
    cost = torch.empty((m, S, B), device=x.device)
    wgrad = torch.empty((3, m, S, B), device=x.device)
    dirs = (torch.empty((F, m, S, B), dtype=torch.int32, device=x.device)
            if want_dirs else None)
    err = lib.cdx_obstacle(
        x.data_ptr(), vel.data_ptr(), acc.data_ptr(), m, S, B,
        data.data_ptr(), F, mx, my, mz, sizes.data_ptr(), lengths.data_ptr(),
        pgw.data_ptr(), pwg.data_ptr(), en.data_ptr(), radii.data_ptr(),
        eps.data_ptr(), of.data_ptr(), cost.data_ptr(), wgrad.data_ptr(),
        dirs.data_ptr() if want_dirs else None,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"cdx_obstacle: CUDA error {err}")
    return (cost, wgrad, dirs) if want_dirs else (cost, wgrad)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent_cu", type=Path)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import kernels, sdf_lookup
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    if not torch.cuda.is_available():
        print("ab_obstacle: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    out_dir = opts.out or kernels._BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    reports = {}
    parent_lib = None
    for name, src in (("parent", opts.parent_cu),
                      ("this", kernels._CSRC / "obstacle.cu")):
        lib_path, log = build(src, f"k1_{name}", kernels)
        reports[name] = dict(ptxas=ptxas_lines(log),
                             sass=sass_counts(lib_path, kernels,
                                              out_dir / f"ab_sass_{name}.txt"))
        for ln in reports[name]["ptxas"]:
            print(f"{name} ptxas: {ln}")
        print(f"{name} SASS instructions: {reports[name]['sass']}")
        if name == "parent":
            parent_lib = ctypes.CDLL(str(lib_path))
            parent_lib.cdx_obstacle.argtypes = kernels._SIGNATURES[
                "cdx_obstacle"][:22] + (ctypes.c_void_p,)
            parent_lib.cdx_obstacle.restype = ctypes.c_int

    dev = torch.device("cuda")
    f32 = torch.float32
    inputs = []
    _, run = cs.bench_module(pt, f32, dev)
    for label, batch in (("config 1", cs.BATCH), ("config 5", cs.BATCH_POD)):
        probs = problem_batch_from_grid(run.problem,
                                        *cs.bench_endpoints(batch),
                                        run.engine)
        _, x, v, a = cost_soa.sphere_kinematics(run.engine.spec,
                                                run.engine.fk, probs)
        inputs.append((label, cs.obstacle_args(run.engine, probs, x, v, a)))
    cs.CACHE_DIR.mkdir(parents=True, exist_ok=True)
    _, run2 = cs.config2_module(pt, f32, dev)
    probs2 = problem_batch_from_grid(run2.problem,
                                     *cs.bench_endpoints(cs.BATCH),
                                     run2.engine)
    _, x, v, a = cost_soa.sphere_kinematics(run2.engine.spec, run2.engine.fk,
                                            probs2)
    own2 = cs.obstacle_args(run2.engine, probs2, x, v, a)
    inputs.insert(1, ("config 2", own2))
    inputs.insert(2, ("config 2 moved in",
                      cs.moved_in_args(torch, own2, probs2)))

    lines = []
    for label, args in inputs:
        x, data = args[0], args[3]
        _, m, S, B = x.shape
        F, mx, my, mz = data.shape
        geom, _ = cs.k1_launch(torch, sdf_lookup, args, label)
        want = sdf_lookup.obstacle_ref(*args, want_dirs=True)
        designs = {
            "parent": lambda w=False: parent_call(torch, parent_lib, args, w),
            "this": lambda w=False: sdf_lookup.obstacle_launch(
                geom, *args, want_dirs=w)}
        for name, fn in designs.items():
            full, main_path = fn(True), fn(False)
            ok = (all(torch.equal(a, b) for a, b in zip(full, want))
                  and all(torch.equal(a, b) for a, b in zip(main_path, want)))
            cs.check(ok, f"{label}: {name} is not bit-equal to obstacle_ref")
        times = {name: [] for name in designs}
        order = list(designs) + list(designs)[::-1]
        for _ in range(opts.rounds):
            for name in order:
                times[name].append(cs.device_ms(torch, designs[name],
                                                opts.reps))
        nbytes = sdf_lookup.obstacle_traffic_bytes(m, S, B, F, mx, my, mz)
        line = dict(input=label, m=m, S=S, B=B, F=F,
                    stack_bytes=4 * data.numel(),
                    bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    ms=times, bit_equal=True, card=card)
        print(json.dumps(line))
        lines.append(line)
    (out_dir / "ab_obstacle.json").write_text(json.dumps(
        dict(card=card, builds=reports, inputs=lines), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
