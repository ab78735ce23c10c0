"""K2 against an earlier design of it, on one card, in one process.

    python3 ab_selfcol.py PARENT_CU [--reps N] [--rounds N] [--out DIR]

PARENT_CU is the selfcol.cu of the design to compare with, for example
the parent commit's ``or_cdchomp_tpu_torch/csrc/selfcol.cu`` unpacked
into a directory that .gitignore lists.  It must export the tiled
path's first design: ``cdx_selfcol`` / ``cdx_selfcol_f64`` with a global
scratch buffer (its pair matrices and per-tile boxes) as the last
argument before the stream.  It is built alone with the library's
flags into ``or_cdchomp_tpu_torch/build/ab/`` and loaded with its own
ctypes handle; so is this tree's selfcol.cu, for its compiler report
only (its timed calls go through the package, with the engine's pair
layout).

On chip_smoke.py's inputs (config 1, staged, the same code in both
builds; the 110-sphere grab at B = 256, float32, tiled; config 1's
world in float64 at B = 4, tiled) it holds both designs to
selfcol_pairs_ref (rtol 1e-5, float64 1e-12) and reports whether they
are bit-equal to each other, then times them in turns (earlier, this,
this, earlier; ``--rounds`` times), each reading the profiler's device
time per call (every kernel and memset of the call) over ``--reps``
calls.  It prints each build's registers and spills (ptxas) and one
JSON line per input; the lines are also written to
``DIR/ab_selfcol.json`` (DIR defaults to the build directory).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from ab_obstacle import build, ptxas_lines

ROOT = Path(__file__).resolve().parent


def parent_scratch_words(m, Sa, SI, B, itemsize):
    """The first tiled design's scratch, in 4-byte words: the (Sa, So)
    int32 pair indices padded to whole floats, then the (Sa, So) radius
    sums and 6 box floats per sphere, point and 32-problem tile."""
    So, per = Sa + SI, itemsize // 4
    return (-(-Sa * So // per) * per
            + per * (Sa * So + m * -(-B // 32) * 6 * So))


def parent_call(torch, lib, args):
    """The earlier design's K2 on the wrapper's arguments (its tiled path
    with a fresh scratch buffer, as its wrapper allocated one)."""
    xi, vel, xo, pi, pj, rsum, eps, obs = args[:8]
    _, m, Sa, B = xi.shape
    SI = xo.shape[1]
    f64 = xi.dtype == torch.float64
    net = torch.empty_like(xi)
    cost = torch.empty_like(xi[0])
    tiled = f64 or Sa + SI >= 118
    words = parent_scratch_words(m, Sa, SI, B, xi.dtype.itemsize)
    scratch = (torch.empty(words, dtype=torch.int32, device=xi.device)
               if tiled else None)
    fn = lib.cdx_selfcol_f64 if f64 else lib.cdx_selfcol
    err = fn(xi.data_ptr(), vel.data_ptr(), xo.data_ptr(), m, Sa, SI, B,
             pi.data_ptr(), pj.data_ptr(), rsum.data_ptr(), pi.shape[0],
             eps.data_ptr(), obs.data_ptr(), net.data_ptr(), cost.data_ptr(),
             None if scratch is None else scratch.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"parent cdx_selfcol: CUDA error {err}")
    return net, cost


def k2_args(torch, cost_soa, run, probs):
    """K2's arguments on a batch (the engine's layout last)."""
    eng = run.engine
    _, x, vel, _ = cost_soa.sphere_kinematics(eng.spec, eng.fk, probs)
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    return (x, vel, xo, *eng.pairs, probs.epsilon_self,
            probs.obs_factor_self, eng.pair_layout)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent_cu", type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path, default=None)
    opts = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.chomp import cost_soa
    from or_cdchomp_tpu_torch.ops import kernels, selfcol
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    if not torch.cuda.is_available():
        print("ab_selfcol: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    print(card)
    out_dir = opts.out or kernels._BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    reports = {}
    parent_lib = None
    for name, src in (("parent", opts.parent_cu),
                      ("this", kernels._CSRC / "selfcol.cu")):
        lib_path, log = build(src, f"k2_{name}", kernels)
        reports[name] = ptxas_lines(log)
        for ln in reports[name]:
            print(f"{name} ptxas: {ln}")
        if name == "parent":
            parent_lib = ctypes.CDLL(str(lib_path))
            for fn in (parent_lib.cdx_selfcol, parent_lib.cdx_selfcol_f64):
                fn.argtypes = kernels._SIGNATURES["cdx_selfcol"][:15] + (
                    ctypes.c_void_p, ctypes.c_void_p)
                fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    inputs = []
    mod, run = cs.bench_module(pt, torch.float32, dev)
    probs = problem_batch_from_grid(run.problem,
                                    *cs.bench_endpoints(cs.BATCH), run.engine)
    inputs.append(("config 1", k2_args(torch, cost_soa, run, probs)))
    cs.grab_tray(pt, mod)
    run = mod.runs[mod.create(**cs.run_kw())]
    probs = problem_batch_from_grid(run.problem,
                                    *cs.bench_endpoints(cs.BATCH), run.engine)
    inputs.append(("grab", k2_args(torch, cost_soa, run, probs)))
    _, run = cs.bench_module(pt, torch.float64, dev)
    probs = problem_batch_from_grid(run.problem,
                                    *cs.bench_endpoints(cs.F64_BATCH),
                                    run.engine)
    inputs.append(("float64", k2_args(torch, cost_soa, run, probs)))

    lines = []
    for label, args in inputs:
        x, xo = args[0], args[2]
        _, m, Sa, B = x.shape
        SI, P = xo.shape[1], args[3].shape[0]
        f64 = x.dtype == torch.float64
        rtol = cs.F64_KERNEL_RTOL if f64 else cs.KERNEL_RTOL
        want = selfcol.selfcol_pairs_ref(*args)
        designs = {"parent": lambda a=args: parent_call(torch, parent_lib, a),
                   "this": lambda a=args: selfcol.selfcol_pairs(*a)}
        got = {}
        for name, fn in designs.items():
            got[name] = fn()
            for g, w, part in zip(got[name], want, ("net", "cost")):
                cs.compare(torch, f"{label} {name} {part}", g, w, rtol=rtol)
        same = all(torch.equal(a, b)
                   for a, b in zip(got["parent"], got["this"]))
        per_call = {name: cs.kernels_per_call(torch, fn)
                    for name, fn in designs.items()}
        times = {name: [] for name in designs}
        order = list(designs) + list(designs)[::-1]
        for _ in range(opts.rounds):
            for name in order:
                times[name].append(cs.device_ms(torch, designs[name],
                                                opts.reps))
        nbytes = selfcol.traffic_bytes(m, Sa, SI, B, P, x.dtype.itemsize)
        line = dict(input=label, m=m, Sa=Sa, SI=SI, B=B, P=P,
                    dtype=str(x.dtype).removeprefix("torch."),
                    path=selfcol.launch_shape(Sa, SI, x.dtype.itemsize)[0],
                    bound_ms=nbytes / cs.HBM_BYTES_PER_S * 1e3,
                    kernels_per_call=per_call, ms=times,
                    bit_equal_to_parent=same, card=card)
        print(json.dumps(line))
        lines.append(line)
    (out_dir / "ab_selfcol.json").write_text(json.dumps(
        dict(card=card, builds=reports, inputs=lines), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
