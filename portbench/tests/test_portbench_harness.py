"""CPU tests of the benchmark's harness: cells resolve to their files,
the traffic is seeded, the reference agrees with the port's CPU float64
path, the frozen roofline counts equal the port's, run.py refuses a
machine without a card, nothing loads JAX, and a run whose timed path
is broken comes out not correct (a step that returns its state
unchanged, half a batch left unsolved, an answer altered where it is
produced, one row or request in eight altered, and in a four-card cell
the exchange between cards left out).

    python -m pytest portbench/tests -q
"""

import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import harness, traffic, world  # noqa: E402
from portbench.reference import chomp as reference  # noqa: E402
from portbench.roofline import counts  # noqa: E402

CONFIGS = CHECKOUT / "portbench" / "configs"
BENCH = harness.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# a cell shrunk to a CPU test: 9 points, 4 iterations, batches of 4
TINY = {"create.n_points": 9, "n_iter": 4}
TINY_MIX = {"batch": 4, "check_rows": 4, "check_requests": 2}


def tiny_run(name, seed=2 ** 31 + 11, seconds=0.3, mix=None, **kw):
    cell = harness.resolve(BENCH, name)
    return harness.run(cell, seed, seconds, device="cpu", config=TINY,
                       mix=dict(TINY_MIX, **(mix or {})),
                       log=lambda *a: None, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = harness.resolve(BENCH, name)
    assert cell.config["name"] in {c["name"] for c in BENCH["configs"]}
    assert cell.mix["driver"] in ("batch", "plan")
    assert cell.limits
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


def test_benchmark_names_and_files():
    for c in BENCH["configs"]:
        assert (CHECKOUT / c["file"]).is_file()
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
        assert set(m["workloads"]) <= set(CELLS)


@pytest.mark.parametrize("floating", [False, True])
def test_endpoints_are_seeded(floating):
    start, goal = np.arange(14.0), np.arange(14.0) + 1
    keep = slice(3, 7) if floating else None
    a = traffic.endpoints(2 ** 31 + 5, 3, start, goal, 0.02, 8, keep)
    b = traffic.endpoints(2 ** 31 + 5, 3, start, goal, 0.02, 8, keep)
    c = traffic.endpoints(2 ** 31 + 6, 3, start, goal, 0.02, 8, keep)
    d = traffic.endpoints(2 ** 31 + 5, 4, start, goal, 0.02, 8, keep)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0]) and not np.array_equal(a[0], d[0])
    if floating:
        assert np.array_equal(a[0][:, 3:7], np.tile(start[3:7], (8, 1)))


@pytest.mark.parametrize("name", ["table_mug.batch256", "table_mug.runchomp"])
def test_drivers_give_the_same_inputs_for_a_seed(name):
    cell = harness.resolve(BENCH, name)
    cfg = harness._apply(cell.config, TINY)
    w = world.build(cfg, "cpu")
    mix = dict(cell.mix, **TINY_MIX)
    got = []
    for seed in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2):
        tr = traffic.make(w, mix, seed, lambda name: contextlib.nullcontext(),
                          [torch.device("cpu")])
        tr.unit(0)
        tr.unit(1)
        got.append([r[:2] for r in tr.records])
    same = [all(np.array_equal(a, b) for ra, rb in zip(got[0], g)
                for a, b in zip(ra, rb)) for g in got[1:]]
    assert same == [True, False]


def _port_batch(cfg, starts, goals, n_iter):
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    w = world.build(cfg, "cpu", torch.float64)
    probs = problem_batch_from_grid(w.run.problem, starts, goals,
                                    w.run.engine)
    out, fin, _ = BatchSolver(w.run.engine).solve(probs, n_iter)
    return w, out.traj.numpy(), fin.numpy()


@pytest.mark.parametrize("config", ["wam7_table_mug", "wam7_floating_tsr"])
def test_reference_agrees_with_the_port_in_float64(config):
    cfg = world.load(CONFIGS / f"{config}.json")
    cfg["create"]["n_points"] = 11
    cfg["n_iter"] = 3
    ref = reference.Solver(cfg, "cpu")
    w = world.build(cfg, "cpu", torch.float64)
    traj = w.run.problem.traj.double().numpy()
    keep = slice(3, 7) if ref.floating else None
    starts, goals = traffic.endpoints(7, 0, traj[0], traj[-1], 0.02, 3, keep)
    # the field: the same occupancy, values to the port's float32
    field = w.run.engine.fields.data[0].double().numpy()
    assert np.array_equal(field <= 0, ref.fd[0].numpy() <= 0)
    assert np.abs(field - ref.fd[0].numpy()).max() < 1e-6
    _, T, F = _port_batch(cfg, starts, goals, 3)
    T_ref, F_ref = ref.solve(starts, goals)
    assert np.abs(T - T_ref.numpy()).max() < 1e-6
    assert np.abs(F - F_ref.numpy()).max() < 1e-5
    moved = T_ref.numpy() - ref.lines(starts, goals).numpy()
    assert np.abs(moved).max() > 1e-4


def test_reference_agrees_with_itself():
    cfg = world.load(CONFIGS / "wam7_table_mug.json")
    cfg["create"]["n_points"] = 9
    cfg["n_iter"] = 2
    s, g = traffic.endpoints(1, 0, np.array(cfg["robot"]["start"]),
                             np.array(cfg["create"]["adofgoal"]), 0.02, 4)
    a = reference.Solver(cfg, "cpu").solve(s, g)
    b = reference.Solver(cfg, "cpu").solve(s[:2], g[:2])
    assert torch.equal(a[0][:2], b[0]) or \
        float((a[0][:2] - b[0]).abs().max()) < 1e-12


def test_reference_check_of_a_colliding_line():
    cfg = world.load(CONFIGS / "wam7_table_mug.json")
    ref = reference.Solver(cfg, "cpu")
    start = np.array(cfg["robot"]["start"])
    line = np.linspace(start, [0.0, 1.5, 0.0, 0.5, 0.0, 0.0, 0.0], 20)
    ok = np.linspace(start, cfg["create"]["adofgoal"], 20)
    assert ref.collides(np.stack([line, ok[:1].repeat(20, 0)]),
                        start).tolist() == [True, False]


def test_frozen_counts_equal_the_port():
    from or_cdchomp_tpu_torch.ops import limits, sdf_lookup, selfcol

    for cell in CELLS:
        c = harness.resolve(BENCH, cell)
        kw = c.config["create"]
        m = kw["n_points"] - 2
        S = 16 if kw.get("floating_base") else 15
        SI = 16 - S
        B = c.mix.get("batch", 1) // c.chips
        for F, dims in ((1, (23, 31, 23)), (1, (12, 16, 12)), (3, (9, 9, 9))):
            for item in (4, 8):
                got = counts.obstacle_bytes(m, S, B, F, *dims, itemsize=item)
                assert got == sdf_lookup.obstacle_traffic_bytes(
                    m, S, B, F, *dims, itemsize=item)
            assert counts.obstacle_flops(m, S, B, F) == \
                sdf_lookup.obstacle_flops(m, S, B, F)
        for P in (207, 240):
            assert counts.selfcol_bytes(m, S, SI, B, P) == \
                selfcol.traffic_bytes(m, S, SI, B, P)
            assert counts.selfcol_flops(m, B, P, 1234) == \
                selfcol.flops(m, B, P, 1234)
        n = 14 if kw.get("floating_base") else 7
        assert counts.limits_bytes(B, m, n) == limits.traffic_bytes(B, m, n, 4)
        stats = torch.tensor([[2, 5]] * B)
        assert counts.limits_flops(m, n, 2 * B, 5 * B, B) == \
            limits.flops(m, n, stats)


def test_config_robot_is_the_builtin_wam7():
    import or_cdchomp_tpu_torch as pt

    cfg = world.load(CONFIGS / "wam7_table_mug.json")
    got, want = world.robot_model(cfg), pt.wam7()
    for k in ("parent", "origin", "jtype", "axis", "dof_index",
              "dof_limits_lower", "dof_limits_upper", "dof_max_vel",
              "sphere_link", "sphere_pos", "sphere_radius", "ee_origin"):
        assert np.allclose(getattr(got, k), getattr(want, k), atol=1e-15), k


def test_run_exits_without_a_card():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        CELLS[0], "--seed", str(2 ** 31 + 3), "--seconds", "1",
                        "--trace", "0"], cwd=CHECKOUT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "{" not in p.stdout


def test_nothing_loads_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from portbench import harness;"
            "cell = harness.resolve(harness.load_benchmark(), "
            f"'{CELLS[0]}');"
            "harness.run(cell, 5, 0.1, device='cpu', config="
            f"{TINY!r}, mix={TINY_MIX!r}, log=lambda *a: None);"
            "import torch.profiler;"
            "print(sorted({k.split('.')[0] for k in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=CHECKOUT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    loaded = set(json.loads(p.stdout.strip().splitlines()[-1]
                            .replace("'", '"')))
    assert "or_cdchomp_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(harness.FORBIDDEN)


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("or_cdchomp_tpu_torch_like", sys)
    try:
        assert harness.forbidden_modules() == []
    finally:
        del sys.modules["or_cdchomp_tpu_torch_like"]


# ---- the timed path broken underneath: correct comes out false -------------

@contextlib.contextmanager
def _patch(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


def unchanged():
    """A step that returns its state unchanged."""
    from or_cdchomp_tpu_torch.chomp.solver import ChompEngine

    def step(self, probs, zu):
        return probs, probs.traj.new_zeros((probs.traj.shape[0], 3))
    return _patch(ChompEngine, "_step", step)


def half():
    """Half of the batch left out: its rows come back unsolved."""
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver
    solve = BatchSolver.solve

    def half_solve(self, probs, n_iter, chunk=10, tol=None):
        out, fin, done = solve(self, probs, n_iter, chunk, tol)
        k = probs.traj.shape[0] // 2
        out.traj[k:] = probs.traj[k:]
        return out, fin, done
    return _patch(BatchSolver, "solve", half_solve)


def altered():
    """An answer altered where it is produced: the returned trajectories'
    middle point moved by 5e-3 rad on one joint."""
    from or_cdchomp_tpu_torch.api import CHOMPModule
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver
    solve, gettraj = BatchSolver.solve, CHOMPModule.gettraj

    def alter_solve(self, probs, n_iter, chunk=10, tol=None):
        out, fin, done = solve(self, probs, n_iter, chunk, tol)
        out.traj[:, out.traj.shape[1] // 2, 2] += 5e-3
        return out, fin, done

    def alter_gettraj(self, *a, **k):
        out = gettraj(self, *a, **k)
        out.positions[len(out.positions) // 2, 2] += 5e-3
        return out

    @contextlib.contextmanager
    def both():
        with _patch(BatchSolver, "solve", alter_solve), \
                _patch(CHOMPModule, "gettraj", alter_gettraj):
            yield
    return both()


def one_in_eight():
    """One row in eight altered where it is produced: every eighth
    returned trajectory's middle point moved by 5e-3 rad on one joint
    (every eighth request's, in a plan cell)."""
    from or_cdchomp_tpu_torch.api import CHOMPModule
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver
    solve, gettraj = BatchSolver.solve, CHOMPModule.gettraj
    calls = [0]

    def alter_solve(self, probs, n_iter, chunk=10, tol=None):
        out, fin, done = solve(self, probs, n_iter, chunk, tol)
        out.traj[::8, out.traj.shape[1] // 2, 2] += 5e-3
        return out, fin, done

    def alter_gettraj(self, *a, **k):
        out = gettraj(self, *a, **k)
        if calls[0] % 8 == 0:
            out.positions[len(out.positions) // 2, 2] += 5e-3
        calls[0] += 1
        return out

    @contextlib.contextmanager
    def both():
        with _patch(BatchSolver, "solve", alter_solve), \
                _patch(CHOMPModule, "gettraj", alter_gettraj):
            yield
    return both()


def exchange():
    """The exchange between cards left out: the gather joins the engine's
    card's part once for every part, so no other card's rows reach it."""
    from or_cdchomp_tpu_torch.parallel.batch import BatchSolver

    def home_only(self, tensors):
        return torch.cat([tensors[0].to(self._home)] * len(tensors))
    return _patch(BatchSolver, "_gather", home_only)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered,
          "one_in_eight": one_in_eight, "exchange": exchange}


def _faults(name):
    cell = harness.resolve(BENCH, name)
    out = ["unchanged", "altered"]
    if cell.mix["driver"] == "batch":
        # a plan cell's 8 drawn requests miss one request in eight with
        # probability (7/8)**8, about a third: its check is held to the
        # answers altered, not to one in eight
        out += ["half", "one_in_eight"]
    if cell.chips > 1:
        out.append("exchange")
    return out


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in _faults(n)])
def test_a_broken_timed_path_is_not_correct(name, fault):
    kw = {}
    if fault == "one_in_eight":
        # drawn as the cell draws, as many rows as the cell's mix has, from
        # a window of one batch of 64 (a window of no seconds runs one
        # unit), so that the rows drawn do not hang on the CPU's speed
        cell = harness.resolve(BENCH, name)
        kw = dict(seconds=0.0, mix=dict(batch=64,
                                        check_rows=cell.mix["check_rows"]))
    assert tiny_run(name, **kw)["correct"] is True
    bad = tiny_run(name, fault=FAULTS[fault], **kw)
    assert bad["correct"] is False, bad["checks"]


def test_readers_on_a_made_up_trace():
    from portbench import tracing
    from portbench.roofline import peaks

    spans = tracing.Spans()
    spans.items += [("build", 0.0, 0.002), ("solve", 0.002, 0.010),
                    ("build", 0.010, 0.014)]
    ev = [tracing.Event("obstacle_kernel", 0.003, 0.004, 0),
          tracing.Event("selfcol_kernel", 0.0035, 0.005, 0),
          tracing.Event("Memcpy HtoD", 0.006, 0.007, 0),
          tracing.Event("obstacle_kernel", 0.003, 0.005, 1)]
    sizes = dict(m=99, S=15, SI=1, P=207, fields=(1, 12, 16, 12), B=256,
                 n=7, n_iter=100, itemsize=4)
    t = tracing.Trace(spans, ev, [("solve", 0.002, 0.010)],
                      (0.002, 0.010), 2, [0, 1], sizes,
                      {0: [("solve", 0.0025, 0.0065)],
                       1: [("solve", 0.0025, 0.0065)]}, 1, [0.006, 0.010])
    read = {m: harness.reader(m)(t) for m in (
        "build_ms.batch", "step_device_ms.batch", "kernels_per_step.batch",
        "k1_roofline", "device_idle_pct.batch", "device_idle_pct.plan",
        "create_ms.plan")}
    assert read["build_ms.batch"] == pytest.approx(3.0)
    assert read["create_ms.plan"] is None
    # card 0 busy 3 ms (union of 3–5 and 6–7 ms), card 1 2 ms; 2 steps
    assert read["step_device_ms.batch"] == pytest.approx(1.25)
    assert read["kernels_per_step.batch"] == pytest.approx(0.75)
    least = peaks.bound_s(counts.obstacle_bytes(99, 15, 256, 1, 12, 16, 12),
                          counts.obstacle_flops(99, 15, 256, 1))
    assert read["k1_roofline"] == pytest.approx(
        100 * least / 0.0015)
    # card 1 busy 2 ms of the window's mean unit, 8 ms
    assert read["device_idle_pct.batch"] == pytest.approx(75.0)
    assert read["device_idle_pct.plan"] == read["device_idle_pct.batch"]
    b = tracing.breakdown(t)
    assert b["device_ops"][0] == ["obstacle_kernel", pytest.approx(0.003)]
    assert dict(b["idle_gaps"]) == {"solve": pytest.approx(0.011)}


def test_markers_map_spans_to_the_card():
    from portbench import tracing

    M = "void at::cuda::spin_kernel(long)"
    # host: build 1.000-1.002 s, solve 1.002-1.003 s on card 0; the
    # profiler's clock runs 5 s ahead, and each launch starts 10 us later
    marks = [("build", "begin", 0, 1.000), ("build", "end", 0, 1.002),
             ("solve", "begin", 0, 1.0021), ("solve", "end", 0, 1.003)]
    items = [("build", 1.000, 1.002), ("solve", 1.0021, 1.003)]
    ev = [tracing.Event(M, 6.00001, 6.000012, 0),
          tracing.Event("fill", 6.0001, 6.0019, 0),
          tracing.Event(M, 6.0020, 6.002002, 0),
          tracing.Event(M, 6.0022, 6.002202, 0),
          tracing.Event("obstacle_kernel", 6.0025, 6.0060, 0),
          tracing.Event(M, 6.0061, 6.006102, 0)]
    work, ranges, dev, window = tracing.split_markers(ev, marks, items,
                                                     (0.9999, 1.0070))
    assert [e.name for e in work] == ["fill", "obstacle_kernel"]
    assert window == pytest.approx((5.99991, 6.00701))
    assert ranges[1] == ("solve", pytest.approx(6.00211),
                         pytest.approx(6.00301))
    assert dev == {0: [("build", 6.00001, 6.0020),
                       ("solve", 6.0022, 6.0061)]}
    t = tracing.Trace(None, work, ranges, window, 1, [0], {}, dev)
    assert [e.name for e in t.in_span("solve", 0)] == ["obstacle_kernel"]
    with pytest.raises(RuntimeError, match="marker"):
        tracing.split_markers(ev[:-1], marks, items, (0.9999, 1.0070))
