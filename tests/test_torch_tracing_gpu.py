"""The recorder's card-side facts (utils/profiling.py): a replayed step's
node map counts the events the profiler reports of a replay, and the
``host_sync`` counter counts the syncs torch's sync debug mode reports
over one request.  Skipped without a CUDA device; run on the card with
``python -m pytest tests/test_torch_tracing_gpu.py -q --noconftest``
(tests/conftest.py configures JAX, which that machine does not have)."""

import warnings
from collections import defaultdict

import numpy as np
import pytest
import torch

from or_cdchomp_tpu_torch.utils import profiling

pytestmark = pytest.mark.gpu

START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
GOAL = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _module(device):
    """BASELINE config 1's world: the WAM7 with its hand over the table
    and the mug, one field at the default extent."""
    import or_cdchomp_tpu_torch as pt

    mod = pt.CHOMPModule(dtype=torch.float32, device=device)
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(boxes=[
        ((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
        ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(pt.KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = pt.Robot("wam", pt.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table")
    robot.enabled = True
    return mod


KW = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
          n_points=101)


def _settle(device):
    x = torch.zeros(8, device=device)
    for _ in range(8):
        x.add_(1)
    torch.cuda.synchronize(device)


def _kinds(events):
    """One letter an event: a memcpy node shows as "Memcpy DtoD ..." (a
    copy engine) or as CUDA's "memcpy32_post" kernel (an SM)."""
    return "".join({"memcpy": "c", "memset": "s"}.get(e.name[:6].lower(),
                                                     "k") for e in events)


def _device_events(prof):
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def test_node_map_counts_the_events_of_a_replay(cuda):
    """B = 256 at n_points 101, profiled as the benchmark profiles (CUDA
    activity alone): a replay's events share its launch's correlation
    id, and every replay the profiler kept whole has as many events as
    the step graph's node map has nodes, in the map's kinds; none has
    more.  The map charges nodes to the step's phases; with the host's
    events recorded too, phase_kernels charges each whole replay's K1 to
    ``obstacle`` by it."""
    from torch.profiler import ProfilerActivity, profile

    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    mod = _module(cuda)
    run = mod.runs[mod.create(**KW)]
    rng = np.random.default_rng(3)
    B, reps = 256, 10
    probs = problem_batch_from_grid(
        run.problem, START + 0.02 * rng.normal(size=(B, 7)),
        GOAL + 0.02 * rng.normal(size=(B, 7)), run.engine)
    run.engine.iterate_batched(probs, 2)             # the capture
    torch.cuda.synchronize()
    with profiling.recording() as rec:               # a new recording
        pass
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _settle(cuda)
        run.engine.iterate_batched(probs, reps)
        _settle(cuda)
    m = run.engine.stepper(probs).node_map
    # the whole step: its FK (csrc/fk.cu) and its Jᵀ map (csrc/jtmap.cu)
    # one kernel node each among ~41
    assert m is not None and m.nodes > 30
    assert m.per_node().count("fk") == 1
    assert m.per_node().count("jtmap") == 1
    # a CUDA-only profile records: each replay's span, tagged by the map
    assert profiling.recorded() is rec and rec.node_maps == {m.key: m}
    assert [s.tag for s in rec.named("step.replay")] == [m] * reps
    assert {"fk", "obstacle", "selfcol", "jtmap", "smoothgrad", "limits",
            "smoothcost", "other"} <= {ph for ph, _ in m.phases}
    groups = defaultdict(list)
    for e in _device_events(prof):
        groups[e.id].append(e)
    replays = [g for g in groups.values() if len(g) > 1]
    sizes = sorted(len(g) for g in replays)
    assert len(replays) == reps and max(sizes) == m.nodes, sizes
    whole = [sorted(g, key=lambda e: e.time_range.start) for g in replays
             if len(g) == m.nodes]
    assert len(whole) >= reps - 2, sizes
    for g in whole:
        assert _kinds(g) == m.kinds, [e.name[:40] for e in g[-12:]]
    names = [e.name for e in whole[0]]
    per = m.per_node()
    k1 = [ph for n, ph in zip(names, per) if "obstacle_kernel" in n]
    assert k1 == ["obstacle"]

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _settle(cuda)
        run.engine.iterate_batched(probs, reps)
        _settle(cuda)
    charged = [ph for name, ph, _ in profiling.phase_kernels(prof)
               if "obstacle_kernel" in name]
    assert len(charged) <= reps and charged.count("obstacle") >= reps - 2, \
        charged


def _request(mod, q):
    mod.robots["wam"].q_active = q
    h = mod.create(**KW)
    try:
        mod.iterate(run=h, n_iter=100)
        mod.gettraj(run=h, no_collision_exception=True,
                    no_collision_details=True)
    finally:
        mod.destroy(run=h)


def test_host_sync_counts_the_syncs_of_a_request(cuda):
    """One runchomp request (create, iterate 100, gettraj with its check,
    destroy) after a warm one: the ``host_sync`` counter equals the syncs
    torch's sync debug mode reports, and no engine or graph is built."""
    mod = _module(cuda)
    _request(mod, START)
    torch.cuda.synchronize()
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with profiling.recording() as rec:
                _request(mod, START + 0.01)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = [w for w in caught
             if "synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) >= 9
    assert rec.counters["host_sync"] == len(syncs)
    assert rec.counters["engine_cache.hit"] == 1
    assert rec.counters["engine_cache.miss"] == 0
    assert rec.counters["graph.capture"] == 0
