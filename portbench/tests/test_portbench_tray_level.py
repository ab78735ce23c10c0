"""CPU tests of the cells ``tray_level.batch256`` (config
``wam7_tray_level``: 126 spheres and the upright TSR on a fixed base)
and ``table_mug.sweep10240x4`` (config 1's pod sweep over four cards),
through the harness's existing checks: each resolves to its files, its
inputs are seeded, its shapes are those the cell promises (the tray's
125 active spheres and 3,617 pairs; 2,560 rows on each of four cards),
and a run whose timed path is broken comes out not correct, the cards
stood for by replicas on the CPU.  Also the three step-phase readers
(``selfcol_ms.batch``, ``jtmap_ms.batch``, ``velsaccs_ms.batch``) on a
made-up recording, and their None where the program records nothing.

    python -m pytest portbench/tests/test_portbench_tray_level.py -q
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

CHECKOUT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(CHECKOUT))

from portbench import harness, traffic, world  # noqa: E402
from portbench.tests.test_portbench_harness import (  # noqa: E402
    BENCH, FAULTS, TINY, TINY_MIX, _faults, tiny_run)
from portbench.tests.test_program_spans import (  # noqa: E402
    OFF, _rec, _replay_events, _span, _trace, _ranges)
from portbench.roofline import counts  # noqa: E402
from or_cdchomp_tpu_torch.ops import selfcol  # noqa: E402
from or_cdchomp_tpu_torch.utils import profiling  # noqa: E402

TRAY = "tray_level.batch256"
X4 = "table_mug.sweep10240x4"
NEW_CELLS = [TRAY, X4]
READERS = {"selfcol_ms.batch": "selfcol", "jtmap_ms.batch": "jtmap",
           "velsaccs_ms.batch": "pre_velsaccs"}


def _tiny_traffic(name, seed, devices=None):
    cell = harness.resolve(BENCH, name)
    w = world.build(harness._apply(cell.config, TINY), "cpu")
    devices = devices or [torch.device("cpu")] * cell.chips
    return w, traffic.make(w, dict(cell.mix, **TINY_MIX), seed,
                           lambda name: contextlib.nullcontext(), devices)


@pytest.mark.parametrize("name,config,traffic_,chips", [
    (TRAY, "wam7_tray_level", "batch256", 1),
    (X4, "wam7_table_mug", "batch10240x4", 4)])
def test_new_cells_resolve_to_their_files(name, config, traffic_, chips):
    w = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (w["config"], w["traffic"], w["chips"]) == (config, traffic_,
                                                       chips)
    cell = harness.resolve(BENCH, name)
    assert cell.config["name"] == config and cell.chips == chips
    assert cell.mix["driver"] == "batch" and cell.limits
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                    "solves_per_s"}
    names = {m["name"] for m in cell.per_layer}
    for m in names:
        assert callable(harness.reader(m))
    assert {"step_device_ms.batch", "k2_roofline"} <= names
    if name == TRAY:
        assert set(READERS) <= names


def test_four_card_mix_is_the_sweeps_traffic():
    """The four-card cell's mix is a file of its own (a configuration and
    a mix name one cell) with the one-card sweep's parameters."""
    x4 = harness.resolve(BENCH, X4).mix
    one = harness.resolve(BENCH, "table_mug.sweep10240").mix
    keys = ("driver", "batch", "check_rows")
    assert [x4[k] for k in keys] == [one[k] for k in keys]
    assert set(x4) == set(one)


def test_tray_cell_shape():
    w, tr = _tiny_traffic(TRAY, 2 ** 31 + 3)
    s = harness.shape(w, tr)
    assert (s["S"], s["SI"], s["P"], s["n"]) == (125, 1, 3617, 7)
    assert s["fields"] == (1, 23, 31, 23) and s["itemsize"] == 4
    assert w.run.engine.cons.k_total == 2 * s["m"]
    assert not w.run.spec.floating_base and tr.keep is None
    # k2_roofline's frozen counts at the cell's full shape equal the port's
    m, B = 99, 256
    assert counts.selfcol_bytes(m, 125, 1, B, 3617) == \
        selfcol.traffic_bytes(m, 125, 1, B, 3617)
    assert counts.selfcol_flops(m, B, 3617, 0) == selfcol.flops(m, B, 3617, 0)


def test_four_card_cell_splits_its_batch_over_four_replicas():
    cell = harness.resolve(BENCH, X4)
    w = world.build(harness._apply(cell.config, TINY), "cpu")
    tr = traffic.make(w, cell.mix, 2 ** 31 + 3,
                      lambda name: contextlib.nullcontext(),
                      [torch.device("cpu")] * 4)
    assert tr.B == 10240
    assert tr.parts == [(0, 2560), (2560, 5120), (5120, 7680),
                        (7680, 10240)]
    assert harness.shape(w, tr)["B"] == 2560
    # the drawn rows come from every card's part alike
    tr.records = [None] * 5
    picks = tr.picks(np.random.default_rng(1))
    assert len(picks) == cell.mix["check_rows"]
    for k, (lo, hi) in enumerate(tr.parts):
        part = picks[k * 16:(k + 1) * 16]
        assert all(lo <= r < hi for _, r in part)


@pytest.mark.parametrize("name", NEW_CELLS)
def test_new_cells_give_the_same_inputs_for_a_seed(name):
    got = []
    for seed in (2 ** 33 + 1, 2 ** 33 + 1, 2 ** 33 + 2):
        _, tr = _tiny_traffic(name, seed)
        tr.unit(0)
        got.append(tr.records[0][:2])
    assert all(np.array_equal(a, b) for a, b in zip(got[0], got[1]))
    assert not np.array_equal(got[0][0], got[2][0])


@pytest.mark.parametrize("name,fault", [(n, f) for n in NEW_CELLS
                                        for f in _faults(n)])
def test_a_broken_timed_path_is_not_correct(name, fault):
    kw = {}
    if fault == "one_in_eight":
        cell = harness.resolve(BENCH, name)
        kw = dict(seconds=0.0, mix=dict(batch=64,
                                        check_rows=cell.mix["check_rows"]))
    assert tiny_run(name, **kw)["correct"] is True
    bad = tiny_run(name, fault=FAULTS[fault], **kw)
    assert bad["correct"] is False, bad["checks"]


# ---- the step-phase readers -------------------------------------------------

PHASES = (("fk", 1), ("pre_velsaccs", 2), ("selfcol", 1), ("jtmap", 3),
          ("constraint", 2), ("other", 1))
DUR = [1e-6, 2e-6, 3e-6, 4e-6, 1e-6, 1e-6, 1e-6, 5e-6, 6e-6, 1e-6]


def _maps():
    return {card: profiling.NodeMap(40 + card, card, PHASES, "k" * 10)
            for card in (0, 1)}


def _card_events(card, scale):
    names = [f"kernel_{i}" for i in range(10)]
    ev, t = [], OFF + 0.1
    for _ in range(2):
        block, t = _replay_events(t, names, [d * scale for d in DUR], card)
        ev += block
        t += 1e-6
    return ev


def test_step_phase_readers_on_a_recording(monkeypatch):
    build = _span("batch.build", 0, 3000)
    solve = _span("batch.solve", 3010, 9000)
    maps = _maps()
    spans = [build, solve] + [
        _span("step.replay", 3100 + 100 * i, 3150 + 100 * i, parent=1,
              tag=maps[i % 2]) for i in range(4)]
    monkeypatch.setattr(profiling, "recorded", lambda: _rec(spans))
    # card 1's replays take twice card 0's time
    ev = _card_events(0, 1.0) + _card_events(1, 2.0)
    t = _trace(_ranges(("build", build, 1, 1), ("solve", solve, 1, 1)), ev,
               cards=(0, 1), device_spans={c: [("solve", OFF, OFF + 1.0)]
                                           for c in (0, 1)})
    # the mean over four replays, two a card: 1.5 times card 0's
    want = {"selfcol_ms.batch": 4e-3, "jtmap_ms.batch": 3e-3,
            "velsaccs_ms.batch": 5e-3}
    for m, v in want.items():
        assert harness.reader(m)(t) == pytest.approx(1.5 * v), m


@pytest.mark.parametrize("rec", [None, "no recorder", "empty"])
def test_step_phase_readers_read_nothing_without_the_programs_spans(
        monkeypatch, rec):
    """A program without the recorder, or a recording that holds
    nothing: each reader returns None and raises nothing."""
    if rec == "no recorder":
        monkeypatch.delattr(profiling, "recorded")
    else:
        monkeypatch.setattr(profiling, "recorded", lambda: (
            None if rec is None else profiling.Recording()))
    t = _trace([("solve", 0.0, 1.0)], _card_events(0, 1.0),
               device_spans={0: [("solve", 0.0, 1.0)]})
    for m in READERS:
        assert harness.reader(m)(t) is None, m


def test_step_phase_readers_are_declared():
    per = {m["name"]: m for m in BENCH["per_layer"]}
    batch = ["table_mug.batch256", "floating_tsr.batch256",
             "table_mug.sweep10240", TRAY]
    for m, phase in READERS.items():
        assert phase in profiling.PHASES
        assert per[m]["workloads"] == batch
        assert (per[m]["source"], per[m]["unit"], per[m]["moves"]) == (
            "device_trace", "ms", "solves_per_s")
