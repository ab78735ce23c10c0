"""The port's string transport against the JAX package's
(tests/test_transport.py's cases, merged): the tokenizer, and command
strings through both packages' ``SendCommand`` on the same world at
float64 on the CPU, comparing run handles, iterate's cost (1e-9),
gettraj's JSON (1e-9), the .dat rows and the error messages (equal),
start_tsr over the wire included."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.tsr import TSR as JaxTSR
from or_cdchomp_tpu.utils import shparse as jsh

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.tsr import TSR
from or_cdchomp_tpu_torch.utils import shparse as tsh

from torch_parity import close, share_fields, start_tsr, table_module

RTOL = 1e-9
GOAL = "'0.6 0.7 0.1 1.4 0.0 -0.3 0.0'"


@pytest.mark.parametrize("text", [
    "create robot 'my robot' n_points 11", "a 'b c' \"d e\" f\\ g",
    "x 'it'\\''s'", "", "a \"q\\\"uote\" \"back\\\\slash\" \t\n b",
    "'unterminated", "trailing\\", "\"open"])
def test_shparse_matches_jax(text):
    try:
        want = jsh.shparse(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsh.shparse(text)
        assert str(got.value) == str(e)
        return
    assert tsh.shparse(text) == want


@pytest.mark.parametrize("s", ["simple", "two words", "it's", "a'b'c", ""])
def test_shquot_roundtrip(s):
    assert tsh.shquot(s) == jsh.shquot(s)
    assert tsh.shparse("cmd " + tsh.shquot(s)) == ["cmd", s]


@pytest.fixture(scope="module")
def mods():
    """The table world in each package, its field built by a command
    string; the port then takes the JAX field's values (see
    torch_parity.share_fields)."""
    out = []
    for pkg, kw in ((pt, dict(dtype=torch.float64, device="cpu")),
                    (oc, dict(dtype=jnp.float64))):
        mod = table_module(pkg, **kw)
        robot = mod.robots["wam"]
        robot.enabled = False
        assert mod.SendCommand(
            "computedistancefield kinbody 'table' cube_extent 0.15") == ""
        robot.enabled = True
        out.append(mod)
    return share_fields(*out)


_UP = [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0], [-np.pi, np.pi]]

# each case: command templates run in order; {run} is the handle the
# case's last create returned, {tsr} / {up} serialized TSRs
CASES = {
    "full_flow": [
        "create robot 'wam' adofgoal " + GOAL + " lambda 100.0000 "
        "obs_factor 500.000000 n_points 8 no_report_cost",
        "iterate run {run} n_iter 2", "gettraj run {run} no_collision_check",
        "destroy run {run}"],
    "start_tsr": [
        "create robot wam adofgoal " + GOAL + " n_points 9 lambda 150.0 "
        "start_tsr '{tsr}'",
        "iterate run {run} n_iter 2", "iterate run {run} n_iter 1",
        "gettraj run {run} no_collision_exception no_collision_details",
        "destroy run {run}"],
    "con_tsr_momentum": [
        "create robot wam adofgoal " + GOAL + " n_points 9 con_tsr 'end' "
        "'{up}' use_momentum epsilon 0.1 epsilon_self 0.04 "
        "obs_factor_self 10.0",
        "iterate run {run} n_iter 3", "gettraj run {run} no_collision_check",
        "destroy run {run}"],
    "everyn_starttraj": [
        "create robot wam starttraj "
        "'{{\"positions\": [[2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0], "
        "[0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0]]}}' n_points 7 "
        "everyn_tsr '{up}' derivative 1",
        "iterate run {run} n_iter 2", "gettraj run {run} no_collision_check",
        "destroy run {run}"],
    "bad_argument": ["iterate bogus 1"],
    "needs_value": ["create robot wam n_points"],
    "start_cost_on_wire": [
        "create robot wam adofgoal " + GOAL + " n_points 9 "
        "start_cost 0xdeadbeef"],
    "con_tsr_short": ["create robot wam con_tsr 'end'"],
    "unknown_command": ["frobnicate run run0"],
    "empty": ["   "],
    "bad_lambda": ["create robot wam adofgoal " + GOAL + " lambda 0.001"],
    "bad_tsr": ["create robot wam adofgoal " + GOAL + " start_tsr '1 2 3'"],
}


def _send(mod, text):
    """(kind, value): ("ok", output) or ("err", exception)."""
    try:
        return "ok", mod.SendCommand(text)
    except Exception as e:       # compared with the other package's
        return "err", e


@pytest.mark.parametrize("case", sorted(CASES))
def test_commands_match_jax(mods, case):
    tm, jm = mods
    fill = dict(tsr=start_tsr(TSR).serialize(),
                up=TSR.from_matrices(np.eye(4), np.eye(4),
                                     Bw=np.asarray(_UP)).serialize())
    assert fill["tsr"] == start_tsr(JaxTSR).serialize()
    run = None
    for tmpl in CASES[case]:
        text = tmpl.format(run=run, **fill)
        (jk, jv), (tk, tv) = _send(jm, text), _send(tm, text)
        assert jk == tk, (text, jv, tv)
        if jk == "err":
            assert type(tv) is type(jv) and str(tv) == str(jv), text
            continue
        cmd = text.split()[0]
        if cmd == "create":
            assert tv == jv
            run = tv
            if "start_tsr" in text:
                assert tm.runs[run].spec.start_tsr
                assert tm.runs[run].spec.m == tm.runs[run].n_points - 1
        elif cmd == "iterate":
            close(np.array(float(tv)), np.array(float(jv)), RTOL)
        elif cmd == "gettraj":
            td, jd = json.loads(tv), json.loads(jv)
            assert set(td) == set(jd)
            for k in jd:
                close(np.array(td[k]), np.array(jd[k]), RTOL)
        else:
            assert tv == jv == ""


@pytest.mark.parametrize("flag, rows", [("no_report_cost", 0), ("", 3)])
def test_no_report_cost_rows_match_jax(mods, flag, rows):
    """no_report_cost turns off the per-iteration cost rows in both."""
    got = []
    for mod in mods:
        h = mod.SendCommand(f"create robot wam adofgoal {GOAL} n_points 9 "
                            f"{flag}")
        mod.SendCommand(f"iterate run {h} n_iter 3")
        got.append(len(mod.runs[h].dat_rows))
        mod.SendCommand(f"destroy run {h}")
    assert got == [rows, rows]


def test_no_report_cost_still_writes_dat_file(mods, tmp_path):
    """The .dat rows are written whatever no_report_cost says
    (orcdchomp_mod.cpp:2810-2818), with the same iteration column."""
    cols = []
    for mod, name in zip(mods, ("port", "jax")):
        dat = tmp_path / f"{name}.dat"
        h = mod.SendCommand(f"create robot wam adofgoal {GOAL} n_points 9 "
                            f"no_report_cost dat_filename '{dat}'")
        mod.SendCommand(f"iterate run {h} n_iter 3")
        rows = np.loadtxt(dat, ndmin=2)
        assert rows.shape == (3, 5)
        cols.append(rows[:, [0, 2, 3, 4]])
        mod.SendCommand(f"destroy run {h}")
    close(cols[0], cols[1], RTOL)
