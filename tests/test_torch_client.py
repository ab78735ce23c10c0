"""The port's client (kwargs → command strings → SendCommand) against the
JAX package's (tests/test_client.py's cases, merged): the same calls
through both packages' clients on the same world at float64 on the CPU
give the same command strings, handles, costs (1e-9), trajectories
(1e-9), .dat files and error messages."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu import client as jclient
from or_cdchomp_tpu.tsr import TSR as JaxTSR

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch import client as tclient
from or_cdchomp_tpu_torch.tsr import TSR

from torch_parity import close, share_fields, start_tsr, table_module

RTOL = 1e-9
GOAL = [0.6, 0.7, 0.1, 1.4, 0.0, -0.3, 0.0]


@pytest.fixture(scope="module")
def inner():
    """(port module, JAX module) on the table world, one shared field."""
    out = []
    for pkg, kw in ((pt, dict(dtype=torch.float64, device="cpu")),
                    (oc, dict(dtype=jnp.float64))):
        mod = table_module(pkg, **kw)
        robot = mod.robots["wam"]
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.15)
        robot.enabled = True
        out.append(mod)
    return share_fields(*out)


class _Recorder:
    """A module handle that records each command string it is sent."""

    def __init__(self, handle):
        self.handle, self.sent = handle, []

    def SendCommand(self, cmd, releasegil=False):
        self.sent.append(cmd)
        return self.handle.SendCommand(cmd, releasegil)


def _both(inner):
    """(port recorder, JAX recorder) over SendCommandModules."""
    return (_Recorder(tclient.SendCommandModule(inner[0])),
            _Recorder(jclient.SendCommandModule(inner[1])))


class _Named:
    def GetName(self):
        return "wam"


CASES = {
    "momentum_cycle": dict(
        robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
        n_points=11, seed=3, use_momentum=True, epsilon=0.1),
    "getname_object": dict(robot=_Named(), adofgoal=GOAL, n_points=11,
                           obs_factor_self=10.0, epsilon_self=0.04),
    "start_tsr": dict(robot="wam", adofgoal=GOAL, n_points=9,
                      lambda_=150.0, start_tsr="tsr"),
    "con_tsrs": dict(robot="wam", adofgoal=GOAL, n_points=9,
                     con_tsrs=[("end", "tsr")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_bound_client_cycle_matches_jax(inner, case):
    """bind() + create / iterate(cost=) / gettraj / destroy."""
    outs = []
    for rec, tsr_cls in zip(_both(inner), (TSR, JaxTSR)):
        pkg_client = tclient if tsr_cls is TSR else jclient
        pkg_client.bind(rec)
        kw = dict(CASES[case])
        if kw.get("start_tsr") == "tsr":
            kw["start_tsr"] = start_tsr(tsr_cls)
        if "con_tsrs" in kw:
            kw["con_tsrs"] = [(t, start_tsr(tsr_cls, lift=0.0))
                              for t, _ in kw["con_tsrs"]]
        h = rec.create(**kw)
        cost = [None]
        rec.iterate(run=h, n_iter=5, cost=cost)
        traj = json.loads(rec.gettraj(run=h, no_collision_exception=True))
        rec.destroy(run=h)
        outs.append((h, cost[0], traj, rec.sent))
    (th, tc, tt, tsent), (jh, jc, jt, jsent) = outs
    assert th == jh and tsent == jsent
    close(np.array(tc), np.array(jc), RTOL)
    assert np.asarray(tt["positions"]).shape[1] == 7
    for k in jt:
        close(np.array(tt[k]), np.array(jt[k]), RTOL)


def test_runchomp_wrapper_and_quoting_match_jax(inner, tmp_path):
    """runchomp through each client, a quote in the .dat file's name."""
    trajs, rows = [], []
    for rec, pkg_client, name in zip(_both(inner), (tclient, jclient),
                                     ("port", "jax")):
        dat = tmp_path / f"it's {name}.dat"
        trajs.append(json.loads(pkg_client.runchomp(
            rec, robot="wam", adofgoal=GOAL, lambda_=100.0, n_points=11,
            n_iter=3, no_collision_exception=True, dat_filename=str(dat))))
        rows.append(np.loadtxt(dat, ndmin=2))
    assert len(trajs[0]["times"]) == 11 and rows[0].shape == (3, 5)
    for k in trajs[1]:
        close(np.array(trajs[0][k]), np.array(trajs[1][k]), RTOL)
    close(rows[0][:, [0, 2, 3, 4]], rows[1][:, [0, 2, 3, 4]], RTOL)


def test_flags_reach_the_run(inner):
    """use_hmc and hmc_resample_lambda over the wire (the draws are each
    package's own, so only the run's flags are compared)."""
    specs = []
    for rec, pkg_client, mod in zip(_both(inner), (tclient, jclient), inner):
        h = pkg_client.create(rec, robot=_Named(), adofgoal=GOAL,
                              n_points=11, use_hmc=True,
                              hmc_resample_lambda=0.05, seed=1)
        rn = mod.runs[h]
        specs.append((tuple(rn.spec), float(rn.problem.hmc_resample_lambda)))
        pkg_client.destroy(rec, run=h)
    assert specs[0] == specs[1]
    assert specs[0][0][6] and specs[0][1] == 0.05     # use_hmc


@pytest.mark.parametrize("kw, exc", [
    (dict(start_cost="0xdeadbeef"), ValueError),
    (dict(bogus_kwarg=1), ValueError),
])
def test_client_errors_match_jax(inner, kw, exc):
    msgs = []
    for rec, pkg_client in zip(_both(inner), (tclient, jclient)):
        with pytest.raises(exc) as e:
            pkg_client.create(rec, robot="wam", adofgoal=[0] * 7,
                              n_points=11, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    if "start_cost" in kw:
        assert "in-process" in msgs[0]


def test_shquot_matches_jax():
    for s in ("plain", "it's", "a b", "", "'"):
        assert tclient.shquot(s) == jclient.shquot(s)
