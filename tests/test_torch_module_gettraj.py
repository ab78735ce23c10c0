"""gettraj and gettraj_batch of the port against the JAX package's,
float64 on the CPU, on config 1's scene: the linear retime (times,
positions, a floating base's poses and velocities, at 1e-12), the
sampled collision verdict, the printed lines and the error message
(exact), for a clear path, one through the table and one that folds
the arm into itself; the batch check with a colliding and a
zero-length problem in chunks of two; and the chunk rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch import api
from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
from torch_parity import GOAL, START, close, config1_module

HOST = 1e-12
THROUGH_TABLE = np.array([0.0, 1.5, 0.0, 0.5, 0.0, 0.0, 0.0])
FOLDED = np.array([0.0, 0.0, 0.0, 3.0, 0.0, 0.0, 0.0])
GOALS = dict(clear=GOAL, table=THROUGH_TABLE, self=FOLDED)


@pytest.fixture(scope="module")
def mods():
    return (config1_module(pt, dtype=torch.float64, device="cpu"),
            config1_module(oc, dtype=jnp.float64))


def _gettraj(mod, goal, capsys, **kw):
    h = mod.create(robot="wam", adofgoal=goal, n_points=9)
    try:
        out = mod.gettraj(run=h, no_collision_exception=True, **kw)
    finally:
        mod.destroy(run=h)
    return out, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("case", ["clear", "table", "self"])
def test_gettraj_matches_jax(mods, capsys, case):
    tm, jm = mods
    (tt, tl), (jt, jl) = (_gettraj(m, GOALS[case], capsys) for m in mods)
    close(tt.times, jt.times, HOST)
    close(tt.positions, jt.positions, HOST)
    assert tt.in_collision == jt.in_collision == (case != "clear")
    assert tl == jl
    assert (case == "table") == ("Collision with table" in tl)
    assert (case != "clear") == ("Self collision" in tl)
    quiet, lines = _gettraj(tm, GOALS[case], capsys,
                            no_collision_details=True)
    assert lines == [] and quiet.in_collision == tt.in_collision


@pytest.mark.parametrize("case", ["table", "self"])
def test_gettraj_raises_as_jax(mods, capsys, case):
    errs = []
    for mod in mods:
        h = mod.create(robot="wam", adofgoal=GOALS[case], n_points=9)
        with pytest.raises(RuntimeError) as e:
            mod.gettraj(run=h)
        errs.append(str(e.value))
        mod.destroy(run=h)
    assert errs[0] == errs[1] == "Resulting trajectory is in collision!"


def test_gettraj_floating_base_matches_jax(mods, capsys):
    """A floating base: the base poses and the reference's
    affine_velocities (Δpose over the active DOFs' segment times), on a
    trajectory with noise on every column (quaternions renormalised)."""
    rng = np.random.default_rng(4)
    basegoal = np.array([0.3, 0.1, 0.0, 0.0, 0.0, 0.38268343, 0.92387953])
    out = []
    for mod in mods:
        h = mod.create(robot="wam", adofgoal=GOAL, basegoal=basegoal,
                       floating_base=True, n_points=9)
        rn = mod.runs[h]
        traj = np.asarray(rn.problem.traj) if mod is mods[1] else \
            rn.problem.traj.numpy()
        out.append((mod, h, traj))
    noise = 0.01 * rng.normal(size=out[0][2].shape)
    noisy = out[0][2] + noise
    noisy[:, 3:7] /= np.linalg.norm(noisy[:, 3:7], axis=1, keepdims=True)
    res = []
    for mod, h, _ in out:
        rn = mod.runs[h]
        if mod is mods[0]:
            rn.problem = rn.problem.replace(traj=torch.as_tensor(noisy))
        else:
            rn.problem = rn.problem._replace(traj=jnp.asarray(noisy))
        res.append(mod.gettraj(run=h, no_collision_exception=True))
        mod.destroy(run=h)
    capsys.readouterr()
    t, j = res
    for k in ("times", "positions", "base_poses", "base_velocities"):
        close(getattr(t, k), getattr(j, k), HOST)
    assert t.in_collision == j.in_collision
    q, bp = t.sample(0.37 * t.duration)
    qj, bpj = j.sample(0.37 * j.duration)
    close(q, qj, HOST)
    close(bp, bpj, HOST)


def _batch(pkg_mod, run, starts, goals):
    rn = pkg_mod.runs[run]
    if isinstance(pkg_mod, pt.CHOMPModule):
        return problem_batch_from_grid(rn.problem, starts, goals, rn.engine)
    from or_cdchomp_tpu.parallel.batch import \
        problem_batch_from_grid as jax_batch
    return jax_batch(rn.problem, starts, goals, rn.engine)


def test_gettraj_batch_matches_jax_and_per_run(mods, capsys):
    """B = 5: problem 1 runs through the table, problem 3 has start =
    goal (zero length, never colliding); the port checks in chunks of 2.
    Flags exact against the JAX batch check and the port's gettraj of
    each problem; times and positions at 1e-12."""
    tm, jm = mods
    rng = np.random.default_rng(2)
    starts = START + 0.03 * rng.normal(size=(5, 7))
    goals = GOAL + 0.03 * rng.normal(size=(5, 7))
    goals[1] = THROUGH_TABLE
    goals[3] = starts[3]
    th = tm.create(robot="wam", adofgoal=GOAL, n_points=9)
    jh = jm.create(robot="wam", adofgoal=GOAL, n_points=9)
    tp = _batch(tm, th, starts, goals)
    jp = _batch(jm, jh, starts, goals)
    ttr, tflags = tm.gettraj_batch(run=th, probs=tp, device_chunk=2)
    assert tm.last_check["chunk"] == 2
    jtr, jflags = jm.gettraj_batch(run=jh, probs=jp)
    np.testing.assert_array_equal(tflags, jflags)
    assert tflags[1] and not tflags[3]
    rn = tm.runs[th]
    for b in range(5):
        close(ttr[b].times, jtr[b].times, HOST)
        close(ttr[b].positions, jtr[b].positions, HOST)
        assert ttr[b].in_collision == bool(tflags[b])
        rn.problem = rn.problem.replace(traj=tp.traj[b])
        one = tm.gettraj(run=th, no_collision_exception=True)
        assert one.in_collision == bool(tflags[b])
    _, none = tm.gettraj_batch(run=th, probs=tp, no_collision_check=True)
    assert not none.any()
    capsys.readouterr()
    tm.destroy(run=th)
    jm.destroy(run=jh)


def test_check_chunk_rule():
    """Problems per chunk: the float64 pair tensor of a chunk within
    CHECK_PAIR_BYTES, at least one problem, device_chunk an upper bound."""
    per = 100 * 16 * 16 * 3 * 8
    assert api.check_chunk(100, 16) == api.CHECK_PAIR_BYTES // per
    assert api.check_chunk(100, 16) * per <= api.CHECK_PAIR_BYTES
    assert api.check_chunk(100, 16, device_chunk=64) == 64
    assert api.check_chunk(10 ** 6, 126) == 1
    assert api.check_chunk(1, 1, device_chunk=2048) == 2048
