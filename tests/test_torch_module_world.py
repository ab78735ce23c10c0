"""The port's world commands against the JAX package's, float64 on the
CPU: grabbed bodies (JAX tests/test_grab.py's cases), the self-collision
check's exclusions, viewspheres, addfield_fromobsarray / viewfields /
removefield, a field built around the robot, and a run after grabbing a
tray of 110 spheres (S = 126: K2's plain version at a count the staged
kernel cannot take).  The JAX Robot computes its host kinematics with a
float32 CompiledFK; the tests give it a float64 one, so host math is
held at 1e-12.  Fields are float32 EDTs in both packages (1e-5); solves
1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.api import Robot as JaxRobot
from or_cdchomp_tpu.models.robot import CompiledFK as JaxFK

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.models.robot import link_poses_np
from or_cdchomp_tpu_torch.ops import selfcol
from torch_parity import GOAL, START, close, config1_module, share_fields

HOST = 1e-12
Q1 = np.array([0.0, 2.0, 0.0, 3.0, 0.0, 1.5, 0.0])
_FK64 = {}


@pytest.fixture
def fk64(monkeypatch):
    """The JAX Robot's host FK in float64, one per model."""
    def fk(self):
        if id(self.model) not in _FK64:
            _FK64[id(self.model)] = (self.model,
                                     JaxFK(self.model, dtype=jnp.float64))
        return _FK64[id(self.model)][1]

    monkeypatch.setattr(JaxRobot, "_fk", fk)


def _world(pkg, **kw):
    mod = pkg.CHOMPModule(**kw)
    mod.add_kinbody(pkg.KinBody("table", pkg.Scene.build(
        boxes=[((0.5, 0.0, 0.6, 0, 0, 0, 1), (0.25, 0.35, 0.03))])))
    r = pkg.Robot("wam", pkg.wam7(), q_active=START.copy())
    mod.add_robot(r)
    return mod, r


def _worlds():
    return (_world(pt, dtype=torch.float64, device="cpu"),
            _world(oc, dtype=jnp.float64))


def _body(pkg, name, spheres, pose=None):
    b = pkg.KinBody(name, pkg.Scene.build(spheres=spheres))
    if pose is not None:
        b.pose = np.asarray(pose, np.float64).copy()
    return b


def test_link_poses_np_matches_jax():
    q = START + 0.1
    base = np.array([0.1, -0.2, 0.3, 0.0, 0.0, 0.38268343, 0.92387953])
    want, _ = JaxFK(oc.wam7(), dtype=jnp.float64).link_poses(
        jnp.asarray(q), base_pose=jnp.asarray(base))
    close(link_poses_np(pt.wam7(), q, base), np.asarray(want), HOST)


def test_grab_moves_with_link_and_release_matches_jax(fk64):
    """A mug grabbed at the last link: its sphere joins the model, rides
    the link, stays an obstacle at its carried pose, and is left where
    the link carried it on release."""
    res = []
    for (mod, r), pkg in zip(_worlds(), (pt, oc)):
        n0 = len(r.model.sphere_radius)
        last = r.model.link_names[-1]
        ee = link_poses_np(pt.wam7(), r.q_active, r.pose)[-1]
        mug = mod.add_kinbody(_body(pkg, "mug", [((0.0, 0.0, 0.05), 0.04)],
                                    ee))
        r.grab(mug, last)
        assert len(r.model.sphere_radius) == n0 + 1
        assert mug.grabbed_by == "wam"
        x0, rad = r.sphere_world()
        r.q_active = r.q_active + 0.3
        x1, _ = r.sphere_world()
        carried = r.grabbed_body_pose("mug")
        scenes, poses = mod._world_occupancy_scene()
        assert len(scenes) == 3
        close(poses[1], carried, HOST)
        r.release(mug)
        assert len(r.model.sphere_radius) == n0 and mug.grabbed_by is None
        res.append((x0, rad, x1, carried, mug.pose))
    for a, b in zip(*res):
        close(np.asarray(a), np.asarray(b), HOST)
    assert np.linalg.norm(res[0][2][-1] - res[0][0][-1]) > 1e-3


def test_release_order_with_multiple_grabs(fk64):
    """Grab A (2 spheres) and B (1), release A: exactly B's sphere
    remains; release B: the original count (owner tags)."""
    for (mod, r), pkg in zip(_worlds(), (pt, oc)):
        n0 = len(r.model.sphere_radius)
        a = mod.add_kinbody(_body(pkg, "a", [((0, 0, 0), 0.02),
                                             ((0, 0, 0.05), 0.03)]))
        b = mod.add_kinbody(_body(pkg, "b", [((0, 0, 0), 0.04)]))
        link = r.model.link_names[-1]
        r.grab(a, link)
        r.grab(b, link)
        assert len(r.model.sphere_radius) == n0 + 3
        r.release(a)
        assert len(r.model.sphere_radius) == n0 + 1
        assert float(r.model.sphere_radius[-1]) == pytest.approx(0.04)
        r.release(b)
        assert len(r.model.sphere_radius) == n0
        with pytest.raises(RuntimeError, match="already grabbed"):
            r.grab(a, link)
            r.grab(a, link)


def test_other_robots_grabs_stay_obstacles():
    mod, rx = _world(pt, dtype=torch.float64, device="cpu")
    mod.add_robot(pt.Robot("wam2", pt.wam7(), q_active=np.zeros(7)))
    mug = mod.add_kinbody(_body(pt, "mug", [((0, 0, 0), 0.03)]))
    rx.grab(mug, rx.model.link_names[-1])
    scenes, _ = mod._world_occupancy_scene()
    assert len(scenes) == 4   # table, mug, two robots' sphere scenes


def test_check_exclude_mask_matches_jax(fk64):
    """The exclusions at the construction-time reference configuration
    (not where the robot sits at the first check), re-captured at grab
    and release."""
    masks = []
    for (mod, r), pkg in zip(_worlds(), (pt, oc)):
        base = r.check_exclude_mask().copy()
        at_q1 = pkg.Robot("b", pkg.wam7(), q_active=Q1).check_exclude_mask()
        assert not np.array_equal(base, at_q1)
        r.q_active = Q1.copy()
        r._check_exclude = None
        np.testing.assert_array_equal(r.check_exclude_mask(), base)
        a = mod.add_kinbody(_body(pkg, "a", [((0, 0, 0), 0.03)]))
        b = mod.add_kinbody(_body(pkg, "b", [((0, 0, 0), 0.03)]))
        r.grab(a, r.model.link_names[2])
        assert r._check_exclude is None
        mask_a = r.check_exclude_mask().copy()
        r.release(a)
        r.grab(b, r.model.link_names[-1])
        mask_b = r.check_exclude_mask()
        assert mask_a.shape == mask_b.shape == (len(base) + 1,) * 2
        assert not np.array_equal(mask_a, mask_b)
        masks.append((base, at_q1, mask_a, mask_b))
    for a, b in zip(*masks):
        np.testing.assert_array_equal(a, b)


def test_bounding_spheres_match_jax():
    kw = dict(boxes=[((1.0, 0, 0, 0, 0, 0, 1), (0.1, 0.2, 0.3))],
              spheres=[((0, 1.0, 0), 0.5)],
              cylinders=[((0, 0, 2.0, 0, 0, 0, 1), 0.2, 0.4)])
    tc, tr = pt.Scene.build(**kw).bounding_spheres()
    jc, jr = oc.Scene.build(**kw).bounding_spheres()
    close(tc, jc, HOST)
    close(tr, jr, HOST)


def test_viewspheres_matches_jax(fk64):
    (tm, _), (jm, _) = _worlds()
    t, j = tm.viewspheres(robot="wam"), jm.viewspheres(robot="wam")
    assert [s[0] for s in t] == [s[0] for s in j]
    close(np.stack([s[1] for s in t]), np.stack([s[1] for s in j]), HOST)
    close([s[2] for s in t], [s[2] for s in j], HOST)


def _obsarray_case(mod):
    rng = np.random.default_rng(5)
    occ = (rng.uniform(size=(6, 7, 5)) < 0.2).astype(np.uint8)
    pose = np.array([0.2, -0.1, 0.4, 0.0, 0.0, 0.6, 0.8])
    mod.addfield_fromobsarray(kinbody="table", obsarray=occ.ravel(),
                              sizes=(6, 7, 5), lengths=(0.3, 0.35, 0.25),
                              pose=pose * 1.5)    # normalised on the way in


def test_field_commands_match_jax():
    """addfield_fromobsarray (the pose's quaternion normalised),
    viewfields, the duplicate-field and unknown-field errors, and
    removefield."""
    (tm, _), (jm, _) = _worlds()
    errs = []
    for mod in (tm, jm):
        _obsarray_case(mod)
        with pytest.raises(RuntimeError) as dup:
            _obsarray_case(mod)
        with pytest.raises(RuntimeError) as missing:
            mod.removefield(kinbody="mug_not_there")
        errs.append((str(dup.value), str(missing.value)))
    assert errs[0] == errs[1]
    close(tm.sdfs[0].pose, jm.sdfs[0].pose, HOST)
    np.testing.assert_allclose(tm.sdfs[0].grid.data.numpy(),
                               np.asarray(jm.sdfs[0].grid.data), atol=1e-5)
    tv, jv = tm.viewfields(), jm.viewfields()
    assert list(tv) == list(jv) == ["table"]
    assert tv["table"].shape == jv["table"].shape
    np.testing.assert_allclose(tv["table"], jv["table"], atol=1e-5)
    for mod in (tm, jm):
        assert mod.removefield(kinbody="table") == ""
        assert mod.viewfields() == {}


def test_field_around_robot(fk64):
    """computedistancefield(kinbody="wam") anchors the field on the
    (disabled) robot's base (the reference demo's set-up; JAX's
    _body_world_pose raises on a Robot, so its robot gets the attribute
    it reads); the run created on it iterates."""
    (tm, tr), (jm, jr) = _worlds()
    jr.grabbed_by = None
    for mod, r in ((tm, tr), (jm, jr)):
        r.enabled = False
        mod.computedistancefield(kinbody="wam", cube_extent=0.1)
        r.enabled = True
    ts, js = tm.sdfs[0], jm.sdfs[0]
    close(ts.pose, js.pose, HOST)
    assert tuple(ts.grid.data.shape) == tuple(js.grid.data.shape)
    np.testing.assert_allclose(ts.grid.data.numpy(), np.asarray(js.grid.data),
                               atol=1e-5)
    h = tm.create(robot="wam", adofgoal=GOAL, n_points=7)
    assert np.isfinite(tm.iterate(run=h, n_iter=2))
    assert tm.viewfields()["wam"].shape[1] == 3


def tray_spheres():
    """A flat tray of 10 x 11 spheres of 1.5 cm radius, 3 cm apart."""
    return [((0.03 * (i - 4.5), 0.03 * (j - 5.0), 0.0), 0.015)
            for i in range(10) for j in range(11)]


def test_grabbed_tray_run_matches_jax(fk64):
    """A tray of 110 spheres grabbed at the hand: S = 126 spheres, 125
    active, one inactive.  The run's create and two iterations equal the
    JAX package's; release restores 16 spheres."""
    tm, jm = share_fields(
        config1_module(pt, dtype=torch.float64, device="cpu"),
        config1_module(oc, dtype=jnp.float64))
    out = []
    for mod, pkg in ((tm, pt), (jm, oc)):
        r = mod.robots["wam"]
        hand = link_poses_np(pt.wam7(), r.q_active, r.pose)[
            r.model.link_names.index("handbase")]
        pose = pkg.api.np_pose.compose(hand, [0, 0, 0.22, 0, 0, 0, 1])
        tray = mod.add_kinbody(_body(pkg, "tray", tray_spheres(), pose))
        r.grab(tray, "handbase")
        assert len(r.model.sphere_radius) == 126
        h = mod.create(robot="wam", adofgoal=GOAL, lambda_=100.0,
                       obs_factor=500.0, n_points=7)
        c = mod.iterate(run=h, n_iter=2)
        out.append((c, mod.runs[h]))
        r.release(tray)
        assert len(r.model.sphere_radius) == 16
    (tc, trun), (jc, jrun) = out
    assert trun.engine.n_spheres_active == 125
    assert selfcol.launch_shape(125, 1)[0] == "tiled"
    close(trun.problem.inactive_pos.numpy(),
          np.asarray(jrun.problem.inactive_pos), HOST)
    close(tc, jc, 1e-9)
    close(trun.problem.traj.numpy(), np.asarray(jrun.problem.traj), 1e-9)


@pytest.mark.parametrize("SI", [0, 1, 2])
def test_selfcol_shared_memory_rule(SI):
    """Every sphere count up to 1,024 has a path whose block fits: the
    staged path where its shared memory (growing with S) fits, which is
    up to 117 spheres with at most one inactive, the tiled path beyond:
    16 warps, and a ring of 32-sphere slots in shared memory, one per
    chunk up to 256 spheres (resident), two (streamed) beyond, so that
    two blocks share an SM."""
    slot = 4 * (3 * 32 * 32 + 6 * 32)
    for S in range(SI + 1, 1025):
        Sa = S - SI
        path, threads, smem = selfcol.launch_shape(Sa, SI)
        staged = 4 * selfcol.smem_words(Sa, S, min(Sa, 16))
        assert path == ("staged" if staged <= selfcol.SMEM_BLOCK_MAX
                        else "tiled")
        if S <= 116:
            assert path == "staged"
        if S >= 118 and SI <= 1:
            assert path == "tiled"
        assert selfcol.ring_resident(S) == (S <= 256)
        slots = -(-S // 32) if S <= 256 else 2
        assert smem == (staged if path == "staged" else slots * slot)
        assert smem <= selfcol.SMEM_BLOCK_MAX
        assert threads == 32 * (min(Sa, 16) if path == "staged" else 16)
        # two tiled blocks fit an SM's 228 KB with 1 KB reserved each
        assert path == "staged" or 2 * (smem + 1024) <= 233_472


@pytest.mark.parametrize("SI", [0, 1])
def test_selfcol_float64_rule(SI):
    """float64 takes the tiled path at every sphere count, in blocks of
    16 warps; its ring slots hold 8-byte floats, so every chunk of up to
    128 spheres stays resident (four slots, as many bytes as float32's
    eight), two slots stream beyond."""
    slot = 8 * (3 * 32 * 32 + 6 * 32)
    for Sa in (1, 2, 15, 117, 127, 128, 300):
        So = Sa + SI
        slots = -(-So // 32) if So <= 128 else 2
        assert selfcol.ring_resident(So, 8) == (So <= 128)
        assert selfcol.launch_shape(Sa, SI, 8) == ("tiled", 512,
                                                   slots * slot)
        assert slots * slot <= selfcol.RING_BYTES_MAX == 8 * slot // 2
