"""The port's triangle-mesh scenes against the JAX package at float64 on
the CPU: the mesh generators, the signed mesh distance, the triangle-cube
SAT and voxelization (and the chunked voxelization against one piece),
the mesh demo's distance field (examples/wam7_mesh_demo.py's scene at
0.15 m), grabbing a mesh body, the trajectory check's chunk with
triangles, and a short solve on the mesh field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.api import Robot as JaxRobot
from or_cdchomp_tpu.models.robot import CompiledFK as JaxFK
from or_cdchomp_tpu.ops import voxelize as jv

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch import api
from or_cdchomp_tpu_torch.ops import voxelize as tv

from torch_parity import GOAL, START, close, share_fields

MATH_RTOL = 1e-12
STEP_RTOL = 1e-9
POSE = (0.05, -0.02, 0.03, 0.0, 0.0, 0.19866933, 0.98006658)  # yaw ~0.4
HALF = (0.25, 0.15, 0.1)
CUBE_EXTENT = 0.15


def _scene_args(pkg_vox):
    """A posed box mesh, a 12-gon cylinder mesh, a box and a cylinder."""
    bv, bf = pkg_vox.box_trimesh(HALF)
    cv, cf = pkg_vox.cylinder_trimesh(0.07, 0.12, n=12)
    return dict(
        meshes=[(POSE, bv, bf), ((0.2, 0.25, -0.1, 0, 0, 0, 1), cv, cf)],
        boxes=[((-0.25, -0.2, 0.2, 0, 0, 0, 1), (0.05, 0.08, 0.04))],
        cylinders=[((0.3, -0.3, 0.25, 0, 0, 0, 1), 0.05, 0.06)])


@pytest.fixture(scope="module")
def scenes():
    return (pt.Scene.build(**_scene_args(tv), dtype=torch.float64),
            jv.Scene.build(**_scene_args(jv), dtype=jnp.float64))


def _grid(n=21, lo=-0.45, hi=0.45):
    axes = [np.linspace(lo, hi, n)] * 3
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("n", [12, 24])
def test_trimesh_generators_match_jax(n):
    for got, want in zip(tv.box_trimesh(HALF), jv.box_trimesh(HALF)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tv.cylinder_trimesh(0.04, 0.06, n=n),
                         jv.cylinder_trimesh(0.04, 0.06, n=n)):
        np.testing.assert_array_equal(got, want)


def test_scene_build_and_bounds_match_jax(scenes):
    ts, js = scenes
    assert tuple(ts.tri_verts.shape) == (12 + 48, 3, 3)
    assert ts.n_primitives == 60 + 1 + 1
    close(ts.tri_verts, js.tri_verts, MATH_RTOL)
    for a, b in zip(ts.bounding_spheres(), js.bounding_spheres()):
        close(a, b, MATH_RTOL)
    lo_t, hi_t = pt.KinBody("b", ts).aabb_at_origin(0.1)
    lo_j, hi_j = oc.KinBody("b", js).aabb_at_origin(0.1)
    close(lo_t, lo_j, MATH_RTOL)
    close(hi_t, hi_j, MATH_RTOL)


def test_sd_trimesh_matches_jax(scenes):
    """500 points: the closest-triangle distances, the winding-number
    signed distance of each mesh and the whole scene's distance."""
    ts, js = scenes
    p = np.random.default_rng(0).uniform(-0.5, 0.5, size=(500, 3))
    tp, jp = torch.as_tensor(p), jnp.asarray(p)
    close(tv._closest_tri_dist(tp, ts.tri_verts),
          jax.jit(jv._closest_tri_dist)(jp, js.tri_verts), MATH_RTOL)
    for sl in (slice(0, 12), slice(12, 60)):
        got = tv.sd_trimesh(tp, ts.tri_verts[sl])
        want = np.asarray(jax.jit(jv.sd_trimesh)(jp, js.tri_verts[sl]))
        assert (want < 0).any() and (want > 0).any()
        close(got, want, MATH_RTOL)
    close(tv.scene_distance(ts, tp), jax.jit(jv.scene_distance)(js, jp),
          MATH_RTOL)


def test_voxelize_matches_jax_and_chunks(scenes, monkeypatch):
    """A 21³ grid of cubes (half extent 0.03): the triangle-cube SAT per
    triangle and the scene's occupancy equal JAX's booleans; chunks of 1,000
    cells (a small byte budget; 10 chunks, the last partial) give the
    one-piece occupancy."""
    ts, js = scenes
    c = _grid()
    e = 0.03
    hit_t = tv._tri_cube_overlap(torch.as_tensor(c), e, ts.tri_verts)
    hit_j = np.asarray(jax.jit(jv._tri_cube_overlap, static_argnums=1)(
        jnp.asarray(c), e, js.tri_verts))
    assert 0 < int(hit_j.sum()) < hit_j.size
    np.testing.assert_array_equal(hit_t.numpy(), hit_j)
    occ_t = tv.voxelize_scene(ts, torch.as_tensor(c), e)
    occ_j = np.asarray(jax.jit(jv.voxelize_scene, static_argnums=2)(
        js, jnp.asarray(c), e))
    np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    ident = np.array([0.0, 0, 0, 0, 0, 0, 1])
    monkeypatch.setattr(api, "VOXEL_CHUNK_BYTES", 1000 * 9 * 8 *
                        ts.n_primitives)
    for c64 in (None, torch.as_tensor(c)):
        chunked = api.voxelize_chunked([(ts, ident)], torch.as_tensor(c), e,
                                       centers64=c64)
        assert torch.equal(chunked, occ_t)


def _mesh_world(pkg, vox, **mod_kw):
    """examples/wam7_mesh_demo.py's scene: the table top and leg as box
    meshes, the mug as a 24-gon cylinder mesh, the WAM7 at START; the
    table's field at CUBE_EXTENT."""
    top_v, top_f = vox.box_trimesh((0.25, 0.4, 0.02))
    leg_v, leg_f = vox.box_trimesh((0.08, 0.08, 0.25))
    mug_v, mug_f = vox.cylinder_trimesh(0.04, 0.06, n=24)
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(pkg.KinBody("table", pkg.Scene.build(
        meshes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), top_v, top_f),
                ((0.75, 0.0, 0.25, 0, 0, 0, 1), leg_v, leg_f)])))
    mod.add_kinbody(pkg.KinBody("mug", pkg.Scene.build(
        meshes=[((0.65, 0.15, 0.58, 0, 0, 0, 1), mug_v, mug_f)])))
    robot = pkg.Robot("wam", pkg.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=CUBE_EXTENT)
    robot.enabled = True
    return mod


@pytest.fixture(scope="module")
def mesh_mods():
    return (_mesh_world(pt, tv, dtype=torch.float64, device="cpu"),
            _mesh_world(oc, jv, dtype=jnp.float64))


def test_mesh_field_matches_jax(mesh_mods):
    """The mesh demo's float32 field: the same grid, the same occupancy
    (cells on which the two packages' rounding ties the other way are
    counted and listed: none at this scene), values as the box field's
    test holds them; the closed table interior reads negative."""
    tm, jm = mesh_mods
    t, j = tm.sdfs[0], jm.sdfs[0]
    close(t.pose, j.pose, MATH_RTOL)
    td, jd = t.grid.data.numpy(), np.asarray(j.grid.data)
    assert td.dtype == np.float32 and td.shape == jd.shape
    ties = np.argwhere((td <= 0) != (jd <= 0))
    print(f"occupancy ties: {len(ties)} of {td.size} cells: "
          f"{ties.tolist()}")
    assert len(ties) == 0
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    assert (td < 0).any()


def test_grab_mesh_body_gives_jax_sphere(monkeypatch):
    """Grabbing a mesh mug adds one sphere, JAX's bounding sphere, in the
    hand link's frame (the JAX Robot's host FK in float64, as
    test_torch_module_world.py has it); release takes it off."""
    fk = JaxFK(oc.wam7(), dtype=jnp.float64)
    monkeypatch.setattr(JaxRobot, "_fk", lambda self: fk)
    mv, mf = tv.cylinder_trimesh(0.04, 0.06, n=12)
    pose = np.array([0.5, 0.0, 0.8, 0, 0, 0, 1.0])
    robots = []
    for pkg in (pt, oc):
        kw = (dict(dtype=torch.float64, device="cpu") if pkg is pt
              else dict(dtype=jnp.float64))
        mod = pkg.CHOMPModule(**kw)
        mug = mod.add_kinbody(pkg.KinBody("mug", pkg.Scene.build(
            meshes=[((0, 0, 0, 0, 0, 0, 1), mv, mf)],
            dtype=kw["dtype"]), pose=pose.copy()))
        robot = pkg.Robot("wam", pkg.wam7(), q_active=START.copy())
        mod.add_robot(robot)
        n0 = len(robot.model.sphere_radius)
        robot.grab(mug, "wam7")
        assert len(robot.model.sphere_radius) == n0 + 1
        robots.append((robot, mug, n0))
    (tr, tmug, n0), (jr, _, _) = robots
    close(np.asarray(tr.model.sphere_radius)[-1],
          np.asarray(jr.model.sphere_radius)[-1], MATH_RTOL)
    close(np.asarray(tr.model.sphere_pos)[-1],
          np.asarray(jr.model.sphere_pos)[-1], MATH_RTOL)
    tr.release(tmug)
    assert len(tr.model.sphere_radius) == n0


def test_check_chunk_counts_triangles():
    """A mesh body's (chunk, samples, S, T, 3) tensor sizes the chunk once
    T > S; below that the pair tensor does."""
    per = 100 * 16 * 120 * 3 * 8
    assert api.check_chunk(100, 16, triangles=120) == \
        api.CHECK_PAIR_BYTES // per
    assert api.check_chunk(100, 16, triangles=8) == api.check_chunk(100, 16)
    assert api.check_chunk(10 ** 6, 16, triangles=10 ** 4) == 1


def test_mesh_solve_matches_jax(mesh_mods):
    """The slice on the mesh field: create + iterate(5) at n_points 9
    against JAX (one field), gettraj's verdict and the check's sizes."""
    tm, jm = share_fields(*mesh_mods)
    kw = dict(robot="wam", adofgoal=GOAL, lambda_=100.0, obs_factor=500.0,
              n_points=9)
    th, jh = tm.create(**kw), jm.create(**kw)
    close(np.float64(tm.iterate(run=th, n_iter=5)),
          np.float64(jm.iterate(run=jh, n_iter=5)), STEP_RTOL)
    close(tm.runs[th].problem.traj, jm.runs[jh].problem.traj, STEP_RTOL)
    tt = tm.gettraj(run=th, no_collision_exception=True)
    jt = jm.gettraj(run=jh, no_collision_exception=True)
    assert tt.in_collision == jt.in_collision
    assert tm.last_check["triangles"] == 96
