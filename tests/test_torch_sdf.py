"""K1's plain version and the SDF build against the JAX package, float64
on CPU: the bench scene's field, the raw 4-cell lookup (Pallas kernel in
interpret mode), and the fused obstacle phase (_obstacle_soa) with its
edge cases."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import or_cdchomp_tpu as oc
from or_cdchomp_tpu.api import KinBody as JaxKinBody, Robot as JaxRobot
from or_cdchomp_tpu.chomp import cost_soa as jax_cost_soa
from or_cdchomp_tpu.chomp.cost import FieldStack as JaxFieldStack
from or_cdchomp_tpu.ops.grid import Grid3D as JaxGrid3D
from or_cdchomp_tpu.ops.grid import pad_stack_grids as jax_pad_stack
from or_cdchomp_tpu.ops.pallas_sdf import sdf_cell_lookup as pallas_lookup

import or_cdchomp_tpu_torch as pt
from or_cdchomp_tpu_torch.api import KinBody, Robot
from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.convert import fields_from_numpy
from or_cdchomp_tpu_torch.ops.sdf_lookup import (obstacle_cells,
                                                 obstacle_traffic_bytes,
                                                 sdf_cell_lookup_ref)

RTOL = 1e-10   # float64; the sums differ only in association order
START = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])


def _bench_scene(pkg, kinbody, robot_cls, **mod_kw):
    mod = pkg.CHOMPModule(**mod_kw)
    mod.add_kinbody(kinbody("table", pkg.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(kinbody("mug", pkg.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    robot = robot_cls("wam", pkg.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    return mod


def test_bench_field_matches_jax():
    tm = _bench_scene(pt, KinBody, Robot, device="cpu")
    jm = _bench_scene(oc, JaxKinBody, JaxRobot)
    tg, jg = tm.sdfs[0].grid, jm.sdfs[0].grid
    td, jd = tg.data.numpy(), np.asarray(jg.data)
    assert td.shape == jd.shape == (12, 16, 12)
    np.testing.assert_array_equal(td <= 0.0, jd <= 0.0)     # occupancy
    np.testing.assert_allclose(td, jd, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tg.lengths.numpy(), np.asarray(jg.lengths))
    np.testing.assert_array_equal(tm.sdfs[0].pose, jm.sdfs[0].pose)


def test_duplicate_field_and_cache_file_raise(tmp_path):
    """A duplicate field raises; the cache file (raw float32, C order)
    round-trips bit-equal, a file of the wrong size is a miss, and
    ``require_cache`` raises on a miss."""
    tm = _bench_scene(pt, KinBody, Robot, device="cpu")
    with pytest.raises(RuntimeError, match="already have an sdf"):
        tm.computedistancefield(kinbody="table", cube_extent=0.04)

    path = tmp_path / "mug.dat"
    tm.computedistancefield(kinbody="mug", cube_extent=0.04,
                            cache_filename=str(path))
    built = tm.sdfs[-1].grid
    raw = np.fromfile(path, dtype=np.float32)
    assert raw.size == built.data.numel() and raw.nbytes == path.stat().st_size
    np.testing.assert_array_equal(raw.reshape(tuple(built.data.shape)),
                                  built.data.numpy())

    def reread(**kw):
        m = _bench_scene(pt, KinBody, Robot, device="cpu")
        m.computedistancefield(kinbody="mug", cube_extent=0.04,
                               cache_filename=str(path), **kw)
        return m.sdfs[-1].grid

    got = reread(require_cache=True)              # a hit
    assert got.data.dtype == torch.float32
    assert torch.equal(got.data, built.data)
    assert torch.equal(got.lengths, built.lengths)

    marked = raw.copy()
    marked[0] = 123.0                             # right size: read as is
    marked.tofile(path)
    assert float(reread().data.flatten()[0]) == 123.0

    raw[:5].tofile(path)                          # wrong size: a miss
    msg = "Field not found from cache, but require_cache flag set!"
    with pytest.raises(RuntimeError, match=msg):
        reread(require_cache=True)
    assert torch.equal(reread().data, built.data)  # rebuilt and rewritten
    assert path.stat().st_size == raw.nbytes
    with pytest.raises(RuntimeError, match=msg):
        tm2 = _bench_scene(pt, KinBody, Robot, device="cpu")
        tm2.computedistancefield(kinbody="mug", cube_extent=0.04,
                                 cache_filename=str(tmp_path / "none.dat"),
                                 require_cache=True)


def test_mesh_scene_not_ported():
    """Meshes are ported now: Scene.build(meshes=...) bakes the triangles
    into the scene frame as the JAX package does."""
    from or_cdchomp_tpu.ops.voxelize import Scene as JaxScene

    pose = (0.1, -0.2, 0.3, 0.0, 0.0, 0.19866933, 0.98006658)
    verts = np.array([[0.0, 0.0, 0.0], [0.2, 0.0, 0.1], [0.0, 0.3, -0.1]])
    meshes = [(pose, verts, np.array([[0, 1, 2]]))]
    got = pt.Scene.build(meshes=meshes, dtype=torch.float64).tri_verts
    want = np.asarray(JaxScene.build(meshes=meshes,
                                     dtype=jnp.float64).tri_verts)
    assert tuple(got.shape) == want.shape == (1, 3, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ---- raw lookup: the Pallas kernel's contract -------------------------------

def test_cell_lookup_ref_equals_pallas():
    rng = np.random.default_rng(1)
    f, mx, my, mz = 2, 5, 6, 7
    data = rng.normal(size=(f, mx, my, mz))
    qn = 23
    sub = rng.integers(0, [mx, my, mz], size=(f, qn, 3)).astype(np.int32)
    dirs = rng.choice([-1, 1], size=(f, qn, 3))
    nbr = np.clip(sub + dirs, 0, np.array([mx, my, mz]) - 1).astype(np.int32)
    want = pallas_lookup(jnp.asarray(data), jnp.asarray(sub),
                         jnp.asarray(nbr), interpret=True)
    got = sdf_cell_lookup_ref(torch.as_tensor(data), torch.as_tensor(sub),
                              torch.as_tensor(nbr))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---- fused obstacle phase ---------------------------------------------------

def test_obstacle_traffic_bytes_flagship():
    """The flagship shape (m=99, S=15, B=256, one 12×16×12 field) by
    hand, Q = 380,160 queries: x, vel, acc 9·Q·4 = 13,685,760 B; field
    9,216; sizes + lengths 24; both poses 2·7·256·4 = 14,336;
    field_enabled 256; radii 60; epsilon + obs_factor 2,048; cost +
    wgrad 4·Q·4 = 6,082,560."""
    assert obstacle_traffic_bytes(99, 15, 256, 1, 12, 16, 12) == (
        13_685_760 + 9_216 + 24 + 14_336 + 256 + 60 + 2_048
        + 6_082_560) == 19_794_260


def test_obstacle_cells_counts_the_cells_read():
    """obstacle_cells: the distinct (field, cell) of the centre and the
    three one-sided neighbours of each query inside an enabled field's
    box, against a per-query count in plain Python (float64)."""
    rng = np.random.default_rng(8)
    F, m, S, B = 2, 5, 6, 10
    data, sizes, lengths = (np.array(a) for a in _fields(rng, F))
    x = rng.uniform(-0.15, 0.95, size=(3, m, S, B))
    pg = np.zeros((B, F, 7))
    pg[..., :3] = rng.normal(size=(B, F, 3)) * 0.05
    q = rng.normal(size=(B, F, 4))
    pg[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    enabled = np.ones((B, F), bool)
    enabled[2, 1] = False
    t = torch.as_tensor
    got = obstacle_cells(t(x), t(data), t(sizes),
                         t(lengths.astype(np.float64)), t(pg), t(enabled))
    want = set()
    for f in range(F):
        sz, ln = sizes[f], lengths[f].astype(np.float64)
        for k, s_, b in np.ndindex(m, S, B):
            if not enabled[b, f]:
                continue
            p = oc.utils.np_pose.apply(pg[b, f], x[:, k, s_, b])
            if not np.all((p / ln >= 0) & (p / ln <= 1)):
                continue
            sub = np.clip(np.floor(p / ln * sz), 0, sz - 1).astype(int)
            cen = (sub + 0.5) / sz * ln
            up = np.where(sub == 0, True,
                          np.where(sub == sz - 1, False, p >= cen))
            nb = sub + np.where(up, 1, -1)
            want.add((f, *sub))
            for i in range(3):
                c = sub.copy()
                c[i] = nb[i]
                want.add((f, *c))
    assert len(want) > 60 and got == len(want)
    assert obstacle_traffic_bytes(m, S, B, F, *data.shape[1:], got) == \
        obstacle_traffic_bytes(m, S, B, F, *data.shape[1:]) \
        - 4 * (data.size - got)


def _fields(rng, F, inf_cell=False, all_occupied=False):
    g1 = rng.normal(size=(6, 9, 5)) * 0.2 + 0.05
    if inf_cell:
        g1[2, 4, 2] = np.inf                      # HUGE_VAL interior cell
    g2 = np.full((8, 4, 7), -np.inf) if all_occupied else \
        rng.normal(size=(8, 4, 7)) * 0.2
    grids = [JaxGrid3D(data=jnp.asarray(g1, jnp.float32),
                       lengths=jnp.asarray([0.6, 0.9, 0.5], jnp.float32)),
             JaxGrid3D(data=jnp.asarray(g2, jnp.float32),
                       lengths=jnp.asarray([0.8, 0.4, 0.7], jnp.float32))]
    return jax_pad_stack(grids[:F])


class _Probs:
    pass


def _obstacle_case(seed, F, B=4, m=5, S=3, stationary=False, disable=None,
                   **fkw):
    rng = np.random.default_rng(seed)
    data, sizes, lengths = _fields(rng, F, **fkw)
    # points over [-0.15, 0.95] m: inside the field boxes, near their
    # edges and out of bounds
    x = rng.uniform(-0.15, 0.95, size=(3, m, S, B))
    vel = rng.normal(size=(3, m, S, B))
    if stationary:
        vel[:, :, 0] = 0.0                         # stationary sphere
    acc = rng.normal(size=(3, m, S, B))
    pw = np.zeros((B, F, 7))
    pw[..., :3] = rng.normal(size=(B, F, 3)) * 0.05
    q = rng.normal(size=(B, F, 4))
    pw[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pg = np.zeros_like(pw)
    for b in range(B):
        for f in range(F):
            pg[b, f] = oc.utils.np_pose.invert(pw[b, f])
    enabled = np.ones((B, F), bool)
    if disable is not None:
        enabled[disable] = False
    arrs = dict(epsilon=rng.uniform(0.05, 0.2, size=B),
                obs_factor=rng.uniform(100, 500, size=B),
                pose_world_gsdf=pw, pose_gsdf_world=pg, field_enabled=enabled)
    radii = rng.uniform(0.03, 0.1, size=S)

    jp = _Probs()
    for k, v in arrs.items():
        setattr(jp, k, jnp.asarray(v))
    c_j, w_j, *_ = jax_cost_soa._obstacle_soa(
        None, JaxFieldStack(data, sizes, lengths), jnp.asarray(radii), jp,
        tuple(jnp.asarray(c) for c in x), tuple(jnp.asarray(c) for c in vel),
        tuple(jnp.asarray(c) for c in acc), jnp.float64)

    tp = _Probs()
    for k, v in arrs.items():
        setattr(tp, k, torch.as_tensor(v))
    fields = fields_from_numpy(np.asarray(data), np.asarray(sizes),
                               np.asarray(lengths), device="cpu",
                               dtype=torch.float64)
    c_t, w_t = cost_soa._obstacle_soa(
        fields, torch.as_tensor(radii), tp, torch.as_tensor(x),
        torch.as_tensor(vel), torch.as_tensor(acc))
    return (c_t.numpy(), w_t.numpy()), (np.asarray(c_j),
                                        np.stack([np.asarray(c) for c in w_j]))


@pytest.mark.parametrize("case", [
    dict(F=1),
    dict(F=2, disable=(1, 0)),
    dict(F=1, inf_cell=True),
    dict(F=2, all_occupied=True),
    dict(F=2, stationary=True),
])
def test_obstacle_matches_jax(case):
    (c_t, w_t), (c_j, w_j) = _obstacle_case(3, **case)
    assert np.isfinite(c_t).all() and np.isfinite(w_t).all()
    assert np.abs(c_j).max() > 0.0           # the hinge is actually active
    np.testing.assert_allclose(c_t, c_j, rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(w_t, w_j, rtol=RTOL,
                               atol=1e-12 * np.abs(w_j).max())


def test_obstacle_all_occupied_field_reads_not_contained():
    """Every query inside an all-occupied (−inf) field only: the field
    must read as "not contained" (zero cost, zero gradient), never as an
    infinite obstacle."""
    rng = np.random.default_rng(0)
    data = np.full((1, 4, 5, 3), -np.inf)
    fields = fields_from_numpy(data, np.array([[4, 5, 3]]),
                               np.array([[0.4, 0.5, 0.3]]),
                               device="cpu", dtype=torch.float64)
    B, m, S = 2, 3, 2
    tp = _Probs()
    tp.epsilon = torch.full((B,), 0.1, dtype=torch.float64)
    tp.obs_factor = torch.full((B,), 200.0, dtype=torch.float64)
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], dtype=torch.float64)
    tp.pose_world_gsdf = ident.expand(B, 1, 7)
    tp.pose_gsdf_world = ident.expand(B, 1, 7)
    tp.field_enabled = torch.ones((B, 1), dtype=torch.bool)
    x = torch.as_tensor(rng.uniform(0.05, 0.25, size=(3, m, S, B)))
    vel = torch.as_tensor(rng.normal(size=(3, m, S, B)))
    c, w = cost_soa._obstacle_soa(fields, torch.full((S,), 0.05,
                                                     dtype=torch.float64),
                                  tp, x, vel, vel)
    assert float(c.abs().max()) == 0.0 and float(w.abs().max()) == 0.0


def test_obstacle_field_ties_and_enabled_mask():
    """Exact value ties between fields resolve to the first field (strict
    min-select), and a disabled field never wins.  Field 0 is constant c;
    field 1 rises along x, so at its x = 0 cell centres it reads exactly
    c, with a non-zero gradient.  Problem 0 has both fields (tie → field
    0, zero field gradient); problem 1 disables field 0 (field 1 wins)."""
    c = 0.05
    ga = np.full((8, 4, 7), c)
    gb = c + 0.01 * np.arange(6)[:, None, None] * np.ones((6, 9, 5))
    grids = [JaxGrid3D(data=jnp.asarray(ga, jnp.float32),
                       lengths=jnp.asarray([0.8, 0.4, 0.7], jnp.float32)),
             JaxGrid3D(data=jnp.asarray(gb, jnp.float32),
                       lengths=jnp.asarray([0.6, 0.9, 0.5], jnp.float32))]
    data, sizes, lengths = jax_pad_stack(grids)
    ln = np.asarray(lengths[1], np.float64)       # float32 lengths, as stored
    S, B = 4, 2
    x = np.zeros((3, 1, S, B))
    x[0] = (0.0 + 0.5) / 6.0 * ln[0]                       # x cell 0 centre
    x[1] = ((np.arange(S) + 0.5) / 9.0 * ln[1])[None, :, None]
    x[2] = (2.0 + 0.5) / 5.0 * ln[2]
    rng = np.random.default_rng(9)
    vel = np.broadcast_to(rng.normal(size=(3, 1, S, 1)), (3, 1, S, B)).copy()
    acc = np.broadcast_to(rng.normal(size=(3, 1, S, 1)), (3, 1, S, B)).copy()
    ident = np.array([0, 0, 0, 0, 0, 0, 1.0])
    arrs = dict(epsilon=np.full(B, 0.1), obs_factor=np.full(B, 200.0),
                pose_world_gsdf=np.tile(ident, (B, 2, 1)),
                pose_gsdf_world=np.tile(ident, (B, 2, 1)),
                field_enabled=np.array([[True, True], [False, True]]))
    radii = np.full(S, 0.02)

    jp = _Probs()
    for k, v in arrs.items():
        setattr(jp, k, jnp.asarray(v))
    c_j, w_j, *_ = jax_cost_soa._obstacle_soa(
        None, JaxFieldStack(data, sizes, lengths), jnp.asarray(radii), jp,
        tuple(jnp.asarray(v) for v in x), tuple(jnp.asarray(v) for v in vel),
        tuple(jnp.asarray(v) for v in acc), jnp.float64)
    tp = _Probs()
    for k, v in arrs.items():
        setattr(tp, k, torch.as_tensor(v))
    fields = fields_from_numpy(np.asarray(data), np.asarray(sizes),
                               np.asarray(lengths), device="cpu",
                               dtype=torch.float64)
    c_t, w_t = cost_soa._obstacle_soa(
        fields, torch.as_tensor(radii), tp, torch.as_tensor(x),
        torch.as_tensor(vel), torch.as_tensor(acc))
    w_j = np.stack([np.asarray(v) for v in w_j])
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=RTOL)
    np.testing.assert_allclose(w_t.numpy(), w_j, rtol=RTOL, atol=1e-12)
    # same inputs, different winner: the two problems' gradients differ
    w = w_t.numpy()
    assert np.abs(w[..., 0] - w[..., 1]).max() > 1e-3


def test_float64_cpu_module_runs_plain_versions(monkeypatch):
    """A float64 module on the CPU takes every wrapper's plain version
    (obstacle, selfcol_pairs, sdf_cell_lookup through
    multigrid_interp_grad): the kernel library is never reached and the
    launch counts stay 0."""
    from or_cdchomp_tpu_torch.ops import grid, kernels, sdf_lookup, selfcol

    def no_library():
        raise AssertionError("a float64 CPU call reached the kernels")

    monkeypatch.setattr(kernels, "library", no_library)
    n0 = (sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES, selfcol.LAUNCHES)
    mod = pt.CHOMPModule(dtype=torch.float64, device="cpu")
    mod.add_kinbody(KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    robot = Robot("wam", pt.wam7(), q_active=START.copy())
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    h = mod.create(robot="wam", adofgoal=[0.4, 0.6, 0.1, 1.3, 0, -0.5, 0],
                   lambda_=100.0, obs_factor=500.0, n_points=9)
    cost = mod.iterate(run=h, n_iter=3)
    run = mod.runs[h]
    f = run.engine.fields
    assert f.data.dtype == run.problem.traj.dtype == torch.float64
    p = torch.as_tensor(np.random.default_rng(5).uniform(
        size=(5, 1, 3))) * f.lengths
    v, _, inb = grid.multigrid_interp_grad(f.data, f.sizes, f.lengths, p)
    assert np.isfinite(cost) and bool(inb.all())
    assert v.dtype == torch.float64
    assert (sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES,
            selfcol.LAUNCHES) == n0 == (0, 0, 0)


def test_kernel_dtypes():
    """The kernels are built for float32 and float64: another dtype
    raises before any launch, and the traffic counts scale with the
    float size (4-byte ints and 1-byte bools stay)."""
    from or_cdchomp_tpu_torch.ops import kernels, sdf_lookup, selfcol

    for dt in (torch.float32, torch.float64):
        assert kernels.check_dtype(dt, "obstacle") is dt
    for dt in (torch.float16, torch.bfloat16, torch.int32):
        with pytest.raises(ValueError, match="dtype"):
            kernels.check_dtype(dt, "obstacle")
        with pytest.raises(ValueError, match="dtype"):
            kernels.entry("cdx_obstacle", dt)
    args = (99, 15, 256, 3, 11, 19, 11)
    b4 = sdf_lookup.obstacle_traffic_bytes(*args)
    b8 = sdf_lookup.obstacle_traffic_bytes(*args, itemsize=8)
    ints_bools = 4 * 3 * 3 + 256 * 3
    assert b8 - ints_bools == 2 * (b4 - ints_bools)
    assert sdf_lookup.smem_bytes(3, 11, 19, 11, 8) == \
        2 * sdf_lookup.smem_bytes(3, 11, 19, 11)
    t4, t8 = (selfcol.traffic_bytes(99, 15, 1, 256, 207, k) for k in (4, 8))
    assert t8 - 4 * 2 * 207 == 2 * (t4 - 4 * 2 * 207)

