"""The two CUDA kernels against their plain PyTorch versions on the card,
at small shapes.  Skipped without a CUDA device; run on the card with
``python -m pytest tests/test_torch_kernels_gpu.py -q --noconftest``
(tests/conftest.py configures JAX, which that machine does not have)."""

import dataclasses

import numpy as np
import pytest
import torch

from or_cdchomp_tpu_torch.ops import kernels, sdf_lookup, selfcol
from or_cdchomp_tpu_torch.utils import np_pose

pytestmark = pytest.mark.gpu

RTOL = 1e-5   # float32 kernel vs float32 plain version: op order only


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    b = b.double().cpu().numpy()
    np.testing.assert_allclose(a.double().cpu().numpy(), b, rtol=RTOL,
                               atol=RTOL * max(np.abs(b).max(), 1e-30))


def test_sdf_cell_lookup_exact(cuda):
    rng = np.random.default_rng(1)
    F, mx, my, mz, Q = 2, 5, 6, 7, 1000
    data = torch.as_tensor(rng.normal(size=(F, mx, my, mz)),
                           dtype=torch.float32)
    sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
    nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                  np.array([mx, my, mz]) - 1).astype(np.int32)
    args = (data, torch.as_tensor(sub), torch.as_tensor(nbr))
    want = sdf_lookup.sdf_cell_lookup(*args)
    n0 = sdf_lookup.LOOKUP_LAUNCHES
    got = sdf_lookup.sdf_cell_lookup(*(a.to(cuda) for a in args))
    assert sdf_lookup.LOOKUP_LAUNCHES == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _obstacle_args(rng, dev, F=2, m=7, S=5, B=33):
    data = rng.normal(size=(F, 8, 9, 7)) * 0.2 + 0.05
    data[0, 3, 3, 3] = np.inf
    data[1, 6:, :, :] = np.inf                    # padding of a smaller field
    sizes = np.array([[8, 9, 7], [6, 9, 7]][:F], np.int32)
    lengths = np.array([[0.8, 0.9, 0.7], [0.6, 0.9, 0.7]][:F])
    pw = np.zeros((B, F, 7))
    pw[..., :3] = rng.normal(size=(B, F, 3)) * 0.05
    q = rng.normal(size=(B, F, 4))
    pw[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pg = np.stack([[np_pose.invert(p) for p in row] for row in pw])
    f32 = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f32).contiguous()   # noqa: E731
    enabled = torch.ones((B, F), dtype=torch.bool, device=dev)
    enabled[3, 0] = False
    vel = rng.normal(size=(3, m, S, B))
    vel[:, :, 0, :5] = 0.0
    return (t(rng.uniform(-0.1, 0.9, size=(3, m, S, B))), t(vel),
            t(rng.normal(size=(3, m, S, B))), t(data),
            torch.as_tensor(sizes, device=dev), t(lengths), t(pg),
            t(pw), enabled, t(rng.uniform(0.03, 0.1, size=S)),
            t(rng.uniform(0.05, 0.2, size=B)),
            t(rng.uniform(100, 500, size=B)))


def test_obstacle_kernel_matches_plain(cuda):
    args = _obstacle_args(np.random.default_rng(0), cuda)
    want = sdf_lookup.obstacle_ref(*args, want_dirs=True)
    n0 = sdf_lookup.LAUNCHES
    got = sdf_lookup.obstacle(*args, want_dirs=True)
    torch.cuda.synchronize()
    assert sdf_lookup.LAUNCHES == n0 + 1
    assert torch.equal(got[2], want[2])           # one-sided choices
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_obstacle_kernel_field_tie(cuda):
    """An exact value tie between two fields goes to the first field in
    the kernel as in the plain version: field 0 is constant c, field 1
    reads exactly c (with a non-zero gradient) at its x = 0 centres."""
    f32 = dict(dtype=torch.float32, device=cuda)
    c = 0.05
    data = torch.full((2, 8, 9, 7), float("inf"), **f32)
    data[0, :8, :4, :7] = c
    data[1, :6, :9, :5] = c + 0.01 * torch.arange(6, **f32)[:, None, None]
    sizes = torch.tensor([[8, 4, 7], [6, 9, 5]], dtype=torch.int32,
                         device=cuda)
    lengths = torch.tensor([[0.8, 0.4, 0.7], [0.6, 0.9, 0.5]], **f32)
    S, B = 4, 2
    ln = lengths[1]
    sz = sizes[1].to(torch.float32)   # tensor divisors: IEEE division, as
    x = torch.empty((3, 1, S, B), **f32)          # the kernel computes it
    x[0] = (torch.zeros((), **f32) + 0.5) / sz[0] * ln[0]
    x[1] = ((torch.arange(S, **f32) + 0.5) / sz[1] * ln[1])[None, :, None]
    x[2] = (torch.full((), 2.0, **f32) + 0.5) / sz[2] * ln[2]
    rng = np.random.default_rng(9)
    vel = torch.as_tensor(rng.normal(size=(3, 1, S, 1)), **f32).expand(
        3, 1, S, B).contiguous()
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], **f32)
    pose = ident.expand(B, 2, 7).contiguous()
    enabled = torch.tensor([[True, True], [False, True]], device=cuda)
    args = (x, vel, vel.clone(), data, sizes, lengths, pose, pose.clone(),
            enabled, torch.full((S,), 0.02, **f32),
            torch.full((B,), 0.1, **f32), torch.full((B,), 200.0, **f32))
    want = sdf_lookup.obstacle_ref(*args)
    got = sdf_lookup.obstacle(*args)
    _close(got[0], want[0])
    _close(got[1], want[1])
    w = want[1].cpu()
    assert float((w[..., 0] - w[..., 1]).abs().max()) > 1e-3


def _selfcol_args(rng, dev, m=11, Sa=9, SI=2, B=37, scale=0.25):
    same = np.eye(Sa, Sa + SI, dtype=bool)
    same[0, 1] = same[1, 0] = True
    if SI:
        same[2, Sa] = True
    ra = rng.uniform(0.03, 0.1, size=Sa)
    rall = np.concatenate([ra, rng.uniform(0.03, 0.1, size=SI)])
    pi, pj, rsum = selfcol.pair_table(same, ra, rall)
    f32 = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f32).contiguous()   # noqa: E731
    vel = rng.normal(size=(3, m, Sa, B))
    vel[:, :, 0, :4] = 0.0
    return [t(rng.normal(size=(3, m, Sa, B)) * scale), t(vel),
            t(rng.normal(size=(3, SI, B)) * scale),
            torch.as_tensor(pi, device=dev), torch.as_tensor(pj, device=dev),
            t(rsum), t(rng.uniform(0.02, 0.08, size=B)),
            t(rng.uniform(5.0, 20.0, size=B))]


def _selfcol_check(args):
    want = selfcol.selfcol_pairs_ref(*args)
    n0 = selfcol.LAUNCHES
    got = selfcol.selfcol_pairs(*args)
    torch.cuda.synchronize()
    assert selfcol.LAUNCHES == n0 + 1
    _close(got[0], want[0])
    _close(got[1], want[1])
    return got, want


def test_selfcol_kernel_matches_plain(cuda):
    args = _selfcol_args(np.random.default_rng(4), cuda)
    _, want = _selfcol_check(args)
    assert float(want[1].abs().max()) > 0.0


@pytest.mark.parametrize("B", [1, 33, 100])
@pytest.mark.parametrize("SI", [0, 2])
def test_selfcol_kernel_ragged(cuda, B, SI):
    """One moving point, problem counts that leave a warp part empty."""
    args = _selfcol_args(np.random.default_rng(B + SI), cuda, m=1, SI=SI,
                         B=B, scale=0.1)
    _selfcol_check(args)


def test_selfcol_kernel_many_spheres(cuda):
    """More active spheres than warps in a block (30 > 16) and more
    spheres than lanes in a warp (35 > 32): warps take several spheres
    and the pair masks several 32-sphere chunks."""
    args = _selfcol_args(np.random.default_rng(8), cuda, m=3, Sa=30, SI=5,
                         B=40, scale=0.15)
    _, want = _selfcol_check(args)
    assert float(want[1][:, 16:].abs().max()) > 0.0


@pytest.mark.parametrize("case", ["out_of_reach", "stationary"])
def test_selfcol_kernel_exact_zeros(cuda, case):
    """Spheres all beyond reach, or all at rest: exactly 0 everywhere."""
    args = _selfcol_args(np.random.default_rng(5), cuda, m=3, B=40)
    if case == "out_of_reach":
        Sa, SI = args[0].shape[2], args[2].shape[1]
        far = 100.0 * torch.arange(Sa + SI, dtype=torch.float32,
                                   device=cuda)
        args[0][0] += far[:Sa, None]
        args[2][0] += far[Sa:, None]
    else:
        args[1].zero_()
    net, cost = selfcol.selfcol_pairs(*args)
    assert float(net.abs().max()) == 0.0 and float(cost.abs().max()) == 0.0


def test_selfcol_kernel_partial_warp_vote(cuda):
    """Only a few problems of each warp have a pair in reach: the warp
    takes the pair math, the problems out of reach add nothing."""
    args = _selfcol_args(np.random.default_rng(6), cuda, m=2, SI=1, B=64)
    Sa = args[0].shape[2]
    far = 100.0 * torch.arange(Sa + 1, dtype=torch.float32, device=cuda)
    args[0][0] += far[:Sa, None]
    args[2][0] += far[Sa:, None]
    for b in (3, 40):                       # one problem in each warp
        args[0][:, :, 4, b] = args[0][:, :, 3, b] + 0.01
    votes, near, taken, reach = selfcol.vote_stats(args[0], *args[2:7])
    assert 0 < taken <= near < votes and reach < taken * selfcol.LANES
    (net, cost), (_, cost_r) = _selfcol_check(args)
    hit = cost_r.abs().sum(dim=(0, 1)) > 0
    assert hit.nonzero().flatten().tolist() == [3, 40]
    assert float(cost[:, :, ~hit].abs().max()) == 0.0
    assert float(net[:, :, :, ~hit].abs().max()) == 0.0


def test_selfcol_kernel_deterministic(cuda):
    """No atomics: two launches on the same inputs are bit-equal."""
    args = _selfcol_args(np.random.default_rng(7), cuda, m=19, Sa=15, SI=1,
                         B=256, scale=0.15)
    a = selfcol.selfcol_pairs(*args)
    b = selfcol.selfcol_pairs(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_selfcol_kernel_residency(cuda):
    """The flagship shape (15 active spheres, 1 inactive) keeps the three
    blocks of 15 warps per SM the design counts on."""
    info = selfcol.launch_info(15, 1)
    assert info["threads"] == 15 * 32 and info["blocks_per_sm"] >= 3
    assert info["registers"] <= 40


def test_wrappers_reject_bad_inputs(cuda):
    args = list(_obstacle_args(np.random.default_rng(0), cuda))
    args[0] = args[0].double()
    with pytest.raises(ValueError, match="dtype"):
        sdf_lookup.obstacle(*args)
    args = list(_obstacle_args(np.random.default_rng(0), cuda))
    args[1] = args[1].transpose(2, 3).contiguous().transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        sdf_lookup.obstacle(*args)


def test_obstacle_kernel_three_fields_exact(cuda):
    """Three padded fields of different true sizes (+inf padding, one
    interior +inf cell), every field disabled in some problems: the
    kernel is bit-equal to its plain version, one-sided choices too."""
    rng = np.random.default_rng(11)
    F, m, S, B = 3, 5, 4, 70
    sizes = np.array([[8, 9, 7], [6, 9, 5], [8, 4, 6]], np.int32)
    lengths = np.array([[0.8, 0.9, 0.7], [0.6, 0.9, 0.5], [0.8, 0.4, 0.6]])
    data = np.full((F, 8, 9, 7), np.inf)
    for f, (sx, sy, sz) in enumerate(sizes):
        data[f, :sx, :sy, :sz] = rng.normal(size=(sx, sy, sz)) * 0.2 + 0.05
    data[1, 2, 3, 1] = np.inf
    pw = np.zeros((B, F, 7))
    pw[..., :3] = rng.normal(size=(B, F, 3)) * 0.05
    q = rng.normal(size=(B, F, 4))
    pw[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pg = np.stack([[np_pose.invert(p) for p in row] for row in pw])
    f32 = dict(dtype=torch.float32, device=cuda)
    t = lambda a: torch.as_tensor(a, **f32).contiguous()   # noqa: E731
    enabled = torch.ones((B, F), dtype=torch.bool, device=cuda)
    for f in range(F):
        enabled[f::5, f] = False
    args = (t(rng.uniform(-0.1, 0.9, size=(3, m, S, B))),
            t(rng.normal(size=(3, m, S, B))), t(rng.normal(size=(3, m, S, B))),
            t(data), torch.as_tensor(sizes, device=cuda), t(lengths), t(pg),
            t(pw), enabled, t(rng.uniform(0.03, 0.1, size=S)),
            t(rng.uniform(0.2, 0.5, size=B)), t(rng.uniform(100, 500, size=B)))
    want = sdf_lookup.obstacle_ref(*args, want_dirs=True)
    got = sdf_lookup.obstacle(*args, want_dirs=True)
    assert float((want[0] != 0).double().mean()) > 0.05  # hinge active
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ---- K1's launch geometry and skip paths, bit-equal -------------------------

_K1_SIZES = [[8, 9, 7], [6, 9, 5], [8, 4, 6], [3, 9, 2]]


def _k1_args(rng, dev, F=2, m=7, S=5, B=33, sizes=None):
    """K1 inputs over F fields of unequal true sizes (+inf padding, one
    interior +inf cell) and unequal cell sizes, each problem with its
    own poses; a list, so a case can change an argument."""
    sizes = np.array(sizes or _K1_SIZES[:F], np.int32)
    dims = sizes.max(axis=0)
    lengths = sizes * rng.uniform(0.06, 0.12, size=(F, 1))
    data = np.full((F, *dims), np.inf)
    for f, (sx, sy, sz) in enumerate(sizes):
        data[f, :sx, :sy, :sz] = rng.normal(size=(sx, sy, sz)) * 0.2 + 0.05
    data[0, 1, 2, 1] = np.inf
    pw = np.zeros((B, F, 7))
    pw[..., :3] = rng.normal(size=(B, F, 3)) * 0.05
    q = rng.normal(size=(B, F, 4))
    pw[..., 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    pg = np.stack([[np_pose.invert(p) for p in row] for row in pw])
    f32 = dict(dtype=torch.float32, device=dev)
    t = lambda a: torch.as_tensor(a, **f32).contiguous()   # noqa: E731
    enabled = torch.ones((B, F), dtype=torch.bool, device=dev)
    enabled[1::5, F - 1] = False
    vel = rng.normal(size=(3, m, S, B))
    vel[:, :, 0, :3] = 0.0
    return [t(rng.uniform(-0.1, 0.9, size=(3, m, S, B))), t(vel),
            t(rng.normal(size=(3, m, S, B))), t(data),
            torch.as_tensor(sizes, device=dev), t(lengths), t(pg), t(pw),
            enabled, t(rng.uniform(0.03, 0.1, size=S)),
            t(rng.uniform(0.2, 0.5, size=B)), t(rng.uniform(100, 500, size=B))]


def _k1_geometry(args, per=None):
    """The wrapper's geometry for these inputs, or (``per``) one with a
    smaller grid of longer per-block walks."""
    _, m, S, B = args[0].shape
    geom = sdf_lookup.device_geometry(m, S, B, *args[3].shape,
                                      args[0].device.index)
    if per is not None:
        geom = dataclasses.replace(geom, per=per,
                                   grid=-(-geom.units // per))
    return geom


def _k1_exact(args, geom=None):
    """The kernel, with and without the one-sided choices (the main path
    skips the subscripts of queries outside a box), against
    obstacle_ref: torch.equal on cost, gradient and dirs."""
    geom = geom or _k1_geometry(args)
    want = sdf_lookup.obstacle_ref(*args, want_dirs=True)
    n0 = sdf_lookup.LAUNCHES
    got = sdf_lookup.obstacle_launch(geom, *args, want_dirs=True)
    main = sdf_lookup.obstacle_launch(geom, *args)
    torch.cuda.synchronize()
    assert sdf_lookup.LAUNCHES == n0 + 2
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(main[0], want[0]) and torch.equal(main[1], want[1])
    return want


@pytest.mark.parametrize("shape", [
    dict(B=33), dict(B=257, m=3, S=4), dict(m=1, S=1, B=40),
    dict(m=1, S=9, B=70), dict(F=4, m=3, S=5, B=50), dict(F=1, B=1),
], ids=["B33", "B257", "m1S1", "m1S9", "F4", "B1"])
def test_obstacle_kernel_ragged_exact(cuda, shape):
    """Tiles of 32 problems left partly empty (B = 33, 257, 70, 1), fewer
    rows than warps (m = 1), F = 4 with unequal true sizes: bit-equal,
    with the hinge active."""
    args = _k1_args(np.random.default_rng(len(str(shape))), cuda, **shape)
    want = _k1_exact(args)
    assert float(want[0].abs().max()) > 0.0


@pytest.mark.parametrize("per", [10, 37, 1000])
def test_obstacle_kernel_partial_walks(cuda, per):
    """Blocks of 10, 37 or 1000 (tile, row) units: warps walk unequal row
    counts, a block's range crosses tiles (restaging their poses), and
    the last block's range is cut short."""
    args = _k1_args(np.random.default_rng(per), cuda, F=3, m=6, S=7, B=75)
    geom = _k1_geometry(args, per=per)
    assert geom.units % per != 0 and geom.grid * per >= geom.units
    _k1_exact(args, geom)


@pytest.mark.parametrize("case", ["outside", "disabled"])
def test_obstacle_kernel_skipped_gathers(cuda, case):
    """Every query outside every box, or every field disabled: no cell is
    read and the cost and gradient are exactly the plain version's."""
    args = _k1_args(np.random.default_rng(3), cuda, F=3, m=4, S=5, B=40)
    if case == "outside":
        args[0] = (args[0] + 50.0).contiguous()
    else:
        args[8] = torch.zeros_like(args[8])
    want = _k1_exact(args)
    assert float(want[0].abs().max()) == 0.0


def test_obstacle_kernel_cell_centres(cuda):
    """Queries exactly on cell centres of field 0 (identity pose), where
    the one-sided choice takes the next cell only if the kernel's centre
    rounds as obstacle_ref's: every centre axis uses the next cell."""
    rng = np.random.default_rng(12)
    m, S, B = 4, 6, 45
    args = _k1_args(rng, cuda, F=2, m=m, S=S, B=B)
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=cuda)
    for k in (6, 7):
        args[k][:, 0] = ident
    sizes = args[4][0].cpu()
    ln = args[5][0].cpu()
    x = torch.empty((3, m, S, B))
    for i in range(3):
        # inner cells only: cell 0 and the last one force their choice
        si = torch.as_tensor(rng.integers(1, int(sizes[i]) - 1,
                                          size=(m, S, B)))
        szf = sizes[i].to(torch.float32)
        x[i] = (si.to(torch.float32) + 0.5) / szf * ln[i]
    args[0] = x.to(cuda).contiguous()
    args[8] = torch.ones_like(args[8])
    want = _k1_exact(args)
    assert float((want[2][0] == 7).double().mean()) == 1.0


def test_obstacle_kernel_box_faces(cuda):
    """Queries on and around the faces of field 0's box (identity pose),
    one axis at a time: -0, ±1e-45, the pre-test's bounds -1e-6·ln and
    1.0001·ln and their float neighbours, ln and its neighbours.  The
    main path's division-free pre-test may skip only queries certainly
    outside, so with a 1 m hinge every query inside has a cost, and the
    kernel is bit-equal on both paths."""
    args = _k1_args(np.random.default_rng(13), cuda, F=1, m=1, S=1, B=33)
    ln = args[5][0].cpu().numpy().astype(np.float32)
    f32 = np.float32
    rows = []
    for i in range(3):
        lo, hi = f32(-ln[i] * f32(1e-6)), f32(ln[i] * f32(1.0001))
        for v in (f32(-0.0), f32(1e-45), f32(-1e-45), lo, ln[i], hi):
            for w in (v, np.nextafter(v, f32(-1)), np.nextafter(v, f32(2))):
                p = ln / 2
                p[i] = w
                rows.append(p)
    S = len(rows)
    x = torch.as_tensor(np.stack(rows).T[:, None, :, None].repeat(33, 3))
    ident = torch.tensor([0, 0, 0, 0, 0, 0, 1.0], device=cuda)
    args[0] = x.to(cuda).contiguous()
    args[1] = torch.ones_like(args[0])
    args[2] = torch.ones_like(args[0])
    args[6][:] = ident
    args[7][:] = ident
    args[8] = torch.ones_like(args[8])
    args[9] = torch.full((S,), 0.05, device=cuda)
    args[10] = torch.ones_like(args[10])
    want = _k1_exact(args)
    inside = ((x[:, 0] >= 0) & (x[:, 0] <= torch.as_tensor(ln)[:, None, None])
              ).all(dim=0)
    assert bool(inside.any()) and bool((~inside).any())
    assert bool((want[0][0].cpu() != 0)[inside].all())


def test_obstacle_kernel_deterministic(cuda):
    """Two launches on the same inputs are bit-equal."""
    args = _k1_args(np.random.default_rng(5), cuda, F=3, m=9, S=15, B=96)
    a = sdf_lookup.obstacle(*args)
    b = sdf_lookup.obstacle(*args)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_obstacle_kernel_large_stack(cuda):
    """A 280 KB stack, beyond what shared memory could hold: its cells
    are read from global memory, bit-equal."""
    args = _k1_args(np.random.default_rng(6), cuda, F=2, m=3, S=4, B=40,
                    sizes=[[40, 44, 20], [30, 44, 17]])
    assert 4 * args[3].numel() > sdf_lookup.SMEM_BLOCK_MAX
    _k1_exact(args)


def test_obstacle_kernel_launch_info(cuda):
    """The kernel compiles without spills and keeps at least three
    blocks of THREADS threads on an SM at config 2's shapes."""
    geom = sdf_lookup.device_geometry(99, 15, 256, 3, 11, 19, 11,
                                      torch.cuda.current_device())
    info = sdf_lookup.launch_info(geom.smem_bytes)
    assert info["local_bytes"] == 0 and info["blocks_per_sm"] >= 3
    assert geom.blocks_per_sm == info["blocks_per_sm"]
    assert geom.grid <= geom.blocks_per_sm * \
        torch.cuda.get_device_properties(0).multi_processor_count


@pytest.mark.parametrize("F, dims", [
    (1, (12, 16, 12)), (3, (11, 19, 11)), (4, (8, 9, 7)), (2, (40, 44, 20)),
])
def test_obstacle_smem_bytes_matches_kernel(cuda, F, dims):
    """The wrapper sizes the launch's shared memory with the layout the
    kernel indexes (sdf_lookup.smem_bytes against obstacle.cu's count)."""
    lib = kernels.library()
    assert sdf_lookup.smem_bytes(F, *dims) == \
        lib.cdx_obstacle_smem_bytes(F, *dims)


def _hmc_run(device, dtype):
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
    import or_cdchomp_tpu_torch as pt

    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    robot = pt.Robot("wam", pt.wam7(), q_active=start)
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    run = mod.runs[mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                              obs_factor=500.0, n_points=11, use_hmc=True,
                              hmc_resample_lambda=2.0, seed=3)]
    rng = np.random.default_rng(0)
    starts = start + 0.02 * rng.normal(size=(4, 7))
    goals = goal + 0.02 * rng.normal(size=(4, 7))
    return run, problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)


def test_hmc_steps_card_match_cpu(cuda):
    """Three HMC steps on the card (its own generator) against the same
    steps on the CPU in float64 fed the card's draws."""
    from or_cdchomp_tpu_torch.chomp.solver import RecordingDraw, ReplayDraw

    run, probs = _hmc_run(cuda, torch.float32)
    rec = RecordingDraw(run.engine.draw)
    run.engine.draw = rec
    run64, p64 = _hmc_run("cpu", torch.float64)
    run64.engine.draw = ReplayDraw(rec.z, rec.u)
    for _ in range(3):
        probs, _ = run.engine.step_batched(probs)
        p64, _ = run64.engine.step_batched(p64)
    assert probs.traj.device.type == "cuda" and len(rec.z) == 3
    for k in ("resample_iter", "leapfrog_first", "iteration"):
        assert torch.equal(getattr(probs, k).cpu(), getattr(p64, k)), k
    err = float((probs.traj.double().cpu() - p64.traj).abs().max())
    assert err <= 1e-5, err


def test_best_of_batch_on_card(cuda):
    """torch.argmin on the card: first index on ties, the first NaN row
    wins (as jnp.argmin)."""
    from or_cdchomp_tpu_torch.parallel.batch import best_of_batch

    run, probs = _hmc_run(cuda, torch.float32)
    for totals, want in (([3.0, 1.0, 2.0, 1.0], 1),
                         ([3.0, 1.0, float("nan"), 1.0], 2)):
        finals = torch.zeros((4, 3), device=cuda)
        finals[:, 0] = torch.tensor(totals, device=cuda)
        best, idx = best_of_batch(probs, finals)
        assert int(idx) == want
        assert torch.equal(best.traj, probs.traj[want])


def _config4_run(device, dtype, n_points=11, B=4):
    """Config 4 (benchmarks/configs.py:102-134) at a small shape: WAM7 on
    an SE(3) base with the upright everyn TSR, table + mug at 0.08 m,
    bench-perturbed endpoints (quaternion columns kept)."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
    import or_cdchomp_tpu_torch as pt

    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02)),
               ((0.75, 0.0, 0.25, 0, 0, 0, 1), (0.08, 0.08, 0.25))])))
    mod.add_kinbody(pt.KinBody("mug", pt.Scene.build(
        cylinders=[((0.65, 0.15, 0.58, 0, 0, 0, 1), 0.04, 0.06)])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    robot = pt.Robot("wam", pt.wam7(), q_active=start)
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.08)
    robot.enabled = True
    tsr = pt.TSR.from_matrices(np.eye(4), np.eye(4), Bw=np.array(
        [[-10, 10], [-10, 10], [-10, 10], [0, 0], [0, 0], [-np.pi, np.pi]]))
    run = mod.runs[mod.create(
        robot="wam", adofgoal=goal,
        basegoal=np.array([0.15, 0.1, 0.0, 0.0, 0.0, 0.0, 1.0]),
        floating_base=True, lambda_=200.0, obs_factor=200.0,
        n_points=n_points, everyn_tsr=tsr)]
    traj = run.problem.traj.double().cpu().numpy()
    rng = np.random.default_rng(0)
    starts = traj[0] + 0.02 * rng.normal(size=(B, 14))
    goals = traj[-1] + 0.02 * rng.normal(size=(B, 14))
    starts[:, 3:7] = traj[0, 3:7]
    goals[:, 3:7] = traj[-1, 3:7]
    return run, problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)


def test_selfcol_kernel_no_inactive_spheres(cuda):
    """A floating base makes every sphere active: K2 at SI = 0 (an empty
    xo) and Sa = 16 on config 4's own inputs."""
    from or_cdchomp_tpu_torch.chomp.cost_soa import sphere_kinematics

    run, probs = _config4_run(cuda, torch.float32, B=40)
    eng = run.engine
    _, x, vel, _ = sphere_kinematics(eng.spec, eng.fk, probs)
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    assert tuple(xo.shape) == (3, 0, 40) and x.shape[2] == 16
    args = [x, vel, xo, *eng.pairs, probs.epsilon_self, probs.obs_factor_self]
    _selfcol_check(args)
    # and with the spheres pulled together, so that pairs are in reach
    args[0] = (0.3 * (x - x.mean(dim=2, keepdim=True))).contiguous()
    _, want = _selfcol_check(args)
    assert float(want[1].abs().max()) > 0.0


def test_config4_steps_card_match_cpu(cuda):
    """Three config-4 steps (floating base, TSR projection) on the card
    in float32 against the same steps on the CPU in float64."""
    run, probs = _config4_run(cuda, torch.float32)
    run64, p64 = _config4_run("cpu", torch.float64)
    before = float(run.engine.constraint_values(probs).abs().max())
    n0 = selfcol.LAUNCHES, sdf_lookup.LAUNCHES
    for _ in range(3):
        probs, costs = run.engine.step_batched(probs)
        p64, costs64 = run64.engine.step_batched(p64)
    assert (selfcol.LAUNCHES, sdf_lookup.LAUNCHES) == (n0[0] + 3, n0[1] + 3)
    err = float((probs.traj.double().cpu() - p64.traj).abs().max())
    assert err <= 1e-5, err
    _close(costs, costs64.float())
    # the projection pulls roll and pitch of the end effector toward 0
    assert float(run.engine.constraint_values(probs).abs().max()) < \
        0.1 * before


# ---- K2 at any sphere count, K1 split along B, a module run -----------------

@pytest.mark.parametrize("SI", [0, 1])
@pytest.mark.parametrize("S", [117, 118, 250, 600])
def test_selfcol_kernel_any_sphere_count(cuda, S, SI):
    """S spheres in all (SI inactive) on either side of the staged path's
    shared-memory limit: the launch takes the path launch_shape names,
    matches the plain version and is bit-equal across two launches."""
    Sa = S - SI
    args = _selfcol_args(np.random.default_rng(S + SI), cuda, m=3, Sa=Sa,
                         SI=SI, B=40, scale=0.6)
    info = selfcol.launch_info(Sa, SI)
    assert info["path"] == selfcol.launch_shape(Sa, SI)[0]
    assert info["path"] == ("staged" if Sa + SI <= 117 else "tiled")
    got, want = _selfcol_check(args)
    again = selfcol.selfcol_pairs(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert float(want[1].abs().max()) > 0.0


@pytest.mark.parametrize("Sa, SI", [(1, 0), (15, 1), (16, 0), (116, 1),
                                    (117, 0), (117, 1), (118, 0), (125, 1),
                                    (600, 1), (1024, 0)])
def test_selfcol_launch_shape_matches_kernel(cuda, Sa, SI):
    """The wrapper's mirror of the dispatch rule and of the staged
    layout (selfcol.launch_shape) against cdx_selfcol_launch_info; no
    path spills or needs more than a block may have."""
    path, threads, smem = selfcol.launch_shape(Sa, SI)
    info = selfcol.launch_info(Sa, SI)
    assert (info["path"], info["threads"], info["smem_bytes"]) == \
        (path, threads, smem)
    assert smem <= selfcol.SMEM_BLOCK_MAX and info["blocks_per_sm"] >= 1
    assert info["local_bytes"] == 0


def test_obstacle_forced_split_bit_equal(cuda, monkeypatch):
    """A call past the per-launch query limit (forced low) is split along
    B into launches whose results are bit-equal to one launch."""
    args = _k1_args(np.random.default_rng(21), cuda, F=3, m=5, S=7, B=100)
    whole = sdf_lookup.obstacle(*args, want_dirs=True)
    monkeypatch.setattr(sdf_lookup, "MAX_QUERIES", 5 * 7 * 37)
    n0 = sdf_lookup.LAUNCHES
    split = sdf_lookup.obstacle(*args, want_dirs=True)
    assert sdf_lookup.LAUNCHES == n0 + 3               # 37 + 37 + 26
    for a, b in zip(split, whole):
        assert torch.equal(a, b)


def test_module_iterate_card_matches_cpu(cuda):
    """A run (B = 1) iterated on the card in float32 against the same
    run on the CPU in float64; launches one K1 and one K2 per step and
    one each for the final cost."""
    import or_cdchomp_tpu_torch as pt

    def run(device, dtype):
        mod = pt.CHOMPModule(dtype=dtype, device=device)
        mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
            boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
        robot = pt.Robot("wam", pt.wam7(), q_active=np.array(
            [2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0]))
        mod.add_robot(robot)
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.04)
        robot.enabled = True
        h = mod.create(robot="wam", adofgoal=np.array(
            [0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0]), lambda_=100.0,
            obs_factor=500.0, n_points=21)
        return mod, h

    mod, h = run(cuda, torch.float32)
    mod64, h64 = run("cpu", torch.float64)
    n0 = selfcol.LAUNCHES, sdf_lookup.LAUNCHES
    cost = mod.iterate(run=h, n_iter=20)
    assert (selfcol.LAUNCHES, sdf_lookup.LAUNCHES) == (n0[0] + 21, n0[1] + 21)
    cost64 = mod64.iterate(run=h64, n_iter=20)
    assert mod.runs[h].problem.traj.device.type == "cuda"
    err = float((mod.runs[h].problem.traj.double().cpu()
                 - mod64.runs[h64].problem.traj).abs().max())
    assert err <= 1e-5, err
    assert abs(cost - cost64) <= 1e-4 * abs(cost64)


# ---- the front door: start_tsr, start_cost, an XML robot by strings ---------

def _front_door(device, dtype):
    """chip_smoke's front door at a small shape: the WAM7 + hand from its
    OpenRAVE XML text on config 1's world, the field built by a command
    string.  Returns (module, start TSR)."""
    import chip_smoke as cs
    import or_cdchomp_tpu_torch as pt

    model = pt.parse_robot_xml(cs.wam7_xml(pt))
    return cs.front_door_module(pt, model, dtype, device), cs.front_door_tsr(pt)


def test_kernels_at_start_tsr_shape(cuda):
    """K1 (bit-equal, both paths) and K2 on a start_tsr batch's own
    inputs: n_points − 1 moving rows, point 0 with its one-sided
    velocity."""
    import chip_smoke as cs
    from or_cdchomp_tpu_torch.chomp.cost_soa import sphere_kinematics
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    mod, tsr = _front_door(cuda, torch.float32)
    run = mod.runs[mod.create(**dict(cs.run_kw(), n_points=11),
                              start_tsr=tsr)]
    starts, goals = cs.bench_endpoints(40)
    probs = problem_batch_from_grid(run.problem, starts, goals, run.engine)
    eng = run.engine
    _, x, vel, acc = sphere_kinematics(eng.spec, eng.fk, probs)
    assert tuple(x.shape) == (3, 10, 15, 40)
    _k1_exact(cs.obstacle_args(eng, probs, x, vel, acc))
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    _selfcol_check([x, vel, xo, *eng.pairs, probs.epsilon_self,
                    probs.obs_factor_self])


def test_front_door_strings_card_match_cpu(cuda):
    """create with start_tsr, iterate, gettraj and destroy as command
    strings on the card in float32 against the CPU in float64; one K1
    and one K2 launch per step and one each for the final cost."""
    import chip_smoke as cs
    import or_cdchomp_tpu_torch as pt

    mod, tsr = _front_door(cuda, torch.float32)
    mod64, _ = _front_door("cpu", torch.float64)
    n0 = selfcol.LAUNCHES, sdf_lookup.LAUNCHES
    cost, out, before, after, spec = cs.string_drive(pt, mod, tsr, n_iter=20,
                                                     n_points=21)
    assert (selfcol.LAUNCHES, sdf_lookup.LAUNCHES) == (n0[0] + 21, n0[1] + 21)
    cost64, out64, *_ = cs.string_drive(pt, mod64, tsr, n_iter=20,
                                        n_points=21)
    assert spec.start_tsr and spec.m == 20
    err = np.abs(np.array(out["positions"]) - np.array(out64["positions"]))
    assert err.max() <= 1e-5, err.max()
    assert abs(cost - cost64) <= 1e-4 * abs(cost64)
    assert after < 0.01 * before


def test_start_cost_batch_card_matches_cpu(cuda):
    """A quadratic start_cost hook, vmapped over a B = 4 batch, on the
    card in float32 against the CPU in float64."""
    import chip_smoke as cs
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    starts, goals = cs.bench_endpoints(4)
    outs = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        mod, _ = _front_door(dev, dt)
        run = mod.runs[mod.create(**dict(cs.run_kw(), n_points=11),
                                  start_cost=cs.quadratic_hook(torch, dt,
                                                               dev))]
        probs = problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)
        outs.append(BatchSolver(run.engine).iterate(probs, 5))
    (out, costs), (out64, costs64) = outs
    err = float((out.traj.double().cpu() - out64.traj).abs().max())
    assert err <= 1e-5, err
    _close(costs, costs64.float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B, m, n", [(5, 3, 7), (33, 99, 7), (2, 1, 1)])
def test_hmc_draw_kernel_matches_plain(cuda, dtype, B, m, n):
    """The draw kernel's words bit-equal to its plain version's; z and u
    within 1e-6 relative (the float64 transcendentals of two libraries,
    then one cast); one launch."""
    from or_cdchomp_tpu_torch.ops import draw

    seed = torch.as_tensor(np.array([7, -3, 2 ** 40 + 1] * 11)[:B])
    it = torch.arange(B, dtype=torch.int32) * 7
    want = draw.hmc_draw(seed, it, m, n, dtype, want_words=True)
    n0 = draw.LAUNCHES
    got = draw.hmc_draw(seed.to(cuda), it.to(cuda), m, n, dtype,
                        want_words=True)
    assert draw.LAUNCHES == n0 + 1
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == dtype
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(w.abs().max()))
    assert float(got[1].max()) < 1.0 and float(got[1].min()) >= 1e-12


def test_hmc_draw_kernel_batch_independent(cuda):
    """Rows 2..4 of a B = 40 launch bit-equal to the same rows alone."""
    from or_cdchomp_tpu_torch.ops import draw

    seed = (100 + torch.arange(40)).to(cuda)
    it = (torch.arange(40, dtype=torch.int32) % 5).to(cuda)
    z, u = draw.hmc_draw(seed, it, 99, 7, torch.float32)
    zs, us = draw.hmc_draw(seed[2:5].contiguous(), it[2:5].contiguous(), 99,
                           7, torch.float32)
    assert torch.equal(z[2:5], zs) and torch.equal(u[2:5], us)


def _ragged_stack(dev):
    """Three fields of different sizes (+inf padding), a +inf interior
    cell in the second, and queries spanning each box and its outside."""
    from or_cdchomp_tpu_torch.ops import grid

    rng = np.random.default_rng(31)
    shapes = [(6, 9, 5), (8, 4, 7), (5, 6, 6)]
    lens = [(0.6, 0.9, 0.5), (0.8, 0.4, 0.7), (0.5, 0.6, 0.55)]
    grids = []
    for i, (s, ln) in enumerate(zip(shapes, lens)):
        d = rng.normal(size=s).astype(np.float32)
        if i == 1:
            d[2, 1, 3] = np.inf
        grids.append(grid.Grid3D(data=torch.as_tensor(d),
                                 lengths=torch.tensor(ln)))
    stack = grid.pad_stack_grids(grids, device=dev)
    p = rng.uniform(-0.1, 1.1, size=(50, 7, 3, 3)) * np.asarray(lens)
    return stack, torch.as_tensor(p, dtype=torch.float32, device=dev)


def test_multigrid_interp_grad_card_matches_cpu(cuda):
    """multigrid_interp_grad on the card (K1's raw lookup, one launch)
    against the same float32 call on the CPU, on a ragged 3-field stack;
    a float64 call on the card raises."""
    from or_cdchomp_tpu_torch.ops import grid

    stack, p = _ragged_stack(cuda)
    args = (stack.data, stack.sizes, stack.lengths)
    n0 = sdf_lookup.LOOKUP_LAUNCHES
    v, g, inb = grid.multigrid_interp_grad(*args, p)
    assert sdf_lookup.LOOKUP_LAUNCHES == n0 + 1
    vc, gc, inbc = grid.multigrid_interp_grad(*(a.cpu() for a in args),
                                              p.cpu())
    assert torch.equal(inb.cpu(), inbc)
    assert torch.equal(torch.isposinf(v).cpu(), torch.isposinf(vc))
    assert bool(inbc.any() and (~inbc).any() and torch.isposinf(vc[inbc]).any())
    fin = torch.isfinite(vc)
    _close(v.cpu()[fin], vc[fin])
    _close(g.cpu(), gc)
    with pytest.raises(ValueError, match="float64"):
        grid.multigrid_interp_grad(stack.data, stack.sizes,
                                   stack.lengths.double(), p.double())


def test_sdf_cell_lookup_card_query_limit(cuda):
    """The raw lookup takes fewer than 2**31 queries per field and raises
    past that, before it launches (zero-stride views, nothing allocated)."""
    data = torch.zeros((1, 2, 2, 2), device=cuda)
    sub = torch.zeros((1, 1, 3), dtype=torch.int32,
                      device=cuda).expand(1, 2 ** 31, 3)
    n0 = sdf_lookup.LOOKUP_LAUNCHES
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sdf_lookup.sdf_cell_lookup(data, sub, sub)
    assert sdf_lookup.LOOKUP_LAUNCHES == n0


def test_per_problem_fk_card_matches_cpu(cuda):
    """fk_spheres and apply_sphere_jacT on the card in float32 against
    the CPU in float64 (the WAM7, a batch of configurations)."""
    from or_cdchomp_tpu_torch.models.robot import CompiledFK
    from or_cdchomp_tpu_torch.models.wam7 import wam7

    rng = np.random.default_rng(32)
    q = rng.uniform(-2.0, 2.0, size=(6, 11, 7))
    base = np.array([0.1, -0.2, 0.3, 0.0, 0.0, 0.38268343, 0.92387953])
    w = rng.normal(size=(6, 11, 16, 3))
    out = []
    for dev, dt in ((cuda, torch.float32), ("cpu", torch.float64)):
        fk = CompiledFK(wam7(), dtype=dt, device=dev)
        x, jac, lp = fk.fk_spheres(q, base)
        _, anchors = fk.red_poses(q, base)
        g = fk.apply_sphere_jacT(anchors, x, torch.as_tensor(w, dtype=dt,
                                                             device=dev))
        out.append((x, jac, lp, g))
    for a, b in zip(*out):
        np.testing.assert_allclose(a.double().cpu().numpy(), b.numpy(),
                                   rtol=1e-4, atol=1e-5)
