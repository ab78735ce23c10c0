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
RTOL64 = 1e-12   # the same in float64 (K2's sum order and rsqrt)


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
    if Sa > 1:
        same[0, 1] = same[1, 0] = True
    if SI and Sa > 2:
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
    # a dtype the kernels are not built for raises: no plain version
    n0 = sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES, selfcol.LAUNCHES
    half = [a.half() if a.is_floating_point() else a for a in
            _obstacle_args(np.random.default_rng(0), cuda)]
    with pytest.raises(ValueError, match="dtype"):
        sdf_lookup.obstacle(*half)
    sub = torch.zeros((2, 4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        sdf_lookup.sdf_cell_lookup(half[3], sub, sub)
    sargs = [a.bfloat16() if a.is_floating_point() else a for a in
             _selfcol_args(np.random.default_rng(0), cuda)]
    with pytest.raises(ValueError, match="dtype"):
        selfcol.selfcol_pairs(*sargs)
    assert (sdf_lookup.LAUNCHES, sdf_lookup.LOOKUP_LAUNCHES,
            selfcol.LAUNCHES) == n0
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
                                      args[0].device.index, args[0].dtype)
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
    """The wrapper's mirror of the dispatch rule, of the staged layout
    and of the tiled block (16 warps, its ring of chunk slots;
    selfcol.launch_shape) against cdx_selfcol_launch_info, in float32
    and float64; no path spills or needs more than a block may have, and
    a float32 tiled block keeps the two blocks per SM it is built for."""
    for dtype in (torch.float32, torch.float64):
        path, threads, smem = selfcol.launch_shape(Sa, SI, dtype.itemsize)
        info = selfcol.launch_info(Sa, SI, dtype)
        assert (info["path"], info["threads"], info["smem_bytes"]) == \
            (path, threads, smem)
        assert smem <= selfcol.SMEM_BLOCK_MAX and info["blocks_per_sm"] >= 1
        assert info["local_bytes"] == 0
        if path == "tiled" and dtype == torch.float32:
            assert threads == 512 and info["blocks_per_sm"] >= 2


# ---- K2's tiled path ------------------------------------------------------

@pytest.mark.parametrize("B", [1, 33, 256])
@pytest.mark.parametrize("SI", [0, 1, 3])
@pytest.mark.parametrize("S", [118, 126, 200, 300])
def test_selfcol_tiled_matches_plain(cuda, S, SI, B):
    """The tiled path at S spheres in all (SI inactive; at 118 with 3
    inactive the staged block still fits, and takes them): the ring
    holds every chunk up to 256 spheres and streams at 300; a call
    without a layout builds it (one launch of the layout kernel,
    bit-equal to the plain builder), then one K2 launch matches the
    plain version and a second is bit-equal to it."""
    Sa = S - SI
    args = _selfcol_args(np.random.default_rng(S * 10 + SI + B), cuda, m=3,
                         Sa=Sa, SI=SI, B=B, scale=0.6)
    tiled = selfcol.launch_shape(Sa, SI)[0] == "tiled"
    assert tiled == ((S, SI) != (118, 3))
    n0 = selfcol.LAYOUT_LAUNCHES
    got, want = _selfcol_check(args)
    assert selfcol.LAYOUT_LAUNCHES == n0 + tiled
    layout = selfcol.pair_layout(*args[3:6], Sa, S)
    plain = selfcol.pair_layout_ref(*(a.cpu() for a in args[3:6]), Sa, S)
    for g, w in zip(layout, plain):
        assert torch.equal(g.cpu(), w)
    again = selfcol.selfcol_pairs(*args, layout)
    assert selfcol.LAYOUT_LAUNCHES == n0 + tiled + 1
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert float(want[1].abs().max()) > 0.0


@pytest.mark.parametrize("S, m, B", [(126, 264, 1), (300, 264, 1),
                                     (126, 99, 256), (300, 600, 1)])
def test_selfcol_tiled_rounds(cuda, S, m, B):
    """Shapes with as many (point, tile) work items as the card holds
    blocks (264 points of one problem) or more (the grab's 99 x 8, or
    600): no z-groups, so each warp takes its active spheres in rounds
    (8 at 126 spheres, 19 at 300), every chunk resident (126) or streamed
    (300)."""
    args = _selfcol_args(np.random.default_rng(S + m), cuda, m=m, Sa=S - 1,
                         SI=1, B=B, scale=0.6)
    got, want = _selfcol_check(args)
    again = selfcol.selfcol_pairs(*args)
    assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
    assert float(want[1].abs().max()) > 0.0


def test_selfcol_tiled_uneven_mirror(cuda):
    """An active pair (i, j) whose radius sum differs from its mirror
    (j, i)'s: the layout marks no mirror, so (j, i) takes a vote of its
    own with its own radius sum, and the result stays the plain one."""
    args = _selfcol_args(np.random.default_rng(12), cuda, m=4, Sa=125, SI=1,
                         B=64, scale=0.5)
    pi, pj, rsum = args[3:6]
    p = int(((pi == 4) & (pj == 9)).nonzero())
    q = int(((pi == 9) & (pj == 4)).nonzero())
    rsum[p] += 0.03
    args[0][:, :, 9] = args[0][:, :, 4] + 0.05     # the pair in reach
    layout = selfcol.pair_layout(pi, pj, rsum, 125, 126)
    words = layout.masks.cpu()
    g, lane = divmod(layout.partners[4].flatten().tolist().index(9), 32)
    assert int(words[4, g, 2]) >> lane & 1 == 0     # no mirror bit
    assert int(words[4, g, 1]) >> lane & 1 == 1     # (9, 4) votes alone
    assert float(rsum[p]) != float(rsum[q])
    _, want = _selfcol_check(args)
    assert float(want[0][:, :, 4].abs().max()) > 0.0


@pytest.mark.parametrize("case", ["out_of_reach", "stationary"])
def test_selfcol_tiled_exact_zeros(cuda, case):
    """The tiled path with every sphere beyond reach, or all at rest:
    exactly 0 everywhere."""
    args = _selfcol_args(np.random.default_rng(15), cuda, m=3, Sa=125,
                         SI=1, B=40)
    if case == "out_of_reach":
        far = 100.0 * torch.arange(126, dtype=torch.float32, device=cuda)
        args[0][0] += far[:125, None]
        args[2][0] += far[125:, None]
    else:
        args[1].zero_()
    net, cost = selfcol.selfcol_pairs(*args)
    assert float(net.abs().max()) == 0.0 and float(cost.abs().max()) == 0.0


def test_selfcol_tiled_partial_warp_vote(cuda):
    """The tiled path at a ragged B = 33 (a second warp of one live
    lane): only problems 3 and 32 have a pair in reach, so two warps
    take the pair math and the problems out of reach add nothing."""
    args = _selfcol_args(np.random.default_rng(16), cuda, m=2, Sa=125,
                         SI=1, B=33)
    far = 100.0 * torch.arange(126, dtype=torch.float32, device=cuda)
    args[0][0] += far[:125, None]
    args[2][0] += far[125:, None]
    for b in (3, 32):
        args[0][:, :, 40, b] = args[0][:, :, 41, b] + 0.01
    votes, near, taken, reach = selfcol.vote_stats(args[0], *args[2:7])
    assert 0 < taken <= near < votes and reach < taken * selfcol.LANES
    (net, cost), (_, cost_r) = _selfcol_check(args)
    hit = cost_r.abs().sum(dim=(0, 1)) > 0
    assert hit.nonzero().flatten().tolist() == [3, 32]
    assert float(cost[:, :, ~hit].abs().max()) == 0.0
    assert float(net[:, :, :, ~hit].abs().max()) == 0.0


def _grab_run(device, dtype, B=40):
    """Config 1's world with a 110-sphere tray held at the hand (126
    spheres, 125 active) at n_points 11, and a batch of B perturbed
    problems."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
    import or_cdchomp_tpu_torch as pt

    model = pt.wam7().with_spheres([
        ("handbase", (0.03 * (a - 4.5), 0.03 * (c - 5.0), 0.22), 0.015)
        for a in range(10) for c in range(11)])
    mod = pt.CHOMPModule(dtype=dtype, device=device)
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    robot = pt.Robot("wam", model, q_active=start)
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.08)
    robot.enabled = True
    run = mod.runs[mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                              obs_factor=500.0, n_points=11)]
    rng = np.random.default_rng(3)
    return run, problem_batch_from_grid(
        run.problem, start + 0.3 * rng.normal(size=(B, 7)),
        goal + 0.3 * rng.normal(size=(B, 7)), run.engine)


def test_selfcol_engine_layout(cuda):
    """The engine's layout (built once, on the host) equals the layout
    kernel's on its pair table, bit for bit; a K2 call that passes it
    and one that passes none give bit-equal results; a step launches
    K2 once and builds no layout."""
    from or_cdchomp_tpu_torch.chomp.cost_soa import sphere_kinematics

    run, probs = _grab_run(cuda, torch.float32)
    eng = run.engine
    _, x, vel, _ = sphere_kinematics(eng.spec, eng.fk, probs)
    assert x.shape[2] == eng.n_spheres_active == 125
    for g, w in zip(selfcol.pair_layout(*eng.pairs, 125, 126),
                    eng.pair_layout):
        assert torch.equal(g, w)
    xo = probs.inactive_pos.permute(2, 1, 0).contiguous()
    args = [x, vel, xo, *eng.pairs, probs.epsilon_self, probs.obs_factor_self]
    n0 = selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES
    with_layout = selfcol.selfcol_pairs(*args, eng.pair_layout)
    assert (selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES) == (n0[0] + 1, n0[1])
    without = selfcol.selfcol_pairs(*args)
    assert (selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES) == (n0[0] + 2,
                                                           n0[1] + 1)
    for a, b in zip(with_layout, without):
        assert torch.equal(a, b)
    _, want = _selfcol_check(args + [eng.pair_layout])
    assert float(want[1].abs().max()) > 0.0
    n0 = selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES
    eng.step_batched(probs)
    assert (selfcol.LAUNCHES, selfcol.LAYOUT_LAUNCHES) == (n0[0] + 1, n0[1])


# ---- float64: the kernels' double instantiations --------------------------

def _double(args):
    return [a.double() if a.is_floating_point() else a for a in args]


def test_sdf_cell_lookup_float64_exact(cuda):
    """The raw lookup's float64 kernel reads the same cells as its plain
    version, bit for bit, in one launch."""
    rng = np.random.default_rng(2)
    F, mx, my, mz, Q = 3, 5, 6, 7, 999
    data = torch.as_tensor(rng.normal(size=(F, mx, my, mz)), device=cuda)
    sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
    nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                  np.array([mx, my, mz]) - 1).astype(np.int32)
    args = (data, torch.as_tensor(sub, device=cuda),
            torch.as_tensor(nbr, device=cuda))
    n0 = sdf_lookup.LOOKUP_LAUNCHES
    got = sdf_lookup.sdf_cell_lookup(*args)
    assert sdf_lookup.LOOKUP_LAUNCHES == n0 + 1
    for g, w in zip(got, sdf_lookup.sdf_cell_lookup_ref(*args)):
        assert g.dtype == torch.float64 and torch.equal(g, w)


@pytest.mark.parametrize("shape", [
    dict(B=33), dict(F=3, m=3, S=5, B=70), dict(F=1, B=1),
], ids=["B33", "F3", "B1"])
def test_obstacle_kernel_float64_exact(cuda, shape):
    """K1's float64 kernel on both paths against obstacle_ref in float64
    on the card: the same expressions in the same order, so cost,
    gradient and one-sided choices are bit-equal, as in float32."""
    args = _double(_k1_args(np.random.default_rng(23), cuda, **shape))
    want = _k1_exact(args)
    assert want[0].dtype == torch.float64
    assert float(want[0].abs().max()) > 0.0


def test_obstacle_kernel_float64_launch_info(cuda):
    """The float64 kernel's shared memory is the float32 layout in
    8-byte words, counted alike by the wrapper and the kernel, and at
    least one block fits an SM at config 2's shapes."""
    lib = kernels.library()
    for F, dims in ((1, (12, 16, 12)), (3, (11, 19, 11))):
        assert sdf_lookup.smem_bytes(F, *dims, 8) == \
            lib.cdx_obstacle_smem_bytes_f64(F, *dims) == \
            2 * lib.cdx_obstacle_smem_bytes(F, *dims)
    geom = sdf_lookup.device_geometry(99, 15, 256, 3, 11, 19, 11,
                                      torch.cuda.current_device(),
                                      torch.float64)
    info = sdf_lookup.launch_info(geom.smem_bytes, torch.float64)
    assert geom.blocks_per_sm == info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("Sa, SI, B", [(9, 2, 37), (15, 1, 256), (15, 0, 5),
                                       (120, 1, 40), (1, 1, 256), (1, 3, 33),
                                       (126, 0, 40), (125, 1, 256),
                                       (299, 1, 33)])
def test_selfcol_kernel_float64(cuda, Sa, SI, B):
    """K2's float64 kernel (the tiled path at every sphere count: its
    ring resident up to 128 spheres, streamed at 300) against
    selfcol_pairs_ref in float64 on the card, within RTOL64, one launch,
    bit-equal across two launches."""
    args = _double(_selfcol_args(np.random.default_rng(Sa + B), cuda, m=5,
                                 Sa=Sa, SI=SI, B=B, scale=0.4))
    info = selfcol.launch_info(Sa, SI, torch.float64)
    assert info["path"] == selfcol.launch_shape(Sa, SI, 8)[0] == "tiled"
    assert info["blocks_per_sm"] >= 1
    want = selfcol.selfcol_pairs_ref(*args)
    n0 = selfcol.LAUNCHES
    got = selfcol.selfcol_pairs(*args)
    again = selfcol.selfcol_pairs(*args)
    torch.cuda.synchronize()
    assert selfcol.LAUNCHES == n0 + 2
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.float64 and torch.equal(g, a)
        np.testing.assert_allclose(
            g.cpu().numpy(), w.cpu().numpy(), rtol=RTOL64,
            atol=RTOL64 * float(w.abs().max()))
    assert float(want[1].abs().max()) > 0.0


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


def test_float64_module_card_matches_cpu(cuda):
    """CHOMPModule(dtype=float64) on the card: runchomp and a B = 4 batch
    run K1's and K2's float64 kernels (one launch each per step) and
    equal the CPU's float64 on the same field within 1e-9."""
    import or_cdchomp_tpu_torch as pt
    from or_cdchomp_tpu_torch.parallel.batch import (BatchSolver,
                                                     problem_batch_from_grid)

    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    kw = dict(robot="wam", adofgoal=goal, lambda_=100.0, obs_factor=500.0,
              n_points=21)
    rng = np.random.default_rng(4)
    starts = start + 0.02 * rng.normal(size=(4, 7))
    goals = goal + 0.02 * rng.normal(size=(4, 7))
    field = None
    res = []
    for dev in (cuda, torch.device("cpu")):
        mod = pt.CHOMPModule(dtype=torch.float64, device=dev)
        mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
            boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
        robot = pt.Robot("wam", pt.wam7(), q_active=start.copy())
        mod.add_robot(robot)
        robot.enabled = False
        mod.computedistancefield(kinbody="table", cube_extent=0.04)
        robot.enabled = True
        if field is None:
            field = mod.sdfs[0].grid.data.cpu()
        else:                         # the card's field on both
            mod.sdfs[0].grid.data = field.clone()
        n0 = sdf_lookup.LAUNCHES, selfcol.LAUNCHES
        cost = [0.0]
        traj = mod.runchomp(n_iter=20, cost=cost, **kw)
        run = mod.runs[mod.create(**kw)]
        probs = problem_batch_from_grid(run.problem, starts, goals,
                                        run.engine)
        out, costs = BatchSolver(run.engine).iterate(probs, 20)
        n = sdf_lookup.LAUNCHES - n0[0], selfcol.LAUNCHES - n0[1]
        assert n == ((0, 0) if dev.type == "cpu" else (n[0], n[0]))
        assert dev.type == "cpu" or n[0] >= 40
        assert out.traj.dtype == torch.float64
        assert out.traj.device.type == dev.type
        res.append((traj, cost[0], out.traj.cpu(), costs.cpu()))
    (traj, cost, bt, bc), (traj_c, cost_c, bt_c, bc_c) = res
    assert traj.in_collision == traj_c.in_collision
    np.testing.assert_allclose(traj.positions, traj_c.positions, rtol=0,
                               atol=1e-9)
    assert abs(cost - cost_c) <= 1e-9 * abs(cost_c)
    assert float((bt - bt_c).abs().max()) <= 1e-9
    np.testing.assert_allclose(bc.numpy(), bc_c.numpy(), rtol=1e-9,
                               atol=1e-9 * float(bc_c.abs().max()))


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
                                  start_cost=cs.quadratic_hook(torch))]
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
    a float64 call on the card (the lookup's float64 kernel, one launch)
    equals the CPU's within 1e-12."""
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
    args64 = (stack.data.double(), stack.sizes, stack.lengths.double())
    n0 = sdf_lookup.LOOKUP_LAUNCHES
    v, g, inb = grid.multigrid_interp_grad(*args64, p.double())
    assert sdf_lookup.LOOKUP_LAUNCHES == n0 + 1
    assert v.dtype == g.dtype == torch.float64 and v.device.type == "cuda"
    vc, gc, inbc = grid.multigrid_interp_grad(
        *(a.cpu() for a in args64), p.double().cpu())
    assert torch.equal(inb.cpu(), inbc)
    assert torch.equal(torch.isposinf(v).cpu(), torch.isposinf(vc))
    fin = torch.isfinite(vc)
    np.testing.assert_allclose(v.cpu()[fin].numpy(), vc[fin].numpy(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(g.cpu().numpy(), gc.numpy(), rtol=1e-12,
                               atol=1e-12)


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


# ---- launches on a card that is not the current device ----------------------

@pytest.fixture
def other_card():
    """The machine's last card, with cuda:0 the runtime's current device:
    every kernel must launch on its tensors' card whatever is current.
    Skipped with fewer than two cards."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    yield torch.device("cuda", torch.cuda.device_count() - 1)
    torch.cuda.set_device(0)


def _on_card(args, dev):
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["obstacle", "lookup", "selfcol_staged",
                                    "selfcol_tiled", "layout", "draw"])
def test_kernels_launch_on_a_card_that_is_not_current(other_card, kernel,
                                                      dtype):
    """K1 (both of its paths), the raw lookup, K2 on its staged path
    (float32; float64 always tiles) and its tiled path, the layout
    kernel and the draw, each launched on the last card while cuda:0 is
    current: one launch, its results on that card and equal to the plain
    version (K1's on the same card, the others' on the CPU; bit for bit
    where the plain version is, K2 within its rtol), and cuda:0 still
    current afterwards."""
    from or_cdchomp_tpu_torch.ops import draw

    dev = other_card
    rng = np.random.default_rng(41)
    if kernel == "obstacle":
        # bit-equal to the plain version on the same card, as everywhere
        # (in float64 the CPU's plain version differs in the last bit)
        args = _on_card(_k1_args(rng, "cpu"), dev)
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        want = [w.cpu() for w in sdf_lookup.obstacle_ref(*args,
                                                         want_dirs=True)]
        n0 = sdf_lookup.LAUNCHES
        got = sdf_lookup.obstacle(*args, want_dirs=True)
        main = sdf_lookup.obstacle(*args)
        assert sdf_lookup.LAUNCHES == n0 + 2
        assert torch.equal(main[0].cpu(), want[0])
        assert torch.equal(main[1].cpu(), want[1])
    elif kernel == "lookup":
        F, mx, my, mz, Q = 2, 5, 6, 7, 1000
        sub = rng.integers(0, [mx, my, mz], size=(F, Q, 3)).astype(np.int32)
        nbr = np.clip(sub + rng.choice([-1, 1], size=(F, Q, 3)), 0,
                      np.array([mx, my, mz]) - 1).astype(np.int32)
        args = (torch.as_tensor(rng.normal(size=(F, mx, my, mz)),
                                dtype=dtype),
                torch.as_tensor(sub), torch.as_tensor(nbr))
        want = sdf_lookup.sdf_cell_lookup_ref(*args)
        n0 = sdf_lookup.LOOKUP_LAUNCHES
        got = sdf_lookup.sdf_cell_lookup(*_on_card(args, dev))
        assert sdf_lookup.LOOKUP_LAUNCHES == n0 + 1
    elif kernel.startswith("selfcol"):
        Sa, SI = (9, 2) if kernel == "selfcol_staged" else (125, 1)
        args = _selfcol_args(rng, "cpu", m=3, Sa=Sa, SI=SI, B=37,
                             scale=0.6)
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        path = selfcol.launch_shape(Sa, SI, dtype.itemsize)[0]
        if kernel == "selfcol_staged" and path != "staged":
            pytest.skip("float64 has no staged path")
        assert path == kernel.removeprefix("selfcol_")
        want = selfcol.selfcol_pairs_ref(*args)
        card = _on_card(args, dev)
        layout = (selfcol.pair_layout(*card[3:6], Sa, Sa + SI)
                  if path == "tiled" else None)
        n0 = selfcol.LAUNCHES
        got = selfcol.selfcol_pairs(*card, layout)
        assert selfcol.LAUNCHES == n0 + 1
        assert float(want[1].abs().max()) > 0.0
        for g, w in zip(got, want):
            assert g.device == dev
            np.testing.assert_allclose(
                g.double().cpu().numpy(), w.double().numpy(),
                rtol=RTOL if dtype == torch.float32 else RTOL64,
                atol=(RTOL if dtype == torch.float32 else RTOL64)
                * max(float(w.abs().max()), 1e-30))
        got = want = ()
    elif kernel == "layout":
        args = _selfcol_args(rng, "cpu", m=3, Sa=125, SI=1, B=4)[3:6]
        args[2] = args[2].to(dtype)
        want = selfcol.pair_layout_ref(*args, 125, 126)
        n0 = selfcol.LAYOUT_LAUNCHES
        got = selfcol.pair_layout(*_on_card(args, dev), 125, 126)
        assert selfcol.LAYOUT_LAUNCHES == n0 + 1
    else:
        seed = torch.as_tensor(np.array([7, -3, 2 ** 40 + 1] * 11))
        it = torch.arange(33, dtype=torch.int32) * 7
        want = draw.hmc_draw(seed, it, 99, 7, dtype, want_words=True)[2:]
        n0 = draw.LAUNCHES
        got = draw.hmc_draw(seed.to(dev), it.to(dev), 99, 7, dtype,
                            want_words=True)[2:]
        assert draw.LAUNCHES == n0 + 1
    torch.cuda.synchronize(dev)
    for g, w in zip(got, want):
        assert g.device == dev
        assert torch.equal(g.cpu(), w)
    assert torch.cuda.current_device() == 0


def test_kernels_refuse_tensors_on_two_cards(other_card):
    """A kernel call whose tensors lie on two cards raises ValueError
    before it launches."""
    rng = np.random.default_rng(42)
    args = _on_card(_k1_args(rng, "cpu"), other_card)
    args[3] = args[3].to("cuda:0")                 # the field stack
    n0 = sdf_lookup.LAUNCHES
    with pytest.raises(ValueError, match="expected"):
        sdf_lookup.obstacle(*args)
    sargs = _on_card(_selfcol_args(rng, "cpu"), other_card)
    sargs[1] = sargs[1].to("cuda:0")               # the velocities
    with pytest.raises(ValueError, match="expected"):
        selfcol.selfcol_pairs(*sargs)
    assert sdf_lookup.LAUNCHES == n0


# ---- the joint-limit repair, and the step replayed as a CUDA graph ---------

def _limit_case(dev, dtype, B=37, m=99, n=7, seed=5):
    """(T, lo, hi) with rows pushed out of their limits: a few entries of
    most rows by up to 0.3, every eighth row left clean."""
    rng = np.random.default_rng(seed)
    lo = np.full((B, n), -1.0)
    hi = np.full((B, n), 1.0)
    lo[:, 6], hi[:, 6] = -2.5, 0.75
    T = rng.uniform(-0.3, 0.3, size=(B, m, n))
    for b in range(B):
        if b % 8 == 0:
            continue
        for _ in range(1 + b % 4):
            i, j = rng.integers(m), rng.integers(n)
            side = rng.choice([-1.0, 1.0])
            T[b, i, j] = (hi[b, j] if side > 0 else lo[b, j]) \
                + side * rng.uniform(0.01, 0.3)
    t = (lambda a: torch.as_tensor(a, dtype=dtype, device=dev))  # noqa: E731
    return t(T), t(lo), t(hi)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("metric", ["dense", "sep"])
def test_limit_repair_kernel_matches_plain(cuda, dtype, metric):
    """The limits kernel against its plain version on the machine's last
    card with cuda:0 current (on a one-card machine, that card): one
    launch, float32 within rtol 1e-5 and float64 within 1e-12 of max |T|,
    every clean row untouched, the same rounds per problem, and two
    launches bit-equal."""
    from or_cdchomp_tpu_torch.chomp import metric as metric_mod
    from or_cdchomp_tpu_torch.ops import limits

    torch.cuda.set_device(0)
    dev = torch.device("cuda", torch.cuda.device_count() - 1)
    m = 99 if metric == "dense" else 300
    T, lo, hi = _limit_case(dev, dtype, m=m)
    dt = 1.0 / (m + 1)
    met = (torch.as_tensor(metric_mod.build_metric(m, dt).Ainv, dtype=dtype,
                           device=dev) if metric == "dense" else dt)
    want, wstats = limits.limit_repair_ref(T, lo, hi, met, want_stats=True)
    n0 = limits.LAUNCHES
    got, stats = limits.limit_repair(T, lo, hi, met, want_stats=True)
    assert limits.LAUNCHES == n0 + 1
    again = limits.limit_repair(T, lo, hi, met)
    torch.cuda.synchronize(dev)
    assert got.device == dev and torch.cuda.current_device() == 0
    rtol = RTOL if dtype == torch.float32 else RTOL64
    np.testing.assert_allclose(got.double().cpu().numpy(),
                               want.double().cpu().numpy(), rtol=rtol,
                               atol=rtol * float(want.abs().max()))
    assert torch.equal(got[::8], T[::8])
    assert torch.equal(stats.cpu(), wstats.cpu())
    assert int(stats[:, 0].max()) >= 1
    assert torch.equal(again, got)


def _graph_run(device, kind, B=4):
    """A run and its B-problem batch for the replay tests: config 1 at
    n_points 11 (``config1``), the same with HMC (``seeded``: seeds per
    problem; ``unseeded``, ``recorded``: the engine's draw source), or
    config 4 (``config4``)."""
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid
    import or_cdchomp_tpu_torch as pt

    if kind == "config4":
        return _config4_run(device, torch.float32, B=B)
    mod = pt.CHOMPModule(dtype=torch.float32, device=device)
    mod.add_kinbody(pt.KinBody("table", pt.Scene.build(
        boxes=[((0.75, 0.0, 0.5, 0, 0, 0, 1), (0.25, 0.4, 0.02))])))
    start = np.array([2.5, -1.8, 0.0, 2.0, 0.0, 0.2, 0.0])
    goal = np.array([0.4, 0.6, 0.1, 1.3, 0.0, -0.5, 0.0])
    robot = pt.Robot("wam", pt.wam7(), q_active=start)
    mod.add_robot(robot)
    robot.enabled = False
    mod.computedistancefield(kinbody="table", cube_extent=0.04)
    robot.enabled = True
    hmc = kind != "config1"
    run = mod.runs[mod.create(robot="wam", adofgoal=goal, lambda_=100.0,
                              obs_factor=500.0, n_points=11, use_hmc=hmc,
                              hmc_resample_lambda=2.0, seed=3)]
    rng = np.random.default_rng(0)
    starts = start + 0.02 * rng.normal(size=(B, 7))
    goals = goal + 0.02 * rng.normal(size=(B, 7))
    starts[0, 0] = 2.75             # problem 0 starts past J1's limit (2.6)
    return run, problem_batch_from_grid(
        run.problem, starts, goals, run.engine,
        seeds=np.arange(B) + 7 if kind == "seeded" else None)


def _launch_counts():
    from or_cdchomp_tpu_torch.ops import draw, limits

    return (sdf_lookup.LAUNCHES, selfcol.LAUNCHES, limits.LAUNCHES,
            draw.LAUNCHES)


@pytest.mark.parametrize("kind", ["config1", "config4", "seeded",
                                  "unseeded", "recorded"])
def test_iterate_replays_match_eager_steps(cuda, kind):
    """iterate_batched on the card (its first step eager, the rest
    replays of one captured step; then a second call, all replays)
    against a loop of eager step_batched calls: every leaf and every cost
    bit-equal, K1, K2 and the limits kernel counted once a step either
    way, the seeded draw kernel once a step; unseeded HMC from two fresh
    generators of one seed, and a recording's draws replayed (ReplayDraw
    called once a step)."""
    from or_cdchomp_tpu_torch.chomp.solver import (HmcDraw, RecordingDraw,
                                                   ReplayDraw)

    run, probs = _graph_run(cuda, kind)
    eng, n = run.engine, 6

    def draws():
        if kind in ("unseeded", "recorded"):
            return HmcDraw(5, cuda)
        return None

    rec = RecordingDraw(draws()) if kind == "recorded" else draws()
    eager, costs = probs, []
    c0 = _launch_counts()
    for _ in range(n):
        eager, c = eng.step_batched(eager, rec)
        costs.append(c)
    c1 = _launch_counts()
    per_call = tuple(b - a for a, b in zip(c0, c1))
    for call in range(2):
        draw = ReplayDraw(rec.z, rec.u) if kind == "recorded" else draws()
        out, got = eng.iterate_batched(probs, n, draw)
        c2 = _launch_counts()
        assert tuple(b - a for a, b in zip(c1, c2)) == per_call, \
            (call, per_call, c1, c2)
        c1 = c2
        for k, v in eager.leaves().items():
            assert torch.equal(out.leaves()[k], v), (call, k)
        assert torch.equal(got, torch.stack(costs, dim=1)), call
        if kind == "recorded":
            assert draw.calls == n
    assert c1[0] - c0[0] == 3 * n and c1[2] - c0[2] == 3 * n
    if kind != "config4":          # the repair held J1 below its limit
        assert float(eager.traj[0, 1:-1, 0].max()) <= 2.6 + 1e-6


def test_iterate_refuses_a_syncing_hook(cuda):
    """An extra_cost hook that synchronises the card: step_batched runs it
    eagerly, iterate_batched raises naming the capture (no eager
    fallback); the engine's next capture, of a hook-free engine, works."""
    from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
    import or_cdchomp_tpu_torch as pt

    run, probs = _graph_run(cuda, "config1")

    def hook(T):
        torch.cuda.synchronize()
        return 0.5 * (T * T).sum(), T

    e = run.engine
    eng = ChompEngine(e.spec, pt.wam7(), e.fields, extra_cost=hook,
                      dtype=torch.float32, device=cuda)
    eng.step_batched(probs)
    with pytest.raises(RuntimeError, match="capturing the step failed"):
        eng.iterate_batched(probs, 3)
    out, costs = e.iterate_batched(probs, 3)
    assert bool(torch.isfinite(costs).all())
