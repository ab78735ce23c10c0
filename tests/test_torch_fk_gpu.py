"""The FK kernel (csrc/fk.cu) against the plain ``CompiledFK.fk_soa_plain``
on the card.  Skipped without a CUDA device; run on the card with
``python -m pytest tests/test_torch_fk_gpu.py -q --noconftest``.

Tolerances: float32 within 2e-6 (m on positions, unitless on quaternions
and axes, all of magnitude ≤ ~2): the two evaluate the same formulas in
the same association, and may differ only where a sin or cos of the
library rounds apart from the kernel's (each ≤ 1 ulp, carried down a
7-joint chain); float64 within 1e-12 for the same reason."""

import pytest
import torch

from fk_cases import inputs, make_fk, max_err
from or_cdchomp_tpu_torch.ops import fk as fk_kernel

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 2e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check(fk, args):
    """One kernel launch against the plain version; returns the outputs."""
    n0 = fk_kernel.FK_LAUNCHES
    got = fk.fk_soa(*args)
    torch.cuda.synchronize()
    assert fk_kernel.FK_LAUNCHES == n0 + 1
    want = fk.fk_soa_plain(*args)
    assert max_err(got, want) <= TOL[fk.dtype]
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B", [1, 255, 256, 10_240])
@pytest.mark.parametrize("base", ["fixed", "floating"])
def test_fk_kernel_wam7(cuda, dtype, B, base):
    fk = make_fk("wam7", dtype, cuda)
    got = _check(fk, inputs(fk, 101, B, base, dtype, cuda, seed=B))
    for comps in got:   # one contiguous (c, n_points, K, B) tensor each
        n = comps[0].numel() * comps[0].element_size()
        assert all(c.is_contiguous() for c in comps)
        assert [c.data_ptr() - comps[0].data_ptr() for c in comps] == \
            [i * n for i in range(len(comps))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot, base", [
    ("urdf_prismatic", "fixed"), ("urdf_prismatic", "floating"),
    ("wam7_all_subset", "fixed"), ("wam7_frozen", "floating"),
    ("no_dof", "fixed"), ("wam7", "scalar"),
])
def test_fk_kernel_robots(cuda, dtype, robot, base):
    """A prismatic and a fixed joint, a branch whose parent is read back,
    frozen joints folded into K, no DOF at all, one pose for every
    point and problem (the trajectory check's fixed base)."""
    fk = make_fk(robot, dtype, cuda)
    _check(fk, inputs(fk, 33, 37, base, dtype, cuda, seed=2))


@pytest.mark.parametrize("robot", ["wam7", "no_dof"])
def test_fk_kernel_fields_share_one_buffer(cuda, robot):
    """The six FkSoA fields are the kernel's one output buffer, unsplit:
    (c, n_points, ·, B) views of a single storage, laid end to end in the
    order x, anch_pos, anch_q, axis_w, red_pos, red_q."""
    fk = make_fk(robot, torch.float32, cuda)
    out = fk.fk_soa(*inputs(fk, 9, 40, "fixed", torch.float32, cuda))
    assert len({t.untyped_storage().data_ptr() for t in out}) == 1
    at = 0     # in elements: an empty field (no DOF) has no data pointer
    for t, c in zip(out, (3, 3, 4, 3, 3, 4)):
        assert isinstance(t, torch.Tensor) and t.is_contiguous()
        assert t.shape[0] == c and t.shape[1] == 9 and t.shape[3] == 40
        assert t.storage_offset() == at
        at += t.numel()
    assert at * 4 == out.x.untyped_storage().nbytes()


def test_fk_kernel_matches_table_walk(cuda):
    """The kernel and its plain version over the same table words."""
    fk = make_fk("urdf_prismatic", torch.float64, cuda)
    args = inputs(fk, 9, 40, "floating", torch.float64, cuda, seed=5)
    want = fk_kernel.fk_soa_table_ref(fk.fk_table, fk.n_dof,
                                      len(fk.sphere_subset), *args)
    assert max_err(fk.fk_soa(*args), want) <= TOL[torch.float64]


@pytest.mark.parametrize("n_spheres", [2_900, 4_000])
def test_fk_kernel_large_tables(cuda, n_spheres):
    """A table just under the 48 KB a block stages (2,900 spheres, 46 KB)
    runs; one past it (4,000 spheres, 63 KB) is refused before any
    launch."""
    from fk_cases import with_spheres

    fk = with_spheres(n_spheres, torch.float32, cuda)
    args = inputs(fk, 3, 70, "fixed", torch.float32, cuda, seed=1)
    if fk.fk_table.numel() * 4 <= fk_kernel.TABLE_BYTES_MAX:
        _check(fk, args)
        return
    n0 = fk_kernel.FK_LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        fk.fk_soa(*args)
    assert fk_kernel.FK_LAUNCHES == n0


def test_fk_kernel_graph_replay(cuda):
    """A CUDA graph capture of the call and its replays equal the eager
    call, counted once per replay through the recorded launch."""
    from or_cdchomp_tpu_torch.ops import kernels

    fk = make_fk("wam7", torch.float32, cuda)
    qT, bp, bq = inputs(fk, 101, 256, "floating", torch.float32, cuda)
    want = fk.fk_soa(qT, bp, bq)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fk.fk_soa(qT, bp, bq)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with kernels.recording() as records, torch.cuda.graph(g):
        got = fk.fk_soa(qT, bp, bq)
    assert records == [(fk_kernel, "FK_LAUNCHES")]
    n0 = fk_kernel.FK_LAUNCHES
    for _ in range(2):
        g.replay()
        kernels.replay_counts(records)
    torch.cuda.synchronize()
    assert fk_kernel.FK_LAUNCHES == n0 + 2
    assert max_err(got, want) == 0.0


def test_fk_kernel_refuses_other_card_dtype(cuda):
    fk = make_fk("wam7", torch.float32, cuda)
    qT, bp, bq = inputs(fk, 5, 3, "fixed", torch.float64, cuda)
    with pytest.raises(ValueError, match="dtype"):
        fk.fk_soa(qT, bp, bq)
    qT, bp, bq = inputs(fk, 5, 3, "fixed", torch.float32, cuda)
    with pytest.raises(ValueError, match="is on cpu"):
        fk.fk_soa(qT, tuple(c.cpu() for c in bp), bq)
