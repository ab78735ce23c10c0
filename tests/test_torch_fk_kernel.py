"""The FK kernel's input on the CPU (ops/fk.py): the packed table walked by
the kernel's plain version, ``fk_soa_table_ref``, against the plain
``CompiledFK.fk_soa`` on all six outputs (float64, rtol and atol 1e-12:
the same arithmetic, read from the table's words); the table's layout and
its copy by ``_on``; the wrapper's refusals.  The kernel itself runs in
tests/test_torch_fk_gpu.py on the card."""

import numpy as np
import pytest
import torch

from fk_cases import ROBOTS, inputs, make_fk, with_spheres
from or_cdchomp_tpu_torch.ops import fk as fk_kernel

TOL = 1e-12
F64 = torch.float64


def _ref(fk, qT, bp, bq):
    return fk_kernel.fk_soa_table_ref(fk.fk_table, fk.n_dof,
                                      len(fk.sphere_subset), qT, bp, bq)


def _assert_equal(got, want, tol):
    for f, g, w in zip(("x", "anch_pos", "anch_q", "axis_w", "red_pos",
                        "red_q"), got, want):
        assert len(g) == len(w), f
        for gc, wc in zip(g, w):
            assert tuple(gc.shape) == tuple(wc.shape), f
            np.testing.assert_allclose(gc.numpy(), wc.numpy(), rtol=tol,
                                       atol=tol, err_msg=f)


@pytest.mark.parametrize("robot, base", [
    ("wam7", "fixed"), ("wam7", "floating"), ("wam7", "scalar"),
    ("wam7_all_subset", "fixed"), ("wam7_frozen", "floating"),
    ("urdf_prismatic", "fixed"), ("urdf_prismatic", "floating"),
    ("no_dof", "fixed"), ("no_dof", "floating"),
])
def test_table_walk_matches_fk_soa(robot, base):
    fk = make_fk(robot, F64, "cpu")
    args = inputs(fk, 7, 5, base, F64, "cpu", seed=3)
    _assert_equal(_ref(fk, *args), fk.fk_soa(*args), TOL)


def test_table_walk_float32():
    """In float32 the walk reads the table's float32 words, as the plain
    version rounds its Python constants to float32: the two agree to
    float32 rounding."""
    fk = make_fk("wam7_all_subset", torch.float32, "cpu")
    args = inputs(fk, 5, 9, "floating", torch.float32, "cpu", seed=4)
    _assert_equal(_ref(fk, *args), fk.fk_soa(*args), 2e-6)


def test_cpu_fk_soa_is_the_plain_version():
    fk = make_fk("wam7", F64, "cpu")
    args = inputs(fk, 4, 3, "fixed", F64, "cpu")
    n0 = fk_kernel.FK_LAUNCHES
    _assert_equal(fk.fk_soa(*args), fk.fk_soa_plain(*args), 0.0)
    assert fk_kernel.FK_LAUNCHES == n0


@pytest.mark.parametrize("robot, base", [("wam7", "floating"),
                                         ("no_dof", "fixed")])
def test_fields_are_batch_last_tensors(robot, base):
    """Each FkSoA field of the plain version is one contiguous (c,
    n_points, ·, B) tensor, components leading, as the kernel writes it;
    iterating it yields its components."""
    fk = make_fk(robot, F64, "cpu")
    out = fk.fk_soa(*inputs(fk, 6, 5, base, F64, "cpu"))
    S, D, R = len(fk.sphere_subset), fk.n_dof, fk.n_red
    shapes = dict(x=(3, S), anch_pos=(3, D), anch_q=(4, D), axis_w=(3, D),
                  red_pos=(3, R), red_q=(4, R))
    for f, (c, K) in shapes.items():
        t = getattr(out, f)
        assert isinstance(t, torch.Tensor), f
        assert tuple(t.shape) == (c, 6, K, 5) and t.is_contiguous(), f
        assert [tuple(p.shape) for p in t] == [(6, K, 5)] * c, f


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_table_layout(robot):
    """The words of the table: per chain entry its fields, per slot the
    start of its spheres (sorted by slot), per sphere its index and
    folded offset."""
    fk = make_fk(robot, F64, "cpu")
    t = fk._fk_table_np
    E, S = len(fk._chain), len(fk.sphere_subset)
    assert E == fk.n_dof == fk.n_red - 1
    assert t.shape == (fk_kernel.table_words(E, S),)
    W = fk_kernel.ENTRY_WORDS
    for e, ch in enumerate(fk._chain):
        w = t[W * e:W * (e + 1)]
        np.testing.assert_array_equal(
            w, [ch["parent_slot"], ch["dof"], ch["jtype"], ch["rot_id"],
                ch["pos_zero"], *ch["axis"], *ch["K"]])
    start = t[W * E:W * E + fk.n_red + 1].astype(int)
    sph = t[W * E + fk.n_red + 1:].reshape(S, fk_kernel.SPHERE_WORDS)
    slot = fk._sphere_red_slot_np
    assert start[0] == 0 and start[-1] == S
    for r in range(fk.n_red):
        idx = sph[start[r]:start[r + 1], 0].astype(int)
        assert (slot[idx] == r).all()
    np.testing.assert_array_equal(np.sort(sph[:, 0]), np.arange(S))
    np.testing.assert_array_equal(sph[:, 1:],
                                  fk._sphere_folded_np[sph[:, 0].astype(int)])


def test_table_survives_on():
    fk = make_fk("urdf_prismatic", torch.float32, "cpu")
    other = fk._on("cpu")
    assert other.fk_table is not fk.fk_table
    assert other.fk_table.dtype == torch.float32
    assert torch.equal(other.fk_table, fk.fk_table)
    assert torch.equal(fk.fk_table, torch.as_tensor(fk._fk_table_np,
                                                    dtype=torch.float32))
    args = inputs(fk, 3, 4, "fixed", torch.float32, "cpu")
    _assert_equal(_ref(other, *args), _ref(fk, *args), 0.0)


def test_pack_table_refuses_a_short_chain():
    fk = make_fk("wam7", F64, "cpu")
    with pytest.raises(ValueError, match="chain entries"):
        fk_kernel.pack_table(fk._chain[:-1], fk.n_red,
                             fk._sphere_red_slot_np, fk._sphere_folded_np)


def _bad(case, fk):
    qT, bp, bq = inputs(fk, 4, 3, "fixed", F64, "cpu")
    if case == "dtype":
        return qT.float(), bp, bq
    if case == "half":
        return qT.half(), bp, bq
    if case == "ndof":
        return qT[:, :-1], bp, bq
    if case == "rank":
        return qT[0], bp, bq
    if case == "base_shape":
        return qT, (torch.zeros(5, 3, dtype=F64), *bp[1:]), bq
    if case == "base_dtype":
        return qT, (bp[0].float(), *bp[1:]), bq
    if case == "base_count":
        return qT, bp[:2], bq
    return qT, bp, bq   # "cpu": right in all but the device


@pytest.mark.parametrize("case, match", [
    ("dtype", "dtype"), ("half", "float32 or float64"), ("ndof", "shape"),
    ("rank", "shape"), ("base_shape", "broadcastable"),
    ("base_dtype", "dtype"), ("base_count", "components"),
    ("cpu", "CUDA"),
])
def test_wrapper_refuses(case, match):
    """The launch checks dtype, shape and device before anything runs:
    here every input is refused on the CPU, where no kernel exists."""
    fk = make_fk("wam7", F64, "cpu")
    n0 = fk_kernel.FK_LAUNCHES
    with pytest.raises(ValueError, match=match):
        fk_kernel.fk_soa(fk.fk_table, fk.n_dof, len(fk.sphere_subset),
                         *_bad(case, fk))
    assert fk_kernel.FK_LAUNCHES == n0


def test_wrapper_refuses_a_table_past_shared_memory():
    """A robot whose table passes the 48 KB a block stages (1,600 more
    spheres in float64, 51 KB) is refused before the device is read."""
    fk = with_spheres(1_600, F64, "cpu")
    assert fk.fk_table.numel() * 8 > fk_kernel.TABLE_BYTES_MAX
    n0 = fk_kernel.FK_LAUNCHES
    with pytest.raises(ValueError, match="shared memory"):
        fk_kernel.fk_soa(fk.fk_table, fk.n_dof, len(fk.sphere_subset),
                         *inputs(fk, 3, 2, "fixed", F64, "cpu"))
    assert fk_kernel.FK_LAUNCHES == n0


def test_traffic_bytes_wam7():
    """171 values per (point, problem) written and 7 joint values read
    for the engine's WAM7 FK (S = 15 active spheres, D = 7, n_red = 8),
    and the 7 base values of each problem."""
    got = fk_kernel.traffic_bytes(101, 256, 7, 15, 256, 4)
    assert got == (7 * 101 * 256 + 7 * 256 + 171 * 101 * 256) * 4
