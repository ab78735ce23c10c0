"""The Jᵀ map kernel's input on the CPU (ops/jtmap.py): the packed table
walked by the kernel's plain version, ``jtmap_table_ref``, against the
step's plain code (``cost_soa._jacT`` on the CPU: w_obs + w_self, then
``CompiledFK.apply_sphere_jacT_soa``, and ``_base_jacT``'s sums for the
totals) in float64 within 1e-12 (the same arithmetic, the sums over the
spheres in another order); the table's words; the wrapper's refusals.
The kernel itself runs in tests/test_torch_jtmap_gpu.py on the card."""

import re
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fk_cases import URDF_BRANCH, inputs, make_fk
from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.models.urdf import parse_urdf
from or_cdchomp_tpu_torch.models.wam7 import wam7
from or_cdchomp_tpu_torch.ops import jtmap as jt

TOL = 1e-12
F64 = torch.float64

# URDF_BRANCH without its second branch: a serial chain with a prismatic
# joint (revolute, prismatic, fixed tool, revolute)
URDF_SERIAL = re.sub(r'<joint name="j4".*?</joint>', "",
                     re.sub(r'<link name="thumb">.*?</link>', "", URDF_BRANCH,
                            flags=re.S), flags=re.S)


def _tray():
    """The WAM7 carrying the benchmark's tray: 110 spheres of 1.5 cm on
    ``handbase`` (126 spheres in all)."""
    model = wam7()
    rows = [("handbase", (0.03 * (i - 4.5), 0.03 * (j - 5.0), 0.22), 0.015)
            for i in range(10) for j in range(11)]
    return CompiledFK(model.with_spheres(rows), dtype=F64, device="cpu")


def _fk(case):
    """An FK of each structure the kernel reads."""
    if case == "tray":
        return _tray()
    if case == "serial_prismatic":
        return CompiledFK(parse_urdf(URDF_SERIAL), dtype=F64, device="cpu")
    if case == "wam7_sorted":   # a sphere order the suffix walk must sort
        model = wam7()
        return CompiledFK(model, dtype=F64, device="cpu",
                          sphere_subset=np.arange(len(model.sphere_link))[::-1])
    if case == "wam7_mask":     # the masked chain of a branching robot
        fk = make_fk("wam7", F64, "cpu")
        fk._jt_suffix = None
        fk._to_device()
        return fk
    return make_fk(case, F64, "cpu")


CASES = {
    # case: (suffix walk, a prismatic joint, the order sorted)
    "wam7": (True, False, False),
    "wam7_mask": (False, False, False),
    "wam7_sorted": (True, False, True),
    "wam7_frozen": (True, False, False),
    "serial_prismatic": (True, True, False),
    "urdf_prismatic": (False, True, False),
    "wam7_all_subset": (False, False, False),
    "no_dof": (False, False, False),
    "tray": (True, False, False),
}


def _args(fk, m, B, lo, seed=0):
    """(anchors, axes, x, w_obs, w_self) as the step hands them over: the
    anchors and axes views of an FK's outputs at points lo .. lo + m − 1
    (lo 0 under start_tsr, else 1), the gradients seeded normals."""
    n_points = m + 2 - lo
    out = fk.fk_soa(*inputs(fk, n_points, B, "fixed", F64, "cpu", seed))
    rng = np.random.default_rng(seed + 1)
    S = len(fk.sphere_subset)
    x = out.x[:, lo:lo + m].contiguous()
    w_obs, w_self = (torch.as_tensor(rng.normal(size=(3, m, S, B)))
                     for _ in range(2))
    return (out.anch_pos[:, lo:lo + m], out.axis_w[:, lo:lo + m], x, w_obs,
            w_self)


def _today(fk, lo, m, totals, args):
    """The step's plain code on the CPU (``cost_soa._jacT``)."""
    spec = SimpleNamespace(start_tsr=lo == 0, m=m, floating_base=totals)
    anch, axes, x, wo, ws = args

    def pad(t):   # the step slices [lo, lo + m) itself: lo rows in front
        return torch.cat([torch.zeros_like(t[:, :1]).expand(
            -1, lo, -1, -1), t], dim=1)

    fk_out = SimpleNamespace(anch_pos=pad(anch), axis_w=pad(axes))
    return cost_soa._jacT(spec, fk, fk_out, x, wo, ws)


@pytest.mark.parametrize("totals", [False, True])
@pytest.mark.parametrize("lo", [0, 1])
@pytest.mark.parametrize("case", sorted(CASES))
def test_table_walk_matches_the_step(case, lo, totals):
    fk = _fk(case)
    suffix, prismatic, sorted_ = CASES[case]
    assert (fk._jt_suffix is not None) == suffix
    assert bool(np.any(fk._jtype_per_dof_np == 2)) == prismatic
    if suffix:
        assert (fk._jt_order is not None) == sorted_
    m, B = 5, 4
    args = _args(fk, m, B, lo, seed=len(case))
    G, tot = jt.jtmap_table_ref(fk.jt_table, fk.n_dof, *args, totals=totals)
    G0, tot0 = _today(fk, lo, m, totals, args)
    assert tuple(G.shape) == (m, fk.n_dof, B)
    np.testing.assert_allclose(G.numpy(), G0.numpy(), rtol=0, atol=TOL)
    if totals:
        assert tuple(tot.shape) == (6, m, B)
        np.testing.assert_allclose(tot.numpy(), tot0.numpy(), rtol=0,
                                   atol=TOL)
    else:
        assert tot is None and tot0 is None


def test_tray_has_126_spheres():
    fk = _tray()
    assert len(fk.sphere_subset) == 126 and fk._jt_suffix is not None
    _, lst = jt.table_steps(fk.jt_table.tolist(), fk.n_dof)
    assert sorted(lst) == list(range(126))


def _summed(fk):
    """The spheres each step's sums hold when it emits, from the table
    walked as the kernel walks it: a list of D + 1 sorted lists."""
    steps, lst = jt.table_steps(fk.jt_table.tolist(), fk.n_dof)
    held, out = [], []
    for clear, lo, hi, _, _ in steps:
        if clear:
            held = []
        held = held + lst[lo:hi]
        out.append(sorted(held))
    return steps, out


@pytest.mark.parametrize("case", sorted(CASES))
def test_table_words(case):
    """Each DOF's step sums exactly the spheres its mask gives it, once
    each, and writes its own row with its joint type; the last step sums
    every sphere; a suffix walk never clears after its first step and
    adds each sphere once."""
    fk = _fk(case)
    D, S = fk.n_dof, len(fk.sphere_subset)
    t = fk.jt_table
    assert t.dtype == torch.int32 and t.dim() == 1
    steps, summed = _summed(fk)
    assert len(steps) == D + 1
    mask = fk._sphere_dof_mask_np
    for (clear, _, _, d, jtype), held in zip(steps[:D], summed[:D]):
        assert held == list(np.flatnonzero(mask[:, d]))
        assert jtype == fk._jtype_per_dof_np[d]
    assert sorted(s[3] for s in steps[:D]) == list(range(D))
    assert steps[D][3:] == (D, 0)
    assert summed[D] == list(range(S))
    _, lst = jt.table_steps(t.tolist(), D)
    if fk._jt_suffix is not None:
        assert [s[0] for s in steps] == [1] + [0] * D
        assert len(lst) == S
        assert [s[3] for s in steps[:D]] == list(range(D - 1, -1, -1))
    else:
        assert all(s[0] for s in steps)
    assert t.numel() == jt.STEP_WORDS * (D + 1) + len(lst)


def test_table_words_serial_prismatic():
    """The words of a 3-DOF serial chain (revolute, prismatic, revolute;
    spheres 0..5 moved by the first 0, 1, 2, 2, 3, 3 DOFs): the steps
    from the last DOF to the first, each over its new spheres of the
    order walked from its end, then the totals over the rest."""
    fk = _fk("serial_prismatic")
    order, start = fk._jt_suffix
    assert list(order) == list(range(6)) and list(start) == [1, 2, 4]
    assert fk.jt_table.tolist() == [
        1, 0, 2, 2, 1,     # DOF 2: spheres 5, 4
        0, 2, 4, 1, 2,     # DOF 1: then 3, 2
        0, 4, 5, 0, 1,     # DOF 0: then 1
        0, 5, 6, 3, 0,     # the totals: then 0
        5, 4, 3, 2, 1, 0]


def test_table_survives_on():
    fk = _fk("urdf_prismatic")
    other = fk._on("cpu")
    assert other.jt_table is not fk.jt_table
    assert torch.equal(other.jt_table, fk.jt_table)


def test_pack_table_refuses_a_short_type_list():
    fk = _fk("wam7")
    with pytest.raises(ValueError, match="joint types"):
        jt.pack_table(fk._jt_suffix, fk._sphere_dof_mask_np,
                      fk._jtype_per_dof_np[:-1])


def test_cpu_step_takes_the_plain_code(monkeypatch):
    """On the CPU the step never reaches the wrapper."""
    def refuse(*a, **kw):
        raise AssertionError("the wrapper was called on the CPU")

    monkeypatch.setattr(cost_soa, "jtmap", refuse)
    fk = _fk("wam7")
    n0 = jt.JT_LAUNCHES
    _today(fk, 1, 3, True, _args(fk, 3, 2, 1))
    assert jt.JT_LAUNCHES == n0


def _bad(case, fk):
    """The wrapper's arguments, wrong in one way each."""
    table, D = fk.jt_table, fk.n_dof
    anch, axes, x, wo, ws = _args(fk, 3, 2, 1)
    if case == "dtype":
        return table, D, anch, axes, x.float(), wo, ws
    if case == "mixed":
        return table, D, anch, axes, x, wo.float(), ws
    if case == "half":
        return table, D, anch, axes, x.half(), wo, ws
    if case == "x_rank":
        return table, D, anch, axes, x[0], wo, ws
    if case == "w_shape":
        return table, D, anch, axes, x, wo, ws[:, :, :-1]
    if case == "dof":           # anchors of another D than the table's
        return table, D, anch[:, :, :-1], axes, x, wo, ws
    if case == "table_dof":     # a table short of D's steps
        return table[:jt.STEP_WORDS * D], D, anch, axes, x, wo, ws
    if case == "table_dtype":
        return table.long(), D, anch, axes, x, wo, ws
    if case == "table_size":    # past the 48 KB a block stages
        big = torch.zeros(jt.TABLE_BYTES_MAX // 4 + 1, dtype=torch.int32)
        return big, D, anch, axes, x, wo, ws
    return table, D, anch, axes, x, wo, ws   # "cpu": right but the device


@pytest.mark.parametrize("case, match", [
    ("dtype", "dtype"), ("mixed", "dtype"), ("half", "float32 or float64"),
    ("x_rank", "shape"), ("w_shape", "shape"), ("dof", "shape"),
    ("table_dof", "does not hold"), ("table_dtype", "int32"),
    ("table_size", "shared memory"), ("cpu", "CUDA"),
])
def test_wrapper_refuses(case, match):
    """The launch checks dtype, shape, the table and the device before
    anything runs: here every input is refused on the CPU, where no
    kernel exists."""
    fk = _fk("wam7")
    n0 = jt.JT_LAUNCHES
    with pytest.raises(ValueError, match=match):
        jt.jtmap(*_bad(case, fk), totals=True)
    assert jt.JT_LAUNCHES == n0


def test_traffic_and_flops_wam7():
    """Per (moving point, problem) of the engine's WAM7 (S = 15 active
    spheres, D = 7, all revolute): 135 values read at the spheres, 42 at
    the joints, 7 written; 18 operations a sphere, 17 a joint."""
    assert jt.traffic_bytes(99, 15, 7, 256, 4) == (135 + 42 + 7) * 99 * 256 * 4
    assert jt.traffic_bytes(99, 15, 7, 256, 4, totals=True) == \
        (135 + 42 + 7 + 6) * 99 * 256 * 4
    fk = CompiledFK(wam7(), dtype=torch.float32, device="cpu",
                    sphere_subset=np.arange(1, 16))
    assert fk._jt_suffix is not None
    assert jt.flops(fk.jt_table, 7, 99, 256) == \
        (18 * 15 + 17 * 7) * 99 * 256
