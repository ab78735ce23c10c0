"""The Jᵀ map kernel (csrc/jtmap.cu) against its plain version reading
the same table, ``jtmap_table_ref``, on the card, and the step it serves.
Skipped without a CUDA device; run on the card with
``python -m pytest tests/test_torch_jtmap_gpu.py -q --noconftest``
(tests/conftest.py configures JAX, which that machine does not have).

Tolerances: the two evaluate the same formulas in the same association
and add the spheres in the same order, so they may differ only where
the library's elementwise kernels round apart from the kernel's (they
do not fuse); float32 within 1e-6 of max |G| and float64 within 1e-12.
Over 100 iterations at B = 256 the step with the kernel stays within the
benchmark cell's own limits (portbench/limits/) of the step with its
plain phase, whose sums PyTorch may take in another order."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fk_cases import inputs, make_fk
from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.models.robot import CompiledFK
from or_cdchomp_tpu_torch.models.wam7 import wam7
from or_cdchomp_tpu_torch.ops import jtmap as jt
from or_cdchomp_tpu_torch.ops import kernels

pytestmark = pytest.mark.gpu

CHECKOUT = Path(__file__).resolve().parents[1]
RTOL = {torch.float32: 1e-6, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _fk(robot, dtype, device):
    if robot == "tray":   # the benchmark's tray: 110 spheres on handbase
        rows = [("handbase", (0.03 * (i - 4.5), 0.03 * (j - 5.0), 0.22),
                 0.015) for i in range(10) for j in range(11)]
        return CompiledFK(wam7().with_spheres(rows), dtype=dtype,
                          device=device)
    fk = make_fk(robot.removesuffix("_mask"), dtype, device)
    if robot.endswith("_mask"):
        fk._jt_suffix = None
        fk._to_device()
    return fk


def _args(fk, m, B, lo, base, dtype, device, seed=0):
    """(anchors, axes, x, w_obs, w_self) as the step hands them over:
    views of an FK's outputs at points lo .. lo + m − 1 and seeded
    gradients."""
    n_points = m + 2 - lo
    out = fk.fk_soa(*inputs(fk, n_points, B, base, dtype, device, seed))
    g = torch.Generator(device=device).manual_seed(seed)
    S = len(fk.sphere_subset)
    w = [torch.randn((3, m, S, B), generator=g, dtype=dtype, device=device)
         for _ in range(2)]
    return (out.anch_pos[:, lo:lo + m], out.axis_w[:, lo:lo + m],
            out.x[:, lo:lo + m].contiguous(), *w)


def _check(fk, args, totals):
    n0 = jt.JT_LAUNCHES
    G, tot = jt.jtmap(fk.jt_table, fk.n_dof, *args, totals=totals)
    torch.cuda.synchronize()
    assert jt.JT_LAUNCHES == n0 + 1
    G0, tot0 = jt.jtmap_table_ref(fk.jt_table, fk.n_dof, *args,
                                  totals=totals)
    for got, want in ((G, G0), (tot, tot0)):
        if want is None:
            assert got is None
            continue
        assert got.shape == want.shape and got.is_contiguous()
        if want.numel():   # no DOF: G is (m, 0, B)
            scale = max(float(want.abs().max()), 1.0)
            err = float((got - want).abs().max())
            assert err <= RTOL[fk.dtype] * scale, (err, scale)
    return G, tot


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("robot, m, B, lo, base, totals", [
    ("wam7", 99, 1, 1, "fixed", False),          # config 1 at B = 1
    ("wam7", 99, 256, 1, "fixed", False),        # config 1 at B = 256
    ("wam7", 49, 256, 1, "floating", True),      # config 4's floating base
    ("tray", 99, 256, 1, "fixed", False),        # the tray's 126 spheres
    ("wam7", 100, 37, 0, "fixed", False),        # start_tsr: lo = 0
    ("wam7_mask", 9, 70, 1, "floating", True),   # the masked chain
    ("urdf_prismatic", 9, 33, 1, "fixed", True),   # prismatic, branching
    ("no_dof", 5, 40, 1, "floating", True),      # no DOF: the totals alone
])
def test_jtmap_kernel(cuda, dtype, robot, m, B, lo, base, totals):
    fk = _fk(robot, dtype, cuda)
    _check(fk, _args(fk, m, B, lo, base, dtype, cuda, seed=B), totals)


def test_jtmap_kernel_against_the_plain_step(cuda):
    """The kernel against the step's plain code (w_obs + w_self, then
    ``apply_sphere_jacT_soa``, and the totals' sums) on the card, in
    float64."""
    fk = _fk("wam7", torch.float64, cuda)
    args = _args(fk, 99, 64, 1, "floating", torch.float64, cuda)
    G, tot = jt.jtmap(fk.jt_table, fk.n_dof, *args, totals=True)
    G0, tot0 = cost_soa._jacT_plain(fk, *args, totals=True)
    assert float((G - G0).abs().max()) <= 1e-12 * float(G0.abs().max())
    assert float((tot - tot0).abs().max()) <= 1e-12 * float(
        tot0.abs().max())


def test_jtmap_kernel_graph_replay(cuda):
    """A CUDA graph capture of the call and its replays equal the eager
    call, counted once per replay through the recorded launch."""
    fk = _fk("wam7", torch.float32, cuda)
    args = _args(fk, 99, 256, 1, "fixed", torch.float32, cuda)
    want, _ = jt.jtmap(fk.jt_table, fk.n_dof, *args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        jt.jtmap(fk.jt_table, fk.n_dof, *args)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with kernels.recording() as records, torch.cuda.graph(g):
        got, _ = jt.jtmap(fk.jt_table, fk.n_dof, *args)
    assert records == [(jt, "JT_LAUNCHES")]
    n0 = jt.JT_LAUNCHES
    for _ in range(2):
        g.replay()
        kernels.replay_counts(records)
    torch.cuda.synchronize()
    assert jt.JT_LAUNCHES == n0 + 2
    assert torch.equal(got, want)


def test_jtmap_kernel_refuses_other_card_dtype(cuda):
    fk = _fk("wam7", torch.float32, cuda)
    args = list(_args(fk, 5, 3, 1, "fixed", torch.float32, cuda))
    with pytest.raises(ValueError, match="dtype"):
        jt.jtmap(fk.jt_table, fk.n_dof, *args[:4], args[4].double())
    with pytest.raises(ValueError, match="is on cpu"):
        jt.jtmap(fk.jt_table.cpu(), fk.n_dof, *args)


def _world(name):
    sys.path.insert(0, str(CHECKOUT))
    from portbench import traffic, world

    cfg = world.load(CHECKOUT / "portbench" / "configs" / f"{name}.json")
    w = world.build(cfg, "cuda")
    traj = w.run.problem.traj.double().cpu().numpy()
    starts, goals = traffic.endpoints(2 ** 31 + 7, 0, traj[0], traj[-1],
                                      cfg["sigma"], 256)
    return w.run.engine, w.run.problem, starts, goals


def _solve(engine, problem, starts, goals, n_iter):
    from or_cdchomp_tpu_torch.parallel.batch import problem_batch_from_grid

    engine.__dict__.pop("_graphs", None)   # capture this phase's step
    probs = problem_batch_from_grid(problem, starts, goals, engine)
    out, costs = engine.iterate_batched(probs, n_iter)
    fin = torch.stack(engine.final_costs_batch(out), dim=-1)
    torch.cuda.synchronize()
    return out.traj.double().cpu().numpy(), fin.double().cpu().numpy()


@pytest.mark.parametrize("name, cell", [
    ("wam7_table_mug", "table_mug.batch256"),
    ("wam7_tray_level", "tray_level.batch256"),
])
def test_step_with_the_kernel_matches_the_plain_phase(cuda, monkeypatch,
                                                      name, cell):
    """100 captured iterations at B = 256 with the kernel against the
    same with the plain phase on the card (each step a replayed graph):
    the kernel launches once a step, and the trajectories and final
    costs stay within the cell's limits of each other."""
    engine, problem, starts, goals = _world(name)
    limits = json.loads((CHECKOUT / "portbench" / "limits"
                         / f"{cell}.json").read_text())["limits"]
    n0 = jt.JT_LAUNCHES
    T1, F1 = _solve(engine, problem, starts, goals, 100)
    assert jt.JT_LAUNCHES - n0 == 100

    def plain(table, n_dof, *args, totals=False):
        return cost_soa._jacT_plain(engine.fk, *args, totals)

    monkeypatch.setattr(cost_soa, "jtmap", plain)
    n0 = jt.JT_LAUNCHES
    T0, F0 = _solve(engine, problem, starts, goals, 100)
    assert jt.JT_LAUNCHES == n0
    row = np.abs(T1 - T0).max(axis=(1, 2))
    cost = (np.abs(F1 - F0) / np.maximum(np.abs(F0), 1.0)).max(axis=1)
    assert row.max() <= limits["traj_err_max"], row.max()
    assert np.percentile(row, 75) <= limits["traj_err_p75"]
    assert cost.max() <= limits["cost_err_max"], cost.max()
    assert np.percentile(cost, 75) <= limits["cost_err_p75"]
