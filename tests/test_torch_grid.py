"""The port's grid lookups (or_cdchomp_tpu_torch/ops/grid.py) against the
JAX package's (or_cdchomp_tpu/ops/grid.py), float64 on the CPU, within
rtol 1e-12 and atol 1e-12 (ROADMAP's bar for pure math); the cell values
are the same float32 numbers in both.  Points cover the inside, cell
centres exactly, edge cells on both sides of their centre and the box's
outside (tests/test_grid.py's and tests/test_pallas_sdf.py's cases).
``multigrid_interp_grad`` runs on a three-field stack padded with +inf
and holding a +inf interior cell, and on an all-occupied (−inf) field,
against JAX's "gather" backend and its Pallas kernel in interpret mode.
The signed-distance grid is float32 in both packages; their EDTs differ
by an ulp on some cells, so it is held within 1e-6 m (as
tests/test_torch_sdf.py holds the bench field)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.ops import edt as jedt
from or_cdchomp_tpu.ops import grid as jg
from or_cdchomp_tpu.ops.voxelize import Scene as JaxScene
from or_cdchomp_tpu_torch.ops import edt as tedt
from or_cdchomp_tpu_torch.ops import grid as tg
from or_cdchomp_tpu_torch.ops import sdf_lookup
from or_cdchomp_tpu_torch.ops.voxelize import Scene

RTOL = ATOL = 1e-12
RNG = np.random.default_rng(13)


def close(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(w))
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def _points(shape, lengths, n, cell=(3, 4, 2)):
    """Around ``cell`` (its centre and a third of a cell either side on
    each axis), then every first and last cell's centre and points a
    quarter cell either side of it, cell centres exactly, and n random
    points spanning the box and its outside."""
    sizes, lengths = np.asarray(shape), np.asarray(lengths)
    h = lengths / sizes
    c = (np.asarray(cell) + 0.5) * h
    pts = [c[None], c + h / 3 * np.eye(3), c - h / 3 * np.eye(3)]
    for corner in ((0, 0, 0), sizes - 1, (0, sizes[1] - 1, 2)):
        c = (np.asarray(corner) + 0.5) * h
        pts += [c[None], (c + 0.25 * h)[None], (c - 0.25 * h)[None]]
    pts.append(((RNG.integers(0, sizes, size=(8, 3)) + 0.5)
                / sizes * lengths))                   # centres, exactly
    pts.append(RNG.uniform(-0.15, 1.15, size=(n, 3)) * lengths)
    return np.concatenate(pts)


def test_grid_interp_grad_matches_jax():
    data = RNG.normal(size=(7, 9, 5))
    data[3, 4, 2] = np.inf                        # a HUGE_VAL cell
    lengths = np.array([1.4, 0.9, 2.0])
    p = _points(data.shape, lengths, 200)
    got = tg.grid_interp_grad(torch.as_tensor(data),
                              torch.as_tensor(lengths), torch.as_tensor(p))
    want = jg.grid_interp_grad(jnp.asarray(data), jnp.asarray(lengths),
                               jnp.asarray(p))
    close(got, want)
    assert not got[2].all() and got[2].any()
    assert np.isposinf(got[0].numpy()[got[2].numpy()]).any()
    close(tg.grid_interp(torch.as_tensor(data), torch.as_tensor(lengths),
                         torch.as_tensor(p)),
          jg.grid_interp(jnp.asarray(data), jnp.asarray(lengths),
                         jnp.asarray(p)))


def _stack(pkg_grid, to):
    """Three fields of different sizes, a +inf interior cell in the
    second; stacked by ``pkg_grid``'s pad_stack_grids (+inf padding)."""
    rng = np.random.default_rng(2)
    shapes = [(6, 9, 5), (8, 4, 7), (5, 6, 6)]
    lens = [(0.6, 0.9, 0.5), (0.8, 0.4, 0.7), (0.5, 0.6, 0.55)]
    grids = []
    for i, (s, ln) in enumerate(zip(shapes, lens)):
        d = rng.normal(size=s).astype(np.float32)
        if i == 1:
            d[2, 1, 3] = np.inf
        grids.append(pkg_grid.Grid3D(data=to(d), lengths=to(
            np.asarray(ln, np.float32))))
    return grids, shapes, lens


def _multigrid_inputs(lead=(40,)):
    jgrids, shapes, lens = _stack(jg, jnp.asarray)
    tgrids, _, _ = _stack(tg, torch.as_tensor)
    jd, js, jl = jg.pad_stack_grids(jgrids)
    stack = tg.pad_stack_grids(tgrids, device="cpu")
    np.testing.assert_array_equal(stack.data.numpy(), np.asarray(jd))
    pts = np.stack([_points(s, ln, 40, cell=(2, 1, 3))[:int(np.prod(lead))]
                    for s, ln in zip(shapes, lens)], axis=-2)
    p = pts.reshape(lead + pts.shape[-2:])
    return (jd, js, jl), stack, p


@pytest.mark.parametrize("method", ["gather", "pallas_interpret"])
@pytest.mark.parametrize("lead", [(40,), (5, 8)])
def test_multigrid_matches_jax(method, lead):
    (jd, js, jl), stack, p = _multigrid_inputs(lead)
    want = jg.multigrid_interp_grad(jd, js, jl.astype(jnp.float64),
                                    jnp.asarray(p), method=method)
    got = tg.multigrid_interp_grad(stack.data, stack.sizes,
                                   stack.lengths.double(),
                                   torch.as_tensor(p), method=method)
    close(got, want)
    v, _, inb = (t.numpy() for t in got)
    assert (~inb).any() and inb.any()
    assert np.isposinf(v[inb]).any()              # padding or HUGE_VAL


def test_multigrid_matches_single_grids():
    """Each field of the stack reads as grid_interp_grad on its own
    (float32) grid: the +inf padding never leaks into a true cell."""
    (_, _, _), stack, p = _multigrid_inputs()
    v, g, inb = tg.multigrid_interp_grad(stack.data, stack.sizes,
                                         stack.lengths.double(),
                                         torch.as_tensor(p))
    tgrids, _, _ = _stack(tg, torch.as_tensor)
    for f, grid in enumerate(tgrids):
        one = tg.grid_interp_grad(grid.data, grid.lengths.double(),
                                  torch.as_tensor(p[:, f]))
        close((v[:, f], g[:, f], inb[:, f]), one)


def test_all_occupied_field_not_contained():
    """An all-occupied grid is −inf everywhere (an empty free-space
    EDT): every query reads +inf and gradient 0, as JAX's gather and
    Pallas backends report (tests/test_pallas_sdf.py:59)."""
    data = np.full((4, 5, 3), -np.inf, np.float32)
    lengths = np.array([0.4, 0.5, 0.3], np.float32)
    p = np.array([[0.2, 0.25, 0.15], [0.05, 0.45, 0.29]])[:, None, :]
    jd, js, jl = jg.pad_stack_grids([jg.Grid3D(data=jnp.asarray(data),
                                               lengths=jnp.asarray(lengths))])
    stack = tg.pad_stack_grids([tg.Grid3D(data=torch.as_tensor(data),
                                          lengths=torch.as_tensor(lengths))],
                               device="cpu")
    got = tg.multigrid_interp_grad(stack.data, stack.sizes,
                                   stack.lengths.double(), torch.as_tensor(p))
    for method in ("gather", "pallas_interpret"):
        close(got, jg.multigrid_interp_grad(jd, js, jl.astype(jnp.float64),
                                            jnp.asarray(p), method=method))
    assert got[2].all() and np.isposinf(got[0].numpy()).all()
    np.testing.assert_array_equal(got[1].numpy(), 0.0)


def test_big_stand_in_reads_as_infinite():
    """A cell at JAX's ±1e30 stand-in for ±inf (grid.py:183) counts as
    infinite, as in its one-hot and Pallas paths."""
    data = np.ones((1, 3, 3, 3), np.float32)
    data[0, 1, 1, 1] = -1e30
    p = np.array([[[0.5, 0.5, 0.5]], [[0.1, 0.1, 0.1]]])
    got = tg.multigrid_interp_grad(
        torch.as_tensor(data), torch.tensor([[3, 3, 3]], dtype=torch.int32),
        torch.ones((1, 3), dtype=torch.float64), torch.as_tensor(p))
    np.testing.assert_array_equal(got[0].numpy(), [[np.inf], [1.0]])
    np.testing.assert_array_equal(got[1].numpy(), 0.0)


def test_multigrid_one_lookup_call(monkeypatch):
    """A call reads all its cells in one contiguous lookup of every
    (field, query)."""
    (_, _, _), stack, p = _multigrid_inputs((5, 8))
    args = (stack.data, stack.sizes, stack.lengths.double(),
            torch.as_tensor(p))
    whole = tg.multigrid_interp_grad(*args)
    calls = []
    inner = sdf_lookup.sdf_cell_lookup

    def counted(data, sub, nbr):
        assert sub.is_contiguous() and nbr.is_contiguous()
        calls.append(tuple(sub.shape))
        return inner(data, sub, nbr)

    monkeypatch.setattr(sdf_lookup, "sdf_cell_lookup", counted)
    again = tg.multigrid_interp_grad(*args)
    assert calls == [(3, 40, 3)]
    for a, b in zip(again, whole):
        assert torch.equal(a, b)


def test_methods_accepted_and_unknown_raises():
    (_, _, _), stack, p = _multigrid_inputs()
    args = (stack.data, stack.sizes, stack.lengths.double(),
            torch.as_tensor(p))
    ref = tg.multigrid_interp_grad(*args)
    for method in tg.METHODS:
        out = tg.multigrid_interp_grad(*args, method=method)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    with pytest.raises(ValueError, match="unknown method 'mxu'"):
        tg.multigrid_interp_grad(*args, method="mxu")


def test_sdf_grid_from_occupancy_matches_jax():
    occ = np.zeros((8, 7, 9), dtype=bool)
    occ[2:5, 3:6, 1:4] = True
    lengths = np.array([0.8, 0.7, 0.9])
    got = tedt.sdf_grid_from_occupancy(torch.as_tensor(occ), lengths)
    want = jedt.sdf_grid_from_occupancy(jnp.asarray(occ), lengths)
    assert got.data.dtype == torch.float32 and got.sizes == want.sizes
    np.testing.assert_allclose(got.data.numpy(), np.asarray(want.data),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    empty = tedt.sdf_grid_from_occupancy(torch.zeros((3, 3, 3), dtype=bool),
                                         [1.0, 1.0, 1.0])
    assert torch.isposinf(empty.data).all()


def test_grid_sizes_cell_extents_and_scene_empty():
    lengths = np.array([1.4, 0.9, 2.0])
    g = tg.Grid3D.create((7, 9, 5), lengths, dtype=torch.float64,
                         device="cpu")
    j = jg.Grid3D.create((7, 9, 5), lengths, dtype=jnp.float64)
    assert g.sizes == tuple(j.sizes) == (7, 9, 5)
    close([g.cell_extents()], [j.cell_extents()])
    close([g.center_of_index(torch.tensor([[0, 0, 0], [6, 8, 4]]))],
          [j.center_of_index(jnp.asarray([[0, 0, 0], [6, 8, 4]]))])
    s, js = Scene.empty(dtype=torch.float64, device="cpu"), JaxScene.empty(
        jnp.float64)
    assert s.n_primitives == 0
    for a, b in zip(s, js):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float64
        assert a.device.type == "cpu"
