"""The port's per-problem metric and row helpers (ChompEngine.apply_A,
solve_A, smooth_cost, mov_lo, get_T_mov, set_T_mov) against the JAX
package's engine, float64 on the CPU, within rtol 1e-12 and atol 1e-12
(ROADMAP's bar for pure math): the dense metric, the semiseparable one
(``SEP_MIN_M`` patched to 16 in both packages, so that m = 18 takes it,
as tests/test_torch_sep_metric.py does;
the engines are built here, not taken from a module's engine cache), and
the dense metric under start_tsr (the window of moving points from point
0).  B and trC come from each engine's own ``build_affine``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.chomp import metric as jmm
from or_cdchomp_tpu.chomp.problem import ChompSpec as JaxSpec
from or_cdchomp_tpu.chomp.solver import ChompEngine as JaxEngine
from or_cdchomp_tpu.models.wam7 import wam7 as jax_wam7
from or_cdchomp_tpu_torch.chomp import metric as tmm
from or_cdchomp_tpu_torch.chomp.problem import ChompSpec
from or_cdchomp_tpu_torch.chomp.solver import ChompEngine
from or_cdchomp_tpu_torch.models.wam7 import wam7

RTOL = ATOL = 1e-12
N_POINTS, N = 20, 7
SEP_MIN_M = 16


class Affine:
    """The problem fields smooth_cost reads."""

    def __init__(self, B, trC):
        self.B, self.trC = B, trC


@pytest.fixture(params=["dense", "sep", "start_tsr"])
def engines(request, monkeypatch):
    if request.param == "sep":
        monkeypatch.setattr(jmm, "SEP_MIN_M", SEP_MIN_M)
        monkeypatch.setattr(tmm, "SEP_MIN_M", SEP_MIN_M)
    start_tsr = request.param == "start_tsr"
    m = N_POINTS - 1 if start_tsr else N_POINTS - 2
    kw = dict(n_points=N_POINTS, n=N, m=m, start_tsr=start_tsr)
    j = JaxEngine(JaxSpec(**kw), jax_wam7(), None, dtype=jnp.float64)
    t = ChompEngine(ChompSpec(**kw), wam7(), None, dtype=torch.float64,
                    device="cpu")
    assert t.metric_mode == j.metric_mode == (
        "sep" if request.param == "sep" else "dense")
    return t, j


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def _affine(eng, init, final, to):
    B, trC, _ = eng.build_affine(None if eng.spec.start_tsr else init,
                                 final, N)
    return Affine(to(np.asarray(B)), to(np.asarray(trC)))


def test_metric_matches_jax(engines):
    t, j = engines
    rng = np.random.default_rng(15)
    X = rng.normal(size=(t.spec.m, N))
    close(t.apply_A(torch.as_tensor(X)), j.apply_A(jnp.asarray(X)))
    close(t.solve_A(torch.as_tensor(X)), j.solve_A(jnp.asarray(X)))
    close(t.apply_A(t.solve_A(torch.as_tensor(X))), X)


def test_rows_match_jax(engines):
    t, j = engines
    assert t.mov_lo == j.mov_lo == (0 if t.spec.start_tsr else 1)
    rng = np.random.default_rng(16)
    traj = rng.normal(size=(N_POINTS, N))
    T_new = rng.normal(size=(t.spec.m, N))
    got = t.get_T_mov(torch.as_tensor(traj))
    close(got, j.get_T_mov(jnp.asarray(traj)))
    assert tuple(got.shape) == (t.spec.m, N)
    out = t.set_T_mov(torch.as_tensor(traj), torch.as_tensor(T_new))
    close(out, j.set_T_mov(jnp.asarray(traj), jnp.asarray(T_new)))
    close(t.get_T_mov(out), T_new)
    np.testing.assert_array_equal(out[-1].numpy(), traj[-1])


def test_smooth_cost_matches_jax(engines):
    t, j = engines
    rng = np.random.default_rng(17)
    init, final = rng.normal(size=N), rng.normal(size=N)
    T = rng.normal(size=(t.spec.m, N))
    tp, jp = (_affine(t, init, final, torch.as_tensor),
              _affine(j, init, final, jnp.asarray))
    got = t.smooth_cost(tp, torch.as_tensor(T))
    close(got, j.smooth_cost(jp, jnp.asarray(T)))
    assert got.shape == ()
    # the batched step's form: one cost per problem of a batch
    Ts = rng.normal(size=(3, t.spec.m, N))
    batch = Affine(tp.B.expand(3, -1, -1), tp.trC.expand(3))
    close(t.smooth_cost(batch, torch.as_tensor(Ts)),
          [j.smooth_cost(jp, jnp.asarray(Tb)) for Tb in Ts])
