"""The port's cd_mat helpers (or_cdchomp_tpu_torch/ops/matops.py) against
the JAX package's (or_cdchomp_tpu/ops/matops.py), float64 on the CPU,
within rtol 1e-12 and atol 1e-12 (ROADMAP's bar for pure math); the
cases of tests/test_matops.py, batched and rectangular ones added."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.ops import matops as jm
from or_cdchomp_tpu_torch.ops import matops as tm

RTOL = ATOL = 1e-12
RNG = np.random.default_rng(12)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_cross_accumulates():
    """cd_mat_cross accumulates into res (mat.c:126-132)."""
    a, b, res = (RNG.normal(size=(5, 3)) for _ in range(3))
    close(tm.cross_accum(*map(torch.as_tensor, (a, b, res))),
          jm.cross_accum(*map(jnp.asarray, (a, b, res))))
    one = tm.cross_accum(torch.tensor([1.0, 0, 0]), torch.tensor([0, 1.0, 0]),
                         torch.tensor([10.0, 20.0, 30.0]))
    np.testing.assert_array_equal(one.numpy(), [10.0, 20.0, 31.0])


@pytest.mark.parametrize("m,n", [(2, 4), (3, 3), (5, 2)])
def test_set_diag(m, n):
    got = tm.set_diag(m, n, 3.5, dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    close(got, jm.set_diag(m, n, 3.5, dtype=jnp.float64))


@pytest.mark.parametrize("shape", [(2, 3), (4, 4), (5, 3, 2)])
def test_trace(shape):
    A = RNG.normal(size=shape)
    close(tm.trace(torch.as_tensor(A)), jm.trace(jnp.asarray(A)))


@pytest.mark.parametrize("a", [[1.0, -2.5], np.arange(6.0).reshape(2, 3),
                               [1234.56789, -0.00004]])
def test_vec_to_str(a):
    want = jm.vec_to_str("v: ", a)
    assert tm.vec_to_str("v: ", torch.as_tensor(np.asarray(a))) == want
    assert tm.vec_to_str("v: ", a) == want
