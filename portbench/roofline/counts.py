"""Frozen copies of the port's counts of what its kernels must move and
compute (or_cdchomp_tpu_torch/ops/sdf_lookup.py, selfcol.py, limits.py,
as of the benchmark's first version).  Each input is counted read once
and each output written once; floats are ``itemsize`` bytes, ints 4,
bools 1."""

# K1, the fused obstacle kernel (csrc/obstacle.cu): float operations of
# one query, per field and once
K1_FLOPS_FIELD = 120
K1_FLOPS_QUERY = 80
# K2, the self-collision kernel (csrc/selfcol.cu): per (point, pair,
# problem) the distance test; more per pair within reach
K2_FLOPS_TEST = 12
K2_FLOPS_REACH = 33


def obstacle_bytes(m, S, B, F, mx, my, mz, cells=None, itemsize=4):
    """K1's bytes for m points, S spheres, B problems and F fields of
    mx × my × mz cells: x, vel, acc, the field cells (``cells``, or the
    whole stack), sizes and lengths, both per-problem field poses,
    field_enabled, the radii, epsilon and obs_factor read; the cost and
    the gradient written."""
    q = m * S * B
    cells = F * mx * my * mz if cells is None else cells
    reads = (itemsize * (3 * 3 * q + cells + 3 * F + 2 * 7 * B * F + S
                         + 2 * B)
             + 4 * 3 * F + B * F)
    writes = itemsize * (q + 3 * q)
    return reads + writes


def obstacle_flops(m, S, B, F):
    """K1's float operations."""
    return m * S * B * (F * K1_FLOPS_FIELD + K1_FLOPS_QUERY)


def selfcol_bytes(m, Sa, SI, B, P, itemsize=4):
    """K2's bytes for Sa active and SI inactive spheres and P pairs: the
    active positions and velocities, the inactive positions, epsilon_self,
    obs_factor_self and the pair table read; the net gradient and the
    cost written."""
    floats = (2 * 3 * m * Sa * B + 3 * SI * B + 2 * B + P
              + 3 * m * Sa * B + m * Sa * B)
    return itemsize * floats + 4 * 2 * P


def selfcol_flops(m, B, P, n_reach):
    """K2's float operations, ``n_reach`` of the (point, pair, problem)
    triples within reach."""
    return K2_FLOPS_TEST * m * B * P + K2_FLOPS_REACH * n_reach


def limits_bytes(B, m, n, itemsize=4):
    """The limit-repair kernel's bytes: the trajectory read and written,
    the limits read."""
    return (2 * B * m * n + 2 * B * n) * itemsize


def limits_flops(m, n, rounds, entries, B):
    """The limit-repair kernel's operations for ``rounds`` applied rounds
    and ``entries`` violations summed over them, over B problems."""
    tests = rounds + B
    return 4 * m * n * tests + 2 * m * n * rounds + 2 * m * entries
