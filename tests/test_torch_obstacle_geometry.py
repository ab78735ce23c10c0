"""K1's launch geometry (ops/sdf_lookup.py:launch_geometry), on the CPU:
the kernel's walk over the (tile, row) space, replayed in Python in
obstacle.cu's loop order, visits every (row, problem) query exactly
once, keeps its incremental sphere index right, and stays within the
H100's shared memory per block."""

import numpy as np
import pytest

from or_cdchomp_tpu_torch.ops import sdf_lookup
from or_cdchomp_tpu_torch.ops.sdf_lookup import (LANES, SMEM_BLOCK_MAX,
                                                 launch_geometry)

N_SM = 132   # H100 SXM


def _walk(geom, m, S, B):
    """Queries visited per (row, problem), replaying obstacle_kernel's
    loops: block ranges, tile segments, each warp's rows (with its
    sphere index s stepped by W mod S, as the kernel keeps it)."""
    rows = m * S
    W = geom.threads // LANES
    seen = np.zeros((rows, B), np.int64)
    for blk in range(geom.grid):
        u = blk * geom.per
        u_end = min(u + geom.per, geom.units)
        while u < u_end:
            tile = u // rows
            r_lo = u - tile * rows
            r_hi = min(rows, r_lo + (u_end - u))
            u += r_hi - r_lo
            b0 = tile * LANES
            nb = min(LANES, B - b0)
            assert nb > 0
            for warp in range(W):
                r, s = r_lo + warp, (r_lo + warp) % S
                while r < r_hi:
                    assert s == r % S
                    seen[r, b0:b0 + nb] += 1
                    r += W
                    s += W % S
                    if s >= S:
                        s -= S
    return seen


@pytest.mark.parametrize("m, S, B, F, dims, bps", [
    (99, 15, 256, 1, (12, 16, 12), 4),        # config 1
    (99, 15, 256, 3, (11, 19, 11), 3),        # config 2
    (99, 15, 10_240, 1, (12, 16, 12), 4),     # config 5
    (1, 1, 1, 1, (3, 3, 3), 8),
    (1, 9, 70, 2, (8, 9, 7), 8),
    (3, 4, 257, 4, (8, 9, 7), 1),
    (7, 5, 33, 2, (40, 44, 20), 6),           # a 280 KB stack
    (13, 3, 95, 3, (5, 6, 7), 2),
], ids=["config1", "config2", "config5", "one", "m1", "B257", "bigstack",
        "odd"])
def test_launch_geometry_covers_each_query_once(m, S, B, F, dims, bps):
    seen_occ = []
    geom = launch_geometry(m, S, B, F, *dims, N_SM,
                           lambda smem: seen_occ.append(smem) or bps)
    assert seen_occ == [geom.smem_bytes]
    assert geom.smem_bytes <= SMEM_BLOCK_MAX
    assert geom.grid <= N_SM * bps or geom.per == geom.threads // LANES
    assert (geom.grid - 1) * geom.per < geom.units <= geom.grid * geom.per
    assert (_walk(geom, m, S, B) == 1).all()


def test_launch_geometry_refuses_what_does_not_fit():
    """Shared memory grows with F (about 1.7 KB a field); past 227 KB a
    block, or where no block fits an SM, the geometry raises."""
    occ = lambda smem: 2                             # noqa: E731
    assert launch_geometry(3, 4, 64, 100, 8, 8, 8, N_SM, occ).smem_bytes \
        <= SMEM_BLOCK_MAX
    with pytest.raises(ValueError, match="shared memory"):
        launch_geometry(3, 4, 64, 200, 8, 8, 8, N_SM, occ)
    with pytest.raises(ValueError, match="fits"):
        launch_geometry(3, 4, 64, 1, 4, 4, 4, N_SM, lambda smem: 0)


@pytest.mark.parametrize("F, dims, want", [
    (1, (12, 16, 12), 4 * (4 * 3 * 32 + 20 + 40)),         # config 1
    (3, (11, 19, 11), 4 * (4 * 3 * 3 * 32 + 60 + 123)),    # config 2
])
def test_smem_bytes_counts_the_staged_arrays(F, dims, want):
    """Both poses 12 words per (field, lane), 20 words of constants per
    field, one centre per (field, cell of an axis)."""
    assert sdf_lookup.smem_bytes(F, *dims) == want
