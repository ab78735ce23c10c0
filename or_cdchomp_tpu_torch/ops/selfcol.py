"""K2: all-pairs sphere self-collision (csrc/selfcol.cu).

Counterpart of or_cdchomp_tpu/ops/pallas_selfcol.py (``selfcol_pairs``,
dense variant): the same (net, cost) contract, with the allowed pairs
given as a compacted ordered list instead of an (Sa, So) mask.
:func:`selfcol_pairs` dispatches on the device of its tensors: CPU
tensors go to :func:`selfcol_pairs_ref`, CUDA tensors to the kernel (or
an error).  There is no fallback.

``LAUNCHES`` counts kernel launches of :func:`selfcol_pairs`.
:func:`traffic_bytes`, :func:`flops` and :func:`vote_stats` count the
work of one call for its bound on the card.

The kernel has two paths, chosen by a fixed rule that
:func:`launch_shape` mirrors: the staged path (the pair matrices and the
spheres of a block in shared memory) wherever its block fits in
SMEM_BLOCK_MAX bytes, which holds up to 117 spheres, and beyond that the
tiled path, which uses no shared memory and a global scratch buffer of
:func:`scratch_words` words that the wrapper allocates.  That rule is
float32's, the solve's path; float64 (a module created with dtype
float64) always takes the tiled path.  Another dtype on CUDA raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import kernels

LAUNCHES = 0
LANES = 32          # problems per warp of the kernel: one vote each
MAX_WARPS = 16      # warps (active spheres in flight) of a staged block
TILED_WARPS = 8     # warps (active spheres) of a tiled block
SMEM_BLOCK_MAX = 232_448   # shared memory one block may use (227 KB)
FLOPS_TEST = 12     # per (point, pair, problem): diff, d², rsqrt, d, test
FLOPS_REACH = 33    # more per pair in reach: hinge, w1, w2, g, the sums


def pair_table(same_link, radii_act, radii_all):
    """Ordered pair list of the pairs that carry cost: (i active, j any
    sphere of the active-then-inactive order) with ``same_link[i, j]``
    false, i-major and j ascending — the order the Pallas kernel walks
    them.  Returns (pair_i, pair_j) int32 and rsum = r_i + r_j float64,
    all numpy (P,)."""
    same = np.asarray(same_link, dtype=bool)
    ii, jj = np.nonzero(~same)
    rsum = (np.asarray(radii_act, np.float64)[ii]
            + np.asarray(radii_all, np.float64)[jj])
    return ii.astype(np.int32), jj.astype(np.int32), rsum


def _distance(xi, xo, pi, pj, rsum):
    """Per (point, pair, problem): diff = x_i − x_j (3, m, P, B), 1/|diff|
    and d = |diff| − rsum (m, P, B)."""
    _, m, _, B = xi.shape
    SI = xo.shape[1]
    x_all = torch.cat([xi, xo[:, None].expand(3, m, SI, B)], dim=2)
    diff = xi[:, :, pi] - x_all[:, :, pj]
    d2 = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
    inv_cd = torch.rsqrt(torch.clamp(d2, min=1e-24))
    return diff, inv_cd, d2 * inv_cd - rsum[:, None]


def selfcol_pairs_ref(xi, vel, xo, pair_i, pair_j, rsum, eps_self, obs_self):
    """Plain version of :func:`selfcol_pairs` (same contract)."""
    Sa = xi.shape[2]
    pi = pair_i.long()
    pj = pair_j.long()
    inv_eps = 1.0 / eps_self
    v2 = vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]
    vn = torch.sqrt(v2)
    safe = vn > 1e-6
    inv_v2 = torch.where(safe, 1.0 / torch.where(safe, v2, 1.0), 0.0)
    ofv = obs_self * vn                                   # (m, Sa, B)

    diff, inv_cd, d = _distance(xi, xo, pi, pj, rsum)     # (3, m, P, B)
    ok = d <= eps_self
    de = d - eps_self
    c_h = torch.where(d < 0.0, 0.5 * eps_self - d, 0.5 * de * de * inv_eps)
    ofv_p = ofv[:, pi]
    cost_pair = torch.where(ok, c_h, 0.0) * ofv_p
    slope = torch.where(d < 0.0, -1.0, d * inv_eps - 1.0)
    w1 = torch.where(ok, slope * ofv_p * inv_cd, 0.0)
    vp = vel[:, :, pi]
    bv = vp[0] * diff[0] + vp[1] * diff[1] + vp[2] * diff[2]
    w2 = torch.where(safe[:, pi], w1 * bv * inv_v2[:, pi], 0.0)
    g = w1 * diff - w2 * vp                               # (3, m, P, B)

    net = torch.zeros_like(xi).index_add_(2, pi, g)
    act = pj < Sa
    net.index_add_(2, pj[act], -g[:, :, act])
    cost = torch.zeros_like(xi[0]).index_add_(1, pi, cost_pair)
    return net, cost


def selfcol_pairs(xi, vel, xo, pair_i, pair_j, rsum, eps_self, obs_self):
    """Self-collision net workspace gradient and per-sphere cost.

    xi, vel: (3, m, Sa, B) active sphere positions / velocities; xo
    (3, SI, B) inactive sphere positions (SI may be 0); pair_i, pair_j
    (P,) int32 and rsum (P,) from :func:`pair_table`, pair_j indexing the
    active-then-inactive order and sorted by pair_i; eps_self, obs_self
    (B,).

    Returns (net (3, m, Sa, B), cost (m, Sa, B)): per (point, active
    sphere) the summed workspace gradient and the pair cost scaled by
    obs_factor_self·‖ẋ_i‖ (pallas_selfcol.py:selfcol_pairs).

    The kernel takes float32 or float64 tensors (another dtype raises
    ValueError); every tensor of floats has xi's dtype.
    """
    global LAUNCHES
    if xi.device.type == "cpu":
        return selfcol_pairs_ref(xi, vel, xo, pair_i, pair_j, rsum,
                                 eps_self, obs_self)
    if xi.device.type != "cuda":
        raise ValueError(f"selfcol_pairs: unsupported device {xi.device}")
    _, m, Sa, B = xi.shape
    SI = xo.shape[1]
    P = pair_i.shape[0]
    dev = xi.device
    dt = kernels.check_dtype(xi.dtype, "selfcol_pairs")
    kernels.require(xi, "xi", dt, (3, m, Sa, B), dev)
    kernels.require(vel, "vel", dt, (3, m, Sa, B), dev)
    kernels.require(xo, "xo", dt, (3, SI, B), dev)
    kernels.require(pair_i, "pair_i", torch.int32, (P,), dev)
    kernels.require(pair_j, "pair_j", torch.int32, (P,), dev)
    kernels.require(rsum, "rsum", dt, (P,), dev)
    kernels.require(eps_self, "eps_self", dt, (B,), dev)
    kernels.require(obs_self, "obs_self", dt, (B,), dev)
    net = torch.empty((3, m, Sa, B), dtype=dt, device=dev)
    cost = torch.empty((m, Sa, B), dtype=dt, device=dev)
    words = scratch_words(m, Sa, SI, B, dt.itemsize)
    scratch = (torch.empty(words, dtype=torch.int32, device=dev) if words
               else None)
    err = kernels.entry("cdx_selfcol", dt)(
        xi.data_ptr(), vel.data_ptr(), xo.data_ptr(), m, Sa, SI, B,
        pair_i.data_ptr(), pair_j.data_ptr(), rsum.data_ptr(), P,
        eps_self.data_ptr(), obs_self.data_ptr(), net.data_ptr(),
        cost.data_ptr(), None if scratch is None else scratch.data_ptr(),
        kernels.stream_ptr(xi))
    kernels.check(err, "selfcol_pairs")
    LAUNCHES += 1
    return net, cost


def traffic_bytes(m, Sa, SI, B, P, itemsize=4):
    """Bytes one call must move at the given shapes: each input read once
    (xi, vel, xo, eps_self, obs_self, the pair table), each output
    written once (net, cost); floats of ``itemsize`` bytes (4 float32, 8
    float64), 4-byte ints."""
    floats = (2 * 3 * m * Sa * B + 3 * SI * B + 2 * B + P
              + 3 * m * Sa * B + m * Sa * B)
    return itemsize * floats + 4 * 2 * P


def flops(m, B, P, n_reach):
    """Float operations one call needs: the distance test of every
    (point, pair, problem) and the rest of the pair math for the
    ``n_reach`` of them within reach (:func:`vote_stats`)."""
    return FLOPS_TEST * m * B * P + FLOPS_REACH * n_reach


def vote_stats(xi, xo, pair_i, pair_j, rsum, eps_self):
    """What the kernel's two skip tests meet on these inputs.  A vote is
    one (point, pair, warp of LANES problems).  It passes the box test
    when the gap between the two spheres' bounding boxes over the warp's
    problems is within rsum + the warp's largest eps (with the kernel's
    margin), and it is taken when some problem of the warp has the pair
    within reach (d <= eps_self).  Returns (votes, votes past the box
    test, votes taken, (point, pair, problem) triples in reach)."""
    pi, pj = pair_i.long(), pair_j.long()
    _, _, d = _distance(xi, xo, pi, pj, rsum)
    ok = d <= eps_self                                    # (m, P, B)
    m, P, B = ok.shape
    pad = -B % LANES
    W = (B + pad) // LANES
    taken = torch.cat([ok, ok.new_zeros((m, P, pad))], dim=2)
    taken = taken.reshape(m, P, W, LANES).any(dim=3)

    SI = xo.shape[1]
    x_all = torch.cat([xi, xo[:, None].expand(3, m, SI, B)], dim=2)

    def per_warp(x, fill, reduce):
        x = torch.cat([x, x.new_full(x.shape[:-1] + (pad,), fill)], dim=-1)
        return reduce(x.reshape(x.shape[:-1] + (W, LANES)), dim=-1)

    lo = per_warp(x_all, float("inf"), torch.amin)        # (3, m, So, W)
    hi = per_warp(x_all, float("-inf"), torch.amax)
    emax = per_warp(eps_self, float("-inf"), torch.amax)  # (W,)
    gap = torch.clamp(torch.maximum(lo[:, :, pj] - hi[:, :, pi],
                                    lo[:, :, pi] - hi[:, :, pj]), min=0.0)
    g2 = (gap * gap).sum(dim=0)                           # (m, P, W)
    reach = (emax + rsum[:, None]) * (1.0 + 1e-4) + 1e-6
    near = g2 <= reach * reach
    return taken.numel(), int(near.sum()), int(taken.sum()), int(ok.sum())


def smem_words(Sa, So, nw):
    """Shared memory of a staged block of nw warps, in 4-byte words: the
    positions of So spheres and the velocities, |v| and 1/|v|² of the Sa
    active ones for 32 problems, each sphere's bounding box, the (Sa, So)
    matrices of radius sums and pair indices, and one vote word per warp
    and 32 spheres (selfcol.cu's smem_words; a GPU test holds the two
    equal through launch_info)."""
    return (LANES * (3 * So + 5 * Sa) + 6 * So + 2 * Sa * So
            + nw * -(-So // LANES))


def launch_shape(Sa, SI, itemsize=4):
    """The kernel's path for Sa active and SI inactive spheres and its
    main launch: (path, threads, dynamic shared memory bytes) per block.
    In float32 (``itemsize`` 4) the staged path wherever its block fits
    in SMEM_BLOCK_MAX, else the tiled path (selfcol.cu
    selfcol_path_staged); in float64 (8) the tiled path."""
    if itemsize != 4:
        return "tiled", LANES * TILED_WARPS, 0
    nw = min(Sa, MAX_WARPS)
    smem = 4 * smem_words(Sa, Sa + SI, nw)
    if smem <= SMEM_BLOCK_MAX:
        return "staged", LANES * nw, smem
    return "tiled", LANES * TILED_WARPS, 0


def scratch_words(m, Sa, SI, B, itemsize=4):
    """Global scratch of a call, in 4-byte words: none on the staged
    path; on the tiled path the (Sa, So) matrix of int32 pair indices
    (padded to a whole number of floats of ``itemsize`` bytes), then the
    (Sa, So) matrix of radius sums and each sphere's box (6 floats) per
    point and 32-problem tile."""
    if launch_shape(Sa, SI, itemsize)[0] == "staged":
        return 0
    So = Sa + SI
    per = itemsize // 4
    return (-(-Sa * So // per) * per
            + per * (Sa * So + m * -(-B // LANES) * 6 * So))


def launch_info(Sa, SI, dtype=torch.float32):
    """The kernel's main launch on the card for Sa active and SI inactive
    spheres in ``dtype``: threads and dynamic shared memory per block,
    resident blocks per SM, registers and local (spill) bytes per thread,
    and the path taken ("staged" or "tiled")."""
    info = (ctypes.c_int * 6)()
    kernels.check(kernels.entry("cdx_selfcol_launch_info", dtype)(
        Sa, SI, info), "selfcol launch_info")
    out = dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                    "local_bytes"), info))
    out["path"] = ("staged", "tiled")[info[5]]
    return out
