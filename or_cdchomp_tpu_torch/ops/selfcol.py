"""K2: all-pairs sphere self-collision (csrc/selfcol.cu).

Counterpart of or_cdchomp_tpu/ops/pallas_selfcol.py (``selfcol_pairs``,
dense variant): the same (net, cost) contract, with the allowed pairs
given as a compacted ordered list instead of an (Sa, So) mask.
:func:`selfcol_pairs` dispatches on the device of its tensors: CPU
tensors go to :func:`selfcol_pairs_ref`, CUDA tensors to the kernel (or
an error).  There is no fallback.

``LAUNCHES`` counts kernel launches of :func:`selfcol_pairs`.
:func:`traffic_bytes`, :func:`flops` and :func:`vote_stats` count the
work of one call for its bound on the card, :func:`layout_traffic_bytes`
that of one :func:`pair_layout`.

The kernel has two paths, chosen by a fixed rule that
:func:`launch_shape` mirrors: the staged path (the pair matrices and the
spheres of a block in shared memory) wherever its block fits in
SMEM_BLOCK_MAX bytes, which holds up to 117 spheres, and beyond that the
tiled path, which stages the spheres 32 at a time in a shared-memory
ring (all of them where :func:`ring_resident`) and reads the pair table
through its :func:`pair_layout`, an engine constant.  That rule is float32's,
the solve's path; float64 (a module created with dtype float64) always
takes the tiled path.  Another dtype on CUDA raises.
"""

from __future__ import annotations

import ctypes
import sys
from typing import NamedTuple

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import kernels

_THIS = sys.modules[__name__]

LAUNCHES = 0
LAYOUT_LAUNCHES = 0   # launches of the pair-layout kernel (pair_layout)
LANES = 32          # problems per warp of the kernel: one vote each
MAX_WARPS = 16      # warps (active spheres in flight) of a staged block
TILED_WARPS = 16    # warps (own active spheres) of a tiled block
SMEM_BLOCK_MAX = 232_448   # shared memory one block may use (227 KB)
# one tiled ring slot, in floats: a 32-sphere chunk's positions for 32
# problems and the chunk spheres' boxes; the ring's budget holds 8 float32
# or 4 float64 slots (selfcol.cu kSlotWords, kRingBytesMax)
SLOT_WORDS = 3 * LANES * LANES + 6 * LANES
RING_BYTES_MAX = 8 * SLOT_WORDS * 4
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


class PairLayout(NamedTuple):
    """The tiled path's view of a pair table (:func:`pair_layout`); G =
    ceil(So / 32) groups of 32 lanes per active sphere."""
    masks: torch.Tensor      # (Sa, G, 4) int32: out, inonly, mirror, groups
    partners: torch.Tensor   # (Sa, G, 32) int32: the partner of each lane
    rs: torch.Tensor         # (2, Sa, G, 32): rsum of (i, j), of (j, i)


def _words(bits):
    """(..., 32) bool → (...) int32 words, bit l from entry l."""
    shift = torch.arange(LANES, device=bits.device)
    words = (bits.long() << shift).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pair_layout_ref(pair_i, pair_j, rsum, Sa, So):
    """Plain version of :func:`pair_layout` (same contract)."""
    dev = rsum.device
    G = -(-So // LANES)
    pi, pj = pair_i.long(), pair_j.long()
    ok = (pi >= 0) & (pi < Sa) & (pj >= 0) & (pj < So)
    pi, pj, rv = pi[ok], pj[ok], rsum[ok]
    act = pj < Sa
    out = torch.zeros((Sa, G * LANES), dtype=torch.bool, device=dev)
    inn = torch.zeros_like(out)
    r = torch.zeros((2, Sa, G * LANES), dtype=rsum.dtype, device=dev)
    out[pi, pj] = True
    r[0, pi, pj] = rv
    inn[pj[act], pi[act]] = True
    r[1, pj[act], pi[act]] = rv[act]
    any_ = out | inn
    if ring_resident(So, rsum.dtype.itemsize):
        # compacted: each sphere's partners in ascending order, lanes past
        # them 0 (partner 0, no bit)
        order = torch.argsort((~any_).to(torch.int8), dim=1, stable=True)
        count = any_.sum(dim=1)
        live = torch.arange(G * LANES, device=dev) < count[:, None]
        partners = torch.where(live, order, 0)
        out, inn = (torch.gather(t, 1, order) & live for t in (out, inn))
        r = torch.where(live, torch.gather(r, 2, order.expand(2, -1, -1)), 0)
        groups = -(-count // LANES)
    else:
        # group g is chunk g
        partners = torch.arange(G * LANES, device=dev).expand(Sa, -1)
        partners = torch.where(partners < So, partners, 0)
        groups = torch.full((Sa,), G, device=dev)
    mirror = out & inn & (r[0] == r[1])
    bits = torch.stack([out, inn & ~mirror, mirror]).view(3, Sa, G, LANES)
    masks = torch.cat([_words(bits), groups.to(torch.int32)
                       .expand(1, G, Sa).permute(0, 2, 1)]).permute(1, 2, 0)
    return PairLayout(masks.contiguous(),
                      partners.to(torch.int32).view(Sa, G, LANES).contiguous(),
                      r.view(2, Sa, G, LANES).contiguous())


def pair_layout(pair_i, pair_j, rsum, Sa, So):
    """The tiled path's pair layout of a pair table (:func:`pair_table`;
    Sa active spheres, So in all), an engine constant.  Per active sphere
    i the spheres j it pairs with, as (i, j) or as (j, i) with j active,
    in G = ceil(So / 32) groups of 32 lanes: where the kernel's ring holds
    every chunk (:func:`ring_resident` in rsum's dtype), in ascending
    order and compacted; else group g is chunk g (lane l, sphere 32·g +
    l).  Per group a word each of ``out`` (pair (i, j) exists),
    ``inonly`` (pair (j, i) exists, j active, and is no mirror) and
    ``mirror`` (both exist with equal radius sums in rsum's dtype, so
    their distances are bit-equal and share one vote), bit l for lane l,
    and the count of groups that hold a partner; each lane's partner; the
    radius sums of (i, j) and of (j, i) by lane (0 where no pair).  A CPU
    rsum runs the plain version, a CUDA one the layout kernel (one
    launch)."""
    if rsum.device.type == "cpu":
        return pair_layout_ref(pair_i, pair_j, rsum, Sa, So)
    if rsum.device.type != "cuda":
        raise ValueError(f"pair_layout: unsupported device {rsum.device}")
    P = pair_i.shape[0]
    dev = rsum.device
    dt = kernels.check_dtype(rsum.dtype, "pair_layout")
    kernels.require(pair_i, "pair_i", torch.int32, (P,), dev)
    kernels.require(pair_j, "pair_j", torch.int32, (P,), dev)
    kernels.require(rsum, "rsum", dt, (P,), dev)
    G = -(-So // LANES)
    masks = torch.empty((Sa, G, 4), dtype=torch.int32, device=dev)
    partners = torch.empty((Sa, G, LANES), dtype=torch.int32, device=dev)
    rs = torch.empty((2, Sa, G, LANES), dtype=dt, device=dev)
    kernels.launch(rsum, "pair_layout",
                   kernels.entry("cdx_selfcol_layout", dt), pair_i.data_ptr(),
                   pair_j.data_ptr(), rsum.data_ptr(), P, Sa, So,
                   masks.data_ptr(), partners.data_ptr(), rs.data_ptr())
    kernels.count(_THIS, "LAYOUT_LAUNCHES")
    return PairLayout(masks, partners, rs)


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


def selfcol_pairs_ref(xi, vel, xo, pair_i, pair_j, rsum, eps_self, obs_self,
                      layout=None):
    """Plain version of :func:`selfcol_pairs` (same contract; it reads
    the pair table, not ``layout``)."""
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


def selfcol_pairs(xi, vel, xo, pair_i, pair_j, rsum, eps_self, obs_self,
                  layout=None):
    """Self-collision net workspace gradient and per-sphere cost.

    xi, vel: (3, m, Sa, B) active sphere positions / velocities; xo
    (3, SI, B) inactive sphere positions (SI may be 0); pair_i, pair_j
    (P,) int32 and rsum (P,) from :func:`pair_table`, pair_j indexing the
    active-then-inactive order and sorted by pair_i; eps_self, obs_self
    (B,).

    Returns (net (3, m, Sa, B), cost (m, Sa, B)): per (point, active
    sphere) the summed workspace gradient and the pair cost scaled by
    obs_factor_self·‖ẋ_i‖ (pallas_selfcol.py:selfcol_pairs).

    ``layout``: the table's :func:`pair_layout` on xi's device (the
    engine's, built once); on the tiled path a call without one builds it
    first, in one more launch.  The plain version does not read it.

    The kernel takes float32 or float64 tensors (another dtype raises
    ValueError); every tensor of floats has xi's dtype.
    """
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
    ptrs = (None, None, None)
    if launch_shape(Sa, SI, dt.itemsize)[0] == "tiled":
        if layout is None:
            layout = pair_layout(pair_i, pair_j, rsum, Sa, Sa + SI)
        G = -(-(Sa + SI) // LANES)
        for t, name, tdt, shape in zip(
                layout, ("masks", "partners", "rs"),
                (torch.int32, torch.int32, dt),
                ((Sa, G, 4), (Sa, G, LANES), (2, Sa, G, LANES))):
            kernels.require(t, f"layout.{name}", tdt, shape, dev)
        ptrs = tuple(t.data_ptr() for t in layout)
    kernels.launch(
        xi, "selfcol_pairs", kernels.entry("cdx_selfcol", dt),
        xi.data_ptr(), vel.data_ptr(), xo.data_ptr(), m, Sa, SI, B,
        pair_i.data_ptr(), pair_j.data_ptr(), rsum.data_ptr(), P,
        eps_self.data_ptr(), obs_self.data_ptr(), net.data_ptr(),
        cost.data_ptr(), *ptrs)
    kernels.count(_THIS, "LAUNCHES")
    return net, cost


def traffic_bytes(m, Sa, SI, B, P, itemsize=4):
    """Bytes one call must move at the given shapes: each input read once
    (xi, vel, xo, eps_self, obs_self, the pair table), each output
    written once (net, cost); floats of ``itemsize`` bytes (4 float32, 8
    float64), 4-byte ints."""
    floats = (2 * 3 * m * Sa * B + 3 * SI * B + 2 * B + P
              + 3 * m * Sa * B + m * Sa * B)
    return itemsize * floats + 4 * 2 * P


def layout_traffic_bytes(P, Sa, So, itemsize=4):
    """Bytes one :func:`pair_layout` call must move: the pair table read
    once (two int32 columns, rsum in floats of ``itemsize`` bytes), the
    layout written once (G = ceil(So / 32) groups per active sphere: four
    mask words, 32 partners, two rows of 32 radius sums)."""
    G = -(-So // LANES)
    return (8 + itemsize) * P + Sa * G * (4 * 4 + 4 * LANES
                                          + 2 * LANES * itemsize)


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


def ring_resident(So, itemsize=4):
    """Whether a tiled block for So spheres holds every 32-sphere chunk of
    its work item in its shared-memory ring: where they fit in
    RING_BYTES_MAX, up to 256 spheres in float32, 128 in float64; else
    two slots, through which each round streams the chunks (selfcol.cu
    ring_resident)."""
    return -(-So // LANES) * SLOT_WORDS * itemsize <= RING_BYTES_MAX


def tiled_smem(So, itemsize=4):
    """Dynamic shared memory of a tiled block, bytes: its ring
    (selfcol.cu tiled_smem)."""
    slots = -(-So // LANES) if ring_resident(So, itemsize) else 2
    return slots * SLOT_WORDS * itemsize


def launch_shape(Sa, SI, itemsize=4):
    """The kernel's path for Sa active and SI inactive spheres and its
    launch: (path, threads, dynamic shared memory bytes) per block.  In
    float32 (``itemsize`` 4) the staged path wherever its block fits in
    SMEM_BLOCK_MAX, else the tiled path (selfcol.cu
    selfcol_path_staged); in float64 (8) the tiled path."""
    if itemsize == 4:
        nw = min(Sa, MAX_WARPS)
        smem = 4 * smem_words(Sa, Sa + SI, nw)
        if smem <= SMEM_BLOCK_MAX:
            return "staged", LANES * nw, smem
    return "tiled", LANES * TILED_WARPS, tiled_smem(Sa + SI, itemsize)


def launch_info(Sa, SI, dtype=torch.float32, device_index=None):
    """The kernel's main launch on card ``device_index`` (None: the
    current one) for Sa active and SI inactive spheres in ``dtype``:
    threads and dynamic shared memory per block, resident blocks per SM,
    registers and local (spill) bytes per thread, and the path taken
    ("staged" or "tiled")."""
    info = (ctypes.c_int * 6)()
    with torch.cuda.device(device_index):
        kernels.check(kernels.entry("cdx_selfcol_launch_info", dtype)(
            Sa, SI, info), "selfcol launch_info")
    out = dict(zip(("threads", "smem_bytes", "blocks_per_sm", "registers",
                    "local_bytes"), info))
    out["path"] = ("staged", "tiled")[info[5]]
    return out
