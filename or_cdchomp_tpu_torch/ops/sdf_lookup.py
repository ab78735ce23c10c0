"""K1: the SDF cell lookup and the fused obstacle cost (csrc/obstacle.cu).

Counterpart of or_cdchomp_tpu/ops/pallas_sdf.py (the raw 4-cell lookup)
and of the obstacle phase of or_cdchomp_tpu/chomp/cost_soa.py
(``_obstacle_soa``).  Each public function dispatches on the device of
its tensors: CPU tensors go to the plain PyTorch version beside it, CUDA
tensors to the hand-written kernel (or an error).  There is no fallback.

``LAUNCHES`` / ``LOOKUP_LAUNCHES`` count kernel launches of
:func:`obstacle` (one per call unless it splits a call past MAX_QUERIES)
/ :func:`sdf_cell_lookup`.  :func:`obstacle_traffic_bytes` (with
:func:`obstacle_cells`) and :func:`obstacle_flops` count the work of one
:func:`obstacle` call for its bound on the card; :func:`launch_geometry`
sizes its launch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from or_cdchomp_tpu_torch.ops import kernels, soa

LAUNCHES = 0          # fused obstacle kernel launches
LOOKUP_LAUNCHES = 0   # raw sdf_cell_lookup kernel launches

_VEL_EPS = 1e-6       # ‖ẋ‖ guard, orcdchomp_mod.cpp:1226/1285
LANES = 32            # problems per warp, and per block tile (obstacle.cu)
THREADS = 256         # threads per block: 8 warps, each walking rows
SMEM_BLOCK_MAX = 232_448   # shared memory one block may use (227 KB)
# queries (point, sphere, problem) one launch takes: the kernel indexes
# the three components of x, vel and acc with 32-bit ints (3·q < 2**31)
MAX_QUERIES = (2 ** 31 - 1) // 3
# float operations of one obstacle query, counted from obstacle_ref's
# expressions and rounded: per field (frame transform, subscripts, cells,
# gradient, rotation to world, min-select) and once (hinge, projection,
# curvature, scaling)
FLOPS_FIELD = 120
FLOPS_QUERY = 80


# ---- raw 4-cell lookup (the Pallas kernel's contract) ----------------------

def sdf_cell_lookup_ref(data, sub, nbr):
    """Plain version of :func:`sdf_cell_lookup`."""
    F, mx, my, mz = data.shape
    flat = data.reshape(F, -1)

    def at(x, y, z):
        return torch.gather(flat, 1, ((x * my + y) * mz + z).long())

    sx, sy, sz = sub.unbind(-1)
    nx, ny, nz = nbr.unbind(-1)
    return at(sx, sy, sz), at(nx, sy, sz), at(sx, ny, sz), at(sx, sy, nz)


def sdf_cell_lookup(data, sub, nbr):
    """Four cells per (field, query): the centre and one neighbour per
    axis (libcd grid.c:331-454).

    data: (F, mx, my, mz); sub, nbr: (F, Q, 3) int32 in-range centre and
    neighbour subscripts.  Returns (v0, vnx, vny, vnz), each (F, Q), with
    vnx = data[f, nbr_x, sub_y, sub_z] and so on.  One launch on CUDA
    tensors, which takes Q < 2**31 (ValueError past it).
    """
    global LOOKUP_LAUNCHES
    if data.device.type == "cpu":
        return sdf_cell_lookup_ref(data, sub, nbr)
    if data.device.type != "cuda":
        raise ValueError(f"sdf_cell_lookup: unsupported device {data.device}")
    F, mx, my, mz = data.shape
    Q = sub.shape[1]
    if Q >= 2 ** 31:
        raise ValueError(f"sdf_cell_lookup: {Q} queries per field; the "
                         f"kernel takes fewer than 2**31")
    dev = data.device
    kernels.require(data, "data", torch.float32, (F, mx, my, mz), dev)
    kernels.require(sub, "sub", torch.int32, (F, Q, 3), dev)
    kernels.require(nbr, "nbr", torch.int32, (F, Q, 3), dev)
    out = torch.empty((4, F, Q), dtype=torch.float32, device=dev)
    lib = kernels.library()
    err = lib.cdx_sdf_cell_lookup(
        data.data_ptr(), F, mx, my, mz, sub.data_ptr(), nbr.data_ptr(),
        Q, out.data_ptr(), kernels.stream_ptr(data))
    kernels.check(err, "sdf_cell_lookup")
    LOOKUP_LAUNCHES += 1
    return out[0], out[1], out[2], out[3]


# ---- fused obstacle cost ---------------------------------------------------

def lookup_geometry(p, sizes, lengths):
    """libcd's one-sided lookup rule at grid-frame points p (..., 3) in
    grids of integer ``sizes`` and side ``lengths`` (broadcast against
    p): in-box mask, clamped centre subscripts (int32), centres, the
    neighbour choice (the next cell where p is at or past the centre,
    edge cells forced inward) and the sizes in p's dtype (grid.c:191-228,
    331-454; the expressions obstacle.cu rounds alike).  The one copy of
    the rule: :func:`obstacle_ref` and ``grid.multigrid_interp_grad``
    both read it."""
    sizes_f = sizes.to(p.dtype)
    x = p / lengths
    in_bounds = torch.all((x >= 0.0) & (x <= 1.0), dim=-1)
    # clamped before the cast, so a far query never overflows int32
    sub = torch.minimum(torch.clamp(torch.floor(x * sizes_f), min=0.0),
                        sizes_f - 1.0).to(torch.int32)
    center = (sub.to(p.dtype) + 0.5) / sizes_f * lengths
    use_next = p >= center
    use_next = torch.where(sub == 0, True, use_next)
    use_next = torch.where(sub == sizes - 1, False, use_next)
    return in_bounds, sub, center, use_next, sizes_f


def _field_subs(p, ln, size):
    """:func:`lookup_geometry` of one field for points given as 3
    components p (each (m, S, B)), per axis as component lists."""
    sizes = torch.tensor(size, dtype=torch.int32, device=p[0].device)
    in_b, sub, center, use_next, szf = lookup_geometry(
        torch.stack(p, dim=-1), sizes, ln)
    return (in_b, sub.unbind(-1), center.unbind(-1), use_next.unbind(-1),
            szf.unbind(-1))


def obstacle_ref(x, vel, acc, data, sizes, lengths, pose_gsdf_world,
                 pose_world_gsdf, field_enabled, radii, epsilon, obs_factor,
                 want_dirs=False):
    """Plain version of :func:`obstacle` (same contract), written as
    cost_soa.py:_obstacle_soa with true ±inf cells."""
    dtype = x.dtype
    _, m, S, B = x.shape
    F, mx, my, mz = data.shape
    flat = data.reshape(F, -1)
    sizes_l = sizes.tolist()
    xs, vs, as_ = tuple(x), tuple(vel), tuple(acc)
    inf = torch.tensor(float("inf"), dtype=dtype, device=x.device)

    def comps(pose):          # (B, 7) → 7 components of (B,)
        return tuple(pose[:, i] for i in range(7))

    best_v = best_g = None
    dirs = []
    for f in range(F):
        pg = comps(pose_gsdf_world[:, f])
        p = soa.add(soa.qrot(pg[3:], xs), pg[:3])            # (m, S, B)
        ln = lengths[f]
        in_b, sub, center, use_next, szf = _field_subs(p, ln, sizes_l[f])
        if want_dirs:
            dirs.append(use_next[0].to(torch.int32)
                        | (use_next[1].to(torch.int32) << 1)
                        | (use_next[2].to(torch.int32) << 2))

        def cell(cx, cy, cz):
            idx = ((cx.long() * my + cy) * mz + cz).reshape(-1)
            return flat[f].index_select(0, idx).reshape(m, S, B)

        nb = [s + torch.where(u, 1, -1).to(torch.int32)
              for s, u in zip(sub, use_next)]
        v0 = cell(sub[0], sub[1], sub[2])
        vn3 = (cell(nb[0], sub[1], sub[2]), cell(sub[0], nb[1], sub[2]),
               cell(sub[0], sub[1], nb[2]))
        any_inf = torch.isinf(v0)
        value = v0
        g = []
        for i in range(3):
            vn = vn3[i]
            any_inf = any_inf | torch.isinf(vn)
            sign = torch.where(use_next[i], 1.0, -1.0).to(dtype)
            gi = sign * (vn - v0) * (szf[i] / ln[i])
            g.append(gi)
            value = value + gi * (p[i] - center[i])
        bad = (~in_b) | any_inf | (~field_enabled[:, f])
        value = torch.where(bad, inf, value)
        g = tuple(torch.where(bad, 0.0, gi) for gi in g)

        # rotate the gradient to world per field, before the min-select
        pw = comps(pose_world_gsdf[:, f])
        gw = soa.qrot(pw[3:], g)
        if best_v is None:
            best_v, best_g = value, gw
        else:
            take = value < best_v                 # strict: first wins ties
            best_v = torch.where(take, value, best_v)
            best_g = tuple(torch.where(take, a, b) for a, b in zip(gw, best_g))

    has_field = torch.isfinite(best_v)
    dist = torch.where(has_field, best_v, 0.0)
    d = dist - radii[None, :, None]
    eps = epsilon
    v2 = soa.norm2(vs)
    vnorm = torch.sqrt(v2)

    # hinge cost scaled by workspace speed (orcdchomp_mod.cpp:1201-1205)
    c_in = obs_factor * (0.5 * eps - d)
    c_mid = obs_factor * (0.5 / eps) * (d - eps) ** 2
    cost = vnorm * torch.where(d < 0.0, c_in,
                               torch.where(d < eps, c_mid, 0.0))
    cost = torch.where(has_field, cost, 0.0)

    # cost-slope scaling (orcdchomp_mod.cpp:1218-1223)
    slope = torch.where(d < 0.0, -1.0,
                        torch.where(d < eps, d / eps - 1.0, 0.0))
    sc = torch.where(has_field, slope * vnorm * obs_factor, 0.0)
    x_grad = soa.scale(best_g, sc)

    # projection off the velocity + curvature (orcdchomp_mod.cpp:1225-1241)
    safe = vnorm > _VEL_EPS
    v2s = torch.where(safe, v2, 1.0)
    proj = torch.where(safe, soa.dot(x_grad, vs) / v2s, 0.0)
    x_grad = soa.sub(x_grad, soa.scale(vs, proj))
    aproj = torch.where(safe, soa.dot(as_, vs) / v2s, 0.0)
    curv = soa.scale(soa.sub(as_, soa.scale(vs, aproj)),
                     torch.where(safe, 1.0 / v2s, 0.0))
    x_grad = soa.sub(x_grad, soa.scale(curv, cost))
    wgrad = torch.stack(soa.scale(x_grad, vnorm))
    if want_dirs:
        return cost, wgrad, torch.stack(dirs)
    return cost, wgrad


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch of the obstacle kernel.  The (tile, row) space, tiles
    of LANES problems by rows = m·S (point, sphere) rows, has ``units``
    units; block k walks units [k·per, (k+1)·per), its warps every
    (threads / LANES)-th row of each tile it meets."""

    threads: int
    smem_bytes: int       # dynamic shared memory per block
    blocks_per_sm: int
    per: int
    grid: int
    units: int


def smem_bytes(F, mx, my, mz):
    """Shared memory of a block: per field and lane the two staged poses
    (12 words, field_enabled among them), per field 5×4 words of
    constants, the cell centres (F, mx + my + mz).  The layout is
    obstacle.cu's (smem_words); a GPU test holds the two counts equal."""
    return 4 * (4 * 3 * F * LANES + 4 * 5 * F + F * (mx + my + mz))


def launch_geometry(m, S, B, F, mx, my, mz, n_sm, occupancy):
    """The launch of :func:`obstacle` on a card of ``n_sm`` SMs, where
    ``occupancy(smem_bytes)`` gives the resident blocks per SM.  The grid
    is one wave: the units are split evenly over the blocks that fit at
    once, each block taking at least one row per warp."""
    smem = smem_bytes(F, mx, my, mz)
    if smem > SMEM_BLOCK_MAX:
        raise ValueError(f"obstacle: {smem} B of shared memory per block "
                         f"(F={F}) exceeds {SMEM_BLOCK_MAX}")
    bps = occupancy(smem)
    if bps < 1:
        raise ValueError(f"obstacle: no block of {smem} B fits an SM")
    units = -(-B // LANES) * m * S
    per = max(THREADS // LANES, -(-units // (n_sm * bps)))
    return Geometry(THREADS, smem, bps, per, -(-units // per), units)


@functools.lru_cache(maxsize=None)
def launch_info(smem):
    """The kernel's launch on the card for blocks of THREADS threads and
    ``smem`` bytes: resident blocks per SM, registers and local (spill)
    bytes per thread."""
    info = (ctypes.c_int * 3)()
    kernels.check(kernels.library().cdx_obstacle_launch_info(
        THREADS, smem, info), "obstacle launch_info")
    return dict(blocks_per_sm=info[0], registers=info[1],
                local_bytes=info[2])


@functools.lru_cache(maxsize=None)
def device_geometry(m, S, B, F, mx, my, mz, device_index):
    """:func:`launch_geometry` on CUDA device ``device_index``."""
    n_sm = torch.cuda.get_device_properties(
        device_index).multi_processor_count
    return launch_geometry(m, S, B, F, mx, my, mz, n_sm,
                           lambda smem: launch_info(smem)["blocks_per_sm"])


def obstacle(x, vel, acc, data, sizes, lengths, pose_gsdf_world,
             pose_world_gsdf, field_enabled, radii, epsilon, obs_factor,
             want_dirs=False):
    """SoA obstacle cost and workspace gradient over F padded fields.

    x, vel, acc: (3, m, S, B) sphere positions, velocities and
    accelerations.  data (F, mx, my, mz) padded field stack (+inf
    padding), sizes (F, 3) int32 true sizes, lengths (F, 3); per problem
    pose_gsdf_world / pose_world_gsdf (B, F, 7), field_enabled (B, F)
    bool, epsilon / obs_factor (B,); radii (S,).

    Returns (cost (m, S, B), wgrad (3, m, S, B)): the ‖ẋ‖-scaled hinge
    cost per (point, sphere) and the ‖ẋ‖-scaled workspace gradient
    (cost_soa.py:_obstacle_soa).  ``want_dirs`` adds the one-sided
    neighbour choice per field, (F, m, S, B) int32 with bit i set when
    axis i uses the next cell — a check of the subscript arithmetic.

    The kernel indexes with 32-bit integers, so one launch takes at most
    MAX_QUERIES (point, sphere, problem) queries (about 716 M; BASELINE's
    largest, config 5, has 15.2 M).  On the card a larger call is split
    along B into contiguous chunks of problems, one launch each: every
    query's arithmetic is its own, so the result is bit-equal to one
    launch.
    """
    if x.device.type == "cpu":
        return obstacle_ref(x, vel, acc, data, sizes, lengths,
                            pose_gsdf_world, pose_world_gsdf, field_enabled,
                            radii, epsilon, obs_factor, want_dirs)
    if x.device.type != "cuda":
        raise ValueError(f"obstacle: unsupported device {x.device}")
    _, m, S, B = x.shape
    per = max(1, MAX_QUERIES // (m * S))        # problems per launch
    outs = []
    for lo in range(0, B, per):
        hi = min(lo + per, B)
        if (lo, hi) == (0, B):
            cx, cv, ca, per_problem = x, vel, acc, (
                pose_gsdf_world, pose_world_gsdf, field_enabled, epsilon,
                obs_factor)
        else:
            cx, cv, ca = (t[..., lo:hi].contiguous() for t in (x, vel, acc))
            per_problem = tuple(t[lo:hi] for t in (
                pose_gsdf_world, pose_world_gsdf, field_enabled, epsilon,
                obs_factor))
        pg, pw, en, eps, of = per_problem
        geom = device_geometry(m, S, hi - lo, *data.shape, x.device.index)
        outs.append(obstacle_launch(geom, cx, cv, ca, data, sizes, lengths,
                                    pg, pw, en, radii, eps, of, want_dirs))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def obstacle_launch(geom, x, vel, acc, data, sizes, lengths,
                    pose_gsdf_world, pose_world_gsdf, field_enabled, radii,
                    epsilon, obs_factor, want_dirs=False):
    """One launch of the kernel with the given :class:`Geometry` (from
    :func:`device_geometry`; a test may give another grid).  Same
    arguments and results as :func:`obstacle`, CUDA tensors only."""
    global LAUNCHES
    _, m, S, B = x.shape
    F, mx, my, mz = data.shape
    dev = x.device
    f32 = torch.float32
    for name, t in (("x", x), ("vel", vel), ("acc", acc)):
        kernels.require(t, name, f32, (3, m, S, B), dev)
    kernels.require(data, "data", f32, (F, mx, my, mz), dev)
    kernels.require(sizes, "sizes", torch.int32, (F, 3), dev)
    kernels.require(lengths, "lengths", f32, (F, 3), dev)
    kernels.require(pose_gsdf_world, "pose_gsdf_world", f32, (B, F, 7), dev)
    kernels.require(pose_world_gsdf, "pose_world_gsdf", f32, (B, F, 7), dev)
    kernels.require(field_enabled, "field_enabled", torch.bool, (B, F), dev)
    kernels.require(radii, "radii", f32, (S,), dev)
    kernels.require(epsilon, "epsilon", f32, (B,), dev)
    kernels.require(obs_factor, "obs_factor", f32, (B,), dev)
    if m * S * B > MAX_QUERIES:
        raise ValueError(f"obstacle_launch: {m * S * B} queries need 64-bit "
                         f"indices; one launch takes at most {MAX_QUERIES} "
                         "(obstacle splits a larger call)")
    cost = torch.empty((m, S, B), dtype=f32, device=dev)
    wgrad = torch.empty((3, m, S, B), dtype=f32, device=dev)
    dirs = (torch.empty((F, m, S, B), dtype=torch.int32, device=dev)
            if want_dirs else None)
    lib = kernels.library()
    err = lib.cdx_obstacle(
        x.data_ptr(), vel.data_ptr(), acc.data_ptr(), m, S, B,
        data.data_ptr(), F, mx, my, mz, sizes.data_ptr(),
        lengths.data_ptr(), pose_gsdf_world.data_ptr(),
        pose_world_gsdf.data_ptr(), field_enabled.data_ptr(),
        radii.data_ptr(), epsilon.data_ptr(), obs_factor.data_ptr(),
        cost.data_ptr(), wgrad.data_ptr(),
        dirs.data_ptr() if want_dirs else None, geom.grid, geom.threads,
        geom.per, geom.smem_bytes, kernels.stream_ptr(x))
    kernels.check(err, "obstacle")
    LAUNCHES += 1
    if want_dirs:
        return cost, wgrad, dirs
    return cost, wgrad


def obstacle_cells(x, data, sizes, lengths, pose_gsdf_world, field_enabled):
    """Distinct field cells one :func:`obstacle` call needs on these
    inputs: the centre cell and the three one-sided neighbours of every
    query inside an enabled field's box (a query outside gives +inf
    without a read)."""
    F, mx, my, mz = data.shape
    sizes_l = sizes.tolist()
    xs = tuple(x)
    total = 0
    for f in range(F):
        pg = tuple(pose_gsdf_world[:, f, i] for i in range(7))
        p = soa.add(soa.qrot(pg[3:], xs), pg[:3])
        in_b, sub, _, use_next, _ = _field_subs(p, lengths[f], sizes_l[f])
        take = in_b & field_enabled[None, None, :, f]
        sub = [s_[take].long() for s_ in sub]
        nb = [s_ + torch.where(u[take], 1, -1) for s_, u in zip(sub, use_next)]
        cells = torch.cat([(sub[0] * my + sub[1]) * mz + sub[2],
                           (nb[0] * my + sub[1]) * mz + sub[2],
                           (sub[0] * my + nb[1]) * mz + sub[2],
                           (sub[0] * my + sub[1]) * mz + nb[2]])
        total += int(torch.unique(cells).numel())
    return total


def obstacle_traffic_bytes(m, S, B, F, mx, my, mz, cells=None):
    """Bytes one :func:`obstacle` call must move at the given shapes: each
    input read once (x, vel, acc, the field cells — ``cells`` of them, as
    :func:`obstacle_cells` counts on a call's inputs, or the whole stack
    — the sizes and lengths, both per-problem poses, field_enabled,
    radii, epsilon, obs_factor), each output written once (cost, wgrad);
    4-byte floats and ints, 1-byte bools."""
    q = m * S * B
    cells = F * mx * my * mz if cells is None else cells
    reads = (4 * (3 * 3 * q + cells + 2 * 3 * F + 2 * 7 * B * F
                  + S + 2 * B)
             + B * F)
    writes = 4 * (q + 3 * q)
    return reads + writes


def obstacle_flops(m, S, B, F):
    """Float operations of one :func:`obstacle` call (FLOPS_FIELD,
    FLOPS_QUERY)."""
    return m * S * B * (F * FLOPS_FIELD + FLOPS_QUERY)
