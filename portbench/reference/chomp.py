"""A plain float64 CHOMP solve, the yardstick of the benchmark's checks.

Written from the semantics of the reference's solver (or_cdchomp's
chomp.c and orcdchomp_mod.cpp, as the port documents them), in plain
PyTorch and NumPy, and reading only a configuration file
(configs/<name>.json) and the endpoints of each problem.  It imports
nothing of the program under test and takes nothing the program made:
it builds the robot's kinematics, the signed distance field, the metric
and the constraint system again from the configuration.  Where the
program hand-writes a derivative, this code takes it from autograd: the
Jacobian-transpose map is the vector-Jacobian product of the sphere
centres, and the TSR Jacobian the derivative of the constraint values.

One step, per problem of a batch (B, n_points, n):

1. FK of every trajectory point; the moving spheres' centres, their
   finite-difference velocities and accelerations.
2. Obstacle cost and workspace gradient from the field (libcd's
   one-sided four-cell lookup, the hinge scaled by the sphere's speed,
   the gradient projected off its velocity, the curvature term);
   self-collision of every ordered (active sphere, any sphere) pair on
   different links.
3. G = (Jᵀ w) / m (a floating base's columns damped by 0.01), then
   G += A·T + B; AG = A⁻¹·G.
4. With TSR constraints: the goal-set projection of the update.
5. T −= AG / λ; the joint-limit repair; the smoothness cost; a
   floating base's quaternion renormalised.

Everything runs in float64 on the device it is given, in one batch.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

F64 = torch.float64
LIMIT_ROUNDS = 1000      # the repair's cap (chomp.c:608-655)
VEL_EPS = 1e-6           # the |x'| guard of the obstacle and self terms
BASE_DAMP = 0.01         # a floating base's gradient damping
# the field build's contact rules: a box whose separating-axis test, in
# float32 with BOX_TOL added to each |rotation| entry, finds no gap, and
# a cylinder that CONTACT_ROUNDS alternating projections bring within
# CONTACT of a cell's cube, occupy the cell
BOX_TOL = 1e-7
CONTACT = 1e-4
CONTACT_ROUNDS = 96
NEAREST_BLOCK = 2048     # cells a block of the distance transform takes
DEFAULTS = dict(epsilon=0.1, epsilon_self=0.04, obs_factor=200.0,
                obs_factor_self=10.0, lambda_=10.0)


# ---- poses: (x y z qx qy qz qw) ---------------------------------------------

def quat_R(q):
    """Rotation matrices (..., 3, 3) of quaternions (..., 4), normalised
    first."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    rows = [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]
    return torch.stack(rows, dim=-1).unflatten(-1, (3, 3))


def axis_R(axis, theta):
    """Rotations by ``theta`` (...) about the unit ``axis`` (3,)
    (Rodrigues)."""
    a = torch.as_tensor(axis, dtype=theta.dtype, device=theta.device)
    K = torch.zeros((3, 3), dtype=theta.dtype, device=theta.device)
    K[0, 1], K[0, 2], K[1, 2] = -a[2], a[1], -a[0]
    K = K - K.T
    s, c = torch.sin(theta)[..., None, None], torch.cos(theta)[..., None, None]
    return torch.eye(3, dtype=theta.dtype, device=theta.device) + s * K \
        + (1 - c) * (K @ K)


def pose_Rt(pose):
    """(R, t) of a pose (7,) given as a list, float64 numpy."""
    p = torch.as_tensor(np.asarray(pose, np.float64))
    return quat_R(p[3:]).numpy(), p[:3].numpy()


# ---- the robot --------------------------------------------------------------

class Robot:
    """Kinematics of the configuration's robot: links in topological
    order, each joint's origin, axis and active column; the spheres, the
    tool frame.  Joints not in ``active`` are frozen at 0."""

    def __init__(self, cfg, floating):
        r = cfg["robot"]
        self.links = list(r["links"])
        idx = {n: i for i, n in enumerate(self.links)}
        L = len(self.links)
        self.parent = [-1] * L
        self.origin = [(np.eye(3), np.zeros(3))] * L
        self.axis = [None] * L
        self.col = [-1] * L        # active column of the link's joint
        self.moving = [False] * L  # revolute joint, active or frozen
        active = list(r["active"])
        self.lo = np.zeros(len(active))
        self.hi = np.zeros(len(active))
        self.vmax = np.zeros(len(active))
        for j in r["joints"]:
            c = idx[j["child"]]
            self.parent[c] = idx[j["parent"]]
            self.origin[c] = pose_Rt(j["origin"])
            if j.get("type", "revolute") == "fixed":
                continue
            self.moving[c] = True
            a = np.asarray(j["axis"], np.float64)
            self.axis[c] = a / np.linalg.norm(a)
            if j["name"] in active:
                k = active.index(j["name"])
                self.col[c] = k
                self.lo[k], self.hi[k] = j["limits"]
                self.vmax[k] = j["max_vel"]
        self.n_arm = len(active)
        self.floating = floating
        self.base = np.asarray(r["pose"], np.float64)
        self.sphere_link = np.array([idx[s[0]] for s in r["spheres"]])
        self.sphere_pos = np.array([s[1] for s in r["spheres"]], np.float64)
        self.radius = np.array([s[2] for s in r["spheres"]], np.float64)
        self.ee = idx[r["ee_link"]]
        self.ee_origin = pose_Rt(r["ee_origin"])
        # a sphere moves with the arm when an active joint lies above its
        # link; a floating base moves them all
        moved = np.zeros(L, bool)
        for i in range(L):
            j = i
            while j > 0:
                moved[i] |= self.col[j] >= 0
                j = self.parent[j]
        act = np.ones(len(self.radius), bool) if floating \
            else moved[self.sphere_link]
        self.active = np.where(act)[0]
        self.inactive = np.where(~act)[0]

    def links_at(self, T):
        """World (R, t) of every link, each a list over links of
        (..., 3, 3) and (..., 3), for configurations T (..., n): a
        floating base's pose in T[..., :7], then the arm's columns."""
        dev = T.device
        if self.floating:
            R0, t0 = quat_R(T[..., 3:7]), T[..., :3]
            q = T[..., 7:]
        else:
            Rb, tb = pose_Rt(self.base)
            R0 = torch.as_tensor(Rb, dtype=T.dtype, device=dev).expand(
                T.shape[:-1] + (3, 3))
            t0 = torch.as_tensor(tb, dtype=T.dtype, device=dev).expand(
                T.shape[:-1] + (3,))
            q = T
        Rs, ts = [R0], [t0]
        for i in range(1, len(self.links)):
            Rp, tp = Rs[self.parent[i]], ts[self.parent[i]]
            Ro, to = (torch.as_tensor(v, dtype=T.dtype, device=dev)
                      for v in self.origin[i])
            R = Rp @ Ro
            t = tp + (Rp @ to[:, None])[..., 0]
            if self.moving[i]:
                th = q[..., self.col[i]] if self.col[i] >= 0 \
                    else torch.zeros(q.shape[:-1], dtype=T.dtype, device=dev)
                R = R @ axis_R(self.axis[i], th)
            Rs.append(R)
            ts.append(t)
        return Rs, ts

    def spheres(self, T, which):
        """Centres (..., len(which), 3) of the spheres ``which``."""
        Rs, ts = self.links_at(T)
        out = []
        for s in which:
            li = self.sphere_link[s]
            p = torch.as_tensor(self.sphere_pos[s], dtype=T.dtype,
                                device=T.device)
            out.append(ts[li] + (Rs[li] @ p[:, None])[..., 0])
        return torch.stack(out, dim=-2)

    def tool(self, T):
        """World (R, t) of the tool frame (the end-effector link's pose
        composed with the tool origin)."""
        Rs, ts = self.links_at(T)
        Ro, to = (torch.as_tensor(v, dtype=T.dtype, device=T.device)
                  for v in self.ee_origin)
        R, t = Rs[self.ee], ts[self.ee]
        return R @ Ro, t + (R @ to[:, None])[..., 0]

    def adjacent(self):
        """(S, S) bool: spheres whose links are one rigid body or joined
        by one articulated joint (the pairs a self-collision check
        skips)."""
        L = len(self.links)

        def root(i):          # up through fixed and frozen joints
            while i > 0 and self.col[i] < 0:
                i = self.parent[i]
            return i

        art = [root(i) for i in range(L)]
        up = [root(self.parent[a]) if a > 0 else -1 for a in art]
        sl = self.sphere_link
        adj = np.zeros((len(sl), len(sl)), bool)
        for a in range(len(sl)):
            for b in range(len(sl)):
                ra, rb = art[sl[a]], art[sl[b]]
                adj[a, b] = ra == rb or up[sl[a]] == rb or up[sl[b]] == ra
        return adj


# ---- the field --------------------------------------------------------------

def _f32(v):
    """The configuration's float32 scene numbers, as the program holds
    them, in float64."""
    return np.asarray(np.asarray(v, np.float32), np.float64)


def _centres32(sizes, lengths, t_wg):
    """The cells' world centres (sizes + (3,)) as float32 numbers, the
    configuration's precision, in which the occupancy of a cube that
    touches a body exactly is decided."""
    f = np.float32
    axes = [((np.arange(n).astype(f) + f(0.5)) / f(n) * f(lengths[i]))
            .astype(f) + f(t_wg[i]) for i, n in enumerate(sizes)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).astype(f)


def _box_hits(cw, ce, pose, half):
    """Occupancy of the probe cubes (half extent ``ce``) at the float32
    centres ``cw`` against an axis-aligned box, by the separating-axis
    test in float32: a cube overlaps where no face axis of the world or
    of the box separates them, touching counts, and each |rotation|
    entry carries BOX_TOL.  The default extent puts cell faces on the
    table's faces, so the float32 rounding of the centres decides whether
    a touching cube is occupied."""
    f = np.float32
    eps, a = f(BOX_TOL), f(ce)
    on, off = f(1) + eps, eps
    b = np.asarray(half, f)
    gap = np.abs(np.asarray(pose[:3], f) - cw)
    # world axes: a + sum_j b_j |R_ij|; the box's: b_j + a sum_i |R_ij|
    ra = a + np.array([b[0] * on + b[1] * off + b[2] * off,
                       b[0] * off + b[1] * on + b[2] * off,
                       b[0] * off + b[1] * off + b[2] * on], f)
    rb = b + (a * on + a * off + a * off)
    return np.all((gap <= ra) & (gap <= rb), axis=-1)


def _cylinder_hits(p, ce, r, h):
    """Occupancy of the probe cubes (half extent ``ce``) at ``p`` (...,
    3), the cells' centres in the frame of a z-aligned cylinder (radius
    ``r``, half height ``h``).  A cube whose centre lies within ``ce`` of
    the cylinder overlaps it, one whose centre lies beyond ``ce`` √3 does
    not; between them, alternating projections onto the cylinder and the
    cube decide, within CONTACT after CONTACT_ROUNDS rounds.  At the
    default extent some cubes touch the mug exactly; the projections
    settle a touch on a cap within the rounds and not one on the curved
    side, so touching cubes beside the mug stay free."""
    rxy = np.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    out = np.stack([rxy - r, np.abs(p[..., 2]) - h], -1)
    sd = (np.sqrt(np.sum(np.maximum(out, 0.0) ** 2, -1))
          + np.minimum(np.max(out, -1), 0.0))

    def onto_cube(q):
        return p + np.clip(q - p, -ce, ce)

    def onto_cylinder(q):
        d = np.sqrt(q[..., 0] ** 2 + q[..., 1] ** 2)
        s = np.where(d > r, r / np.maximum(d, 1e-30), 1.0)
        return np.stack([q[..., 0] * s, q[..., 1] * s,
                         np.clip(q[..., 2], -h, h)], -1)

    q = onto_cylinder(p)
    for _ in range(CONTACT_ROUNDS):
        q = onto_cylinder(onto_cube(q))
    gap = np.linalg.norm(onto_cube(q) - q, axis=-1)
    return (sd <= ce) | ((sd <= ce * np.sqrt(3.0)) & (gap <= CONTACT))


def field(cfg, device="cpu"):
    """The configuration's signed distance field (float64 numpy data,
    lengths, and the grid's pose): the named body's box at the origin,
    padded, in cells of twice ``cube_extent``; a cell is occupied when
    its cube touches a box (``_box_hits``) or a cylinder of an enabled
    body; free cells
    that the corner cell cannot reach through free cells are occupied
    too; the value is the distance to the nearest occupied cell's centre
    minus the distance to the nearest free one (centre to centre)."""
    f = cfg["field"]
    ce = f["cube_extent"]
    body = next(b for b in cfg["bodies"] if b["name"] == f["kinbody"])
    lo, hi = np.full(3, np.inf), np.full(3, -np.inf)
    for pose, half in body["boxes"]:
        R, t = pose_Rt(_f32(pose))
        ext = np.abs(R) @ _f32(half)
        lo, hi = np.minimum(lo, _f32(t) - ext), np.maximum(hi, _f32(t) + ext)
    for pose, r, h in body["cylinders"]:
        ext = np.sqrt(_f32(r) ** 2 + _f32(h) ** 2)
        lo = np.minimum(lo, _f32(pose[:3]) - ext)
        hi = np.maximum(hi, _f32(pose[:3]) + ext)
    center, extents = 0.5 * (lo + hi), 0.5 * (hi - lo)
    sizes = np.ceil((extents + f["aabb_padding"]) / ce).astype(int)
    lengths = sizes * 2.0 * ce
    t_wg = center - 0.5 * lengths          # the body sits at the origin
    axes = [(np.arange(n) + 0.5) / n * lengths[i] for i, n in enumerate(sizes)]
    cg = np.stack(np.meshgrid(*axes, indexing="ij"), -1)      # grid frame
    cw = _centres32(sizes, lengths, t_wg)
    occ = np.zeros(tuple(sizes), bool)
    for b in cfg["bodies"]:
        for pose, half in b["boxes"]:
            if not np.allclose(pose[3:], [0, 0, 0, 1]):
                raise ValueError("the reference takes axis-aligned boxes")
            occ |= _box_hits(cw, ce, pose, half)
        for pose, r, h in b["cylinders"]:
            if not np.allclose(pose[3:], [0, 0, 0, 1]):
                raise ValueError("the reference takes z-aligned cylinders")
            occ |= _cylinder_hits(cw.astype(np.float64) - _f32(pose[:3]),
                                  ce, _f32(r), _f32(h))
    # the exterior: free cells the corner reaches through free cells
    reach = np.zeros_like(occ)
    todo = collections.deque([(0, 0, 0)] if not occ[0, 0, 0] else [])
    while todo:
        c = todo.popleft()
        if reach[c]:
            continue
        reach[c] = True
        for ax in range(3):
            for s in (-1, 1):
                n = list(c)
                n[ax] += s
                n = tuple(n)
                if 0 <= n[ax] < sizes[ax] and not occ[n] and not reach[n]:
                    todo.append(n)
    occ = ~reach
    pts = cg.reshape(-1, 3)
    flat = occ.reshape(-1)

    pts_t = torch.as_tensor(pts, dtype=F64, device=device)

    def nearest(mask):
        if not mask.any():
            return np.full(pts.shape[0], np.inf)
        to = pts_t[torch.as_tensor(mask, device=device)]
        out = [torch.cdist(pts_t[lo:lo + NEAREST_BLOCK], to,
                           compute_mode="donot_use_mm_for_euclid_dist")
               .amin(dim=1) for lo in range(0, pts.shape[0], NEAREST_BLOCK)]
        return torch.cat(out).cpu().numpy()

    data = (nearest(flat) - nearest(~flat)).reshape(tuple(sizes))
    return data, lengths, t_wg


# ---- cost terms -------------------------------------------------------------

def obstacle(fd, x, vel, acc, radii, eps, obs_factor):
    """Obstacle cost (B, m, S) and workspace gradient (B, m, S, 3) of
    sphere centres x (B, m, S, 3)."""
    data, lengths, t_wg = fd
    p = x - t_wg                                       # grid frame
    sizes = torch.tensor(data.shape, dtype=x.dtype, device=x.device)
    in_b = torch.all((p / lengths >= 0) & (p / lengths <= 1), dim=-1)
    sub = torch.minimum(torch.clamp(torch.floor(p / lengths * sizes), min=0),
                        sizes - 1)
    center = (sub + 0.5) / sizes * lengths
    nxt = p >= center
    nxt = torch.where(sub == 0, True, nxt)
    nxt = torch.where(sub == sizes - 1, False, nxt)
    sub = sub.long()
    nb = sub + torch.where(nxt, 1, -1)

    def at(s):
        return data[s[..., 0], s[..., 1], s[..., 2]]

    v0 = at(sub)
    g, bad = [], ~in_b | torch.isinf(v0)
    value = v0
    for i in range(3):
        s = sub.clone()
        s[..., i] = nb[..., i]
        vn = at(s)
        bad = bad | torch.isinf(vn)
        gi = torch.where(nxt[..., i], 1.0, -1.0) * (vn - v0) \
            * (sizes[i] / lengths[i])
        g.append(gi)
        value = value + gi * (p[..., i] - center[..., i])
    g = torch.stack(g, -1)
    has = ~bad
    dist = torch.where(has, value, 0.0)
    g = torch.where(has[..., None], g, 0.0)           # grid axes = world's
    d = dist - radii
    v2 = (vel * vel).sum(-1)
    vn = torch.sqrt(v2)
    hinge = torch.where(d < eps, 0.5 / eps * (d - eps) ** 2, 0.0)
    c = obs_factor * torch.where(d < 0, 0.5 * eps - d, hinge)
    cost = torch.where(has, vn * c, 0.0)
    slope = torch.where(d < 0, -1.0, torch.where(d < eps, d / eps - 1.0, 0.0))
    xg = g * torch.where(has, slope * vn * obs_factor, 0.0)[..., None]
    safe = vn > VEL_EPS
    v2s = torch.where(safe, v2, 1.0)
    xg = xg - vel * torch.where(safe, (xg * vel).sum(-1) / v2s, 0.0)[..., None]
    curv = (acc - vel * torch.where(safe, (acc * vel).sum(-1) / v2s,
                                    0.0)[..., None]) \
        * torch.where(safe, 1.0 / v2s, 0.0)[..., None]
    xg = xg - curv * cost[..., None]
    return cost, xg * vn[..., None]


def selfcol(xa, vel, xi, pairs, eps, obs_self):
    """Self-collision cost (B, m, Sa) and gradient (B, m, Sa, 3) of the
    moving spheres xa (B, m, Sa, 3) against every sphere (xa, then the
    fixed xi (B, SI, 3)) over the ordered pairs (pi, pj, rsum)."""
    pi, pj, rsum = pairs
    B, m, Sa, _ = xa.shape
    x_all = torch.cat([xa, xi[:, None].expand(B, m, -1, 3)], dim=2)
    diff = xa[:, :, pi] - x_all[:, :, pj]              # (B, m, P, 3)
    dn = torch.linalg.vector_norm(diff, dim=-1)
    d = dn - rsum
    v2 = (vel * vel).sum(-1)
    vn = torch.sqrt(v2)
    safe = vn > VEL_EPS
    ofv = (obs_self * vn)[:, :, pi]
    near = d <= eps
    c = torch.where(d < 0, 0.5 * eps - d, 0.5 * (d - eps) ** 2 / eps)
    cost_p = torch.where(near, c, 0.0) * ofv
    slope = torch.where(d < 0, -1.0, d / eps - 1.0)
    w1 = torch.where(near, slope * ofv / torch.clamp(dn, min=1e-12), 0.0)
    vp = vel[:, :, pi]
    inv_v2 = torch.where(safe, 1.0 / torch.where(safe, v2, 1.0), 0.0)[:, :, pi]
    w2 = w1 * (vp * diff).sum(-1) * inv_v2
    g = w1[..., None] * diff - w2[..., None] * vp
    net = torch.zeros_like(xa).index_add(2, pi, g)
    act = pj < Sa
    net = net.index_add(2, pj[act], -g[:, :, act])
    cost = torch.zeros_like(xa[..., 0]).index_add(2, pi, cost_p)
    return cost, net


def ypr_rows(R):
    """Roll, pitch and yaw of rotations R (..., 3, 3): the reference's
    xyzypr angles (kin.c:587-615); raises at its gimbal guard."""
    sp = -R[..., 2, 0]                           # sin(pitch)
    if bool((sp.abs() > 2 * 0.49999).any()):
        raise ValueError("a constrained pose sits at the gimbal lock")
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.asin(torch.clamp(sp, -1.0, 1.0))
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


# ---- the solve --------------------------------------------------------------

class Solver:
    """The configuration's solve in float64 on ``device`` (in ``dtype``
    if given: the check's control runs it in float32 with TF32 matmuls)."""

    def __init__(self, cfg, device, dtype=F64):
        self.cfg = cfg
        self.dev = torch.device(device)
        self.dtype = dtype
        kw = dict(DEFAULTS, **cfg["create"])
        self.floating = bool(kw.get("floating_base", False))
        self.robot = Robot(cfg, self.floating)
        self.N = int(kw["n_points"])
        self.m = self.N - 2
        self.dt = 1.0 / (self.N - 1)
        self.lam = float(kw["lambda_"])
        self.eps, self.obs = float(kw["epsilon"]), float(kw["obs_factor"])
        self.eps_self = float(kw["epsilon_self"])
        self.obs_self = float(kw["obs_factor_self"])
        self.n_iter = int(cfg["n_iter"])
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=self.dev)
        data, lengths, t_wg = field(cfg, self.dev)
        self.fd = (t(data), t(lengths), t(t_wg))
        rb = self.robot
        self.radii = t(rb.radius[rb.active])
        same = rb.sphere_link[:, None] == rb.sphere_link[None, :]
        order = np.concatenate([rb.active, rb.inactive])
        pi, pj = np.nonzero(~same[np.ix_(rb.active, order)])
        self.pairs = (torch.as_tensor(pi, device=self.dev),
                      torch.as_tensor(pj, device=self.dev),
                      t(rb.radius[rb.active][pi] + rb.radius[order][pj]))
        m, dt = self.m, self.dt
        self.A = t((2 * np.eye(m) - np.eye(m, k=1) - np.eye(m, k=-1))
                   / (dt * dt * (m + 1)))
        i = np.arange(m)
        lo, hi = np.minimum.outer(i, i), np.maximum.outer(i, i)
        self.Ainv = t(dt * dt * (lo + 1.0) * (m - hi))
        n_arm = rb.n_arm
        self.jlo = t(np.concatenate([np.full(7, -np.inf), rb.lo])
                     if self.floating else rb.lo)
        self.jhi = t(np.concatenate([np.full(7, np.inf), rb.hi])
                     if self.floating else rb.hi)
        self.n = n_arm + (7 if self.floating else 0)
        tsr = kw.get("everyn_tsr")
        self.tsr = None
        if tsr is not None:
            bw = np.asarray(tsr["Bw"], np.float64).reshape(6, 2)
            self.tsr_dims = [d for d in range(6) if bw[d, 0] == 0.0
                             and bw[d, 1] == 0.0]
            self.tsr = tuple(t(np.r_[pose_Rt(v)[0].ravel(), pose_Rt(v)[1]])
                             for v in (tsr["T0w"], tsr["Twe"]))

    # -- problems --

    def lines(self, starts, goals):
        """Straight-line trajectories (B, N, n) from (B, n) endpoints, a
        floating base's quaternions normalised."""
        a = np.linspace(0.0, 1.0, self.N)[None, :, None]
        T = (1 - a) * np.asarray(starts)[:, None] \
            + a * np.asarray(goals)[:, None]
        T = torch.as_tensor(T, dtype=self.dtype, device=self.dev)
        return self._renorm(T)

    def _renorm(self, T):
        if not self.floating:
            return T
        q = T[..., 3:7]
        return torch.cat([T[..., :3], q / torch.linalg.vector_norm(
            q, dim=-1, keepdim=True), T[..., 7:]], dim=-1)

    def _affine(self, T):
        """B (B, m, n) and trC (B,) of the endpoints of T."""
        s = 1.0 / (self.dt ** 2 * (self.m + 1))
        a, b = T[:, 0], T[:, -1]
        Bm = torch.zeros_like(T[:, 1:-1])
        Bm[:, 0] -= s * a
        Bm[:, -1] -= s * b
        return Bm, 0.5 * s * ((a * a).sum(-1) + (b * b).sum(-1))

    # -- the cost --

    def _collision(self, T, want_grad):
        """(cost (B,), G (B, m, n) or None) of trajectories T."""
        rb = self.robot
        Tm = T[:, 1:-1].detach().requires_grad_(want_grad)
        full = torch.cat([T[:, :1], Tm, T[:, -1:]], dim=1)
        with torch.set_grad_enabled(want_grad):
            X = rb.spheres(full, rb.active)               # (B, N, Sa, 3)
        Xd = X.detach()
        dt = self.dt
        vel = (Xd[:, 2:] - Xd[:, :-2]) / (2 * dt)
        acc = (Xd[:, :-2] - 2 * Xd[:, 1:-1] + Xd[:, 2:]) / (dt * dt)
        xm = Xd[:, 1:-1]
        c_o, w_o = obstacle(self.fd, xm, vel, acc, self.radii, self.eps,
                            self.obs)
        if len(rb.inactive):
            xi = rb.spheres(T[:, 0].detach(), rb.inactive)
        else:
            xi = xm.new_zeros((T.shape[0], 0, 3))
        c_s, w_s = selfcol(xm, vel, xi, self.pairs, self.eps_self,
                           self.obs_self)
        cost = (c_o.sum((1, 2)) + c_s.sum((1, 2))) / self.m
        if not want_grad:
            return cost, None
        (G,) = torch.autograd.grad(X[:, 1:-1], Tm, grad_outputs=w_o + w_s)
        if self.floating:
            G = torch.cat([BASE_DAMP * G[..., :7], G[..., 7:]], dim=-1)
        return cost, G / self.m

    def smooth(self, T):
        Bm, trC = self._affine(T)
        Tm = T[:, 1:-1]
        return 0.5 * (Tm * (self.A @ Tm)).sum((1, 2)) \
            + (Bm * Tm).sum((1, 2)) + trC

    # -- constraints --

    def _tsr_rows(self, T):
        """Values (B, m, k) and Jacobians (B, m, k, n) of the enabled TSR
        rows at the moving points."""
        T0, Te = self.tsr
        R0w, t0w = T0[:9].view(3, 3), T0[9:]
        Rwe, twe = Te[:9].view(3, 3), Te[9:]
        Tm = T[:, 1:-1].detach().requires_grad_(True)
        R, t = self.robot.tool(Tm)
        # T0w⁻¹ ∘ pose_ee ∘ Twe⁻¹
        R = R @ Rwe.T
        t = t - (R @ twe[:, None])[..., 0]
        t = ((t - t0w)[..., None, :] @ R0w)[..., 0, :]
        R = R0w.T @ R
        roll, pitch, yaw = ypr_rows(R)
        rows = torch.stack([t[..., 0], t[..., 1], t[..., 2], roll, pitch,
                            yaw], -1)[..., self.tsr_dims]
        jac = [torch.autograd.grad(rows[..., k].sum(), Tm,
                                   retain_graph=True)[0]
               for k in range(rows.shape[-1])]
        return rows.detach(), torch.stack(jac, dim=2)

    def _project(self, T, AG):
        """The goal-set projection's correction (B, m, n) of the update
        AG at trajectories T."""
        h, J = self._tsr_rows(T)                     # (B, C, k), (B, C, k, n)
        B, C, k, n = J.shape
        h = h - (J @ AG[..., None])[..., 0] / self.lam
        Jf = J.reshape(B, C * k, n)
        M = (Jf @ Jf.mT).view(B, C, k, C, k) \
            * self.Ainv[None, :, None, :, None]
        x = torch.linalg.solve(M.reshape(B, C * k, C * k),
                               h.reshape(B, C * k)).view(B, C, k)
        delta = (x[..., None, :] @ J)[..., 0, :]      # (B, C, n)
        return -(self.Ainv @ delta)

    # -- limits --

    def _limits(self, Tm):
        lo, hi = self.jlo[None, None], self.jhi[None, None]
        B = Tm.shape[0]
        for _ in range(LIMIT_ROUNDS):
            Gj = torch.where(Tm < lo, lo - Tm, 0.0) \
                + torch.where(Tm > hi, hi - Tm, 0.0)
            Gf = Gj.reshape(B, -1)
            k = torch.argmax(Gf.abs(), dim=1, keepdim=True)
            gmax = torch.gather(Gf, 1, k)[:, 0]
            bad = gmax.abs() > 0
            if not bool(bad.any()):
                break
            GA = self.Ainv @ Gj
            den = torch.gather(GA.reshape(B, -1), 1, k)[:, 0]
            scale = 1.01 * gmax / torch.where(den == 0, 1.0, den)
            Tm = torch.where(bad[:, None, None],
                             Tm + scale[:, None, None] * GA, Tm)
        return Tm

    # -- steps --

    def step(self, T):
        """One iteration: (T', costs (B, 3) = total, obstacle, smooth)."""
        c_obs, G = self._collision(T, True)
        Tm = T[:, 1:-1]
        Bm, _ = self._affine(T)
        AG = self.Ainv @ (G + self.A @ Tm + Bm)
        if self.tsr is not None:
            Tm = Tm + self._project(T, AG)
        Tm = self._limits(Tm - AG / self.lam)
        T = torch.cat([T[:, :1], Tm, T[:, -1:]], dim=1)
        c_s = self.smooth(T)
        return self._renorm(T), torch.stack([c_obs + c_s, c_obs, c_s], -1)

    def final_costs(self, T):
        """(total, obstacle, smooth) (B, 3) without an update."""
        c_obs, _ = self._collision(T, False)
        c_s = self.smooth(T)
        return torch.stack([c_obs + c_s, c_obs, c_s], -1)

    def solve(self, starts, goals, n_iter=None):
        """The configuration's n_iter iterations from straight lines:
        (trajectories (B, N, n), final costs (B, 3)), float64 on the
        device."""
        T = self.lines(starts, goals)
        for _ in range(self.n_iter if n_iter is None else n_iter):
            T, _ = self.step(T)
        return T.detach(), self.final_costs(T).detach()

    # -- the trajectory check --

    def collides(self, q, start):
        """Whether each trajectory of waypoints q (B, N, n_arm) (a fixed
        base) collides, checked as gettraj checks: retimed at the joint
        speed limits, sampled every 0.04 rad of arc length at uniform
        times, every sphere against each body's boxes and cylinders and
        every sphere pair outside the adjacent links and the pairs that
        overlap at ``start``."""
        rb = self.robot
        q = np.asarray(q, np.float64)
        seg = np.maximum((np.abs(np.diff(q, axis=1)) / rb.vmax).max(-1), 1e-6)
        times = np.concatenate([np.zeros((q.shape[0], 1)),
                                np.cumsum(seg, 1)], 1)
        allsp = np.arange(len(rb.radius))
        x0 = rb.spheres(torch.as_tensor(np.asarray(start, np.float64)),
                        allsp).numpy()
        rs = rb.radius[:, None] + rb.radius[None, :]
        skip = rb.adjacent() | (np.linalg.norm(
            x0[:, None] - x0[None], axis=-1) < rs)
        out = []
        for b in range(q.shape[0]):
            dist = np.linalg.norm(np.diff(q[b], axis=0), axis=1).sum()
            if dist <= 0:
                out.append(False)
                continue
            dur = times[b, -1]
            step = dur * 0.04 / dist
            ts = np.minimum(np.arange(int(np.ceil(dur / step))) * step, dur)
            k = np.clip(np.searchsorted(times[b], ts, side="right") - 1, 0,
                        q.shape[1] - 2)
            t0, t1 = times[b, k], times[b, k + 1]
            a = np.where(t1 > t0, (ts - t0) / np.where(t1 > t0, t1 - t0, 1),
                         0)[:, None]
            qs = (1 - a) * q[b, k] + a * q[b, k + 1]
            x = rb.spheres(torch.as_tensor(qs), allsp).numpy()  # (T, S, 3)
            hit = False
            for body in self.cfg["bodies"]:
                for pose, half in body["boxes"]:
                    d = np.abs(x - _f32(pose[:3])) - _f32(half)
                    sd = np.linalg.norm(np.maximum(d, 0), axis=-1) \
                        + np.minimum(d.max(-1), 0)
                    hit |= bool((sd < rb.radius).any())
                for pose, r, h in body["cylinders"]:
                    c = _f32(pose[:3])
                    d = np.stack([np.linalg.norm(x[..., :2] - c[:2], axis=-1)
                                  - _f32(r), np.abs(x[..., 2] - c[2])
                                  - _f32(h)], -1)
                    sd = np.linalg.norm(np.maximum(d, 0), axis=-1) \
                        + np.minimum(d.max(-1), 0)
                    hit |= bool((sd < rb.radius).any())
            pair = np.linalg.norm(x[:, :, None] - x[:, None], axis=-1)
            hit |= bool(((pair < rs) & ~skip).any())
            out.append(hit)
        return np.array(out)
