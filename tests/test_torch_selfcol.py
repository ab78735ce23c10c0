"""K2's plain version against the JAX package, float64 on CPU: the raw
contract against the Pallas dense kernel in interpret mode, and the
port's _selfcol_soa against the default dense XLA form."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from or_cdchomp_tpu.chomp import cost_soa as jax_cost_soa
from or_cdchomp_tpu.ops.pallas_selfcol import selfcol_pairs as pallas_pairs
from or_cdchomp_tpu_torch.chomp import cost_soa
from or_cdchomp_tpu_torch.ops import selfcol
from or_cdchomp_tpu_torch.ops.selfcol import pair_table, selfcol_pairs_ref

RTOL = 1e-10   # float64; per-sphere sums differ in association order

SHAPES = [
    (16, 8, 0, 128),     # no inactive spheres
    (11, 6, 2, 64),      # ragged m and B, inactive spheres
    (8, 16, 1, 128),     # WAM7-like shape
]


def _case(rng, m, Sa, SI, B, scale=0.25):
    """Random positions clustered enough that some pairs collide."""
    x = rng.normal(size=(3, m, Sa, B)) * scale
    vel = rng.normal(size=(3, m, Sa, B))
    xo = rng.normal(size=(3, SI, B)) * scale
    radii_act = rng.uniform(0.03, 0.1, size=Sa)
    radii_all = np.concatenate([radii_act, rng.uniform(0.03, 0.1, size=SI)])
    same = np.zeros((Sa, Sa + SI), dtype=bool)
    same[:, :Sa] |= np.eye(Sa, dtype=bool)
    same[0, 1] = same[1, 0] = True
    if SI:
        same[2, Sa] = True
    eps = rng.uniform(0.02, 0.08, size=B)
    ofs = rng.uniform(5.0, 20.0, size=B)
    return x, vel, xo, same, radii_act, radii_all, eps, ofs


def _ref(x, vel, xo, same, radii_act, radii_all, eps, ofs):
    pi, pj, rsum = pair_table(same, radii_act, radii_all)
    t = torch.as_tensor
    net, cost = selfcol_pairs_ref(t(x), t(vel), t(xo), t(pi), t(pj),
                                  t(rsum), t(eps), t(ofs))
    return net.numpy(), cost.numpy()


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=RTOL * np.abs(b).max())


# The WAM7-like shape unrolls 272 pair bodies, ~90 s in interpret mode on
# a CPU; it is held against the dense XLA form below instead.
@pytest.mark.parametrize("m,Sa,SI,B", SHAPES[:2])
def test_ref_matches_pallas_dense(m, Sa, SI, B):
    rng = np.random.default_rng(m * 1000 + Sa * 10 + SI + B)
    x, vel, xo, same, ra, rall, eps, ofs = _case(rng, m, Sa, SI, B)
    net_p, cost_p = pallas_pairs(
        jnp.asarray(x), jnp.asarray(vel), jnp.asarray(xo), ~same,
        ra[:, None] + rall[None, :], jnp.asarray(eps), jnp.asarray(ofs),
        interpret=True, dense=True)
    net, cost = _ref(x, vel, xo, same, ra, rall, eps, ofs)
    assert np.abs(np.asarray(cost_p)).max() > 0.0
    _close(net, np.asarray(net_p))
    _close(cost, np.asarray(cost_p))


class _Probs:
    pass


@pytest.mark.parametrize("m,Sa,SI,B", SHAPES)
def test_selfcol_soa_matches_xla(m, Sa, SI, B):
    rng = np.random.default_rng(m * 1000 + Sa * 10 + SI + B + 1)
    x, vel, xo, same, ra, rall, eps, ofs = _case(rng, m, Sa, SI, B)
    jp = _Probs()
    jp.inactive_pos = jnp.asarray(np.transpose(xo, (2, 1, 0)))
    jp.epsilon_self = jnp.asarray(eps)
    jp.obs_factor_self = jnp.asarray(ofs)
    xj = tuple(jnp.asarray(c) for c in x)
    vj = tuple(jnp.asarray(c) for c in vel)
    v2 = sum(c * c for c in vj)
    vn = jnp.sqrt(v2)
    c_x, net_x = jax_cost_soa._selfcol_soa(
        None, jnp.asarray(same), jnp.asarray(ra), jnp.asarray(rall), jp, xj,
        vj, vn, v2, vn > 1e-6, method="xla")

    tp = _Probs()
    tp.inactive_pos = torch.as_tensor(np.transpose(xo, (2, 1, 0)))
    tp.epsilon_self = torch.as_tensor(eps)
    tp.obs_factor_self = torch.as_tensor(ofs)
    pi, pj, rsum = pair_table(same, ra, rall)
    pairs = (torch.as_tensor(pi), torch.as_tensor(pj), torch.as_tensor(rsum))
    c_t, net_t = cost_soa._selfcol_soa(pairs, tp, torch.as_tensor(x),
                                       torch.as_tensor(vel))
    _close(c_t.numpy(), np.asarray(c_x))
    _close(net_t.numpy(), np.stack([np.asarray(c) for c in net_x]))


def test_stationary_spheres():
    """vel = 0: the ‖ẋ‖ guard zeroes cost and gradient exactly."""
    rng = np.random.default_rng(7)
    x, vel, xo, same, ra, rall, eps, ofs = _case(rng, 8, 4, 0, 16)
    net, cost = _ref(x, np.zeros_like(vel), xo, same, ra, rall, eps, ofs)
    assert np.abs(net).max() == 0.0 and np.abs(cost).max() == 0.0


def test_far_apart_exactly_zero():
    """Spheres far beyond reach: outputs exactly 0."""
    rng = np.random.default_rng(3)
    m, Sa, B = 8, 4, 16
    x = (rng.normal(size=(3, m, Sa, B)) * 0.01
         + 1000.0 * np.arange(Sa)[None, None, :, None]
         * (np.arange(3) == 0)[:, None, None, None])
    vel = rng.normal(size=(3, m, Sa, B))
    same = np.eye(Sa, dtype=bool)
    net, cost = _ref(x, vel, np.zeros((3, 0, B)), same, np.full(Sa, 0.05),
                     np.full(Sa, 0.05), np.full(B, 0.04), np.full(B, 10.0))
    assert np.abs(net).max() == 0.0 and np.abs(cost).max() == 0.0


def test_pair_table_order():
    """i-major, j ascending, same-link pairs dropped."""
    same = np.array([[True, True, False, False],
                     [True, True, False, True],
                     [False, False, True, False]])
    pi, pj, rsum = pair_table(same, np.array([1.0, 2.0, 3.0]),
                              np.array([1.0, 2.0, 3.0, 4.0]))
    np.testing.assert_array_equal(pi, [0, 0, 1, 2, 2, 2])
    np.testing.assert_array_equal(pj, [2, 3, 2, 0, 1, 3])
    np.testing.assert_array_equal(rsum, [4.0, 5.0, 5.0, 4.0, 5.0, 7.0])
    assert pi.dtype == np.int32 and pj.dtype == np.int32


def test_traffic_bytes_flagship():
    """The flagship shape (m=99, Sa=15, SI=1, B=256, P=207) by hand: xi,
    vel and net 3·99·15·256·4 = 4,561,920 B each, cost 1,520,640, xo
    3,072, eps_self + obs_self 2,048, the pair table 3·207·4 = 2,484."""
    assert selfcol.traffic_bytes(99, 15, 1, 256, 207) == (
        3 * 4_561_920 + 1_520_640 + 3_072 + 2_048 + 2_484) == 15_214_004


def test_vote_stats_counts_warps():
    """Two warps of problems (40 = 32 + a ragged 8); spheres 0 and 1 are
    10 m apart except in problem 5 (first warp), where they overlap: the
    two pairs (0, 1), (1, 0) each pass the box test and take the vote in
    one of their two warps."""
    B = 40
    x = np.zeros((3, 1, 2, B))
    x[0, 0, 1] = 10.0
    x[0, 0, 1, 5] = 0.05
    pi, pj, rsum = pair_table(np.eye(2, dtype=bool), [0.05, 0.05],
                              [0.05, 0.05])
    t = torch.as_tensor
    stats = selfcol.vote_stats(
        t(x), torch.zeros((3, 0, B), dtype=torch.float64), t(pi), t(pj),
        t(rsum), torch.full((B,), 0.04, dtype=torch.float64))
    votes, near, taken, reach = stats
    assert stats == (4, 2, 2, 2)
    assert selfcol.flops(1, B, 2, reach) == 12 * 80 + 33 * 2


def _engine_table(grab):
    """The pair table the engine builds for the WAM7 + hand (15 active
    spheres, 1 inactive), or with a 110-sphere tray grabbed at the hand
    (125 + 1): active-first order, same-link pairs dropped, rsum in
    float32 as on the card."""
    import or_cdchomp_tpu_torch as pt

    model = pt.wam7()
    if grab:
        model = model.with_spheres([("handbase", (0.03 * a, 0.03 * c, 0.2),
                                     0.015)
                                    for a in range(10) for c in range(11)])
    act = model.sphere_active_mask()
    order = np.concatenate([np.where(act)[0], np.where(~act)[0]])
    n_act = int(act.sum())
    radii = model.sphere_radius[order]
    same = model.sphere_same_link()[order][:, order][:n_act]
    pi, pj, rsum = pair_table(same, radii[:n_act], radii)
    return (torch.as_tensor(pi), torch.as_tensor(pj),
            torch.as_tensor(rsum, dtype=torch.float32), n_act, len(radii))


def _synthetic_table(Sa, SI, seed):
    """A pair table of Sa + SI spheres on random links of 3 to 9 spheres,
    radii in float32 (as on the card)."""
    rng = np.random.default_rng(seed)
    link = np.repeat(np.arange(Sa + SI), rng.integers(3, 10, Sa + SI))
    link = link[:Sa + SI]
    radii = rng.uniform(0.01, 0.06, Sa + SI)
    pi, pj, rsum = pair_table(link[:Sa, None] == link[None, :], radii[:Sa],
                              radii)
    return (torch.as_tensor(pi), torch.as_tensor(pj),
            torch.as_tensor(rsum, dtype=torch.float32), Sa, Sa + SI)


@pytest.mark.parametrize("case", ["wam7", "grab", "uneven_mirror",
                                  "streamed"])
def test_pair_layout_entries(case):
    """The tiled path's pair layout against its pair table, entry by
    entry: each sphere's partners (ascending, compacted into groups of
    32 where the ring holds every chunk, 125 + 1 spheres at the grab;
    group g = chunk g past 256 spheres in float32), each lane's mask bits
    and both radius sums, the group count.  ``uneven_mirror`` gives one
    active pair (i, j) another radius sum than (j, i): no mirror, so
    (j, i) takes its own vote, with its own radius sum."""
    if case == "streamed":
        pi, pj, rsum, Sa, So = _synthetic_table(290, 10, 3)
    else:
        pi, pj, rsum, Sa, So = _engine_table(case == "grab")
    if case == "uneven_mirror":
        rsum = rsum.clone()
        rsum[int((pj < Sa).nonzero()[0])] += 0.01
    compact = case != "streamed"
    assert selfcol.ring_resident(So) == compact
    layout = selfcol.pair_layout(pi, pj, rsum, Sa, So)
    G = -(-So // 32)
    assert tuple(layout.masks.shape) == (Sa, G, 4)
    assert tuple(layout.partners.shape) == (Sa, G, 32)
    assert tuple(layout.rs.shape) == (2, Sa, G, 32)
    assert layout.rs.dtype == torch.float32
    table = {(int(a), int(b)): float(r) for a, b, r in zip(pi, pj, rsum)}
    words = layout.masks.numpy().view(np.uint32)
    partners = layout.partners.numpy()
    rs = layout.rs.numpy()
    mirrors = 0
    for i in range(Sa):
        mates = [j for j in range(So)
                 if (i, j) in table or (j < Sa and (j, i) in table)]
        lanes = mates if compact else list(range(So))
        groups = -(-len(mates) // 32) if compact else G
        assert (words[i, :, 3] == groups).all()
        for q in range(G * 32):
            g, l = divmod(q, 32)
            bit = [bool((words[i, g, k] >> l) & 1) for k in range(3)]
            if q >= len(lanes):
                assert partners[i, g, l] == 0 and not any(bit)
                assert rs[0, i, g, l] == rs[1, i, g, l] == 0.0
                continue
            j = lanes[q]
            out = (i, j) in table
            inc = j < Sa and (j, i) in table
            mirror = out and inc and table[(i, j)] == table[(j, i)]
            mirrors += mirror
            assert partners[i, g, l] == j
            assert bit == [out, inc and not mirror, mirror], (i, j)
            assert rs[0, i, g, l] == (table[(i, j)] if out else 0.0)
            assert rs[1, i, g, l] == (table[(j, i)] if inc else 0.0)
    # every active pair has its mirror, but the one made uneven
    active = sum(b < Sa for _, b in table)
    assert mirrors == active - 2 * (case == "uneven_mirror")
