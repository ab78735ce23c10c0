"""Per-problem HMC draws from a counter-based generator (csrc/draw.cu).

Problem p at its iteration i draws from Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC'11) keyed by its seed
(key = (seed mod 2³², seed div 2³² mod 2³²)) at the counters
(j, i, stream, 0):

 - stream 0, j = 0 … ⌈m·n/4⌉ − 1: four words (w0, w1, w2, w3) give the
   normals z[4j … 4j+3] of the (m, n) momentum draw by Box–Muller,
   (w0, w1) → r·cos θ, r·sin θ and (w2, w3) likewise, with
   r = √(−2 ln u1), u1 = (w + 1)·2⁻³² ∈ (0, 1], θ = 2π·w'·2⁻³²;
 - stream 1, j = 0: word 0 gives the uniform u = 1e-12 + (1 − 1e-12)·w·2⁻³²
   of the resample gap, in [1e-12, 1) (the largest value below 1 where
   the cast to float32 rounds up).

The transforms run in float64 and are cast to the problem's dtype at the
end.  A problem's draws depend on its seed and its own iteration only:
not on the batch it sits in, nor on its row.

:func:`hmc_draw` dispatches on the device of its tensors: CPU tensors go
to the plain version :func:`hmc_draw_ref` (the same integer rounds in
int64 torch ops), CUDA tensors to the kernel (one launch for the whole
batch) or an error.  There is no fallback.  ``LAUNCHES`` counts kernel
launches.
"""

from __future__ import annotations

import math

import torch

from or_cdchomp_tpu_torch.ops import kernels

LAUNCHES = 0
U_MIN = 1e-12                     # lower end of u (JAX solver.py:270)
PHILOX_M = (0xD2511F53, 0xCD9E8D57)   # round multipliers (SC'11, Random123)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)   # Weyl key increments
PHILOX_ROUNDS = 10
_M32 = 0xFFFFFFFF
_TWO_M32 = 2.0 ** -32
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


def z_counters(m, n):
    """Stream-0 counters per problem: four normals each."""
    return -(-m * n // 4)


def _mulhilo(a, w):
    """(hi, lo) 32-bit words of a · w for int64 tensors a in [0, 2³²) and a
    32-bit constant w, without int64 overflow: a splits into 16-bit
    halves, each product stays below 2⁴⁸."""
    al, ah = a & 0xFFFF, a >> 16
    p1, p2 = al * w, ah * w
    lo = (((p2 & 0xFFFF) << 16) + p1) & _M32
    hi = ((p2 + (p1 >> 16)) >> 16) & _M32
    return hi, lo


def philox_ref(seed, c0, c1, c2):
    """Philox4x32-10 of counters (c0, c1, c2, 0) under the key of
    ``seed``: int64 tensors that broadcast together, seed any int64 and
    counters in [0, 2³²).  Returns the four output words, int64 in
    [0, 2³²), stacked on a new last axis."""
    k0 = seed & _M32
    k1 = (seed >> 32) & _M32
    x0, x1, x2 = torch.broadcast_tensors(c0 & _M32, c1 & _M32, c2 & _M32)
    x3 = torch.zeros_like(x0)
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W[0]) & _M32
            k1 = (k1 + PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(x0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(x2, PHILOX_M[1])
        x0, x1, x2, x3 = hi1 ^ x1 ^ k0, lo1, hi0 ^ x3 ^ k1, lo0
    return torch.stack([x0, x1, x2, x3], dim=-1)


def _below_one(dtype):
    return torch.nextafter(torch.ones((), dtype=dtype),
                           torch.zeros((), dtype=dtype)).item()


def draws_from_words(wz, wu, m, n, dtype):
    """(z (B, m, n), u (B,)) in ``dtype`` from the words of stream 0 (B,
    ⌈m·n/4⌉, 4) and stream 1 (B, 4), int64 (module docstring)."""
    w = wz.double()
    u1 = (w[..., 0::2] + 1.0) * _TWO_M32               # (B, J, 2)
    theta = (2.0 * math.pi) * (w[..., 1::2] * _TWO_M32)
    r = torch.sqrt(-2.0 * torch.log(u1))
    z = torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)
    z = z.reshape(w.shape[0], -1)[:, :m * n].reshape(-1, m, n).to(dtype)
    u = (U_MIN + (1.0 - U_MIN) * (wu[:, 0].double() * _TWO_M32)).to(dtype)
    return z, torch.clamp(u, max=_below_one(dtype))


def hmc_draw_words_ref(seed, iteration, m, n):
    """The plain version's words: stream 0 (B, ⌈m·n/4⌉, 4) and stream 1
    (B, 4), int64, on ``seed``'s device."""
    s = seed.to(torch.int64)[:, None]
    it = iteration.to(torch.int64)[:, None]
    j = torch.arange(z_counters(m, n), dtype=torch.int64,
                     device=seed.device)[None, :]
    wz = philox_ref(s, j, it, torch.zeros_like(j))
    wu = philox_ref(s[:, 0], torch.zeros_like(it[:, 0]), it[:, 0],
                    torch.ones_like(it[:, 0]))
    return wz, wu


def hmc_draw_ref(seed, iteration, m, n, dtype, want_words=False):
    """Plain version of :func:`hmc_draw` (same contract)."""
    wz, wu = hmc_draw_words_ref(seed, iteration, m, n)
    z, u = draws_from_words(wz, wu, m, n, dtype)
    return (z, u, wz, wu) if want_words else (z, u)


def hmc_draw(seed, iteration, m, n, dtype, want_words=False):
    """Per-problem HMC draws: ``seed`` (B,) int64 and ``iteration`` (B,)
    int32 → ``z`` (B, m, n) standard normal and ``u`` (B,) uniform in
    [1e-12, 1), in ``dtype`` (float32 or float64) on the seeds' device.
    ``want_words`` also returns the generator's words (stream 0 (B,
    ⌈m·n/4⌉, 4), stream 1 (B, 4), int64 in [0, 2³²)), for checks."""
    global LAUNCHES
    if seed.device.type == "cpu":
        return hmc_draw_ref(seed, iteration, m, n, dtype, want_words)
    if seed.device.type != "cuda":
        raise ValueError(f"hmc_draw: unsupported device {seed.device}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"hmc_draw: unsupported dtype {dtype}")
    B = seed.shape[0]
    J = z_counters(m, n)
    dev = seed.device
    kernels.require(seed, "seed", torch.int64, (B,), dev)
    kernels.require(iteration, "iteration", torch.int32, (B,), dev)
    z = torch.empty((B, m, n), dtype=dtype, device=dev)
    u = torch.empty((B,), dtype=dtype, device=dev)
    words = (torch.empty((B, J + 1, 4), dtype=torch.int32, device=dev)
             if want_words else None)
    err = kernels.library().cdx_hmc_draw(
        seed.data_ptr(), iteration.data_ptr(), B, m * n,
        _DTYPE_CODES[dtype], z.data_ptr(), u.data_ptr(),
        None if words is None else words.data_ptr(),
        kernels.stream_ptr(seed))
    kernels.check(err, "hmc_draw")
    LAUNCHES += 1
    if not want_words:
        return z, u
    w = words.to(torch.int64) & _M32
    return z, u, w[:, :J], w[:, J]


def traffic_bytes(B, m, n, itemsize):
    """Bytes one call must move: the seeds and iterations read, z and u
    written."""
    return B * (8 + 4) + B * (m * n + 1) * itemsize
