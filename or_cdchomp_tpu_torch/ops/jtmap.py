"""The Jacobian-transpose map of a batched step in one launch
(csrc/jtmap.cu).

``cost_soa.total_cost_grad_batched`` on a CUDA tensor calls
:func:`jtmap`, which maps the spheres' two workspace gradients onto the
joints in one kernel launch: G = Σ_s J(s)ᵀ (w_obs + w_self)_s per moving
point, and under a floating base the per-point totals [Σ_s x×w; Σ_s w]
that its block of G needs.  On a CPU tensor the step runs its plain code
(``CompiledFK.apply_sphere_jacT_soa``, ``cost_soa._base_jacT``).  The
kernel reads the chain's DOF-affects-sphere structure as data: a table
of int32 words built by :func:`pack_table` once per ``CompiledFK``,
which each block stages in shared memory: at most ``TABLE_BYTES_MAX``
bytes.  :func:`jtmap_table_ref` is the kernel's plain version reading
the same words.  ``JT_LAUNCHES`` counts kernel launches.

The table, in order:

 - D + 1 steps (``STEP_WORDS`` each): clear the six running sums first
   or not, the slice [lo, hi) of the sphere list to add, the DOF whose
   row of G the step writes, its joint type.  The last step's sums are
   the totals over every sphere (its DOF word D, its type 0);
 - the sphere list: sphere indices (x's third axis).

A serial chain (``CompiledFK._jt_suffix``: each sphere moved by DOFs
[0, k_s)) walks its spheres once from the largest k_s down, emitting
the DOFs from the last to the first without clearing; a branching one
(the DOF mask) clears at every step and lists each DOF's spheres.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import kernels, soa

_THIS = sys.modules[__name__]

JT_LAUNCHES = 0
STEP_WORDS = 5
REVOLUTE = 1   # models/robot.py REVOLUTE
TABLE_BYTES_MAX = 48 * 1024   # a block's shared memory without opting in


def pack_table(suffix, mask, jtype):
    """The kernel's table (int32 numpy) of a chain: ``suffix`` is
    ``CompiledFK._jt_suffix`` ((order, start) of a serial chain) or None;
    ``mask`` the (S, D) DOF-affects-sphere mask, read where ``suffix`` is
    None; ``jtype`` the (D,) joint types."""
    mask = np.asarray(mask, dtype=bool)
    S, D = mask.shape
    jtype = np.asarray(jtype, dtype=np.int64)
    if jtype.shape != (D,):
        raise ValueError(f"pack_table: {jtype.shape[0]} joint types for "
                         f"{D} DOFs")
    if suffix is not None:
        order, start = (np.asarray(a, dtype=np.int64) for a in suffix)
        if order.shape != (S,) or start.shape != (D,):
            raise ValueError(f"pack_table: a suffix of {order.shape[0]} "
                             f"spheres and {start.shape[0]} starts for "
                             f"{S} spheres and {D} DOFs")
        # sorted positions [start[d], end[d]) become list positions
        # [S − end[d], S − start[d]) of the order reversed
        end = np.append(start[1:], S)
        steps = [(int(d == D - 1), S - end[d], S - start[d], d, jtype[d])
                 for d in range(D - 1, -1, -1)]
        steps.append((int(D == 0), S - (start[0] if D else S), S, D, 0))
        lst = order[::-1]
    else:
        lists = [np.flatnonzero(mask[:, d]) for d in range(D)]
        lists.append(np.arange(S))
        at = np.cumsum([0] + [len(li) for li in lists])
        steps = [(1, at[d], at[d + 1], d, jtype[d] if d < D else 0)
                 for d in range(D + 1)]
        lst = np.concatenate(lists)
    words = np.concatenate([np.asarray(steps, dtype=np.int64).ravel(), lst])
    return words.astype(np.int32)


def table_steps(table, n_dof):
    """The D + 1 steps of a table's words (a list of ints or an array) as
    tuples (clear, lo, hi, dof, jtype), and its sphere list."""
    words = [int(w) for w in table]
    n = STEP_WORDS * (n_dof + 1)
    if len(words) < n:
        raise ValueError(f"jtmap table of {len(words)} words does not hold "
                         f"the {n_dof + 1} steps of {n_dof} DOFs")
    return ([tuple(words[STEP_WORDS * k:STEP_WORDS * (k + 1)])
             for k in range(n_dof + 1)], words[n:])


def jtmap_table_ref(table, n_dof, anchors_pos, axis_w, x, w_obs, w_self,
                    totals=False):
    """Plain version of the kernel: the same walk of the table (read to
    the host, each word a Python number) in the same association, on
    tensors of (m, B).  Same arguments and result as :func:`jtmap`; a
    tensor on any device."""
    steps, lst = table_steps(table.tolist(), n_dof)
    _, m, _, B = x.shape
    G = torch.empty((m, n_dof, B), dtype=x.dtype, device=x.device)
    zero = torch.zeros((m, B), dtype=x.dtype, device=x.device)
    sums = (zero,) * 6
    tot = None
    for k in range(n_dof + int(totals)):
        clear, lo, hi, d, jt = steps[k]
        if clear:
            sums = (zero,) * 6
        for s in lst[lo:hi]:
            w = soa.add(w_obs[:, :, s], w_self[:, :, s])
            xw = soa.cross(x[:, :, s], w)
            sums = tuple(a + v for a, v in zip(sums, (*xw, *w)))
        if k == n_dof:
            tot = torch.stack(sums)
            break
        sum_xw, sum_w = sums[:3], sums[3:]
        a = axis_w[:, :, d]
        if jt == REVOLUTE:
            oxw = soa.cross(anchors_pos[:, :, d], sum_w)
            G[:, d] = soa.dot(a, soa.sub(sum_xw, oxw))
        else:
            G[:, d] = soa.dot(a, sum_w)
    return G, tot


def jtmap(table, n_dof, anchors_pos, axis_w, x, w_obs, w_self,
          totals=False):
    """The kernel's launch.  x, w_obs, w_self: (3, m, S, B); anchors_pos,
    axis_w: (3, m, D, B) (D = ``n_dof``); all of one dtype (float32 or
    float64), on the table's card, any strides.  Returns (G
    (m, D, B), the totals (6, m, B) [Σ_s x×w; Σ_s w] where ``totals``,
    else None), each contiguous.  Raises ValueError on another dtype,
    shape or device, or a table past TABLE_BYTES_MAX."""
    dt = kernels.check_dtype(x.dtype, "jtmap")
    if x.dim() != 4 or x.shape[0] != 3:
        raise ValueError(f"jtmap: x has shape {tuple(x.shape)}, expected "
                         f"(3, m, S, B)")
    _, m, S, B = x.shape
    want = {"x": (3, m, S, B), "w_obs": (3, m, S, B),
            "w_self": (3, m, S, B), "anchors_pos": (3, m, n_dof, B),
            "axis_w": (3, m, n_dof, B)}
    ins = dict(x=x, w_obs=w_obs, w_self=w_self, anchors_pos=anchors_pos,
               axis_w=axis_w)
    for name, t in ins.items():
        if t.dtype != dt:
            raise ValueError(f"jtmap: {name} has dtype {t.dtype}, x {dt}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"jtmap: {name} has shape {tuple(t.shape)}, "
                             f"expected {want[name]}")
    if table.dtype != torch.int32 or table.dim() != 1:
        raise ValueError(f"jtmap: the table is {table.dtype} of shape "
                         f"{tuple(table.shape)}, not int32 words")
    words = table.numel()
    if words < STEP_WORDS * (n_dof + 1) + S:
        raise ValueError(f"jtmap: a table of {words} words does not hold "
                         f"the steps of {n_dof} DOFs and {S} spheres")
    nbytes = words * table.element_size()
    if nbytes > TABLE_BYTES_MAX:
        raise ValueError(f"jtmap: the chain's table of {nbytes} B does not "
                         f"fit the kernel's {TABLE_BYTES_MAX} B of shared "
                         f"memory ({n_dof} DOFs, {S} spheres)")
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"jtmap: the kernel takes a CUDA tensor, not {dev}")
    for name, t in (("table", table), *ins.items()):
        if t.device != dev:
            raise ValueError(f"jtmap: {name} is on {t.device}, x on {dev}")
    if not table.is_contiguous():
        raise ValueError("jtmap: the table must be contiguous")
    G = torch.empty((m, n_dof, B), dtype=dt, device=dev)
    tot = torch.empty((6, m, B), dtype=dt, device=dev) if totals else None
    order = (x, w_obs, w_self, anchors_pos, axis_w)
    ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in order))
    strides = (ctypes.c_int64 * 20)(*(s for t in order for s in t.stride()))
    kernels.launch(x, "jtmap", kernels.entry("cdx_jtmap", dt), ptrs,
                   strides, table.data_ptr(), words, n_dof, m, B,
                   G.data_ptr(), None if tot is None else tot.data_ptr())
    kernels.count(_THIS, "JT_LAUNCHES")
    return G, tot


def traffic_bytes(m, S, D, B, itemsize, totals=False):
    """Bytes one call must move: x, w_obs and w_self (9 S values) and the
    anchors and axes (6 D) read once, G (D) and the totals (6, where
    asked for) written once, per (moving point, problem)."""
    return (9 * S + 7 * D + (6 if totals else 0)) * m * B * itemsize


def flops(table, n_dof, m, B, totals=False):
    """Operations one call computes, from the table: per sphere a step
    adds, the gradients' sum (3), x×w (9) and the six running sums (6);
    per DOF its row, a revolute joint's o×Σw, difference and dot (17), a
    prismatic joint's dot (5); for each (moving point, problem)."""
    steps, _ = table_steps(table.tolist(), n_dof)
    per = 0
    for k in range(n_dof + int(totals)):
        _, lo, hi, _, jt = steps[k]
        per += 18 * (hi - lo)
        if k < n_dof:
            per += 17 if jt == REVOLUTE else 5
    return per * m * B
