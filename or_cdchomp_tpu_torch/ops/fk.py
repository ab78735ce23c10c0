"""The structure-of-arrays FK of a batched trajectory in one launch
(csrc/fk.cu).

:meth:`CompiledFK.fk_soa <or_cdchomp_tpu_torch.models.robot.CompiledFK.
fk_soa>` on a CUDA tensor calls :func:`fk_soa`, which launches the kernel
once for the whole chain; on a CPU tensor it runs its plain version
(``CompiledFK.fk_soa_plain``).  The kernel reads the robot as data: the
reduced chain and the spheres packed by :func:`pack_table` into one
small table in the FK's dtype, built once per ``CompiledFK``, which
each block stages in shared memory: at most ``TABLE_BYTES_MAX`` bytes
(some 3,000 spheres in float32, 1,500 in float64).
:func:`fk_soa_table_ref` is the kernel's plain version reading the same
words.  ``FK_LAUNCHES`` counts kernel launches.

The table, in order:

 - per chain entry (``ENTRY_WORDS``): parent slot, DOF, joint type,
   rot_id, pos_zero, axis (3), the constant offset K (position 3,
   quaternion 4);
 - per reduced slot r, and one more: the first sphere of slot r in the
   sorted list below (n_red + 1 words);
 - per sphere, sorted by slot (``SPHERE_WORDS``): its index in the FK's
   sphere order, its folded offset (3).
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from or_cdchomp_tpu_torch.ops import kernels, soa

_THIS = sys.modules[__name__]

FK_LAUNCHES = 0
ENTRY_WORDS = 15
SPHERE_WORDS = 4
REVOLUTE = 1   # models/robot.py REVOLUTE
TABLE_BYTES_MAX = 48 * 1024   # a block's shared memory without opting in


def pack_table(chain, n_red, sphere_slot, folded):
    """The kernel's table (float64 numpy) of a reduced chain
    (``_reduced_chain``'s entries and slot count) and its spheres
    (reduced slot (S,), folded offset (S, 3))."""
    sphere_slot = np.asarray(sphere_slot, dtype=np.int64)
    if len(chain) != n_red - 1:
        raise ValueError(f"pack_table: {len(chain)} chain entries for "
                         f"{n_red} reduced slots")
    entries = np.array(
        [[e["parent_slot"], e["dof"], e["jtype"], e["rot_id"], e["pos_zero"],
          *e["axis"], *e["K"]] for e in chain],
        dtype=np.float64).reshape(-1, ENTRY_WORDS)
    order = np.argsort(sphere_slot, kind="stable")
    start = np.searchsorted(sphere_slot[order], np.arange(n_red + 1))
    spheres = np.concatenate(
        [order[:, None], np.asarray(folded, dtype=np.float64)[order]],
        axis=1).reshape(-1, SPHERE_WORDS)
    return np.concatenate([entries.ravel(), start, spheres.ravel()])


def _table_dims(words, n_dof, n_spheres):
    """(chain entries, reduced slots) of a table of ``words`` words."""
    E = (words - 2 - SPHERE_WORDS * n_spheres) // (ENTRY_WORDS + 1)
    if E != n_dof or words != table_words(E, n_spheres):
        raise ValueError(f"fk table of {words} words does not hold a chain "
                         f"of {n_dof} DOFs and {n_spheres} spheres")
    return E, E + 1


def table_words(n_entries, n_spheres):
    """Words of the table of a chain of ``n_entries`` and ``n_spheres``
    spheres."""
    return ENTRY_WORDS * n_entries + n_entries + 2 + SPHERE_WORDS * n_spheres


def outputs_per_point(n_dof, n_spheres):
    """Values one call writes per (point, problem): x (3 S), anch_pos,
    anch_q, axis_w (10 D), red_pos, red_q (7 n_red)."""
    return 3 * n_spheres + 10 * n_dof + 7 * (n_dof + 1)


def _outputs(flat, P, S, D, R, B):
    """The six (c, P, K, B) outputs laid end to end in ``flat``, each a
    view of it: x, anch_pos, anch_q, axis_w, red_pos, red_q."""
    out, at = [], 0
    for c, K in ((3, S), (3, D), (4, D), (3, D), (3, R), (4, R)):
        n = c * P * K * B
        out.append(flat[at:at + n].view(c, P, K, B))
        at += n
    return out


def fk_soa_table_ref(table, n_dof, n_spheres, qT, base_pos, base_q):
    """Plain version of the kernel: the same walk of the packed table
    (read to the host, each word a Python number) in the same
    association, on tensors of (n_points, B).  Same arguments and result
    as :func:`fk_soa`; a tensor on any device."""
    words = table.tolist()
    E, R = _table_dims(len(words), n_dof, n_spheres)
    P, _, B = qT.shape
    full = (P, B)
    flat = torch.empty((outputs_per_point(n_dof, n_spheres) * P * B,),
                       dtype=qT.dtype, device=qT.device)
    x, ap, aq, aw, rp, rq = _outputs(flat, P, n_spheres, n_dof, R, B)
    start = words[ENTRY_WORDS * E:ENTRY_WORDS * E + R + 1]
    sph = words[ENTRY_WORDS * E + R + 1:]

    def put(dst, k, vals):
        for d, v in zip(dst, vals):
            d[:, k] = torch.broadcast_to(v, full)

    def spheres(r, pos, q):
        for i in range(int(start[r]), int(start[r + 1])):
            k, *v = sph[SPHERE_WORDS * i:SPHERE_WORDS * (i + 1)]
            put(x, int(k), soa.add(soa.qrot_const(q, v), pos))

    pose = (tuple(base_pos), tuple(base_q))
    red = [pose]
    put(rp, 0, pose[0])
    put(rq, 0, pose[1])
    spheres(0, *pose)
    for e in range(E):
        w = words[ENTRY_WORDS * e:ENTRY_WORDS * (e + 1)]
        ppos, pq = red[int(w[0])]
        d = int(w[1])
        ax, kpos, kq = w[5:8], w[8:11], w[11:15]
        oq = pq if w[3] else soa.qmul_const(pq, kq)
        opos = ppos if w[4] else soa.add(ppos, soa.qrot_const(pq, kpos))
        axis_w = soa.qrot_const(oq, ax)
        put(ap, d, opos)
        put(aq, d, oq)
        put(aw, d, axis_w)
        v = qT[:, d, :]
        if int(w[2]) == REVOLUTE:
            h = 0.5 * v
            sn, cs = torch.sin(h), torch.cos(h)
            pose = (opos, soa.qmul(oq, (sn * ax[0], sn * ax[1], sn * ax[2],
                                        cs)))
        else:   # prismatic
            pose = (soa.add(opos, soa.scale(axis_w, v)), oq)
        red.append(pose)
        put(rp, e + 1, pose[0])
        put(rq, e + 1, pose[1])
        spheres(e + 1, *pose)
    return x, ap, aq, aw, rp, rq


def fk_soa(table, n_dof, n_spheres, qT, base_pos, base_q):
    """The kernel's launch.  qT (n_points, n_dof, B) of the table's dtype
    on its card, any strides; base_pos / base_q: 3 / 4 tensors of that
    dtype and card, each broadcastable to (n_points, B) (a fixed base is
    (B,) or (), a floating one (n_points, B)), any strides.  Returns
    the six outputs x (·=S), anch_pos, anch_q, axis_w (·=D), red_pos,
    red_q (·=n_red), each a contiguous (c, n_points, ·, B) view of one
    output buffer, in that order.  Raises ValueError on
    another dtype, shape or device, or a table past TABLE_BYTES_MAX."""
    dt = kernels.check_dtype(qT.dtype, "fk_soa")
    if table.dtype != dt:
        raise ValueError(f"fk_soa: qT has dtype {qT.dtype}, the FK "
                         f"{table.dtype}")
    if qT.dim() != 3 or qT.shape[1] != n_dof:
        raise ValueError(f"fk_soa: qT has shape {tuple(qT.shape)}, expected "
                         f"(n_points, {n_dof}, B)")
    E, R = _table_dims(table.numel(), n_dof, n_spheres)
    nbytes = table.numel() * table.element_size()
    if nbytes > TABLE_BYTES_MAX:
        raise ValueError(f"fk_soa: the robot's table of {nbytes} B does not "
                         f"fit the kernel's {TABLE_BYTES_MAX} B of shared "
                         f"memory ({n_spheres} spheres)")
    P, _, B = qT.shape
    if len(base_pos) != 3 or len(base_q) != 4:
        raise ValueError("fk_soa: the base is 3 position and 4 quaternion "
                         "components")
    base = []
    for i, c in enumerate((*base_pos, *base_q)):
        if not isinstance(c, torch.Tensor) or c.dtype != dt:
            raise ValueError(f"fk_soa: base component {i} is not a tensor "
                             f"of dtype {dt}")
        try:   # a view: stride 0 along what does not vary
            base.append(c.expand(P, B))
        except RuntimeError:
            raise ValueError(f"fk_soa: base component {i} has shape "
                             f"{tuple(c.shape)}, not broadcastable to "
                             f"{(P, B)}") from None
    dev = qT.device
    if dev.type != "cuda":
        raise ValueError(f"fk_soa: the kernel takes a CUDA tensor, not "
                         f"{dev}")
    for name, t in (("table", table), *(("base", c) for c in base)):
        if t.device != dev:
            raise ValueError(f"fk_soa: {name} is on {t.device}, qT on {dev}")
    if not table.is_contiguous():
        raise ValueError("fk_soa: the table must be contiguous")
    flat = torch.empty((outputs_per_point(n_dof, n_spheres) * P * B,),
                       dtype=dt, device=dev)
    qs = (ctypes.c_int64 * 3)(*qT.stride())
    bptr = (ctypes.c_void_p * 7)(*(c.data_ptr() for c in base))
    bstr = (ctypes.c_int64 * 14)(*(s for c in base for s in c.stride()))
    kernels.launch(qT, "fk_soa", kernels.entry("cdx_fk_soa", dt),
                   qT.data_ptr(), qs, bptr, bstr, table.data_ptr(),
                   table.numel(), E, n_spheres, n_dof, P, B, flat.data_ptr())
    kernels.count(_THIS, "FK_LAUNCHES")
    return _outputs(flat, P, n_spheres, n_dof, R, B)


def traffic_bytes(P, B, n_dof, n_spheres, n_base, itemsize):
    """Bytes one call must move: the joint values and the ``n_base``
    distinct base poses read once, the six outputs written once."""
    return ((n_dof * P * B + 7 * n_base)
            + outputs_per_point(n_dof, n_spheres) * P * B) * itemsize


def flops(table, n_dof, n_spheres, P, B):
    """Operations one call computes, from the table: per chain entry the
    offset's rotation (28, skipped where rot_id) and translation (33,
    skipped where pos_zero), the world axis (30), and the joint's motion
    (34 revolute, sin and cos one each; 6 prismatic); per sphere its
    rotation and translation (33); for each (point, problem)."""
    words = table.tolist()
    E, _ = _table_dims(len(words), n_dof, n_spheres)
    per = 33 * n_spheres
    for e in range(E):
        w = words[ENTRY_WORDS * e:ENTRY_WORDS * (e + 1)]
        per += (0 if w[3] else 28) + (0 if w[4] else 33) + 30 \
            + (34 if int(w[2]) == REVOLUTE else 6)
    return per * P * B
