"""Dense-matrix helpers of libcd's cd_mat (mat.h:30-51) on tensors
(counterpart of or_cdchomp_tpu/ops/matops.py).

Most of cd_mat is plain tensor arithmetic.  These are the parts that are
not a one-liner, named so that code ported from the reference has them:

 - ``cross_accum``: cd_mat_cross ACCUMULATES into its result argument
   (mat.c:126-132);
 - ``set_diag``: a value on the diagonal of a (possibly non-square)
   matrix, zeros elsewhere (mat.c:39-46);
 - ``vec_to_str``: cd_mat_vec_fprintf-style "%8.4f" text
   (mat.c:134-158).
"""

from __future__ import annotations

import numpy as np
import torch


def cross_accum(a, b, res):
    """res + a × b — cd_mat_cross accumulates (mat.c:126-132)."""
    return res + torch.linalg.cross(a, b, dim=-1)


def set_diag(m, n, value, dtype=torch.float32, device="cuda"):
    """(m, n) matrix with ``value`` on the main diagonal, zeros
    elsewhere (mat.c:39-46)."""
    return value * torch.eye(m, n, dtype=dtype, device=device)


def trace(A):
    """Matrix trace over the last two axes (mat.c:118-124); rectangular
    allowed."""
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def vec_to_str(prefix, a, fmt="%8.4f"):
    """Reference-style vector print string: ``prefix[ v0 v1 ... ]``
    (mat.c:134-158)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    body = " ".join(fmt % v for v in np.asarray(a).ravel())
    return f"{prefix}[ {body} ]"
