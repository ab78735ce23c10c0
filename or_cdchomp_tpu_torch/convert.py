"""State carried across from numpy: build port tensors from arrays that
another implementation produced (for example the JAX package's
``ChompProblem`` as ``{k: np.asarray(v) for k, v in p._asdict().items()}``),
so the same batch can be fed to both solvers."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from or_cdchomp_tpu_torch.chomp.problem import ChompProblem
from or_cdchomp_tpu_torch.ops.grid import FieldStack


# the port's HMC leaves and the JAX problem's flattened ``hmc`` names
_HMC_KEYS = {"resample_iter": "hmc.resample_iter",
            "leapfrog_first": "hmc.leapfrog_first"}


def problem_from_numpy(d, device="cuda", dtype=torch.float64) -> ChompProblem:
    """ChompProblem from a dict of numpy arrays keyed by field name.

    The HMC state is read from the keys ``hmc.resample_iter`` and
    ``hmc.leapfrog_first`` (the JAX problem's ``hmc`` field flattened);
    its PRNG key ``hmc.key``, and any other key that is not a field of
    the port's problem, is ignored; the optional ``hmc_seed`` is read
    where ``d`` has it.  Floating arrays are cast to ``dtype``; integer
    and bool arrays keep theirs."""
    src = {f.name: _HMC_KEYS.get(f.name, f.name)
           for f in dataclasses.fields(ChompProblem)
           if f.name != "hmc_seed" or "hmc_seed" in d}
    missing = [k for k in src.values() if k not in d]
    if missing:
        raise KeyError(f"problem arrays missing: {missing}")

    def conv(a):
        t = torch.as_tensor(np.array(a))
        if t.is_floating_point():
            t = t.to(dtype)
        return t.to(device).contiguous()

    return ChompProblem(**{k: conv(d[v]) for k, v in src.items()})


def fields_from_numpy(data, sizes, lengths, device="cuda",
                      dtype=torch.float32) -> FieldStack:
    """FieldStack from the padded field arrays (data (F, mx, my, mz),
    sizes (F, 3), lengths (F, 3))."""
    return FieldStack(
        data=torch.as_tensor(np.array(data)).to(device, dtype).contiguous(),
        sizes=torch.as_tensor(np.array(sizes, np.int32)).to(device),
        lengths=torch.as_tensor(np.array(lengths)).to(device, dtype))
