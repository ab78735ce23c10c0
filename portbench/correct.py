"""The check that decides ``correct``: what the timed path produced,
held against the plain float64 reference (reference/chomp.py).

After the window, rows (batch cells) or requests (plan cells) are drawn
from the seed among everything the window finished; the reference
solves the same endpoints from straight lines in float64, in blocks,
and the numbers compared are:

- ``traj_err_max``: over the drawn trajectories, the largest
  |program − reference| over their points and columns (radians, and
  metres and quaternion units for a floating base);
- ``traj_err_p75``: the 75th percentile over the drawn trajectories of
  each one's largest gap;
- ``traj_rows_over``: how many drawn trajectories have a largest gap
  over ``row_gap`` (the limits file's), so that a fault confined to a
  few rows fails where the percentile would not see it;
- ``cost_err_max``, ``cost_err_p75`` (batch): the same two of each
  drawn row's largest |program − reference| final cost (total,
  obstacle, smoothness), over max(|reference|, 1);
- ``verdicts_wrong`` (plan): requests whose collision verdict differs
  from the reference's check of the trajectory the program returned.

A limits file holds the numbers its cell compares; every number is
reported in ``readings``.  A row whose sphere sits at a discontinuity of
the obstacle cost (a cell face or the field's box) can cross it at
another iteration in float32 than in float64, and its gap then reads far
above the other rows' (PERF.md): where the control's largest gap does
not stay above the program's, the cell compares the percentile and the
count of rows over ``row_gap`` in place of the largest.

Each has its limit in limits/<cell>.json; PERF.md gives the readings
each was set from.
"""

from __future__ import annotations

import numpy as np

BLOCK = 64          # rows the reference solves at once


def reference_solve(solver, starts, goals):
    """The reference's trajectories and final costs (numpy float64) of
    the endpoints, in blocks of BLOCK rows."""
    T, F = [], []
    for lo in range(0, len(starts), BLOCK):
        t, f = solver.solve(starts[lo:lo + BLOCK], goals[lo:lo + BLOCK])
        T.append(t.cpu().numpy())
        F.append(f.cpu().numpy())
    return np.concatenate(T), np.concatenate(F)


def _rows(gap):
    """(largest, 75th percentile) over rows of per-row gaps."""
    return float(gap.max()), float(np.percentile(gap, 75))


def numbers(kind, solver, results, start_cfg=None, row_gap=1e-5,
            gaps=None):
    """The numbers of a batch or plan cell's drawn results, compared and
    reported.  ``gaps``, a dict if given, receives each drawn row's
    largest trajectory gap (``traj``) and cost gap (``cost``)."""
    starts, goals, traj, last = results
    T, F = reference_solve(solver, starts, goals)
    out = {}
    row = np.abs(traj - T).max(axis=(1, 2))
    out["traj_err_max"], out["traj_err_p75"] = _rows(row)
    out["traj_rows_over"] = int(np.sum(row > row_gap))
    if gaps is not None:
        gaps["traj"] = row.tolist()
    if kind == "batch":
        cost = (np.abs(last - F) / np.maximum(np.abs(F), 1.0)).max(axis=1)
        out["cost_err_max"], out["cost_err_p75"] = _rows(cost)
        if gaps is not None:
            gaps["cost"] = cost.tolist()
    else:
        out["verdicts_wrong"] = int(np.sum(
            solver.collides(traj, start_cfg) != last))
    return out


def judge(values, limits):
    """(correct, [(name, value, limit)]): every number finite, not
    negative and within its limit."""
    rows = [(k, values[k], limits[k]) for k in limits]
    ok = all(np.isfinite(v) and 0 <= v <= lim for _, v, lim in rows)
    return bool(ok), rows
