"""k2_roofline: K2's share of its roofline, percent: the least
time of one self-collision launch (selfcol_kernel or
selfcol_tiled_kernel) at the cell's shape over the mean duration of its
launches in the traced batch.  The operations count the distance test
of every (point, pair, problem) and none of the in-reach work, which
depends on the data (a lower bound; the bytes bound is the larger by
far at these shapes)."""

from portbench.roofline import counts, peaks


def read(trace):
    ev = trace.kernels(r"selfcol(_tiled)?_kernel")
    if not ev:
        return None
    s = trace.shape
    least = peaks.bound_s(
        counts.selfcol_bytes(s["m"], s["S"], s["SI"], s["B"], s["P"],
                             itemsize=s["itemsize"]),
        counts.selfcol_flops(s["m"], s["B"], s["P"], 0))
    mean = sum(e.end - e.start for e in ev) / len(ev)
    return 100.0 * least / mean
