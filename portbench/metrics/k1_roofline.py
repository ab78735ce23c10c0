"""k1_roofline: K1's share of its roofline, percent: the least
time of one obstacle_kernel launch at the cell's shape (frozen byte and
operation counts, roofline/counts.py, over the H100's published peaks,
whichever bound is larger) over the mean duration of its launches in the
traced batch (every card)."""

from portbench.roofline import counts, peaks


def read(trace):
    ev = trace.kernels(r"obstacle_kernel")
    if not ev:
        return None
    s = trace.shape
    F, mx, my, mz = s["fields"]
    least = peaks.bound_s(
        counts.obstacle_bytes(s["m"], s["S"], s["B"], F, mx, my, mz,
                              itemsize=s["itemsize"]),
        counts.obstacle_flops(s["m"], s["S"], s["B"], F))
    mean = sum(e.end - e.start for e in ev) / len(ev)
    return 100.0 * least / mean
