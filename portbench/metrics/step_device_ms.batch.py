"""step_device_ms.batch: device ms a solver step takes on a card: the
union of the card's device-event intervals inside the traced batch's
solve (BatchSolver.solve: its replayed steps and the one final cost pass,
between the solve span's markers; the build's and the fetch's copies
left out), over the steps, the mean over the cards."""

from portbench.tracing import busy_s


def read(trace):
    if not trace.events or not trace.steps:
        return None
    per = [busy_s(trace.in_span("solve", c)) for c in trace.cards]
    if not any(per):
        return None
    return 1e3 * sum(per) / len(per) / trace.steps
