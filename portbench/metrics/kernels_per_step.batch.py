"""kernels_per_step.batch: device kernels a card runs a solver step
(memcpys and memsets left out) inside the traced batch's solve (between
the solve span's markers: the replayed steps and the one final cost
pass), the mean over the cards."""


def read(trace):
    if not trace.events or not trace.steps:
        return None
    n = [sum(1 for e in trace.in_span("solve", c)
             if not e.name.startswith(("Memcpy", "Memset")))
         for c in trace.cards]
    if not any(n):
        return None
    return sum(n) / len(n) / trace.steps
