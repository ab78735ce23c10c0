"""device_idle_pct.plan: percent of a request in which a card runs
nothing, 100 × (1 − the traced request's device busy time / the mean host
time of a request in the untraced window), the largest over the cards."""

from portbench.tracing import idle_pct


def read(trace):
    return idle_pct(trace)
