"""device_idle_pct.batch: percent of a batch in which a card runs
nothing, 100 × (1 − the traced batch's device busy time / the mean host
time of a batch in the untraced window), the largest over the cards."""

from portbench.tracing import idle_pct


def read(trace):
    return idle_pct(trace)
