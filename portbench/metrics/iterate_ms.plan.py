"""iterate_ms.plan: host ms of the module's iterate (api.py, the replayed
step at B = 1 and its cost reads) a request, the mean of the
benchmark's ``iterate`` spans over every request of the window."""

from portbench.tracing import mean_span_ms


def read(trace):
    return mean_span_ms(trace, "iterate")
