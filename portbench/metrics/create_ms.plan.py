"""create_ms.plan: host ms of the module's create (api.py) a request,
the mean of the benchmark's ``create`` spans over every request of the
window."""

from portbench.tracing import mean_span_ms


def read(trace):
    return mean_span_ms(trace, "create")
