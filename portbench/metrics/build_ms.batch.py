"""build_ms.batch: host ms a batch spends in problem_batch_from_grid
(parallel/batch.py), the mean of the benchmark's ``build`` spans over
every batch of the window."""

from portbench.tracing import mean_span_ms


def read(trace):
    return mean_span_ms(trace, "build")
