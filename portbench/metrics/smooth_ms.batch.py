"""smooth_ms.batch: device ms a replayed solver step spends in the graph
nodes captured under ``smoothgrad`` and ``smoothcost`` (the metric's
products and solves and the smoothness cost), as fk_ms.batch reads
``fk``."""

from portbench.program_spans import phase_device_ms


def read(trace):
    return phase_device_ms(trace, ("smoothgrad", "smoothcost"))
