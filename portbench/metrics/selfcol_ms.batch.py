"""selfcol_ms.batch: device ms a replayed solver step spends in the graph
nodes captured under ``selfcol`` (K2, csrc/selfcol.cu, staged or tiled,
and its wrapper's nodes), as fk_ms.batch reads ``fk``."""

from portbench.program_spans import phase_device_ms


def read(trace):
    return phase_device_ms(trace, ("selfcol",))
