"""jtmap_ms.batch: device ms a replayed solver step spends in the graph
nodes captured under ``jtmap`` (the Jacobian-transpose map of the
spheres' workspace gradients onto the joints, cost_soa.py), as
fk_ms.batch reads ``fk``."""

from portbench.program_spans import phase_device_ms


def read(trace):
    return phase_device_ms(trace, ("jtmap",))
