"""velsaccs_ms.batch: device ms a replayed solver step spends in the
graph nodes captured under ``pre_velsaccs`` (the spheres' centres
stacked, their finite-difference velocities and accelerations,
cost_soa.py), as fk_ms.batch reads ``fk``."""

from portbench.program_spans import phase_device_ms


def read(trace):
    return phase_device_ms(trace, ("pre_velsaccs",))
