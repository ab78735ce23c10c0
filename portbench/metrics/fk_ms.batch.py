"""fk_ms.batch: device ms a replayed solver step spends in the graph
nodes captured under the ``fk`` phase (the node map of the program's
StepGraph, or_cdchomp_tpu_torch/utils/profiling.py), the mean over the
complete replays found in the traced batch's solve on every card
(program_spans.replay_phase_ms)."""

from portbench.program_spans import phase_device_ms


def read(trace):
    return phase_device_ms(trace, ("fk",))
