"""fk_kernels.batch: kernels a replayed solver step runs that were
captured under the ``fk`` phase, from the node map of each step graph
replayed in the traced batch (the mean over its replays)."""

from portbench.program_spans import map_nodes


def read(trace):
    return map_nodes(trace, ("fk",))
