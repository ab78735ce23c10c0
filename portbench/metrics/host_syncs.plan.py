"""host_syncs.plan: places where the program's host waits on the card
in a request (the ``host_sync`` counter: blocking host→card copies,
card→host copies, ``.tolist()``), over the traced request's
``module.create`` spans."""

from portbench import program_spans


def read(trace):
    return program_spans.per_unit_count(program_spans.recording(trace),
                                        ("host_sync",), "module.create")
