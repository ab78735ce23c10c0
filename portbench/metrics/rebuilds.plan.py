"""rebuilds.plan: engines and step graphs built in a request: the
program's ``engine_cache.miss`` and ``graph.capture`` counters over the
traced request's ``module.create`` spans (0 while the module's engine
cache and the engine's graphs serve every request)."""

from portbench import program_spans


def read(trace):
    return program_spans.per_unit_count(
        program_spans.recording(trace), ("engine_cache.miss", "graph.capture"),
        "module.create")
