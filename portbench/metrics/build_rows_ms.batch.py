"""build_rows_ms.batch: host ms a batch spends in the program's
``build.rows`` span (problem_batch_from_grid: the straight lines and the
metric's affine terms in numpy), in the traced batch."""

from portbench import program_spans


def read(trace):
    return program_spans.per_unit_ms(program_spans.recording(trace),
                                     "build.rows", "batch.build")
