"""Time of the batched ACA of the admissible blocks a problem, ms, ending
when the device has finished: mean duration of the ``htool.assembly.aca``
spans of the traced problems (one a problem)."""

from harness import program_spans


def read(rec):
    if rec.kind != "new_problem":
        return None
    return program_spans.mean_ms(program_spans.records(), "htool.assembly.aca")
