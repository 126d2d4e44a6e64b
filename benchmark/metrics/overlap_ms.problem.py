"""Host time of the geometric overlap (scipy's cKDTree and its queries) a
problem, ms: mean duration of the ``htool.schwarz.overlap`` spans of the
traced problems."""

from harness import program_spans


def read(rec):
    if rec.kind != "new_problem":
        return None
    return program_spans.mean_ms(program_spans.records(), "htool.schwarz.overlap")
