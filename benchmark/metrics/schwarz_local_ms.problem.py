"""Time of the Schwarz local matrices and their batched inverse a problem,
ms, ending when the device has finished: mean duration of the
``htool.schwarz.local`` spans of the traced problems."""

from harness import program_spans


def read(rec):
    if rec.kind != "new_problem":
        return None
    return program_spans.mean_ms(program_spans.records(), "htool.schwarz.local")
