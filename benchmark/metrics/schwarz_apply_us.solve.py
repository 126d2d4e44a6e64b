"""Device time of one Schwarz preconditioner apply, us: CUDA events around
each ``htool.schwarz.apply`` span of the traced solves (on the CPU, where
the host does the work, the span's own duration), mean over the applies."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    applies = program_spans.named(program_spans.records(), "htool.schwarz.apply")
    return program_spans.mean(r["device_us"] for r in applies if "device_us" in r)
