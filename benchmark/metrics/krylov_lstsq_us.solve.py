"""Device time of block GMRES's least squares a step, us: CUDA events around
each ``htool.krylov.lstsq`` span whose parent is a ``htool.krylov.step`` of
the traced solves (the per-step solve for the stopping test; the final one
at a restart lies outside any step and is left out), on the CPU the span's
own duration; mean over the steps.  None where no such span was recorded."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    recs = program_spans.records()
    steps = {r["id"] for r in program_spans.named(recs, "htool.krylov.step")}
    return program_spans.mean(r["device_us"] for r in program_spans.named(recs, "htool.krylov.lstsq")
                              if r["parent"] in steps and "device_us" in r)
