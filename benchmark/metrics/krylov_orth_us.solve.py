"""Device time of block GMRES's orthogonalization a step, us: CUDA events
around each ``htool.krylov.orth`` span (the block modified Gram-Schmidt
against the basis and the block QR of the new block) whose parent is a
``htool.krylov.step`` of the traced solves, on the CPU the span's own
duration; mean over the steps.  None where no such span was recorded."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    recs = program_spans.records()
    steps = {r["id"] for r in program_spans.named(recs, "htool.krylov.step")}
    return program_spans.mean(r["device_us"] for r in program_spans.named(recs, "htool.krylov.orth")
                              if r["parent"] in steps and "device_us" in r)
