"""Host waits on the device a solve: the change of the program's counter
``syncs`` (each host read of a device value in the Krylov loop, and the
solve's closing synchronization) across each ``htool.ddm.solve`` span of
the traced solves, mean over the solves."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    roots = program_spans.named(program_spans.records(), "htool.ddm.solve")
    return program_spans.mean(r["counters"].get("syncs", 0) for r in roots)
