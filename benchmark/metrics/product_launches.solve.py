"""Kernel launches a solve: the change of the three product kernel wrappers'
CUDA launches across each ``htool.ddm.solve`` span of the traced solves,
mean over the solves.  On the CPU, where a plain version runs in each
kernel's place, the change of the program's counter ``plain_calls``."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    key = "plain_calls" if rec.device_kind == "cpu" else "launches"
    roots = program_spans.named(program_spans.records(), "htool.ddm.solve")
    return program_spans.mean(r["counters"].get(key, 0) for r in roots)
