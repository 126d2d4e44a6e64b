"""GB one H-matrix product streams from its blocks, by the plans' own count:
the change of the program's counter ``product_read_bytes`` (each planned
bucket term adds the bytes its launches read: every slot at its live
extent, each row's run in whole 32-byte sectors; on the CPU, what the plain
version in the kernels' place reads) across each ``htool.ddm.solve`` span
of the traced solves, over the change of ``products`` (the products in the
solve), mean over the solves.  None where no solve counted it: a program
without the counter, or without planned products."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    roots = program_spans.named(program_spans.records(), "htool.ddm.solve")
    per = [c["product_read_bytes"] / c["products"] / 1e9
           for c in (r.get("counters", {}) for r in roots)
           if c.get("product_read_bytes") and c.get("products")]
    return program_spans.mean(per) if roots and len(per) == len(roots) else None
