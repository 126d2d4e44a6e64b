"""Krylov steps replayed from CUDA graphs a solve: the change of the
program's counter ``krylov_graph_steps`` across each ``htool.ddm.solve``
span of the traced solves, mean over the solves.  None where no solve
counted it: a program without CG's graphs, or a run on the CPU, where
nothing is captured."""

from harness import program_spans


def read(rec):
    if rec.kind != "solve_stream":
        return None
    roots = program_spans.named(program_spans.records(), "htool.ddm.solve")
    steps = [r["counters"]["krylov_graph_steps"] for r in roots
             if "krylov_graph_steps" in r.get("counters", {})]
    return program_spans.mean(steps) if len(steps) == len(roots) else None
