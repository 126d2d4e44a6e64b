"""Host self time of a Krylov step, us: of each ``htool.krylov.step`` span
of the traced solves, its duration less its direct ``htool.hmatrix.product``,
``htool.schwarz.apply`` and ``htool.krylov.wait`` children (the solver's own
vector arithmetic as the host issues it), mean over the steps."""

from harness import program_spans

CHILDREN = ("htool.hmatrix.product", "htool.schwarz.apply", "htool.krylov.wait")


def read(rec):
    if rec.kind != "solve_stream":
        return None
    recs = program_spans.records()
    if recs is None:
        return None
    from htool_tpu_torch.utils.profiling import self_times

    m = program_spans.mean(self_times(recs, "htool.krylov.step", CHILDREN))
    return None if m is None else m / 1e3
