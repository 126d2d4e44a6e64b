"""Time of DDMSolver(...) (overlap, local matrices, their inverses) a problem, ms, ending when the device has finished.
Mean of the span ``schwarz_setup`` over the window's problems."""


def read(rec):
    if rec.kind != "new_problem":
        return None
    s = rec.span_mean_s("schwarz_setup")
    return None if s is None else 1e3 * s
