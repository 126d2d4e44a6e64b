"""Time of KernelGenerator + build_hmatrix + prepare_tiled_matvec a problem, ms, ending when the device has finished.
Mean of the span ``assembly`` over the window's problems."""


def read(rec):
    if rec.kind != "new_problem":
        return None
    s = rec.span_mean_s("assembly")
    return None if s is None else 1e3 * s
