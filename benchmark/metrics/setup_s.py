"""Set-up, s: from the start of the process to the start of the window
(imports, inputs, kernel build on a checkout's first run, the cell's
set-up and its warm-up)."""


def read(rec):
    return rec.setup_s
