"""``setup_s``: from the start of the process that prints the result to
the call of the window's first step: imports, inputs, the program's mesh
and solver, warm-up, and in a checkout's first run the kernels' build."""


def read(rec):
    return rec.setup_s
