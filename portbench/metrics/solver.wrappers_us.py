"""``solver.wrappers_us``: the host's time, µs, inside the kernel
wrappers' spans (``kernels.<wrapper>``: checks, output allocations, the
launcher's call) a model step of the traced window; rank 0's.  Nothing
where the program records no such span."""

from portbench import spans


def read(rec):
    return spans.per_step_us(rec, lambda name: name.startswith("kernels."))
