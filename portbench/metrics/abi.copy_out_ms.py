"""``abi.copy_out_ms``: the host's time, ms, inside the program's
``abi.copy_out`` spans (``host_embed.copy_out``: the copy to the host and
the write into the caller's f64 buffers) a model step of the traced
window, every tracer's call; rank 0's.  Nothing where the program records
no such span."""

from portbench import spans


def read(rec):
    us = spans.per_step_us(rec, lambda name: name == "abi.copy_out")
    return None if us is None else us * 1e-3
