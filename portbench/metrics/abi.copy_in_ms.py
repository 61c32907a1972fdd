"""``abi.copy_in_ms``: the host's time, ms, inside the program's
``abi.copy_in`` spans (``host_embed.copy_in``: the cast of the caller's
f64 buffers and the copy to the card) a model step of the traced window,
every tracer's call; rank 0's.  Nothing where the program records no such
span."""

from portbench import spans


def read(rec):
    us = spans.per_step_us(rec, lambda name: name == "abi.copy_in")
    return None if us is None else us * 1e-3
