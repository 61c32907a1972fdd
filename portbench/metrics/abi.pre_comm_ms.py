"""``abi.pre_comm_ms``: the host's time, ms, inside the program's
``abi.pre_comm`` spans (``host_embed.pre_comm``: the copy of a rank's
eight f64 buffers in, K1 and K2, the factors' copy out and the wait for
it) a model step of the traced window, every tracer's call; rank 0's
spans only, the process whose record the harness reads.  Nothing where
the program records no such span."""

from portbench import spans


def read(rec):
    us = spans.per_step_us(rec, lambda name: name == "abi.pre_comm")
    return None if us is None else us * 1e-3
