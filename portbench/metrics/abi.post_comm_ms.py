"""``abi.post_comm_ms``: the host's time, ms, inside the program's
``abi.post_comm`` spans (``host_embed.post_comm``: the exchanged halo
columns of the factors in, K4-fix, the results' copy out and its
synchronize) a model step of the traced window, every tracer's call; rank
0's spans only, the process whose record the harness reads.  Nothing
where the program records no such span."""

from portbench import spans


def read(rec):
    us = spans.per_step_us(rec, lambda name: name == "abi.post_comm")
    return None if us is None else us * 1e-3
