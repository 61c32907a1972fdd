"""``abi.pinned_pct``: the share, %, of the bytes of the caller's f64
buffers that the host ABI moved by DMA of memory it page-locked
(``host_embed.py``): the program's counter ``abi.bytes_registered`` over
it and ``abi.bytes_pageable``, the bytes of the pageable path, in every
call of the run's process (set-up's and the windows').  Nothing where the
program keeps no counters (``tracing.counters()``) or counted no such
bytes."""

NAMES = ("abi.bytes_registered", "abi.bytes_pageable")


def read(rec):
    from fesom2_accelerate_tpu_torch.runtime import tracing

    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    registered, pageable = (c.get(n, 0) for n in NAMES)
    if registered + pageable == 0:
        return None
    return 100.0 * registered / (registered + pageable)
