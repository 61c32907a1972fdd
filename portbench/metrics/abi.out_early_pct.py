"""``abi.out_early_pct``: the share, %, of the result bytes that the host
ABI wrote back into the caller's buffers (``host_embed.py``) whose copy it
ordered behind K2's or K3's end rather than stage c's, so that they went
out over PCIe while the step's last inputs still came in: the program's
counter ``abi.bytes_out_early`` over ``abi.bytes_out``, in every call of
the run's process (set-up's and the windows').  Nothing where the program
keeps no counters (``tracing.counters()``) or wrote no result back."""

NAMES = ("abi.bytes_out_early", "abi.bytes_out")


def read(rec):
    from fesom2_accelerate_tpu_torch.runtime import tracing

    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    early, out = (c.get(n, 0) for n in NAMES)
    if out == 0:
        return None
    return 100.0 * early / out
