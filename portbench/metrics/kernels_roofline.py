"""``kernels_roofline``: the model step's contract bytes
(``portbench/contract.py``) over the time the device was busy in the
traced window (the union of every operation on every stream), as a share
of the H100 SXM data sheet's 3.35 TB/s; over several ranks the contract
bytes of the whole mesh over the sum of the ranks' busy times.  Nothing
where the cell moves more than the contract (through the host)."""

from portbench import contract, trace


def read(rec):
    if rec.bytes_per_step is None or not rec.traces:
        return None
    busy = sum(trace.busy_s(t) for t in rec.traces)
    if busy == 0:
        return None
    steps = min(t["steps"] for t in rec.traces)
    return (100.0 * rec.bytes_per_step * steps / busy
            / contract.PEAK_BYTES_PER_S)
