"""``kernels_roofline.abi``: the model step's contract bytes
(``portbench/contract.py``, at the kernels' itemsize) times the traced
window's steps, over the union of the device time of its kernel
operations (every operation that is not a ``Memcpy`` or ``Memset``), as a
share of the H100 SXM data sheet's 3.35 TB/s: the kernels' share of their
roofline inside a step through the host ABI, where ``kernels_roofline``'s
whole busy time would count the copies over PCIe.  Nothing where the
driver gives no ``bytes_per_step`` or the window ran no kernel."""

from portbench import contract, trace


def read(rec):
    if rec.bytes_per_step is None or not rec.traces:
        return None
    busy = 0.0
    for t in rec.traces:
        ops = [o for o in t["ops"]
               if not o[0].startswith(("Memcpy", "Memset"))]
        busy += sum(b - a for a, b in trace.busy(ops)) * 1e-6
    if busy == 0:
        return None
    steps = min(t["steps"] for t in rec.traces)
    return (100.0 * rec.bytes_per_step * steps / busy
            / contract.PEAK_BYTES_PER_S)
