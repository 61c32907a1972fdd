"""``abi.copy_ms``: the device time of the copies between host and card
(the trace's ``Memcpy`` events) a model step; over several ranks the
largest.  Nothing where no copy ran."""


def read(rec):
    per = [sum(b - a for n, a, b, _ in t["ops"] if n.startswith("Memcpy"))
           / t["steps"] for t in rec.traces]
    if not any(per):
        return None
    return max(per) * 1e-3
