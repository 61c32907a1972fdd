"""``exchange.exposed_ms``: a rank's device time a model step from the
end of its H-K3 launch (``b3h_kernel``) to the start of the K4 launch that
follows it (``update_kernel``, in a split step K4-fix, which reads the
exchanged halo factors): the exchange's wait the compute stream sees.
The largest over ranks; nothing where no such pair ran."""

import re

K3 = re.compile(r"\bb3h_kernel\b")
K4 = re.compile(r"\bupdate_kernel\b")


def read(rec):
    per = []
    for t in rec.traces:
        end, total, pairs = None, 0.0, 0
        for name, a, b, _ in sorted(t["ops"], key=lambda o: o[1]):
            if K3.search(name):
                end = b
            elif K4.search(name) and end is not None:
                total += max(a - end, 0.0)
                pairs += 1
                end = None
        if pairs:
            per.append(total / t["steps"])
    if not per:
        return None
    return max(per) * 1e-3
