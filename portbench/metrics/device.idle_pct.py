"""``device.idle_pct``: the share of the traced window in which the card
ran no kernel and no copy; over several ranks the largest.  Nothing
where no operation ran on the device."""

from portbench import trace


def read(rec):
    per = [100.0 * (1.0 - trace.busy_s(t) / trace.window_s(t))
           for t in rec.traces if t["ops"]]
    return max(per) if per else None
