"""``step_ms_p95``: the 95th percentile of the window's step times, each
from the step's call to the synchronize after it; over several ranks a
step's time is the largest over the ranks."""

import numpy as np


def read(rec):
    n = rec.steps
    times = np.max([[c - a for a, _, c in r["spans"][:n]]
                    for r in rec.ranks], axis=0)
    return float(np.percentile(times, 95)) * 1e3
