"""The comparison that decides ``correct``: how far the program's fields lie
from the reference's."""

from __future__ import annotations

import math

import torch


def relerr(got: dict, want: dict) -> float:
    """max over ``want``'s fields of max|got - want| / max|want|, in
    float64 (a tracer axis, where there is one, included); inf where
    ``got`` holds a non-finite value or a field of another shape."""
    worst = 0.0
    for k, w in want.items():
        g = torch.as_tensor(got[k]).to(device=w.device, dtype=torch.float64)
        w = w.to(torch.float64)
        if g.shape != w.shape:
            return math.inf
        gap = float((g - w).abs().max())
        scale = float(w.abs().max())
        if not math.isfinite(gap):
            return math.inf
        worst = max(worst, gap / scale if scale > 0 else gap)
    return worst
