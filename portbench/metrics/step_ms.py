"""``step_ms``: the window's wall time over the model steps completed in
it, on the host's clock, each step ended by a synchronize; over several
ranks the slowest rank's."""


def read(rec):
    return max(r["window_s"] / len(r["spans"]) for r in rec.ranks) * 1e3
