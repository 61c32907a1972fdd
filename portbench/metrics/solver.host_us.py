"""``solver.host_us``: the host's time from a model step's call to its
return, before the synchronize, as a mean over the window's steps (the
traced run's first window, which runs without the profiler); over several
ranks the largest."""


def read(rec):
    return max(sum(b - a for a, b, _ in r["spans"]) / len(r["spans"])
               for r in rec.ranks) * 1e6
