"""``solver.plan_hit_pct``: the share, %, of the whole steps that the
solver enqueued on the card from a launch plan it had already built
(``ops/cuda/step.py`` ``StepPlans``): 100 x (``solver.plan_steps`` -
``solver.plans_built``) / ``solver.plan_steps``, the program's counters in
every call of the run's process (set-up's and the windows').  Nothing
where the program keeps no counters (``tracing.counters()``) or enqueued
no step from a plan."""

NAMES = ("solver.plan_steps", "solver.plans_built")


def read(rec):
    from fesom2_accelerate_tpu_torch.runtime import tracing

    counters = getattr(tracing, "counters", None)
    if counters is None:
        return None
    c = counters()
    steps, built = (c.get(n, 0) for n in NAMES)
    if steps == 0:
        return None
    return 100.0 * (steps - built) / steps
