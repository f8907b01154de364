"""Share of the unprofiled time a unit (step or frame) in which the card
ran nothing: 1 - (union of the profiled units' device activity, a unit) /
(the window's time a unit, measured without the profiler, which slows the
host and not the kernels)."""


def read(rec):
    if rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["units"] / rec["unit_s"])
