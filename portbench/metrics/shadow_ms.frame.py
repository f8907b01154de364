"""Shadow visibility a frame (DFSS shadow rays, or the sweep volume's read):
the program span ``block.visibility``'s share of the traced units' top
span ``render.frame`` (``utils/profiling.totals()`` of the port, which
records spans only while the profiler runs, so only the traced units),
applied to the window's unprofiled time a unit (the profiler slows the
host), in milliseconds. None without traced units, or where the program
has no span registry."""


def read(rec):
    try:
        from relightableavatar_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    spans = totals()["spans"]
    top = spans.get("render.frame", {}).get("total_s", 0.0)
    if top <= 0:
        return None
    part = sum(spans.get(n, {}).get("total_s", 0.0) for n in ("block.visibility",))
    return 1e3 * rec["unit_s"] * part / top
