"""HDQ band rows a frame, in millions: the port's ``hdq.band_rows`` counter
(the query points inside the SMPL band, which go through the warp and the
MLPs) over the traced frames (``utils/profiling.totals()`` records only
while the profiler runs).  None without traced frames, or where the program
has no span registry."""


def read(rec):
    try:
        from relightableavatar_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    units = t["spans"].get("render.frame", {}).get("count", 0)
    if not units:
        return None
    return t["counters"].get("hdq.band_rows", 0) / units / 1e6
