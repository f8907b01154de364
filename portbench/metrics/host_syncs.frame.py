"""Host waits for the card a frame: the port's ``host.sync`` counter (each
``torch.nonzero``, boolean-mask index, ``.cpu()`` and pageable host-to-card
copy on the frame path) over the traced frames (``utils/profiling.totals()``
records only while the profiler runs).  None without traced frames, or
where the program has no span registry."""


def read(rec):
    try:
        from relightableavatar_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    units = t["spans"].get("render.frame", {}).get("count", 0)
    if not units:
        return None
    return t["counters"].get("host.sync", 0) / units
