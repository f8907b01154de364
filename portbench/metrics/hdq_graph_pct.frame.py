"""Share of the HDQ queries whose band ran as one CUDA graph replay, in %:
the port's ``hdq.band_graph`` counter over ``hdq.band_graph`` plus
``hdq.band_eager`` (queries whose band ran op by op) over the traced frames
(``utils/profiling.totals()`` records only while the profiler runs).  None
without traced frames, or where the program counts neither (a program with
no band graphs)."""


def read(rec):
    try:
        from relightableavatar_tpu_torch.utils.profiling import totals
    except ImportError:
        return None
    t = totals()
    if not t["spans"].get("render.frame", {}).get("count", 0):
        return None
    c = t["counters"]
    graph, eager = c.get("hdq.band_graph", 0), c.get("hdq.band_eager", 0)
    if not graph + eager:
        return None
    return 100.0 * graph / (graph + eager)
