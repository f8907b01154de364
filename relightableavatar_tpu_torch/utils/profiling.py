"""The port's tracing: program spans and counters, and step-scheduled
traces of the train loop on ``torch.profiler``.

Spans and counters.  ``span(name)`` is a context manager around one stage
of the program (a frame, a ray block, an HDQ query, a step's phase, a
collective) and ``count(name, n)`` adds to a counter (HDQ points and band
rows, host waits for the card, collective bytes).  They record only while a
``torch.profiler`` is recording or inside a :func:`collecting` block; off,
each costs a flag read and returns a shared no-op context, and neither ever
synchronises.  On, a span opens ``torch.profiler.record_function(name)``,
so it brackets its kernels in the profiler's timeline, and keeps (name,
start, end, parent, unit), stamped by ``time.time_ns()``, the clock of the
profile's ``trace_start_ns``.  ``render.frame`` and ``train.step`` each open
a new unit.  :func:`totals` sums them by name; :func:`reset` clears them.

The profiler (``relightableavatar_tpu/utils/profiling.py``; reference
``lib/utils/prof_utils.py:26-47``): the same ``cfg.profiling`` keys and the
same skip / wait / warmup / active / repeat schedule, one ``.step()`` an
iteration.  Each active window is written as a Chrome trace,
``<record_dir>/trace_<n>.json``, with the CPU and (where there is one)
the CUDA activity, and its spans as ``spans_<n>.json`` (:func:`export`).
"""
from __future__ import annotations

import contextlib
import heapq
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from relightableavatar_tpu_torch.utils.log import log

UNIT_SPANS = ("render.frame", "train.step")     # each opens a new unit
_NULL = contextlib.nullcontext()
_collecting = 0         # depth of open collecting() blocks
_spans: list = []       # [name, start_ns, end_ns, parent index or -1, unit]
_counters: dict = {}
_units = [0]
_local = threading.local()      # this thread's stack of open span indices


def recording() -> bool:
    """True while spans and counters record."""
    return bool(_collecting) or _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "rec", "stack", "fn")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        if self.name in UNIT_SPANS and not any(_spans[i][0] in UNIT_SPANS for i in stack):
            _units[0] += 1
        self.fn = torch.profiler.record_function(self.name)
        self.fn.__enter__()
        self.rec = [self.name, time.time_ns(), 0, stack[-1] if stack else -1, _units[0]]
        self.stack = stack
        stack.append(len(_spans))
        _spans.append(self.rec)
        return self

    def __exit__(self, *exc):
        self.rec[2] = time.time_ns()
        self.stack.pop()
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one stage of the program (see the module's
    docstring); a shared no-op unless :func:`recording`."""
    if not (_collecting or _autograd_profiler._is_profiler_enabled):
        return _NULL
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` (a host integer) to counter ``name`` while :func:`recording`."""
    if _collecting or _autograd_profiler._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def host_sync(site: str) -> None:
    """Count one host wait for the card at ``site``: under ``host.sync`` and
    ``host.sync.<site>``."""
    if _collecting or _autograd_profiler._is_profiler_enabled:
        _counters["host.sync"] = _counters.get("host.sync", 0) + 1
        key = "host.sync." + site
        _counters[key] = _counters.get(key, 0) + 1


@contextlib.contextmanager
def collecting():
    """Record spans and counters inside the block without a profiler (the
    stage breakdowns of ``chip_smoke.py`` and ``eval/profile_frame.py``)."""
    global _collecting
    _collecting += 1
    try:
        yield
    finally:
        _collecting -= 1


def reset() -> None:
    """Forget every recorded span, counter and unit."""
    _spans.clear()
    _counters.clear()
    _units[0] = 0
    _local.stack = []       # a span open across the reset closes on its own stack


def spans() -> list:
    """The spans recorded, as (name, start_ns, end_ns, parent, unit) tuples
    (``end_ns`` 0 while open); ``parent`` indexes this list (-1 for a top
    span)."""
    return [tuple(s) for s in _spans]


def totals() -> dict:
    """``spans``: by name, ``count``, ``total_s`` and ``self_s`` (the
    duration less that of its child spans); ``counters``; ``units``, the
    units opened (:data:`UNIT_SPANS`)."""
    child = [0] * len(_spans)
    for name, s, e, parent, _ in _spans:
        if parent >= 0 and e:
            child[parent] += e - s
    out: dict = {}
    for i, (name, s, e, _, _) in enumerate(_spans):
        if not e:
            continue        # still open
        t = out.setdefault(name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        t["count"] += 1
        t["total_s"] += (e - s) / 1e9
        t["self_s"] += (e - s - child[i]) / 1e9
    return {"spans": out, "counters": dict(_counters), "units": _units[0]}


def summary(rec: dict | None = None) -> str:
    """One line of :func:`totals` (or ``rec``): each span's count, total and
    self milliseconds in order of first appearance, then the counters."""
    rec = totals() if rec is None else rec
    parts = [f"{name} x{t['count']} {t['total_s'] * 1e3:.1f} ms (self {t['self_s'] * 1e3:.1f})"
             for name, t in rec["spans"].items()]
    parts += [f"{name} {n}" for name, n in sorted(rec["counters"].items())]
    return "; ".join(parts)


def idle_gaps(prof, names) -> dict:
    """Seconds the card ran nothing between device events of the profile
    ``prof``, each gap put down to the innermost of the spans named in
    ``names`` (the profile's ``record_function`` annotations of them) open
    at the gap's middle, or "(outside spans)"; on the profile's one clock."""
    dev, ann = [], []
    names = set(names)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if getattr(e, "is_user_annotation", False):
            if e.device_type == torch.autograd.DeviceType.CPU and e.name in names:
                ann.append((start, end, e.name))
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((start, end))
    merged: list = []
    for s, t in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    gaps = sorted(((a[1] + b[0]) / 2, b[0] - a[1]) for a, b in zip(merged, merged[1:]))
    ann.sort()
    out: dict = {}
    heap: list = []         # the open annotations, the latest started first
    i = 0
    for mid, g in gaps:
        while i < len(ann) and ann[i][0] <= mid:
            heapq.heappush(heap, (-ann[i][0], ann[i][1], ann[i][2]))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        name = heap[0][2] if heap else "(outside spans)"
        out[name] = out.get(name, 0.0) + g / 1e6
    return out


def export(prof, path: str) -> dict:
    """Write the spans of the window profiled by ``prof`` (its
    :func:`totals` and :func:`idle_gaps`) as JSON to ``path``; returns it."""
    rec = totals()
    rec["idle_gaps_s"] = dict(sorted(idle_gaps(prof, rec["spans"]).items(),
                                     key=lambda kv: -kv[1]))
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


class Profiler:
    """Step-scheduled profiler: call :meth:`step` once per training iteration."""

    def __init__(self, cfg):
        node = cfg.profiling
        self.enabled = bool(node.enabled)
        self.record_dir = node.record_dir or os.path.join(cfg.record_dir, 'profile')
        self.skip_first = int(node.skip_first)
        self.wait = int(node.wait)
        self.warmup = int(node.warmup)
        self.active = int(node.active)
        self.repeat = int(node.repeat)
        self.i = 0
        self.prof = None
        self.traces = 0

    def _phase(self, i: int) -> str:
        if i < self.skip_first:
            return 'skip'
        j = (i - self.skip_first) % (self.wait + self.warmup + self.active)
        cycle = (i - self.skip_first) // (self.wait + self.warmup + self.active)
        if self.repeat and cycle >= self.repeat:
            return 'done'
        if j < self.wait:
            return 'wait'
        if j < self.wait + self.warmup:
            return 'warmup'
        return 'active'

    def step(self):
        if not self.enabled:
            return
        phase = self._phase(self.i)
        if phase == 'active' and self.prof is None:
            os.makedirs(self.record_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            reset()
            self.prof.__enter__()
            log(f'profiler: tracing -> {self.record_dir}', 'cyan')
        elif phase != 'active' and self.prof is not None:
            self._stop()
        self.i += 1

    def _stop(self):
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.record_dir, f'trace_{self.traces}.json')
        self.prof.export_chrome_trace(path)
        export(self.prof, os.path.join(self.record_dir, f'spans_{self.traces}.json'))
        reset()
        self.prof = None
        self.traces += 1
        log(f'profiler: trace written to {path} (spans beside it)', 'cyan')

    def close(self):
        if self.prof is not None:
            self._stop()
