"""CUDA graphs of a row-wise function at bucketed row counts.

A function of a few row-indexed inputs (each (rows, ...)) and a few small
constant tensors, each of whose output rows depends on its own input rows
alone, is captured once for each bucket of rows (multiples of :data:`STEP`
up to a cap) and replayed there.  A call gathers the rows its index picks
into static input buffers, copies the constants into static copies of
themselves and replays the bucket's graph; the bucket's tail rows hold
whatever rows an earlier call left there, and their outputs are dropped.
The call returns the first rows of a static output buffer, which the next
replay overwrites: the caller consumes it, on the same stream, first.  One
replay costs the host one launch where eager costs it one launch an op.

The graphs read every other tensor the function closes over (its weights)
at the address it had when they were captured, so the caller names those
tensors and their addresses join the key: a weight updated in place is read
anew by the next replay, and new weight tensors make a new key and a new
capture.

A call replays when its tensors are on CUDA, autograd is off, its rows fit
the cap, it runs on the process's main thread (a key's buffers are shared by
the process) and its key has graphs.  A key's graphs are all captured at its
first such call, largest bucket first, into one memory pool, unless spans
and counters are recording (``utils/profiling.recording()``: a capture would
then sit inside a profile or a timed stage); a key whose capture raised runs
eagerly from then on.  Every other call runs eagerly: :meth:`RowGraphs.run`
returns None and the caller calls the function itself.
"""
from __future__ import annotations

import threading

import torch

from relightableavatar_tpu_torch.utils.log import log
from relightableavatar_tpu_torch.utils.profiling import count, recording

STEP = 1024         # bucket width in rows
CAP = 32768         # the largest bucket: the default shadow block (camera blocks are 8,192 rays)
MAX_KEYS = 4        # keys whose graphs are kept, the latest captured


def bucket(n: int, cap: int = CAP) -> int | None:
    """``n`` rows padded to the next multiple of :data:`STEP` (at least one
    step), or None where that passes ``cap``."""
    b = max(1, -(-n // STEP)) * STEP
    return b if b <= cap else None


class _Group:
    """One key's static buffers and its graphs, by bucket."""

    def __init__(self, rows: list, consts: dict, out: torch.Tensor, graphs: dict):
        self.rows, self.consts, self.out, self.graphs = rows, consts, out, graphs


class RowGraphs:
    """The graphs of one row-wise function, keyed by the caller; counters
    ``<name>_graph`` (calls replayed), ``<name>_eager`` (calls run eagerly),
    ``<name>_pad_rows`` (rows replayed past a call's own) and
    ``<name>_captures`` (graphs captured; 0 inside a recorded window, since
    nothing is captured there).  ``captures`` counts the graphs captured
    whether or not spans record."""

    def __init__(self, name: str, cap: int = CAP):
        self.name, self.cap = name, cap
        self.captures = 0
        self._groups: dict = {}     # key -> _Group, the oldest first
        self._failed: set = set()

    def _on_card(self, t: torch.Tensor) -> bool:
        return t.is_cuda

    def eager_reason(self, key, ref: torch.Tensor, n: int, capturable: bool = True) -> str | None:
        """Why a call of ``n`` rows like ``ref`` under ``key`` runs eagerly,
        or None when it replays (or first captures)."""
        if not capturable:
            return "not capturable"
        if not self._on_card(ref):
            return "not on CUDA"
        if torch.is_grad_enabled():
            return "autograd on"
        if bucket(n, self.cap) is None:
            return "over the cap"
        if threading.current_thread() is not threading.main_thread():
            return "not the main thread"
        if key in self._failed:
            return "its capture raised"
        if key not in self._groups and recording():
            return "recording: no capture"
        return None

    def run(self, key, weights, fn, rows, sel: torch.Tensor, consts: dict,
            capturable: bool = True):
        """``fn([r[sel] for r in rows], consts)`` replayed, or None where the
        call runs eagerly (counted; the caller then calls ``fn`` itself).
        ``key`` names what ``fn`` computes; ``weights`` are the tensors it
        closes over (an iterable, read only where the call may replay)."""
        ref = rows[0]
        n = int(sel.shape[0])
        full = None
        if capturable and self._on_card(ref):
            full = (key, tuple(t.data_ptr() for t in weights), ref.device, ref.dtype,
                    tuple(tuple(r.shape[1:]) for r in rows),
                    torch.backends.cuda.matmul.allow_tf32)
        if self.eager_reason(full, ref, n, capturable) is not None:
            count(self.name + "_eager")
            return None
        group = self._groups.get(full)
        if group is None:
            try:
                group = self._capture(fn, rows, consts)
            except RuntimeError as e:
                self._failed.add(full)
                log(f"{self.name}: CUDA graph capture raised, this key runs eagerly: {e}",
                    "yellow")
                count(self.name + "_eager")
                return None
            while len(self._groups) >= MAX_KEYS:
                self._groups.pop(next(iter(self._groups)))
            self._groups[full] = group
        b = bucket(n, self.cap)
        graph = group.graphs.get(b)
        if graph is None:
            count(self.name + "_eager")
            return None
        for buf, r in zip(group.rows, rows):
            torch.index_select(r, 0, sel, out=buf[:n])
        for k, t in consts.items():
            group.consts[k].copy_(t)
        graph.replay()
        count(self.name + "_graph")
        count(self.name + "_pad_rows", b - n)
        return group.out[:n]

    def _capture(self, fn, rows, consts) -> _Group:
        """Every bucket's graph of ``fn``, the largest first, on a side stream
        into one pool, after one eager call there (its lazy set-up, such as
        the stream's cuBLAS workspace, stays out of the graphs)."""
        dev = rows[0].device
        with torch.cuda.device(dev):
            torch.cuda.synchronize()        # nothing pending on a key evicted below
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            graphs, pool = {}, torch.cuda.graph_pool_handle()
            try:
                with torch.cuda.stream(side):
                    bufs = [r.new_zeros((self.cap, *r.shape[1:])) for r in rows]
                    cbufs = {k: t.clone() for k, t in consts.items()}
                    first = fn(bufs, cbufs)
                    out = first.new_empty((self.cap, *first.shape[1:]))
                    del first
                    for b in range(self.cap // STEP * STEP, 0, -STEP):
                        g = torch.cuda.CUDAGraph()
                        g.capture_begin(pool=pool)
                        try:
                            out[:b].copy_(fn([x[:b] for x in bufs], cbufs))
                        finally:
                            g.capture_end()
                        graphs[b] = g
                        self.captures += 1
                        count(self.name + "_captures")
            finally:
                cur.wait_stream(side)
        return _Group(bufs, cbufs, out, graphs)
