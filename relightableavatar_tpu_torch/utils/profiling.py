"""Step-scheduled traces of the train loop on ``torch.profiler``
(``relightableavatar_tpu/utils/profiling.py``; reference
``lib/utils/prof_utils.py:26-47``): the same ``cfg.profiling`` keys and the
same skip / wait / warmup / active / repeat schedule, one ``.step()`` an
iteration.  Each active window is written as a Chrome trace,
``<record_dir>/trace_<n>.json``, with the CPU and (where there is one)
the CUDA activity."""
from __future__ import annotations

import os

import torch

from relightableavatar_tpu_torch.utils.log import log


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
            self.prof.__enter__()
            log(f'profiler: tracing -> {self.record_dir}', 'cyan')
        elif phase != 'active' and self.prof is not None:
            self._stop()
        self.i += 1

    def _stop(self):
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.record_dir, f'trace_{self.traces}.json')
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.traces += 1
        log(f'profiler: trace written to {path}', 'cyan')

    def close(self):
        if self.prof is not None:
            self._stop()
