"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``kind`` names the generator
``traffic/<kind>.py``), its entry and limits (``workloads/<cell>.json``,
whose ``entry`` names ``entries/<entry>.py``) and the per-layer metrics'
readers (``metrics/<metric>.py``).  A later cell, traffic mix, entry or
metric is new files and new entries, not an edit."""
from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file as a module (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell, resolved: its ``BENCHMARK.json`` entry, configuration,
    traffic, workload file and metrics.  ``base`` is the folder that holds
    ``configs/``, ``traffic/``, ``workloads/``, ``entries/`` and
    ``metrics/`` (this package's by default)."""

    def __init__(self, name: str, bench: dict | None = None, base: str = PKG):
        bench = bench if bench is not None else read_json(os.path.join(ROOT, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.base = base
        self.entry_spec = cells[name]
        self.chips = int(self.entry_spec["chips"])
        self.config = read_json(self._find("configs", self.entry_spec["config"] + ".json"))
        self.traffic = read_json(self._find("traffic", self.entry_spec["traffic"] + ".json"))
        self.workload = read_json(self._find("workloads", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]

    def _find(self, sub: str, fname: str) -> str:
        path = os.path.join(self.base, sub, fname)
        return path if os.path.exists(path) else os.path.join(PKG, sub, fname)

    def generator(self):
        kind = self.traffic["kind"]
        return load_module(self._find("traffic", kind + ".py"), f"_traffic_{kind}")

    def entry(self):
        e = self.workload["entry"]
        return load_module(self._find("entries", e + ".py"), f"_entry_{e}")

    def reader(self, metric: str):
        return load_module(self._find("metrics", metric + ".py"),
                           "_metric_" + metric.replace(".", "_")).read

    def limits(self) -> dict:
        """Each compared number's limit (``workloads/<cell>.json``'s ``limits``)."""
        return dict(self.workload["limits"])

    def make_cfg(self):
        """The port's default config with the configuration's keys and the
        workload's (``cfg``; dotted keys name nested nodes)."""
        from relightableavatar_tpu_torch.config import default_cfg
        cfg = default_cfg()
        for key, value in [*self.config["cfg"].items(), *self.workload.get("cfg", {}).items()]:
            node = cfg
            *path, leaf = key.split(".")
            for part in path:
                node = node[part]
            node[leaf] = value
        return cfg
