"""What a run needs, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic mix (``mixes/<traffic>.json``), its
limits (``cells/<cell>.json``), its driver (``drivers/<driver>.py``, named
by the mix) and the readers of its per-layer metrics
(``metrics/<metric>.py``). A later cell, mix, configuration or metric is a
new file and a new entry; nothing here changes.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parents[1]  # portbench/
ROOT = HERE.parent  # the checkout


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``bench`` (``BENCHMARK.json`` by default); its files
    are found under ``root`` (the checkout) and ``root / "portbench"``."""

    def __init__(self, name: str, bench: Dict = None, root: Path = ROOT):
        bench = bench if bench is not None else benchmark()
        self.base = root / "portbench"
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; "
                           f"known: {sorted(cells)}")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(root / self.config_entry["file"])
        self.mix = load_json(self.base / "mixes"
                             / f"{self.entry['traffic']}.json")
        self.limits = load_json(self.base / "cells" / f"{name}.json")["limits"]
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]

    @classmethod
    def from_parts(cls, name: str, entry: Dict, config: Dict, mix: Dict,
                   limits: Dict, bench: Dict) -> "Cell":
        """A cell from given parts (the tests' small cells)."""
        self = cls.__new__(cls)
        self.base = HERE
        self.name, self.entry, self.config = name, entry, config
        self.mix, self.limits = mix, limits
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._has(m)]
        return self

    def _has(self, metric: Dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def driver(self) -> ModuleType:
        kind = self.mix["driver"]
        return load_module(self.base / "drivers" / f"{kind}.py",
                           f"portbench_driver_{kind}")

    def readers(self) -> List:
        return [(m, load_module(self.base / "metrics" / f"{m['name']}.py",
                                "portbench_metric_" + m["name"].replace(".", "_")))
                for m in self.per_layer]
