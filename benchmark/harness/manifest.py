"""BENCHMARK.json and the files it names: a cell's configuration
(configs/<config>.json), traffic mix (traffic/<traffic>.json), limits
(limits/<cell>.json) and per-layer readers (metrics/<name>.py), each
found by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


class Cell:
    """One entry of `workloads` with everything it names."""

    def __init__(self, name: str, spec: dict | None = None):
        spec = spec or manifest()
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
        self.name, self.spec, self.entry = name, spec, cells[name]
        self.chips = self.entry["chips"]
        cfg = next(c for c in spec["configs"] if c["name"] == self.entry["config"])
        self.config = load_json(ROOT / cfg["file"])
        self.traffic = load_json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.limits = load_json(BENCH / "limits" / f"{name}.json")
        self.end_to_end = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"] if name in m.get("workloads", [name])]

    def reader(self, metric: str):
        """metrics/<metric>.py's `read(record)`."""
        path = BENCH / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
