"""Find a cell's pieces by name: the manifest (``BENCHMARK.json``), the
configuration file it names, the traffic file ``traffic/<traffic>.json``
and one reader ``metrics/<metric>.py`` per per-layer metric.  Adding a
configuration, a traffic mix or a metric is adding files and entries;
nothing here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: Optional[str]
    moves: Optional[str]
    workloads: Optional[List[str]]
    read: Optional[Callable] = None

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _metric(m: dict) -> Metric:
    return Metric(m["name"], m["unit"], m["better"], m["source"],
                  m.get("layer"), m.get("moves"), m.get("workloads"))


def load_reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(record) -> number or None`` of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"_bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def load_cell(name: str, root: str = ROOT,
              manifest: Optional[dict] = None) -> Cell:
    """The cell ``name`` of the manifest with its configuration, traffic
    and the metrics it reports (per-layer ones with their readers)."""
    man = manifest if manifest is not None else load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    cfgs = {c["name"]: c for c in man["configs"]}
    c = cfgs[w["config"]]
    with open(os.path.join(root, c["file"])) as f:
        config = json.load(f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"{w['traffic']}.json")) as f:
        traffic = json.load(f)
    e2e = [m for m in map(_metric, man["end_to_end"]) if m.applies(name)]
    layer = [m for m in map(_metric, man["per_layer"]) if m.applies(name)]
    bench_dir = os.path.join(root, "benchmark")
    for m in layer:
        m.read = load_reader(m.name, bench_dir)
    return Cell(name, int(w["chips"]), config, traffic, e2e, layer)


def read_metrics(metrics: List[Metric], record: dict) -> Dict[str, dict]:
    """Each reader's value on ``record``; a reader that finds nothing
    (None) leaves its metric out."""
    out = {}
    for m in metrics:
        v = m.read(record)
        if v is not None:
            out[m.name] = {"value": v, "unit": m.unit}
    return out
