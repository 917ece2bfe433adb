"""The benchmark's description, read from files by name.

`BENCHMARK.json` (the repository root) lists configurations, cells and
metrics. A cell's files: its configuration's `file`, its traffic mix
`benchmark/traffic/<traffic>.json` (whose `kind` names the driver
`benchmark/drivers/<kind>.py`), the limits of its comparison
`benchmark/limits/<cell>.json`, and for each per-layer metric the reader
`benchmark/metrics/<metric>.py`. A new configuration, mix, cell or metric
is new files and new entries; no file that exists changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, root: str = ROOT) -> Cell:
    """The cell's description from the files of the checkout at `root`."""
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    here = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no cell {cell_name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=cell_name, chips=int(w["chips"]), config_name=conf["name"],
        config=_load(os.path.join(root, conf["file"])), traffic_name=w["traffic"],
        traffic=_load(os.path.join(here, "traffic", f"{w['traffic']}.json")),
        limits=_load(os.path.join(here, "limits", f"{cell_name}.json")),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)], root=root,
    )


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The driver module of a traffic kind (benchmark/drivers/<kind>.py),
    imported by name so that its rank processes can import it too."""
    return importlib.import_module(f"benchmark.drivers.{kind}")


def readers(cell: Cell) -> Dict[str, Callable]:
    """{metric name: read(reading) -> value or None} of the cell's per-layer
    metrics (benchmark/metrics/<name>.py)."""
    out = {}
    for m in cell.per_layer:
        mod = _module(os.path.join(cell.root, "benchmark", "metrics", f"{m['name']}.py"), "benchmark_metric_" + m["name"].replace(".", "_"))
        out[m["name"]] = mod.read
    return out
