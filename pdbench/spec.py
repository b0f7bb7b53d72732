"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own (``configs/<config>.json``,
``traffic/<traffic>.json``), and each per-layer metric is a reader of its
own (``metrics/<name>.py``, a ``read(record)`` function). A later cell, mix
or metric is added as new files and entries, with no file here edited.
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file, as run
    traffic: dict           # the traffic mix file
    end_to_end: List[dict]  # BENCHMARK.json's metrics this cell reports
    per_layer: List[dict]


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_file = root / configs[w["config"]]["file"]
    config = json.loads(cfg_file.read_text())
    traffic = json.loads(
        (root / "pdbench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if _reports(m, name)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def metric_reader(name: str, root: Path = ROOT
                  ) -> Callable[[object], Optional[float]]:
    """The ``read`` function of ``metrics/<name>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = root / "pdbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pdbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
