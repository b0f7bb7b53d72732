"""Find a cell's files by the names in ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; each is a JSON file of its own (``configs/<config>.json``,
``traffic/<traffic>.json``), and each per-layer metric is a reader of its
own (``metrics/<name>.py``, a ``read(record)`` function). A configuration
names its reference module (``"reference": "<module>"``, the file
``reference/<module>.py``; ``model`` where the key is absent), which
supplies the model's equations and counts: ``layout(c)`` (the weight
leaves in draw order), ``logits(c, w, tokens, first)``,
``matmul_params_per_token(c)`` and ``attention_flops(c, pairs)``. The
port's ``ModelConfig`` is built from every key of the configuration that
names one of its fields (``driver.model_config``).

So a new architecture joins the benchmark as new files only: its
configuration file, its reference module, a traffic file if its mix is
new, a reader file for each new metric (a new kernel's operations and
bytes beside its reader), and new entries in ``BENCHMARK.json``'s
``configs``, ``workloads`` and ``per_layer``. The one change to entries
already there is appending the new cell to the ``workloads`` lists of the
metrics it reports. No file here is edited.
"""
from __future__ import annotations

import functools
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Callable, List, Optional

ROOT = Path(__file__).resolve().parents[1]


class Config(dict):
    """A configuration file as run, with the checkout root it was loaded
    from, where its reference module is found."""

    def __init__(self, data: dict, root: Path):
        super().__init__(data)
        self.root = root


def reference(c: dict) -> ModuleType:
    """The reference module that configuration ``c`` names, from the root
    it was loaded from (this checkout for a plain dict)."""
    return _load_reference(getattr(c, "root", ROOT),
                           c.get("reference", "model"))


@functools.cache
def _load_reference(root: Path, name: str) -> ModuleType:
    path = root / "pdbench" / "reference" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"pdbench_reference_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    chips: int
    config: Config          # the configuration file, as run
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
    config = Config(json.loads(cfg_file.read_text()), root)
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
