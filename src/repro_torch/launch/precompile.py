"""Pre-built artifact store (paper §3.2: "Pre-compiled Model Loaded in
Minutes"): an instance starts without compiling.

Counterpart of ``src/repro/launch/precompile.py``. What JAX compiles per
step is an XLA executable; what the port compiles is its kernel library
(``nvcc``, ``kernels/build.py``). So the store keeps, per key, the
library built from this checkout's sources and a JSON manifest with
JAX's fields (key, arch, kind, seq_len, global_batch, compile_s,
size_bytes) plus the sources' hash. An instance ``load``s the library
with no ``nvcc`` and gets its step; a first run of that step on real
inputs (``warm_up``) records ``warmup_s``, the rest of what a cold start
costs (allocator, cuBLAS handles and plans). On the card that first run
of the serve step is also where the instance captures it as a CUDA graph
(``models/steps.py``), the counterpart of loading JAX's compiled serve
executable: ``capture_s`` records the capture's wall beside
``warmup_s`` (0 for a step that captures nothing: prefill, train, a CPU
run).
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models.config import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.models.steps import (decode_window, make_prefill_step,
                                      make_serve_step, make_train_step)
from repro_torch.serving import step_graph


def _step_for(cfg: ModelConfig, shape: ShapeConfig):
    if shape.kind == "train":
        return make_train_step(cfg)
    if shape.kind == "prefill":
        return make_prefill_step(cfg)
    return make_serve_step(cfg, window=decode_window(cfg, shape))


class ArtifactStore:
    """File-backed store of built kernel libraries, one per key."""

    def __init__(self, root):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _paths(self, key: str) -> Tuple[Path, Path]:
        base = str(self.root / key.replace("/", "_"))
        return Path(base + ".so"), Path(base + ".manifest.json")

    def precompile(self, key: str, cfg: ModelConfig,
                   shape: ShapeConfig) -> Dict:
        """Build the kernel library (every kernel the step may launch)
        into the store under ``key``; returns the manifest."""
        lib, man = self._paths(key)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=self.root) as tmp:
            info = build.build(Path(tmp))
            os.replace(info.path, lib)
        manifest = {
            "key": key, "arch": cfg.name, "kind": shape.kind,
            "shape": shape.name, "seq_len": shape.seq_len,
            "global_batch": shape.global_batch,
            "compile_s": time.perf_counter() - t0,
            "size_bytes": lib.stat().st_size,
            "source_hash": build.source_hash(),
        }
        man.write_text(json.dumps(manifest, indent=1))
        return manifest

    def load(self, key: str):
        """Instance-side load: the stored library bound with no ``nvcc``,
        and the key's step. Returns (step, manifest) with ``load_s``."""
        lib, man = self._paths(key)
        manifest = json.loads(man.read_text())
        if manifest["source_hash"] != build.source_hash():
            raise RuntimeError(
                f"artifact {key!r} was built from other kernel sources "
                f"({manifest['source_hash']}, this checkout "
                f"{build.source_hash()}): precompile it again")
        t0 = time.perf_counter()
        build.load_library(lib)
        cfg = get_config(manifest["arch"])
        step = _step_for(cfg, INPUT_SHAPES[manifest["shape"]])
        manifest["load_s"] = time.perf_counter() - t0
        return step, manifest

    def warm_up(self, key: str, step, *args):
        """Run the loaded step once on ``args`` (the key's shape), wait
        for the card, and record ``warmup_s`` and ``capture_s`` (the wall
        of the CUDA-graph captures this run made) in the manifest.
        Returns the step's output."""
        _, man = self._paths(key)
        before = step_graph.capture_s
        t0 = time.perf_counter()
        out = step(*args)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        manifest = json.loads(man.read_text())
        manifest["warmup_s"] = time.perf_counter() - t0
        manifest["capture_s"] = step_graph.capture_s - before
        man.write_text(json.dumps(manifest, indent=1))
        return out

    def available(self) -> List[str]:
        return sorted(json.loads(f.read_text())["key"]
                      for f in self.root.glob("*.manifest.json"))
