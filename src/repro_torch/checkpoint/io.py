"""Checkpoints in the JAX package's format: one ``.npz`` of the param
leaves keyed by their ``"::"``-joined tree paths, and a
``<path>.manifest.json`` with the step, each leaf's shape and dtype, and
free-form meta.

Counterpart of ``src/repro/checkpoint/io.py``: a checkpoint written by
either package loads in the other (leaves equal). The port's trees are
nested dicts, so a path is its keys, in JAX's flattening order (sorted).
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import _leaf_paths, _set, params_to_numpy

SEP = "::"
Tree = Dict[str, Any]


def save_params(path: str, params: Tree, step: int = 0,
                meta: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {SEP.join(p): x
            for p, x in _leaf_paths(params_to_numpy(params))}
    np.savez(path, **flat)
    manifest = {
        "step": step,
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
        "meta": meta or {},
    }
    with open(path + ".manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)


def load_params(path: str, like: Tree, device: DeviceLike = "cuda") -> Tree:
    """The leaves of ``like``'s tree (its structure only) read from the
    checkpoint at ``path``, as tensors on ``device``."""
    dev = resolve_device(device)
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    out: Tree = {}
    for p, _ in _leaf_paths(like):
        _set(out, p, torch.from_numpy(data[SEP.join(p)]).to(dev))
    return out
