"""Weights drawn from the seed, on the device, in the type they are
served in (float32), by the benchmark's own generator.

Every matrix is a view into one flat buffer filled by a few large
``randn`` calls and scaled by 0.02; the norm gains are ones. The tree is
laid out as the port takes its params (one stacked tensor per leaf, the
layers on the leading axis), and the plain reference reads the same
tensors: both sides get the same numbers and neither derives them from
the other.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from pdbench import spec

SCALE = 0.02
CHUNK = 1 << 30          # elements a randn call fills
ALIGN = 64               # elements between leaves (256-byte aligned)


def layout(c: dict) -> List[Tuple[Tuple[str, ...], Tuple[int, ...], str]]:
    """(path, shape, init) of every leaf, init "normal" or "ones", as the
    configuration's reference module lays them out."""
    return spec.reference(c).layout(c)


def make(c: dict, seed: int, device) -> Dict:
    """The weight tree of configuration ``c`` drawn from ``seed``."""
    dev = torch.device(device)
    leaves = layout(c)
    offs, n = [], 0
    for _, shape, init in leaves:
        if init == "normal":
            offs.append(n)
            n += -(-math.prod(shape) // ALIGN) * ALIGN
        else:
            offs.append(None)
    flat = torch.empty(n, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    for a in range(0, n, CHUNK):
        flat[a:a + CHUNK].normal_(generator=gen).mul_(SCALE)
    tree: Dict = {}
    for (path, shape, init), off in zip(leaves, offs):
        if init == "normal":
            x = flat[off:off + math.prod(shape)].view(shape)
        else:
            x = torch.ones(shape, dtype=torch.float32, device=dev)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = x
    return tree
