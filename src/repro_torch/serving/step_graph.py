"""CUDA graphs over the fixed-shape decode steps.

Counterpart of ``decode_step_jit`` and ``spec_decode_step_jit``
(``src/repro/models/modeling.py``): JAX compiles the whole decode
iteration into one device program per shape key and donates the pool
and slot buffers to it. Here the step (``forward_decode_step`` or
``forward_spec_decode_step``) is captured as one CUDA graph per shape key
and replayed; it reads and writes the engine's static buffers (tokens,
positions, mask, block table, caps), the pool and the slot state, all at
fixed addresses, and writes its new tokens and positions back into the
static buffers inside the graph, the counterpart of donation.

The first step at a new key is the warm-up PyTorch asks for: a real step
with its real effects, run eagerly on a side stream. The graph is
captured right after it, which executes nothing, and every later step at
that key replays it. No step is repeated, so no state is snapshotted. An
engine's graphs share one memory pool. There is no way around the graph
on the card: a failed capture or replay raises.

A replay makes no Python call into the kernel wrappers, so their launch
counters would not see it: the capture records the counters' growth
(which it takes back, since capturing launched nothing) and every replay
adds it again.

``decode_step_cache_size()`` and ``spec_decode_step_cache_size()`` count
the distinct shape keys the engines have stepped, on every device (a CPU
step runs eagerly, but is counted), so the CPU tests hold them to JAX's
compile counts. ``captures`` and ``capture_s`` add up every engine's
captures and their wall.

``eager_twin(engine)`` is the reference of a replay: the same step run
eagerly on clones of the engine's step inputs.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Hashable, Set

import torch

from repro_torch.kernels import (flash_prefill, flash_prefill_bwd,
                                 grouped_mm, kv_gather, kv_scatter,
                                 paged_attention)
from repro_torch.models.modeling import (forward_decode_step,
                                         forward_spec_decode_step)
from repro_torch.models.params import tree_map

# the launch counters of the kernel wrappers: (module, attribute)
COUNTERS = ((kv_gather, "launches"), (kv_scatter, "launches"),
            (paged_attention, "launches"), (flash_prefill, "launches"),
            (flash_prefill, "noncausal_launches"),
            (flash_prefill, "window_launches"),
            (flash_prefill_bwd, "launches"), (grouped_mm, "launches"),
            (grouped_mm, "dx_launches"), (grouped_mm, "dw_launches"))

# the shape keys the engines have stepped (each engine adds its own)
decode_keys: Set[Hashable] = set()
spec_keys: Set[Hashable] = set()
captures = 0          # graphs captured by every engine
capture_s = 0.0       # their wall
# one warm-up stream per device for every engine: cuBLAS keeps a
# workspace for each stream it has run on, for the life of the process
_side: Dict[int, torch.cuda.Stream] = {}


def decode_step_cache_size() -> int:
    """Distinct shape keys of the fused decode step stepped so far (the
    retrace-count guard in tests asserts deltas on this)."""
    return len(decode_keys)


def spec_decode_step_cache_size() -> int:
    """Distinct shape keys of the speculative step stepped so far."""
    return len(spec_keys)


def _read_counters() -> tuple:
    return tuple(getattr(m, a) for m, a in COUNTERS)


def _add_counters(delta: tuple) -> None:
    for (m, a), d in zip(COUNTERS, delta):
        setattr(m, a, getattr(m, a) + d)


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor          # the step's output, rewritten by each replay
    launches: tuple            # counter growth of one step


class StepGraphs:
    """One engine's captured steps, keyed by shape. ``run(key, fn)``
    steps once: ``fn()`` runs the step against the engine's static
    buffers and returns its output tensor (the caller's one host
    transfer)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.on_card = device.type == "cuda"
        self._pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self._graphs: Dict[Hashable, _Captured] = {}
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0      # wall of all captures (warm-ups apart)
        self.pool_bytes = 0       # memory the captures reserved

    def run(self, key: Hashable,
            fn: Callable[[], torch.Tensor]) -> torch.Tensor:
        if not self.on_card:
            return fn()
        got = self._graphs.get(key)
        if got is not None:
            got.graph.replay()
            _add_counters(got.launches)
            self.replays += 1
            return got.out
        main = torch.cuda.current_stream(self.device)
        idx = torch.device(self.device).index
        idx = torch.cuda.current_device() if idx is None else idx
        side = _side.get(idx)
        if side is None:
            side = _side[idx] = torch.cuda.Stream(idx)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()                      # the warm-up: a real step
        main.wait_stream(side)
        self._capture(key, fn)
        return out

    def _capture(self, key: Hashable, fn: Callable[[], torch.Tensor]):
        global captures, capture_s
        before = _read_counters()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()      # as the capture does, before reading
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        wall = time.perf_counter() - t0
        self.capture_s += wall
        capture_s += wall
        captures += 1
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        after = _read_counters()
        _add_counters(tuple(b - a for a, b in zip(after, before)))
        self._graphs[key] = _Captured(
            graph, out, tuple(a - b for a, b in zip(after, before)))
        self.captures += 1


def eager_twin(engine) -> Callable[[], Dict[str, object]]:
    """An eager double of ``engine``'s next fused or speculative step,
    over clones of its step inputs taken now (the static buffers, the
    pool with its drop block, the slot states and the draft's pool).
    Each call runs the step once, with no graph, on the clones, advances
    them as the engine's step advances its own, and returns them:
    {"out", "tokens", "pos", "storage" (the pool's own blocks),
    "slot_layers"[, "d_storage", "d_slot_layers"]}. Its first call is
    what the engine's next step must equal bit for bit; later calls run
    the eager step again at the same shapes. The engine is not touched."""
    e = engine
    if e._dirty:
        e._sync_device()
    st = e.pool.full_storage.clone()
    toks, pos = e._tokens.clone(), e._pos.clone()
    sl = tree_map(lambda x: x.clone(), e._slot_layers)
    table, bs = e._table, e.pool.block_size
    twin = {"storage": st[:, :-1], "slot_layers": sl}
    if e.spec is not None:
        d_st = e._d_storage.clone()
        d_sl = tree_map(lambda x: x.clone(), e._d_slot_layers)
        twin.update(d_storage=d_st[:, :-1], d_slot_layers=d_sl)

    def step() -> Dict[str, object]:
        if e.spec is None:
            out, t2, p2, _, _ = forward_decode_step(
                e.cfg, e.params, st, table, toks, pos, e._active, sl,
                block_size=bs)
        else:
            out, t2, p2, _, _, _, _ = forward_spec_decode_step(
                e.cfg, e.spec.draft_cfg, e.params, e.spec.draft_params, st,
                d_st, table, toks, pos, e._active, e._caps_dev, sl, d_sl,
                block_size=bs, k=e.spec.k)
        toks.copy_(t2)
        pos.copy_(p2)
        return dict(twin, out=out, tokens=toks, pos=pos)
    return step
