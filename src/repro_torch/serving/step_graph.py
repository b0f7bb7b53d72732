"""CUDA graphs over the fixed-shape decode steps and prefill forwards.

Counterpart of ``decode_step_jit`` and ``spec_decode_step_jit``
(``src/repro/models/modeling.py``) and of the shared jitted prefill
``_jit_forward_prefill`` (``src/repro/serving/engine.py``): JAX compiles
the whole decode iteration into one device program per shape key and
donates the pool and slot buffers to it. Here the step
(``forward_decode_step`` or ``forward_spec_decode_step``) is captured as
one CUDA graph per shape key and replayed; it reads and writes the
engine's static buffers (tokens, positions, mask, block table, caps), the
pool and the slot state, all at fixed addresses, and writes its new
tokens and positions back into the static buffers inside the graph, the
counterpart of donation. A prefill
engine runs ``forward_prefill`` the same way, once per JAX jit key (the
config, every input shape and the static arguments), over static input
buffers the graph owns (tokens, last index, the prefix length as a 0-d
int32, the padded prefix KV, the restored SSM state, the frames), which
each replay refreshes from the call's inputs; its output tree (first
tokens, the stacked cache, pos) is rewritten by each replay, so the
engine copies what it hands out before the next.

A decode key is captured at its first step: the warm-up PyTorch asks
for is that real step with its real effects, run eagerly on a side
stream, and the graph is captured right after it, which executes
nothing. A prefill key is captured at its second forward (``capture_at``
2): a key a served engine meets once (the first batch of a fresh
engine) costs what the eager forward costs, and a key met again is
warmed up and captured then. Every later step at a key replays it. No
step is repeated, so no state is snapshotted. An engine's graphs share
one memory pool. ``budget`` bounds the bytes an engine's graphs keep
(outputs and static inputs): after a capture the least recently used
graphs are dropped, with their static inputs, until the rest fit (the
newest stays); their blocks go back to the pool for the next capture.
There is no way around the graph on the card: a failed capture or
replay raises.

A replay makes no Python call into the kernel wrappers, so their launch
counters would not see it: the capture records the counters' growth
(which it takes back, since capturing launched nothing) and every replay
adds it again.

``decode_step_cache_size()``, ``spec_decode_step_cache_size()`` and
``prefill_compile_count()`` count the distinct shape keys the engines
have stepped or prefilled, on every device (a CPU step or prefill runs
eagerly, but is counted), so the CPU tests hold them to JAX's compile
counts. ``captures`` and ``capture_s`` add up every engine's captures and
their wall.

``eager_twin(engine)`` is the reference of a replay: the same step run
eagerly on clones of the engine's step inputs.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, Optional, Set

import torch

from repro_torch.kernels import (flash_prefill, flash_prefill_bwd,
                                 grouped_mm, kv_gather, kv_scatter,
                                 paged_attention, skinny_mm)
from repro_torch.models.modeling import (forward_decode_step,
                                         forward_spec_decode_step)
from repro_torch.models.params import tree_leaves, tree_map

# the launch counters of the kernel wrappers: (module, attribute)
COUNTERS = ((kv_gather, "launches"), (kv_scatter, "launches"),
            (paged_attention, "launches"), (flash_prefill, "launches"),
            (flash_prefill, "noncausal_launches"),
            (flash_prefill, "window_launches"),
            (flash_prefill_bwd, "launches"),
            (flash_prefill_bwd, "noncausal_launches"),
            (grouped_mm, "launches"), (grouped_mm, "dx_launches"),
            (grouped_mm, "dw_launches"), (skinny_mm, "launches"))

# the shape keys the engines have stepped (each engine adds its own)
decode_keys: Set[Hashable] = set()
spec_keys: Set[Hashable] = set()
prefill_keys: Set[Hashable] = set()
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


def prefill_compile_count() -> int:
    """Distinct keys of the graphed prefill forward run so far, JAX's
    ``prefill_compile_count`` (the retrace-count guard under ragged
    traffic asserts deltas on this)."""
    return len(prefill_keys)


def _read_counters() -> tuple:
    return tuple(getattr(m, a) for m, a in COUNTERS)


def _add_counters(delta: tuple) -> None:
    for (m, a), d in zip(COUNTERS, delta):
        setattr(m, a, getattr(m, a) + d)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@dataclass
class _Captured:
    graph: torch.cuda.CUDAGraph
    out: Any                   # the step's output (a tensor or a tree),
                               # rewritten by each replay
    launches: tuple            # counter growth of one step
    inputs: Any                # the static input buffers, or None
    nbytes: int                # what it keeps: outputs and inputs


class StepGraphs:
    """One engine's captured steps, keyed by shape. ``run(key, fn)``
    steps once: ``fn()`` runs the step against the engine's static
    buffers and returns its output, a tensor or a dict tree of tensors
    (the caller copies or reads it before the next run at that key).
    ``run(key, fn, inputs)`` runs ``fn(inputs)`` instead, where
    ``inputs`` is a tree of tensors on any device: eagerly over them
    moved to the card, and in a graph over static buffers of the key's
    own that each replay refreshes from them. A key is captured at its
    ``capture_at``-th step; ``budget`` (bytes, or None) bounds what the
    graphs keep (see the module docstring)."""

    def __init__(self, device: torch.device, *, capture_at: int = 1,
                 budget: Optional[int] = None):
        self.device = device
        self.on_card = device.type == "cuda"
        self.capture_at = capture_at
        self.budget = budget
        self._pool = torch.cuda.graph_pool_handle() if self.on_card else None
        # least recently run first
        self._graphs: "OrderedDict[Hashable, _Captured]" = OrderedDict()
        self._met: Dict[Hashable, int] = {}   # steps at keys not captured
        self.captures = 0
        self.replays = 0
        self.evictions = 0
        self.capture_s = 0.0      # wall of all captures (warm-ups apart)
        self.pool_bytes = 0       # memory the captures reserved
        self.held_bytes = 0       # what the live graphs keep: outputs and
                                  # static inputs

    def run(self, key: Hashable, fn: Callable[..., Any],
            inputs: Any = None) -> Any:
        args = () if inputs is None else (inputs,)
        if not self.on_card:
            return fn(*args)
        got = self._graphs.get(key)
        if got is not None:
            if inputs is not None:
                for d, x in zip(tree_leaves(got.inputs), tree_leaves(inputs)):
                    d.copy_(x)
            got.graph.replay()
            _add_counters(got.launches)
            self._graphs.move_to_end(key)
            self.replays += 1
            return got.out
        met = self._met[key] = self._met.get(key, 0) + 1
        if inputs is not None:
            args = (tree_map(lambda t: t.to(self.device), inputs),)
        if met < self.capture_at:
            return fn(*args)                # eager, on the caller's stream
        static = None
        if inputs is not None:
            static = tree_map(lambda t: torch.empty(
                t.shape, dtype=t.dtype, device=self.device), inputs)
            for d, x in zip(tree_leaves(static), tree_leaves(args[0])):
                d.copy_(x)
            args = (static,)
        main = torch.cuda.current_stream(self.device)
        idx = torch.device(self.device).index
        idx = torch.cuda.current_device() if idx is None else idx
        side = _side.get(idx)
        if side is None:
            side = _side[idx] = torch.cuda.Stream(idx)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn(*args)                 # the warm-up: a real step
        main.wait_stream(side)
        self._capture(key, lambda: fn(*args), static)
        del self._met[key]
        self._evict()
        return out

    def _capture(self, key: Hashable, fn: Callable[[], Any], static: Any):
        global captures, capture_s
        before = _read_counters()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()      # as the capture does, before reading
        reserved = torch.cuda.memory_reserved(self.device)
        allocated = torch.cuda.memory_allocated(self.device)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            out = fn()
        wall = time.perf_counter() - t0
        self.capture_s += wall
        capture_s += wall
        captures += 1
        self.pool_bytes += torch.cuda.memory_reserved(self.device) - reserved
        nbytes = torch.cuda.memory_allocated(self.device) - allocated
        if static is not None:
            nbytes += _nbytes(static)
        self.held_bytes += nbytes
        after = _read_counters()
        _add_counters(tuple(b - a for a, b in zip(after, before)))
        self._graphs[key] = _Captured(
            graph, out, tuple(a - b for a, b in zip(after, before)), static,
            nbytes)
        self.captures += 1

    def _evict(self) -> None:
        """Drop the least recently run graphs until the rest fit the
        budget; the newest stays."""
        while self.budget is not None and self.held_bytes > self.budget \
                and len(self._graphs) > 1:
            _, old = self._graphs.popitem(last=False)
            self.held_bytes -= old.nbytes
            self.evictions += 1


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
