"""Flop and byte counts of a step, traced on the ``meta`` device.

Counterpart of ``src/repro/launch/hlo_cost.py``. JAX counts a compiled
per-device HLO program; the port has no compiler, so it runs the step
eagerly on tensors on ``meta`` (shapes, no storage, nothing computed)
and counts what each op would do:

  * matmul flops: ``torch.utils.flop_counter`` (2 * |out| * contraction
    for every matmul and einsum, the count of JAX's ``_dot_flops``);
  * bytes: operand + output bytes of every aten op (JAX's convention),
    views and empty allocations excepted, as they move nothing;
  * each hand-written kernel (``kernels/ops.py`` routes a meta tensor
    here) is charged its own work, by the formulas of PERF.md's bounds:
    flash prefill 4 * hd flops a live (query, key) pair and head (the
    causal, window or full pairs of its mask; every query row counted
    real, as a meta tensor holds no ``q_valid``), its backward 2.5 times
    that, paged attention every table slot live, the copies twice their
    bytes, the grouped product of sorted MoE dispatch 2 * M * K * N
    flops (every row through one expert) and the weights of min(E, M)
    experts (a meta tensor holds no routing: at most that many are
    touched), its weight gradient every expert's gradient written, the
    skinny product 2 * M * K * N flops and its operands' bytes; each
    returns an empty output of the right shape;
  * peak bytes: the most bytes of tensors the step itself made that are
    alive at once (its arguments not included), from the lifetimes of
    their storages;
  * the collective term is not counted (None): the port runs no
    multi-card step from which to count it.

The counts are of the whole (unsharded) step; the planner divides them
by the number of cards.
"""
from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

COLL_NOTE = ("not counted: the port runs no multi-card step, so there is "
             "no collective to count")
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh"}


@dataclass
class Cost:
    matmul_flops: float = 0.0
    kernel_flops: float = 0.0
    bytes: float = 0.0            # aten ops and kernels
    kernel_bytes: float = 0.0
    peak_bytes: float = 0.0
    kernels: Dict[str, Dict[str, float]] = field(default_factory=dict)
    coll_bytes: Optional[float] = None
    coll_note: str = COLL_NOTE

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.kernel_flops

    def _charge(self, name: str, flops: float, nbytes: float) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        self.kernel_flops += flops
        self.kernel_bytes += nbytes
        self.bytes += nbytes


_tls = threading.local()


def _nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def attention_pairs(b: int, s: int, sk: int, q_offset: int, pfx: int,
                    causal: bool, window: Optional[int]) -> int:
    """Live (query, key) pairs of flash prefill's mask per head, every
    query row real: non-causal every key; causal the real keys at or
    before each query's position q_offset + i (the real prefix, then the
    suffix), under a window only the last ``window`` of them."""
    if not causal:
        return b * s * sk
    o = q_offset
    if window is None or window >= o + s:
        return b * (s * o + s * (s + 1) // 2)
    n1 = max(0, min(s, window - o))     # rows i with o + i + 1 <= window
    return b * (n1 * o + n1 * (n1 + 1) // 2 + (s - n1) * window)


def charge_kernel(name: str, *args, **kw):
    """Charge one hand-written kernel call on meta tensors to the active
    count and return its empty output(s). Raises outside ``count``: a
    meta tensor runs nothing, on a kernel or on a plain version."""
    cost = getattr(_tls, "cost", None)
    if cost is None:
        raise ValueError(f"a meta tensor reached the {name} kernel outside "
                         f"launch.cost.count: meta tensors only count")
    if name == "flash_prefill":
        q, k, v = args
        b, s, nq, hd = q.shape
        sk = k.shape[1]
        q_offset = kw.get("q_offset", 0)
        if isinstance(q_offset, torch.Tensor):
            # a device prefix length has no value on meta: charge the
            # most it can be, the whole padded prefix
            q_offset = int(kw.get("prefix_pad", 0)) or sk - s
        q_offset = int(q_offset)
        pfx = int(kw.get("prefix_pad", 0)) or q_offset
        pairs = attention_pairs(b, s, sk, q_offset, pfx,
                                kw.get("causal", True), kw.get("window"))
        out = torch.empty_like(q)
        lse = torch.empty((b, nq, s), dtype=torch.float32, device="meta") \
            if kw.get("return_lse") else None
        cost._charge(name, 4.0 * pairs * nq * hd,
                     _nb(q, k, v, out, lse, kw.get("q_valid")))
        return (out, lse) if kw.get("return_lse") else out
    if name == "flash_prefill_bwd":
        # the five products (2.5x the forward) on the mode's live pairs:
        # causal s x s, non-causal s x sk; q, o, do, dq at s and k, v,
        # dk, dv at sk, each moved once
        q, k, v, o, lse, do = args
        b, s, nq, hd = q.shape
        pairs = attention_pairs(b, s, k.shape[1], 0, 0,
                                kw.get("causal", True), None)
        cost._charge(name, 2.5 * 4.0 * pairs * nq * hd,
                     4 * _nb(q) + 4 * _nb(k) + _nb(lse))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if name in ("kv_gather", "kv_scatter"):
        storage, idx = args[0], args[-1]
        L, _, bs, w = storage.shape
        moved = L * idx.shape[0] * bs * w * storage.element_size()
        cost._charge(name, 0.0, 2 * moved + _nb(idx))
        if name == "kv_scatter":
            return storage
        return torch.empty((L, idx.shape[0] * bs, w), dtype=storage.dtype,
                           device="meta")
    if name == "paged_attention":
        q, pages, bt, lens = args
        B, nq, hd = q.shape
        live = bt.numel() * pages.shape[1]     # every table slot live
        cost._charge(name, 4.0 * live * nq * hd,
                     2 * _nb(q) + live * pages.shape[2]
                     * pages.element_size() + _nb(bt, lens))
        return torch.empty_like(q)
    if name == "grouped_mm":
        x, w, offsets = args
        M, K = x.shape
        E = w.shape[0]
        N = w.shape[1] if kw.get("trans") else w.shape[2]
        out = torch.empty((M, N), dtype=x.dtype, device="meta")
        cost._charge(name, 2.0 * M * K * N,
                     _nb(x, out, offsets) + min(E, M) * K * N
                     * w.element_size())
        return out
    if name == "grouped_mm_dw":
        x, dy, offsets, E = args
        M, K = x.shape
        N = dy.shape[1]
        out = torch.empty((E, K, N), dtype=x.dtype, device="meta")
        cost._charge(name, 2.0 * M * K * N, _nb(x, dy, offsets, out))
        return out
    if name == "skinny_mm":
        x, w = args
        K, N = w.shape
        out = torch.empty(x.shape[:-1] + (N,), dtype=x.dtype, device="meta")
        cost._charge(name, 2.0 * (x.numel() // K) * K * N, _nb(x, w, out))
        return out
    raise ValueError(f"no cost formula for kernel {name}")


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


class _Counter(TorchDispatchMode):
    """Operand + output bytes of every aten op, and the live bytes of
    the storages the step makes."""

    def __init__(self, cost: Cost, args):
        super().__init__()
        self.cost = cost
        self.live: Dict[int, weakref.finalize] = {}
        self.cur = 0
        # the arguments' storages (and views of them) are not the step's
        self.known = {t.untyped_storage()._cdata for t in _tensors(args)}

    def _gone(self, key: int, n: int) -> None:
        self.live.pop(key, None)
        self.cur -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view and \
                func.overloadpacket.__name__ not in _NO_BYTES:
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            self.cost.bytes += _nb(*ins) + _nb(*outs)
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.live and key not in self.known:
                n = st.nbytes()
                self.live[key] = weakref.finalize(st, self._gone, key, n)
                self.cur += n
                self.cost.peak_bytes = max(self.cost.peak_bytes, self.cur)
        return out


def count(step, *args) -> Cost:
    """Run ``step(*args)`` on meta tensors and count its work."""
    if getattr(_tls, "cost", None) is not None:
        raise RuntimeError("launch.cost.count does not nest")
    cost = Cost()
    _tls.cost = cost
    flops = FlopCounterMode(display=False)
    try:
        with flops, _Counter(cost, args) as counter:
            out = step(*args)
            del out
        for fin in list(counter.live.values()):
            fin.detach()
    finally:
        _tls.cost = None
    cost.matmul_flops = float(flops.get_total_flops())
    return cost
