"""Prefix-aware KVCache registry with an HBM budget (paper §2.2.1).

Each prefill instance holds prefix KVCaches in HBM next to the weights.
A mixed pool must cache every scenario's prefixes and thrashes; a
fine-grained P/D group serves one scenario and keeps its prefixes hot —
this is the mechanism behind the paper's E2E gain (Fig. 1b).

The registry is a token-level radix-ish structure simplified to
(prefix_id -> cached length), since the synthetic workload shares exact
prefixes. It is SIMULATOR-side placement accounting only (consumed by
repro_torch.core.cluster_sim); the real serving data path has its own
block-level implementation — the refcounted radix trie inside
``repro_torch.serving.kvcache.PagedKVPool`` (shared blocks, COW tail, LRU
eviction) feeding ``PrefillEngine.run_suffix`` suffix-only prefill.
Copied from ``src/repro/core/prefix_cache.py``.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass


@dataclass
class PrefixEntry:
    prefix_id: str
    tokens: int
    nbytes: int
    hits: int = 0
    # recurrent-state snapshot bytes riding with the entry (SSM/hybrid
    # scenarios): budgeted, inserted, and evicted in lockstep with the
    # KV bytes — the placement-accounting twin of PagedKVPool._snaps
    state_nbytes: int = 0


class PrefixCache:
    """LRU prefix-KVCache placement under an HBM byte budget."""

    def __init__(self, budget_bytes: int, kv_bytes_per_token: int,
                 state_bytes_per_prefix: int = 0):
        self.budget = int(budget_bytes)
        self.kv_bpt = int(kv_bytes_per_token)
        self.state_bpp = int(state_bytes_per_prefix)
        self._entries: "OrderedDict[str, PrefixEntry]" = OrderedDict()
        self.used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.state_bytes = 0        # resident snapshot bytes (lockstep)

    # ------------------------------------------------------------ queries
    def lookup(self, prefix_id: str, prefix_len: int) -> int:
        """Returns cached token count (0 = miss). Marks recency."""
        e = self._entries.get(prefix_id)
        if e is None or e.tokens < prefix_len:
            self.misses += 1
            return e.tokens if e else 0
        self._entries.move_to_end(prefix_id)
        e.hits += 1
        self.hits += 1
        return prefix_len

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    # ------------------------------------------------------------ updates
    def insert(self, prefix_id: str, prefix_len: int) -> bool:
        """Cache a prefix after computing it; evicts LRU entries as needed.
        Returns False if it can never fit. A snapshot payload
        (``state_bytes_per_prefix``) is budgeted with the KV bytes and
        dies with the entry — it never outlives its prefix."""
        nbytes = prefix_len * self.kv_bpt + self.state_bpp
        if nbytes > self.budget:
            return False
        old = self._entries.pop(prefix_id, None)
        if old is not None:
            self.used -= old.nbytes
            self.state_bytes -= old.state_nbytes
        while self.used + nbytes > self.budget and self._entries:
            _, ev = self._entries.popitem(last=False)
            self.used -= ev.nbytes
            self.state_bytes -= ev.state_nbytes
            self.evictions += 1
        e = PrefixEntry(prefix_id, prefix_len, nbytes,
                        hits=old.hits if old else 0,
                        state_nbytes=self.state_bpp)
        self._entries[prefix_id] = e
        self.used += nbytes
        self.state_bytes += self.state_bpp
        return True

    def drop(self, prefix_id: str):
        e = self._entries.pop(prefix_id, None)
        if e is not None:
            self.used -= e.nbytes
            self.state_bytes -= e.state_nbytes

    def __contains__(self, prefix_id: str) -> bool:
        return prefix_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    def invariant_ok(self) -> bool:
        return (self.used == sum(e.nbytes for e in self._entries.values())
                and self.state_bytes == sum(e.state_nbytes
                                            for e in self._entries.values())
                and self.used <= self.budget)


class TieredPrefixCache:
    """HBM + host-memory prefix pool (paper §6.2, multi-turn extension).

    HBM hits are free; host hits pay a load penalty (PCIe/DMA) but beat
    recomputing the prefix; evictions from HBM spill to the host tier.
    Fine-grained P/D groups raise BOTH tiers' hit rates (scenario
    affinity), which is why the pool is per-group.
    """

    def __init__(self, hbm_budget: int, host_budget: int,
                 kv_bytes_per_token: int, *,
                 host_load_bw: float = 20e9):
        self.hbm = PrefixCache(hbm_budget, kv_bytes_per_token)
        self.host = PrefixCache(host_budget, kv_bytes_per_token)
        self.kv_bpt = kv_bytes_per_token
        self.host_load_bw = host_load_bw
        self.host_hits = 0

    def lookup(self, prefix_id: str, prefix_len: int
               ) -> "tuple[int, float]":
        """Returns (cached_tokens, load_seconds)."""
        got = self.hbm.lookup(prefix_id, prefix_len)
        if got >= prefix_len:
            return got, 0.0
        got_host = self.host.lookup(prefix_id, prefix_len)
        if got_host >= prefix_len:
            self.host_hits += 1
            load = prefix_len * self.kv_bpt / self.host_load_bw
            self._promote(prefix_id, prefix_len)
            return got_host, load
        return max(got, got_host), 0.0

    def insert(self, prefix_id: str, prefix_len: int):
        # track HBM evictions so they spill to host instead of vanishing
        before = {pid: e.tokens for pid, e in self.hbm._entries.items()}
        self.hbm.insert(prefix_id, prefix_len)
        for pid, tokens in before.items():
            if pid not in self.hbm and pid != prefix_id:
                self.host.insert(pid, tokens)

    def _promote(self, prefix_id: str, prefix_len: int):
        self.insert(prefix_id, prefix_len)

    def invariant_ok(self) -> bool:
        return self.hbm.invariant_ok() and self.host.invariant_ok()
