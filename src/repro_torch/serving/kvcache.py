"""Paged KV pool (PageAttention-style, paper §2.2.3) with block-level
prefix reuse (paper §2.2.1), on torch storage.

Counterpart of ``src/repro/serving/kvcache.py``: the allocator, the radix
trie, refcounts, copy-on-write tails and LRU eviction are carried over
unchanged. The storage is one torch tensor (layers, num_blocks,
block_size, 2 * kv_dim), K and V packed, that lives on ``device`` and is
updated IN PLACE (the JAX pool swapped in a new array per update); its
``data_ptr()`` never changes. One more block, the DROP block at index
``num_blocks``, follows the pool's blocks in memory: the fused decode
steps write every slot's row on every step and send the rows they must
not keep there (JAX sends them past the pool and drops them with
``mode="drop"``; on the card an out-of-range write is a device assert).
The allocator never hands it out and no block table names it, so nothing
reads it. ``storage`` is the (layers, num_blocks, ...) view of the pool's
own blocks; ``full_storage`` the tensor with the drop block, which only
the decode steps take. The gather (blocks -> contiguous) and
scatter (contiguous -> blocks) paths go through ``kernels.ops``: the
CUDA kernels on the card, their plain versions on the CPU. Everything
read out of the pool is a copy, never a view, so nothing held across a
later pool update can change under its holder.

``storage_writes`` counts engine-issued pool updates (``set_storage``),
as in the JAX pool. Recurrent-state snapshots of SSM/hybrid families are
pinned to the cached block that ends at their boundary and evicted with
it; attention-free pools have width 0, and their blocks are only the
trie's key holders.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig


class PoolExhausted(RuntimeError):
    pass


class _PrefixNode:
    """One cached block in the radix trie. ``key`` is the exact token-id
    chunk the block holds (len < block_size == partial tail leaf)."""

    __slots__ = ("key", "block", "parent", "children", "last_use")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_PrefixNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PrefixNode"] = {}
        self.last_use = 0


class PagedKVPool:
    def __init__(self, cfg: ModelConfig, *, num_blocks: int,
                 block_size: int = 16, dtype: torch.dtype = torch.float32,
                 enable_prefix_cache: bool = False,
                 device: DeviceLike = "cuda"):
        self.cfg = cfg
        self.block_size = block_size
        self.num_blocks = num_blocks
        self.width = 2 * cfg.kv_dim                  # K ++ V
        self.layers = cfg.num_layers if not cfg.attn_free else 0
        n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
        self.attn_layers = n_attn
        self.dtype = dtype
        self.device = resolve_device(device)
        self.full_storage = torch.zeros(
            (max(n_attn, 1), num_blocks + 1, block_size, self.width),
            dtype=dtype, device=self.device)
        self.storage = self.full_storage[:, :num_blocks]
        self._free: List[int] = list(range(num_blocks))
        self._owned: Dict[int, List[int]] = {}       # rid -> blocks
        # ---- prefix index state (enable_prefix_cache only) ----
        # attn-free (pure SSM) stacks cache too: their zero-width KV
        # blocks are trie key-holders for the boundary snapshots
        self.enable_prefix_cache = bool(enable_prefix_cache)
        self._roots: Dict[Optional[str], _PrefixNode] = {}
        self._cached: Dict[int, _PrefixNode] = {}    # block -> trie node
        self._ref: Dict[int, int] = {}               # cached block -> holders
        # recurrent-state snapshots: cached block -> per-(blk,sub) state
        # tree at the boundary ENDING at that block (lockstep-evicted)
        self._snaps: Dict[int, dict] = {}
        self._clock = 0
        # observability
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0
        self.cow_copies = 0
        self.storage_writes = 0      # engine-issued storage swaps
        self.snap_hits = 0           # acquires served with a snapshot
        self.snap_misses = 0         # KV match degraded: boundary had none
        self.snap_stores = 0         # snapshots attached to the trie
        self.snap_bytes = 0          # resident snapshot bytes

    def set_storage(self, storage: torch.Tensor):
        """Record one engine-issued pool update. The decode steps write
        ``full_storage`` in place and hand the same tensor back here,
        once per step."""
        assert storage.data_ptr() == self.full_storage.data_ptr(), \
            "the pool storage is updated in place, never replaced"
        self.storage_writes += 1

    # ------------------------------------------------------------- alloc
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def cached_blocks(self) -> int:
        return len(self._cached)

    def blocks_for_tokens(self, tokens: int) -> int:
        return max(1, math.ceil(tokens / self.block_size))

    def _take_free(self, n: int) -> List[int]:
        """Pop n free blocks, evicting LRU refcount-0 prefix blocks under
        pressure instead of failing outright."""
        while len(self._free) < n and self._evict_one():
            pass
        if n > len(self._free):
            raise PoolExhausted(f"need {n} blocks, have {len(self._free)} "
                                f"free and nothing evictable")
        return [self._free.pop() for _ in range(n)]

    def alloc(self, rid: int, tokens: int) -> List[int]:
        blocks = self._take_free(self.blocks_for_tokens(tokens))
        self._owned.setdefault(rid, []).extend(blocks)
        return blocks

    def alloc_to(self, rid: int, tokens: int) -> List[int]:
        """Grow rid's allocation so it covers `tokens` total tokens
        (suffix blocks after a prefix hit)."""
        have = len(self._owned.get(rid, []))
        need = max(0, self.blocks_for_tokens(tokens) - have)
        blocks = self._take_free(need)
        self._owned.setdefault(rid, []).extend(blocks)
        return blocks

    def extend(self, rid: int, extra_tokens_from: int, to_tokens: int
               ) -> List[int]:
        """Grow a request's allocation (decode appends)."""
        have = self.blocks_for_tokens(extra_tokens_from)
        need = self.blocks_for_tokens(to_tokens)
        out = self._take_free(max(0, need - have))
        self._owned.setdefault(rid, []).extend(out)
        return out

    def release(self, rid: int):
        for b in self._owned.pop(rid, []):
            if b in self._cached:
                # shared prefix block: drop the reference, keep it cached
                # (refcount 0 == LRU-evictable, never freed while held)
                self._ref[b] = max(0, self._ref.get(b, 0) - 1)
            else:
                self._free.append(b)

    def owned(self, rid: int) -> List[int]:
        return list(self._owned.get(rid, []))

    def invariant_ok(self) -> bool:
        owned_all = [b for bs in self._owned.values() for b in bs]
        cached = set(self._cached)
        private = [b for b in owned_all if b not in cached]
        ok = len(private) == len(set(private))       # unique private owner
        counts: Dict[int, int] = {}
        for b in owned_all:
            if b in cached:
                counts[b] = counts.get(b, 0) + 1
        ok &= all(self._ref.get(b, 0) == counts.get(b, 0) for b in cached)
        ok &= len(self._free) == len(set(self._free))
        ok &= not (set(self._free) & (set(private) | cached))
        ok &= sorted(set(self._free) | set(private) | cached) \
            == list(range(self.num_blocks))
        # a snapshot never outlives its block: every snapshot key must
        # be a live cached block (lockstep eviction)
        ok &= set(self._snaps) <= cached
        return bool(ok)

    # ----------------------------------------------------- prefix index
    @property
    def hit_rate(self) -> float:
        return self.hits / self.lookups if self.lookups else 0.0

    def _match(self, tokens: Sequence[int], namespace: Optional[str]
               ) -> Tuple[List[_PrefixNode], Optional[Tuple[_PrefixNode,
                                                            int]]]:
        """Walk the trie: fully-matched whole blocks, plus the best
        partial tail candidate (node, common-prefix token count)."""
        root = self._roots.get(namespace)
        if root is None:
            return [], None
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        chain: List[_PrefixNode] = []
        node = root
        i = 0
        while True:
            rest = toks[i:]
            if not rest:
                return chain, None
            child = node.children.get(rest[:bs])
            if child is not None and len(rest) >= bs:
                chain.append(child)
                node = child
                i += bs
                continue
            # tail: the child sharing the longest common token prefix
            # with the remaining tokens (full or partial block — either
            # way the overlap is COW-copied, never referenced in place)
            best, best_l = None, 0
            for key, ch in node.children.items():
                l = 0
                for a, b in zip(key, rest):
                    if a != b:
                        break
                    l += 1
                if l > best_l:
                    best, best_l = ch, l
            return chain, ((best, best_l) if best is not None else None)

    def _snap_floor(self, full: List[_PrefixNode], target: int,
                    align: int) -> int:
        """Round an aligned match DOWN to the nearest boundary holding a
        recurrent-state snapshot (require_state acquires). ``align``
        must cover whole blocks in this mode, so every candidate
        boundary ends exactly at a full-block node."""
        bs = self.block_size
        assert align % bs == 0, (align, bs)
        target = min(target, len(full) * bs)
        target -= target % align
        while target > 0 and \
                full[target // bs - 1].block not in self._snaps:
            target -= align
        return target

    def peek_prefix(self, tokens: Sequence[int],
                    namespace: Optional[str] = None,
                    align: int = 1, require_state: bool = False) -> int:
        """Read-only match length in tokens (for routing affinity);
        does not touch refcounts or recency. ``align`` rounds the
        reported hit DOWN to a multiple (capacity-MoE engines require
        window-aligned prefixes — see PrefillEngine.prefix_align);
        ``require_state`` further rounds down to the nearest snapshot
        boundary (SSM engines cannot restore from a KV-only match)."""
        if not self.enable_prefix_cache or len(tokens) < 2:
            return 0
        full, tail = self._match(tokens, namespace)
        got = len(full) * self.block_size + (tail[1] if tail else 0)
        got = min(got, len(tokens) - 1)
        got -= got % max(1, align)
        if require_state:
            got = self._snap_floor(full, got, align)
        return got

    def acquire_prefix(self, rid: int, tokens: Sequence[int],
                       namespace: Optional[str] = None,
                       align: int = 1, require_state: bool = False) -> int:
        """Prefix lookup at admission: matched whole blocks become shared
        (refcounted) leading blocks of rid's allocation; a partial tail
        match is copy-on-written into a private block. Returns the cached
        token count (always < len(tokens): the last prompt token is
        recomputed so prefill still yields first-token logits). With
        ``align`` > 1 the hit is rounded DOWN to a multiple — a
        whole-block match past the boundary degrades into a COW tail (or
        is dropped), so engines whose suffix math needs aligned reuse
        boundaries (window-local capacity MoE) stay exact.

        ``require_state`` (SSM/hybrid engines): the hit must land on a
        boundary whose block holds a recurrent-state snapshot — a match
        cut anywhere else (including any would-be COW tail) degrades to
        the nearest snapshot boundary below, or to a clean miss. The
        caller reads the snapshot back with ``snapshot_for``."""
        if not self.enable_prefix_cache or len(tokens) < 2:
            return 0
        self.lookups += 1
        full, tail = self._match(tokens, namespace)
        bs = self.block_size
        raw = len(full) * bs + (tail[1] if tail else 0)
        target = min(raw, len(tokens) - 1)
        target -= target % max(1, align)
        if require_state:
            want = target
            target = self._snap_floor(full, target, align)
            if want > 0 and target < want:
                self.snap_misses += 1   # KV matched past the boundary
            if target > 0:
                self.snap_hits += 1
        n_full = min(len(full), target // bs)
        rem = target - n_full * bs
        tail_node = None
        if rem > 0:
            # the boundary cuts into a matched block: COW its overlap
            tail_node = full[n_full] if n_full < len(full) else tail[0]
        if target <= 0:
            return 0
        blocks: List[int] = []
        for nd in full[:n_full]:
            self._ref[nd.block] = self._ref.get(nd.block, 0) + 1
            blocks.append(nd.block)
        if tail_node is not None:
            # pin the source so eviction pressure from _take_free cannot
            # reclaim it mid-copy
            self._ref[tail_node.block] = self._ref.get(tail_node.block,
                                                       0) + 1
            try:
                dst = self._take_free(1)[0]
            except PoolExhausted:
                # no room for the COW tail: degrade to the whole-block
                # hit (or a clean miss), rolling back refs not yet
                # recorded in _owned — they would leak otherwise
                dst = None
            finally:
                self._ref[tail_node.block] -= 1
            if dst is None:
                tail_node, rem = None, 0
                # the degraded whole-block hit must still respect the
                # alignment contract: keep only the largest block count
                # whose token span is an align multiple, rolling back
                # the refs on dropped blocks (run_suffix asserts
                # plen % align == 0 at admission)
                while n_full and (n_full * bs) % max(1, align):
                    n_full -= 1
                    self._ref[full[n_full].block] -= 1
                    blocks.pop()
                if not blocks:
                    return 0
            else:
                self.storage[:, dst] = self.storage[:, tail_node.block]
                self.cow_copies += 1
                blocks.append(dst)
        cached = n_full * bs + rem
        self._owned.setdefault(rid, []).extend(blocks)
        self.hits += 1
        self.hit_tokens += cached
        self._touch(full[n_full - 1] if n_full else tail_node)
        return cached

    @staticmethod
    def _snap_nbytes(state: dict) -> int:
        def leaves(t):
            if isinstance(t, dict):
                return [x for v in t.values() for x in leaves(v)]
            return [t]
        return sum(int(np.prod(a.shape)) * np.dtype(a.dtype).itemsize
                   if isinstance(a, np.ndarray)
                   else a.numel() * a.element_size() for a in leaves(state))

    def insert_prefix(self, rid: int, tokens: Sequence[int],
                      namespace: Optional[str] = None,
                      states: Optional[Dict[int, dict]] = None):
        """Register rid's prefilled blocks in the trie so later requests
        can share them. Blocks already shared (matched at acquire time)
        are only recency-touched; private blocks become cached with the
        owning request as their first reference.

        ``states`` maps ABSOLUTE token boundaries -> recurrent-state
        snapshot trees (the engine's ``snap_stride`` emission): each is
        attached to the cached block ending at its boundary, so it is
        refcounted/evicted in lockstep with that block. Pre-existing
        nodes missing a snapshot pick one up too (a warm run emits
        snapshots for the NEW suffix boundaries only, but a cold rerun
        of a longer prompt may backfill earlier boundaries)."""
        if not self.enable_prefix_cache:
            return
        blocks = self._owned.get(rid, [])
        root = self._roots.setdefault(namespace, _PrefixNode((), -1, None))
        toks = tuple(int(t) for t in tokens)
        bs = self.block_size
        node = root
        self._clock += 1
        for i, b in enumerate(blocks):
            chunk = toks[i * bs:(i + 1) * bs]
            if not chunk:
                break
            child = node.children.get(chunk)
            if child is None:
                if b in self._cached:
                    break   # defensive: a block caches under one node only
                child = _PrefixNode(chunk, b, node)
                node.children[chunk] = child
                self._cached[b] = child
                self._ref[b] = self._ref.get(b, 0) + 1   # rid holds it
            child.last_use = self._clock
            if len(chunk) == bs and states \
                    and (i + 1) * bs in states \
                    and child.block not in self._snaps:
                st = states[(i + 1) * bs]
                self._snaps[child.block] = st
                self.snap_stores += 1
                self.snap_bytes += self._snap_nbytes(st)
            if len(chunk) < bs:
                break       # partial tail is a leaf
            node = child

    def snapshot_for(self, rid: int, cached: int) -> dict:
        """The recurrent-state snapshot at rid's acquired boundary
        (``cached`` tokens, as returned by a require_state acquire)."""
        bs = self.block_size
        assert cached > 0 and cached % bs == 0, cached
        return self._snaps[self._owned[rid][cached // bs - 1]]

    def _touch(self, node: Optional[_PrefixNode]):
        self._clock += 1
        while node is not None and node.key:
            node.last_use = self._clock
            node = node.parent

    def _evict_one(self) -> bool:
        """Free the LRU evictable trie leaf (refcount 0, no children).
        Leaf-first ordering keeps every cached chain rooted."""
        best: Optional[_PrefixNode] = None
        for b, nd in self._cached.items():
            if self._ref.get(b, 0) == 0 and not nd.children:
                if best is None or nd.last_use < best.last_use:
                    best = nd
        if best is None:
            return False
        del self._cached[best.block]
        self._ref.pop(best.block, None)
        # lockstep: the boundary snapshot dies with its block
        snap = self._snaps.pop(best.block, None)
        if snap is not None:
            self.snap_bytes -= self._snap_nbytes(snap)
        if best.parent is not None:
            best.parent.children.pop(best.key, None)
        self._free.append(best.block)
        self.evictions += 1
        return True

    # ---------------------------------------------------------- data I/O
    def _idx(self, blocks: Sequence[int]) -> torch.Tensor:
        """Block ids as an int32 tensor on the pool's device, range-checked
        on the host."""
        ids = [int(b) for b in blocks]
        if ids and not (0 <= min(ids) and max(ids) < self.num_blocks):
            raise IndexError(f"block ids {ids} outside [0, {self.num_blocks})")
        return torch.tensor(ids, dtype=torch.int32, device=self.device)

    def write_prefill(self, blocks: Sequence[int], k: torch.Tensor,
                      v: torch.Tensor):
        """k, v: (attn_layers, tokens, kv_dim) from forward_prefill."""
        L, s, kvd = k.shape
        kv = torch.cat([k, v], dim=-1).to(self.dtype)
        pad = len(blocks) * self.block_size - s
        if pad:
            kv = F.pad(kv, (0, 0, 0, pad))
        kv = kv.reshape(L, len(blocks), self.block_size, self.width)
        self.storage[:, self._idx(blocks).long()] = kv

    def write_tokens(self, blocks: Sequence[int], start: int,
                     k: torch.Tensor, v: torch.Tensor):
        """Write k/v (attn_layers, n, kv_dim) at token offset ``start`` of
        a request's block list — the suffix write after a prefix hit.
        Only blocks at/after ``start`` are touched, so shared prefix
        blocks are never overwritten."""
        L, n, kvd = k.shape
        kv = torch.cat([k, v], dim=-1).to(self.dtype)
        bs = self.block_size
        toks = np.arange(start, start + n)
        blk = self._idx(np.asarray(blocks)[toks // bs]).long()
        off = torch.as_tensor(toks % bs, device=self.device)
        self.storage[:, blk, off] = kv

    def read_block(self, block: int) -> torch.Tensor:
        """(layers, bs, width) COPY of one block (never a view)."""
        return self.storage[:, block].clone()

    def write_block(self, block: int, data: torch.Tensor):
        self.storage[:, block] = data.to(self.dtype)

    def read_tokens(self, blocks: Sequence[int], tokens: int) -> torch.Tensor:
        """Dense (layers, tokens, width) copy of a request's cache."""
        return self.gather_contiguous(blocks)[:, :tokens]

    # ----------------------------------------------- contiguous transfer
    def layer_nbytes(self, blocks: int) -> int:
        """Wire bytes of ONE layer's stripe of a linearized n-block
        buffer (Fig. 10 offset/length arithmetic works on these)."""
        return blocks * self.block_size * self.width \
            * self.storage.element_size()

    def gather_layer(self, blocks: Sequence[int], layer: int) -> torch.Tensor:
        """Fresh (n*block_size, width) buffer of ONE layer's stripe — the
        per-layer-triggered sender side (paper Fig. 10)."""
        return ops.kv_gather_layer(self.storage, self._idx(blocks), layer)

    def scatter_layer(self, buf: torch.Tensor, blocks: Sequence[int],
                      layer: int):
        """RecvScatter of ONE layer's stripe into discrete blocks — the
        per-layer-triggered receiver side."""
        ops.kv_scatter_layer(self.storage, buf.to(self.dtype),
                             self._idx(blocks), layer)

    def gather_contiguous(self, blocks: Sequence[int]) -> torch.Tensor:
        """Fresh (layers, n*block_size, width) buffer (C3 sender)."""
        return ops.kv_gather(self.storage, self._idx(blocks))

    def scatter_contiguous(self, buf: torch.Tensor, blocks: Sequence[int]):
        """RecvScatter: restore discrete blocks from bytes (C3 receiver)."""
        ops.kv_scatter(self.storage, buf.to(self.dtype), self._idx(blocks))

    def block_tables(self, rids: Sequence[int], max_blocks: int
                     ) -> np.ndarray:
        """(len(rids), max_blocks) int32 table, -1 padded."""
        out = np.full((len(rids), max_blocks), -1, np.int32)
        for i, rid in enumerate(rids):
            bs = self._owned.get(rid, [])
            out[i, :len(bs)] = bs
        return out
