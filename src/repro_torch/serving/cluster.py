"""In-process mini-cluster nodes: the REAL data path, end to end, in
PyTorch.

Counterpart of ``src/repro/serving/cluster.py``. PrefillNode (real
forward into a paged pool, streaming per-layer KV in overlapped mode) ->
block-free KV transfer between paged pools (the CUDA gather/RecvScatter
kernels on the card; overlapped layer-wise pipeline via
``serving.transfer_sched`` by default, blocking transfer otherwise) ->
DecodeNode (paged continuous batching) -> streamed tokens. The gateway
over these nodes is ``serving.frontend.ClusterFrontend``; MiniCluster is
its single-group shim.

Devices: every node's pool lives where its params live. MiniCluster and
ClusterFrontend take ``device=`` (default the card) and raise on a
machine without one unless ``device="cpu"`` is asked for.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.transfer import KVTransferEngine, LinkModel
from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.scope import unported
from repro_torch.serving.engine import (DecodeEngine, PrefillEngine,
                                        PrefillOutput)
from repro_torch.serving.kvcache import PagedKVPool


@dataclass
class ServeRequest:
    rid: int
    tokens: List[int]
    max_new_tokens: int = 16
    generated: List[int] = field(default_factory=list)
    done: bool = False
    on_token: Optional[Callable[[int], None]] = None  # SSE stream
    frames: Optional[object] = None  # enc-dec frontend (not ported)
    scenario: str = "default"        # routes to the matching ServeGroup
    # virtual-second timeline stamps (set by the gateway / event core)
    submit_t: float = -1.0           # gateway arrival
    first_token_t: float = -1.0      # prefill batch completion (TTFT end)
    finish_t: float = -1.0           # last decode token
    # SLO deadline in virtual seconds after submit (<0 == none): the
    # gateway sheds a request whose deadline passed while it waited
    slo_deadline_s: float = -1.0
    shed: bool = False
    gw_attempts: int = 0             # gateway placement attempts burned


def _params_device(params) -> torch.device:
    return params["embed"].device


class PrefillNode:
    def __init__(self, iid: str, cfg: ModelConfig, params, *,
                 num_blocks: int = 128, block_size: int = 16,
                 batch_size: int = 4, prefix_cache: bool = True,
                 bucket_prefill: Optional[bool] = None):
        self.iid = iid
        self.engine = PrefillEngine(cfg, params,
                                    bucket_prefill=bucket_prefill)
        # capacity-MoE hits round down to the capacity window; SSM/hybrid
        # stacks cache recurrent-state snapshots with their blocks and hit
        # only at snapshot boundaries, every lcm(engine alignment, block
        # size) tokens, so each boundary ends a whole cached block
        self.prefix_cache = bool(prefix_cache) \
            and self.engine.supports_prefix_reuse
        self.needs_state = self.prefix_cache \
            and self.engine.requires_state_restore
        self.prefix_align = self.engine.prefix_align
        self.snap_stride = 0
        if self.needs_state:
            self.prefix_align = math.lcm(self.prefix_align, block_size)
            self.snap_stride = self.prefix_align
        self.pool = PagedKVPool(cfg, num_blocks=num_blocks,
                                block_size=block_size,
                                enable_prefix_cache=self.prefix_cache,
                                device=_params_device(params))
        self.batch_size = batch_size
        self.forming: List[ServeRequest] = []
        self.waiting: List[Tuple[ServeRequest, PrefillOutput]] = []
        self.sse_connections = 0
        self.draining = False
        self.crashed = False
        self.ejected = False
        self.busy_until = 0.0        # virtual time the node frees up
        self.prefill_scale = 1.0     # virtual service-time multiplier
        self._batch_evt = False      # a "batch" event is already queued
        self._evictions_seen = 0     # pool evictions already ledgered
        # layer-streaming mode (overlapped transfer): per-rid payloads
        # {attn_layer -> (tokens, width) kv stripe, a fresh tensor} and
        # batch timing
        self.staged: Dict[int, Dict[int, torch.Tensor]] = {}
        self.batch_meta: Dict[int, Tuple[float, float]] = {}

    def idle(self) -> bool:
        return (len(self.forming) < self.batch_size
                and len(self.waiting) < self.batch_size)

    def offer(self, req: ServeRequest) -> bool:
        if req.frames is not None:
            raise unported("encoder frames", 11)
        if self.draining or self.crashed or self.ejected \
                or not self.idle():
            return False
        self.forming.append(req)
        self.sse_connections += 1
        return True

    def prefix_affinity(self, req: ServeRequest) -> int:
        """Cached-prefix token count this node could reuse for req."""
        if not self.prefix_cache:
            return 0
        return self.pool.peek_prefix(req.tokens, align=self.prefix_align,
                                     require_state=self.needs_state)

    def prefix_stats(self) -> Dict[str, float]:
        return {
            "lookups": self.pool.lookups, "hits": self.pool.hits,
            "hit_tokens": self.pool.hit_tokens,
            "evictions": self.pool.evictions,
            "cow_copies": self.pool.cow_copies,
            "compute_tokens": self.engine.compute_tokens,
            "reused_tokens": self.engine.reused_tokens,
            "snap_hits": self.pool.snap_hits,
            "snap_misses": self.pool.snap_misses,
            "snap_stores": self.pool.snap_stores,
            "snap_bytes": self.pool.snap_bytes,
            "state_restores": self.engine.state_restores,
        }

    def run_batch(self, collect_layers: bool = False
                  ) -> List[Tuple[ServeRequest, PrefillOutput]]:
        if not self.forming:
            return []
        batch = self.forming
        self.forming = []
        ready: List[Tuple[ServeRequest, PrefillOutput]] = []
        cold: List[ServeRequest] = []
        warm: List[Tuple[ServeRequest, int]] = []
        for req in batch:
            cached = 0
            if self.prefix_cache:
                cached = self.pool.acquire_prefix(
                    req.rid, req.tokens, align=self.prefix_align,
                    require_state=self.needs_state)
            (warm.append((req, cached)) if cached else cold.append(req))

        def _stash_for(rid):
            def cb(_i, li, k_li, v_li, _frac):
                # torch.cat makes a fresh tensor: the staged payload never
                # aliases the prefill output or the pool
                self.staged.setdefault(rid, {})[li] = torch.cat(
                    [k_li, v_li], dim=-1)
            return cb

        if cold:
            on_layer = None
            if collect_layers:
                def on_layer(i, li, k_li, v_li, frac):
                    _stash_for(cold[i].rid)(i, li, k_li, v_li, frac)
            outs = self.engine.run([r.tokens for r in cold],
                                   on_layer=on_layer,
                                   snap_stride=self.snap_stride)
            for req, out in zip(cold, outs):
                if out.k is not None:
                    blocks = self.pool.alloc(req.rid, out.prompt_len)
                    self.pool.write_prefill(blocks, out.k, out.v)
                elif self.needs_state:
                    # attention-free: zero-width blocks are the trie's
                    # key holders for the boundary snapshots
                    self.pool.alloc(req.rid, out.prompt_len)
                if self.prefix_cache and self.pool.owned(req.rid):
                    self.pool.insert_prefix(req.rid, req.tokens,
                                            states=out.snapshots)
                ready.append((req, out))
        for req, cached in warm:
            # hit: gather the cached prefix KV (kv_gather kernel; a fresh
            # buffer) and, for SSM/hybrid, take the boundary snapshot; run
            # the forward over only the uncached suffix, write the suffix
            # KV into freshly allocated blocks (shared blocks stay
            # read-only)
            buf = None
            if self.pool.attn_layers:
                buf = self.pool.gather_contiguous(
                    self.pool.owned(req.rid))[:, :cached]
            state = self.pool.snapshot_for(req.rid, cached) \
                if self.needs_state else None
            out = self.engine.run_suffix(
                req.tokens[cached:], buf,
                on_layer=_stash_for(req.rid) if collect_layers else None,
                state=state, prefix_len=cached,
                snap_stride=self.snap_stride)
            self.pool.alloc_to(req.rid, out.prompt_len)
            if out.k is not None:
                self.pool.write_tokens(self.pool.owned(req.rid), cached,
                                       out.k[:, cached:], out.v[:, cached:])
            self.pool.insert_prefix(req.rid, req.tokens,
                                    states=out.snapshots)
            ready.append((req, out))
        order = {id(r): i for i, r in enumerate(batch)}
        ready.sort(key=lambda pair: order[id(pair[0])])
        for req, out in ready:
            req.generated.append(out.first_token)
            if req.on_token:
                req.on_token(out.first_token)
        self.waiting.extend(ready)
        return ready


class DecodeNode:
    def __init__(self, iid: str, cfg: ModelConfig, params, *,
                 num_blocks: int = 256, block_size: int = 16,
                 max_slots: int = 8, fused: Optional[bool] = None,
                 spec=None):
        self.iid = iid
        self.cfg = cfg
        self.params = params
        self.pool = PagedKVPool(cfg, num_blocks=num_blocks,
                                block_size=block_size,
                                device=_params_device(params))
        self.engine = DecodeEngine(cfg, params, self.pool,
                                   max_slots=max_slots, fused=fused,
                                   spec=spec)
        self.requests: Dict[int, ServeRequest] = {}
        self.draining = False
        self.crashed = False
        self.ejected = False
        self.busy_until = 0.0        # virtual time the node frees up
        self.decode_scale = 1.0      # virtual service-time multiplier
        self._step_evt = False       # a "step" event is already queued

    def can_admit(self) -> bool:
        return not (self.draining or self.crashed or self.ejected) \
            and bool(self.engine.free_slots())

    def free_slot_count(self) -> int:
        return len(self.engine.free_slots())

    def admit(self, req: ServeRequest, out: PrefillOutput,
              src_pool: PagedKVPool, xfer: KVTransferEngine,
              *, mode: str = "block_free"):
        """Synchronous (blocking) admission: the whole KVCache moves in
        the caller's critical section (one gather + one scatter kernel
        in block-free mode). Attention-free requests move no KV: their
        Mamba state rides on ``out``."""
        total = out.prompt_len + req.max_new_tokens + 1
        dst_blocks = self.pool.alloc(req.rid, total)
        if out.k is not None:
            src_blocks = src_pool.owned(req.rid)
            n = len(src_blocks)
            if mode == "block_free":
                xfer.transfer_block_free(src_pool, src_blocks, self.pool,
                                         dst_blocks[:n])
            else:
                xfer.transfer_block_fixed(src_pool, src_blocks, self.pool,
                                          dst_blocks[:n])
        # attention-free requests may still hold snapshot key blocks on
        # the source pool: always release
        src_pool.release(req.rid)
        self.finish_admit(req, out)

    def finish_admit(self, req: ServeRequest, out: PrefillOutput):
        """Attach an already-transferred request (KV in self.pool, Mamba
        state on ``out``) to a decode slot."""
        self.engine.admit(req.rid, out, self.pool.owned(req.rid))
        self.requests[req.rid] = req

    def step(self) -> List[ServeRequest]:
        """One continuous-batching iteration; returns the requests that
        finished during it."""
        res = self.engine.step()
        finished: List[ServeRequest] = []
        for slot, tok in res.items():
            rid = self.engine.rid[slot]
            req = self.requests[rid]
            req.generated.append(tok)
            if req.on_token:
                req.on_token(tok)
            if len(req.generated) >= req.max_new_tokens + 1:
                req.done = True
                self.engine.evict(slot)
                self.pool.release(rid)
                del self.requests[rid]
                finished.append(req)
        return finished


class MiniCluster:
    """One P/D group with real compute: a thin single-group shim over
    ``serving.frontend.ClusterFrontend`` with flat instance ids (P0, D0,
    ...). ``device`` places params and pools (default: the card)."""

    def __init__(self, cfg: ModelConfig, *, n_prefill: int = 1,
                 n_decode: int = 1, seed: int = 0,
                 transfer_mode: str = "block_free",
                 params=None, link: LinkModel = LinkModel(),
                 overlap_transfer: bool = True, tickless: bool = True,
                 device: DeviceLike = "cuda"):
        from repro_torch.serving.frontend import ClusterFrontend
        self.frontend = ClusterFrontend(
            cfg, topology={"default": (n_prefill, n_decode)}, seed=seed,
            transfer_mode=transfer_mode, params=params, link=link,
            flat_iids=True, overlap_transfer=overlap_transfer,
            tickless=tickless, device=device)
        self.cfg = cfg
        self.params = self.frontend.params
        self.transfer_mode = transfer_mode

    @property
    def meta(self):
        return self.frontend.meta

    @property
    def xfer(self):
        return self.frontend.xfer

    @property
    def prefills(self):
        return self.frontend.groups["default"].prefills

    @property
    def decodes(self):
        return self.frontend.groups["default"].decodes

    @property
    def pending(self) -> List[ServeRequest]:
        return self.frontend.pending

    @property
    def rejections(self) -> int:
        return self.frontend.rejections

    def submit(self, req: ServeRequest):
        self.frontend.submit(req)

    def run(self, requests: Sequence[ServeRequest], *,
            max_ticks: int = 200) -> List[ServeRequest]:
        return self.frontend.run(requests, max_ticks=max_ticks)
