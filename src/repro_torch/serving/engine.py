"""Real-compute P/D engines for the in-process mini-cluster, in PyTorch.

Counterpart of ``src/repro/serving/engine.py`` for the dense
decoder-only family. PrefillEngine runs prefill batches and hands out
per-request KV; DecodeEngine runs continuous-batched decode over a paged
KV pool, one fused iteration per step.

Hot-loop shape discipline, as in the JAX engines:

  * prefill batches are right-padded to power-of-two length BUCKETS
    (from PREFILL_BUCKET_MIN) and run through one forward; padding is
    exact by the model's pad-invariance contract (padded queries attend
    to nothing). Suffix-only (prefix-reuse) prefills also bucket the
    prefix KV length;
  * the decode iteration runs eagerly over fixed-shape slot tensors
    (padded (max_slots,) tokens / positions / mask and a power-of-two
    bucketed block table), which are rebuilt only when slot membership
    changes. The paged pool is written in place, and a step makes
    exactly one device->host copy (the argmax). There is no jit here;
    CUDA graphs over the same fixed shapes are a later step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.caches import decode_slot_state
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.modeling import forward_decode_step, forward_prefill
from repro_torch.models.params import block_period, num_blocks
from repro_torch.scope import check_dense, unported
from repro_torch.serving.kvcache import PagedKVPool

Tree = dict

# layer-streaming callback: (batch_index, attn_layer_index, k_layer
# (tokens, kv_dim), v_layer, network_depth_fraction), invoked in network
# order so a transfer scheduler can ship layer i while later layers are
# still in flight (per-layer triggering, paper Fig. 10)
OnLayer = Callable[[int, int, torch.Tensor, torch.Tensor, float], None]

# smallest prefill length bucket; buckets double up to cfg.max_seq_len
PREFILL_BUCKET_MIN = 16


def _attn_layer_order(cfg: ModelConfig) -> List[Tuple[int, int]]:
    """(blk, sub) pairs of attention layers, in network order."""
    period = block_period(cfg)
    kinds = cfg.layer_kinds()
    return [(b, s) for b in range(num_blocks(cfg)) for s in range(period)
            if kinds[s] == ATTN]


@dataclass
class PrefillOutput:
    first_token: int
    k: Optional[torch.Tensor]        # (attn_layers, tokens, kv_dim)
    v: Optional[torch.Tensor]
    mamba_state: Optional[Tree]      # SSM families (not ported): None
    prompt_len: int
    cross: Optional[Tree] = None     # enc-dec (not ported): None
    snapshots: Optional[Dict[int, Tree]] = None


class PrefillEngine:
    """Batched prefill on real params; emits per-request KV.

    ``run_suffix`` is the prefix-reuse fast path: given a gathered prefix
    KVCache it runs the forward over only the uncached suffix tokens.
    ``compute_tokens`` counts real prompt tokens pushed through the
    forward; bucket padding is ledgered in ``padded_tokens``.
    ``prefill_batches`` / ``bucket_hits`` count launches and how many
    landed on an already-seen shape bucket."""

    def __init__(self, cfg: ModelConfig, params: Tree, *,
                 bucket_prefill: Optional[bool] = None):
        check_dense(cfg)
        if bucket_prefill is False:
            raise unported("exact-length prefill (bucket_prefill=False)", 12)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self._attn_order = _attn_layer_order(cfg)
        period = block_period(cfg)
        total = num_blocks(cfg) * period
        self._layer_fractions: Tuple[float, ...] = tuple(
            (bk * period + sb + 1) / total for bk, sb in self._attn_order)
        self.compute_tokens = 0      # real prompt tokens through the fwd
        self.padded_tokens = 0       # bucket-padding tokens on top
        self.reused_tokens = 0       # tokens served from a prefix hit
        self.prefix_prefills = 0     # suffix-only prefills executed
        self.state_restores = 0      # SSM warm restores (not ported): 0
        self.prefill_batches = 0     # forward launches
        self.bucket_hits = 0         # launches on an already-seen shape
        self._shapes_seen: set = set()

    def layer_fractions(self) -> Tuple[float, ...]:
        """Network-depth completion fraction of each attention layer, in
        network order (static per config)."""
        return self._layer_fractions

    def _emit_layers(self, on_layer: Optional[OnLayer], idx: int,
                     k: Optional[torch.Tensor], v: Optional[torch.Tensor]):
        if on_layer is None or k is None:
            return
        for li, frac in enumerate(self._layer_fractions):
            on_layer(idx, li, k[li], v[li], frac)

    @property
    def supports_prefix_reuse(self) -> bool:
        return bool(self._attn_order)

    @property
    def requires_state_restore(self) -> bool:
        return False

    @property
    def prefix_align(self) -> int:
        return 1

    def _bucket_len(self, n: int) -> int:
        b = PREFILL_BUCKET_MIN
        while b < n:
            b *= 2
        return min(b, max(self.cfg.max_seq_len, n))

    def _count_launch(self, shape_key: Tuple) -> None:
        self.prefill_batches += 1
        if shape_key in self._shapes_seen:
            self.bucket_hits += 1
        else:
            self._shapes_seen.add(shape_key)

    @staticmethod
    def _no_snapshots(snap_stride: int) -> None:
        if snap_stride:
            raise unported("recurrent-state snapshots", 10)

    def run(self, token_lists: Sequence[Sequence[int]],
            frames: Optional[Sequence] = None,
            on_layer: Optional[OnLayer] = None,
            snap_stride: int = 0) -> List[PrefillOutput]:
        """Ragged prompts are grouped into padded power-of-two length
        buckets, one forward per bucket. ``on_layer`` streams each
        request's per-layer (k, v) in network order."""
        if frames is not None:
            raise unported("encoder frames", 11)
        self._no_snapshots(snap_stride)
        by_len: Dict[int, List[int]] = {}
        for i, t in enumerate(token_lists):
            by_len.setdefault(self._bucket_len(len(t)), []).append(i)
        outs: List[Optional[PrefillOutput]] = [None] * len(token_lists)
        for ln, idxs in by_len.items():
            sub = self._run_equal([token_lists[i] for i in idxs], pad_to=ln)
            for i, o in zip(idxs, sub):
                outs[i] = o
                self._emit_layers(on_layer, i, o.k, o.v)
        return outs  # type: ignore[return-value]

    def _run_equal(self, token_lists: Sequence[Sequence[int]],
                   pad_to: int) -> List[PrefillOutput]:
        b = len(token_lists)
        lens = [len(t) for t in token_lists]
        s = pad_to
        assert s >= max(lens), (s, lens)
        toks = np.zeros((b, s), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        self.compute_tokens += sum(lens)
        self.padded_tokens += b * s - sum(lens)
        self._count_launch((b, s, 0))
        last = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                            device=self.device)
        first, cache = forward_prefill(self.cfg, self.params, batch,
                                       last_index=last)
        first_host = first.tolist()
        layers = cache["layers"]
        outs: List[PrefillOutput] = []
        for i, ln in enumerate(lens):
            # torch.stack copies: the per-request KV owns its memory
            k = torch.stack([layers[f"sub{sb}"]["k"][bk, i, :ln]
                             for bk, sb in self._attn_order])
            v = torch.stack([layers[f"sub{sb}"]["v"][bk, i, :ln]
                             for bk, sb in self._attn_order])
            outs.append(PrefillOutput(int(first_host[i]), k, v, None, ln))
        return outs

    def run_suffix(self, suffix_tokens: Sequence[int],
                   prefix_kv: Optional[torch.Tensor] = None,
                   frames: Optional[object] = None,
                   on_layer: Optional[OnLayer] = None, *,
                   state: Optional[Tree] = None,
                   prefix_len: Optional[int] = None,
                   snap_stride: int = 0) -> PrefillOutput:
        """Suffix-only prefill after a prefix hit (attention-only stacks).

        ``prefix_kv``: (attn_layers, plen, 2*kv_dim), the cached prefix
        gathered from the paged pool, K and V packed as the pool stores
        them. The suffix is right-padded to its length bucket and the
        prefix to its own bucket, with the real prefix length passed to
        the flash kernel (padded prefix keys are masked from every
        softmax). Returns a PrefillOutput whose k/v cover the FULL prompt
        (prefix stitched back on, as fresh tensors)."""
        cfg = self.cfg
        if frames is not None:
            raise unported("encoder frames", 11)
        if state is not None:
            raise unported("recurrent-state restore", 10)
        self._no_snapshots(snap_stride)
        assert prefix_kv is not None, "attention stacks reuse prefix KV"
        s = len(suffix_tokens)
        assert s >= 1, "prefix hit must leave at least one suffix token"
        plen = int(prefix_kv.shape[1])
        assert prefix_len is None or int(prefix_len) == plen
        s_pad = self._bucket_len(s)
        p_pad = self._bucket_len(plen)
        if p_pad != plen:
            prefix_kv = F.pad(prefix_kv, (0, 0, 0, p_pad - plen))
        kvd = cfg.kv_dim
        k_pre, v_pre = prefix_kv[..., :kvd], prefix_kv[..., kvd:]
        attn_idx = {pair: li for li, pair in enumerate(self._attn_order)}
        prefix: Tree = {}
        for sb in range(block_period(cfg)):
            rows = [attn_idx[(bk, sb)] for bk in range(num_blocks(cfg))]
            # (num_blocks, b=1, p_pad, kv_dim)
            prefix[f"sub{sb}"] = {"k": k_pre[rows][:, None],
                                  "v": v_pre[rows][:, None]}
        toks = list(suffix_tokens) + [0] * (s_pad - s)
        batch = {"tokens": torch.tensor([toks], dtype=torch.int32,
                                        device=self.device)}
        first, cache = forward_prefill(
            cfg, self.params, batch,
            last_index=torch.tensor([s - 1], dtype=torch.int32,
                                    device=self.device),
            prefix=prefix, prefix_len=plen)
        self.compute_tokens += s
        self.padded_tokens += (s_pad - s) + (p_pad - plen)
        self.reused_tokens += plen
        self.prefix_prefills += 1
        self._count_launch(("suffix", p_pad, s_pad, 0))
        layers = cache["layers"]
        k_suf = torch.stack([layers[f"sub{sb}"]["k"][bk, 0, :s]
                             for bk, sb in self._attn_order])
        v_suf = torch.stack([layers[f"sub{sb}"]["v"][bk, 0, :s]
                             for bk, sb in self._attn_order])
        # stitch with the REAL prefix rows only (bucket pads sliced off)
        k = torch.cat([k_pre[:, :plen].to(k_suf.dtype), k_suf], dim=1)
        v = torch.cat([v_pre[:, :plen].to(v_suf.dtype), v_suf], dim=1)
        out = PrefillOutput(int(first.item()), k, v, None, plen + s)
        self._emit_layers(on_layer, 0, k, v)
        return out

    def iter_chunks(self, tokens: Sequence[int], *, chunk_tokens: int,
                    frames: Optional[object] = None):
        raise unported("chunked prefill", 13)

    def run_chunked(self, tokens: Sequence[int], *, chunk_tokens: int,
                    frames: Optional[object] = None) -> PrefillOutput:
        raise unported("chunked prefill", 13)


class DecodeEngine:
    """Continuous-batched paged decode over a PagedKVPool.

    Slot state lives in fixed-shape tensors over ``max_slots`` (tokens,
    positions, active mask, the power-of-two bucketed block table, and
    the indices of the active slots whose KV rows a step writes), pushed
    to the device only after admissions and evictions. A step is one
    ``forward_decode_step`` that writes the pool in place and one
    device->host copy of the argmax."""

    def __init__(self, cfg: ModelConfig, params: Tree, pool: PagedKVPool,
                 *, max_slots: int = 8, fused: Optional[bool] = None,
                 spec=None):
        check_dense(cfg)
        if fused is False:
            raise unported("eager decode (fused=False)", 12)
        if spec is not None:
            raise unported("speculative decode (spec=)", 14)
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.max_slots = max_slots
        dev = pool.device
        self.device = dev
        # host mirrors (admission bookkeeping) ...
        self.rid: List[Optional[int]] = [None] * max_slots
        self.pos = np.zeros(max_slots, np.int64)      # tokens so far
        self.last_tok = np.zeros(max_slots, np.int32)
        # ... and the fixed-shape device state of the fused step
        self._slot_layers = decode_slot_state(cfg, max_slots, device=dev)
        self._tokens = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._active = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self._rows = torch.zeros(0, dtype=torch.int64, device=dev)
        self._table_w = 1                             # pow2 table bucket
        self._table = torch.full((max_slots, 1), -1, dtype=torch.int32,
                                 device=dev)
        self._caps = np.zeros(max_slots, np.int64)    # tokens allocatable
        self._dirty = True        # host mirrors ahead of device tensors
        self.fused_steps = 0

    # ------------------------------------------------------------- slots
    def free_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.rid) if r is None]

    def active_slots(self) -> List[int]:
        return [i for i, r in enumerate(self.rid) if r is not None]

    def admit(self, rid: int, out: PrefillOutput, blocks: Sequence[int],
              slot: Optional[int] = None,
              prompt: Optional[Sequence[int]] = None) -> int:
        """Attach a transferred request to a free slot. Its prompt KV must
        already be in ``self.pool`` under ``blocks``, and its FULL block
        allocation (prompt + generation room) must be in place."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free decode slot")
            slot = free[0]
        self.rid[slot] = rid
        self.pos[slot] = out.prompt_len
        self.last_tok[slot] = out.first_token
        self._dirty = True
        return slot

    def evict(self, slot: int):
        self.rid[slot] = None
        self.pos[slot] = 0
        self.last_tok[slot] = 0
        self._dirty = True

    def evict_all(self) -> List[int]:
        slots = self.active_slots()
        for s in slots:
            self.evict(s)
        return slots

    # -------------------------------------------------------------- step
    def step(self) -> Dict[int, int]:
        """One decode iteration over all active slots: {slot: token}."""
        return self._step_fused()

    def _sync_device(self):
        """Push host slot mirrors into the fixed-shape device tensors
        (after admissions/evictions only: host->device copies)."""
        need = max((len(self.pool.owned(r)) for r in self.rid
                    if r is not None), default=1)
        while self._table_w < need:
            self._table_w *= 2
        dev = self.device
        active = [r is not None for r in self.rid]
        self._tokens = torch.from_numpy(self.last_tok.copy()).to(dev)
        self._pos = torch.from_numpy(self.pos.astype(np.int32)).to(dev)
        self._active = torch.tensor(active, dtype=torch.bool, device=dev)
        self._rows = torch.tensor(self.active_slots(), dtype=torch.int64,
                                  device=dev)
        self._table = torch.from_numpy(self.pool.block_tables(
            list(self.rid), self._table_w)).to(dev)
        bs = self.pool.block_size
        self._caps = np.asarray(
            [len(self.pool.owned(r)) * bs if r is not None else 0
             for r in self.rid], np.int64)
        self._dirty = False

    def _step_fused(self) -> Dict[int, int]:
        act = self.active_slots()
        if not act:
            return {}
        if self._dirty:
            self._sync_device()
        # a position past the slot's allocation would index past its
        # block table: fail loudly (caps snapshotted at sync)
        over = [s for s in np.nonzero(self.pos >= self._caps)[0]
                if self.rid[s] is not None]
        if over:
            s_i = over[0]
            raise IndexError(
                f"slot {s_i} (rid {self.rid[s_i]}): token position "
                f"{int(self.pos[s_i])} outside its "
                f"{int(self._caps[s_i])}-token block allocation")
        nxt, toks, pos, storage, layers = forward_decode_step(
            self.cfg, self.params, self.pool.storage, self._table,
            self._tokens, self._pos, self._active, self._slot_layers,
            block_size=self.pool.block_size, write_rows=self._rows)
        self.pool.set_storage(storage)       # written in place
        self._slot_layers = layers
        self._tokens, self._pos = toks, pos
        self.fused_steps += 1
        out_np = nxt.cpu().numpy()           # the ONE host sync per step
        out: Dict[int, int] = {}
        for s_i in act:
            self.pos[s_i] += 1
            self.last_tok[s_i] = out_np[s_i]
            out[s_i] = int(out_np[s_i])
        return out
