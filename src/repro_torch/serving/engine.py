"""Real-compute P/D engines for the in-process mini-cluster, in PyTorch.

Counterpart of ``src/repro/serving/engine.py`` for the decoder-only
families (dense, MoE, SSM and hybrid). PrefillEngine runs prefill
batches and hands out per-request KV, Mamba hand-off state and
recurrent-state snapshots; DecodeEngine runs continuous-batched decode
over a paged KV pool and per-slot Mamba state, one fused iteration per
step.

Hot-loop shape discipline, as in the JAX engines:

  * prefill batches are right-padded to power-of-two length BUCKETS
    (from PREFILL_BUCKET_MIN) and run through one forward; padding is
    exact by the model's pad-invariance contract (padded queries attend
    to nothing, pads take no MoE capacity and leave the SSD recurrence
    untouched). Suffix-only (prefix-reuse) prefills also bucket the
    prefix KV length (hybrid stacks keep it exact, as JAX does);
  * the decode iteration runs eagerly over fixed-shape slot tensors
    (padded (max_slots,) tokens / positions / mask and a power-of-two
    bucketed block table), which are rebuilt only when slot membership
    changes. The paged pool is written in place, and a step makes
    exactly one device->host copy (the argmax). There is no jit here;
    CUDA graphs over the same fixed shapes are a later step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.caches import SSM_LEAVES, decode_slot_state
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.modeling import forward_decode_step, forward_prefill
from repro_torch.models.params import block_period, num_blocks
from repro_torch.scope import check_served, unported
from repro_torch.serving.kvcache import PagedKVPool

Tree = dict

# layer-streaming callback: (batch_index, attn_layer_index, k_layer
# (tokens, kv_dim), v_layer, network_depth_fraction), invoked in network
# order so a transfer scheduler can ship layer i while later layers are
# still in flight (per-layer triggering, paper Fig. 10)
OnLayer = Callable[[int, int, torch.Tensor, torch.Tensor, float], None]

# smallest prefill length bucket; buckets double up to cfg.max_seq_len
PREFILL_BUCKET_MIN = 16


def _layer_order(cfg: ModelConfig, attn: bool) -> List[Tuple[int, int]]:
    """(blk, sub) pairs of the attention (or else the Mamba) layers, in
    network order."""
    period = block_period(cfg)
    kinds = cfg.layer_kinds()
    return [(b, s) for b in range(num_blocks(cfg)) for s in range(period)
            if (kinds[s] == ATTN) == attn]


def _mamba_state(layers: Tree, order: List[Tuple[int, int]], row: int,
                 j: Optional[int] = None) -> Tree:
    """{(blk, sub): {"conv_x", "conv_b", "conv_c", "state"}} of batch row
    ``row`` of a stacked prefill cache: the hand-off state, or with
    ``j`` the snapshot at stride boundary j + 1 ("snap_*" leaves). Each
    sub's leaf is copied once for all blocks, so the result owns its
    memory and pins no batch-wide cache."""
    own = {}
    for sb in {sb for _, sb in order}:
        c = layers[f"sub{sb}"]
        own[sb] = {k: (c[k][:, row] if j is None
                       else c[f"snap_{k}"][:, j, row]).clone()
                   for k in SSM_LEAVES}
    return {(bk, sb): {k: own[sb][k][bk] for k in SSM_LEAVES}
            for bk, sb in order}


@dataclass
class PrefillOutput:
    first_token: int
    k: Optional[torch.Tensor]        # (attn_layers, tokens, kv_dim)
    v: Optional[torch.Tensor]
    mamba_state: Optional[Tree]      # (blk, sub) -> conv tails + SSD state
    prompt_len: int
    cross: Optional[Tree] = None     # enc-dec (not ported): None
    # recurrent-state snapshots for the prefix store: absolute token
    # boundary -> (blk, sub) -> {"conv_x", "conv_b", "conv_c", "state"}
    snapshots: Optional[Dict[int, Tree]] = None


class PrefillEngine:
    """Batched prefill on real params; emits per-request KV and Mamba
    state.

    ``run_suffix`` is the prefix-reuse fast path: given a gathered prefix
    KVCache it runs the forward over only the uncached suffix tokens.
    ``compute_tokens`` counts real prompt tokens pushed through the
    forward; bucket padding is ledgered in ``padded_tokens``.
    ``prefill_batches`` / ``bucket_hits`` count launches and how many
    landed on an already-seen shape bucket."""

    def __init__(self, cfg: ModelConfig, params: Tree, *,
                 bucket_prefill: Optional[bool] = None):
        check_served(cfg)
        if bucket_prefill is False:
            raise unported("exact-length prefill (bucket_prefill=False)", 12)
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self._attn_order = _layer_order(cfg, attn=True)
        self._mamba_order = _layer_order(cfg, attn=False)
        period = block_period(cfg)
        total = num_blocks(cfg) * period
        self._layer_fractions: Tuple[float, ...] = tuple(
            (bk * period + sb + 1) / total for bk, sb in self._attn_order)
        self.compute_tokens = 0      # real prompt tokens through the fwd
        self.padded_tokens = 0       # bucket-padding tokens on top
        self.reused_tokens = 0       # tokens served from a prefix hit
        self.prefix_prefills = 0     # suffix-only prefills executed
        self.state_restores = 0      # warm runs seeded from a snapshot
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
        """Every served family reuses prefixes: attention stacks reuse
        the KV prefix, SSM/hybrid stacks also restore a recurrent-state
        snapshot cached at the reuse boundary (``requires_state_restore``),
        and capacity MoE needs the boundary on its capacity window
        (``prefix_align``)."""
        return bool(self._attn_order) or bool(self._mamba_order)

    @property
    def requires_state_restore(self) -> bool:
        """SSM/hybrid stacks: a warm hit restores conv tails and SSD
        state with any prefix KV."""
        return bool(self._mamba_order)

    @property
    def prefix_align(self) -> int:
        """Token alignment of a reused prefix: the capacity window for
        capacity-dispatch MoE (the suffix then sees the windows a full
        run gives it), the SSD chunk for Mamba layers (the scan carry at
        a chunk boundary is the state there, and the suffix keeps the
        cold run's chunk partition); hybrids take the lcm."""
        a = 1
        m = self.cfg.moe
        if m is not None and m.dispatch == "capacity" \
                and any(self.cfg.moe_layer_mask()):
            a = m.capacity_window
        if self._mamba_order:
            a = math.lcm(a, self.cfg.ssm_cfg.chunk)
        return a

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

    def run(self, token_lists: Sequence[Sequence[int]],
            frames: Optional[Sequence] = None,
            on_layer: Optional[OnLayer] = None,
            snap_stride: int = 0) -> List[PrefillOutput]:
        """Ragged prompts are grouped into padded power-of-two length
        buckets, one forward per bucket. ``on_layer`` streams each
        request's per-layer (k, v) in network order. ``snap_stride`` > 0
        (a multiple of the SSD chunk, from the serving node) makes Mamba
        sublayers emit snapshots at stride boundaries into each output's
        ``snapshots``."""
        if frames is not None:
            raise unported("encoder frames", 11)
        by_len: Dict[int, List[int]] = {}
        for i, t in enumerate(token_lists):
            by_len.setdefault(self._bucket_len(len(t)), []).append(i)
        outs: List[Optional[PrefillOutput]] = [None] * len(token_lists)
        for ln, idxs in by_len.items():
            sub = self._run_equal([token_lists[i] for i in idxs], pad_to=ln,
                                  snap_stride=snap_stride)
            for i, o in zip(idxs, sub):
                outs[i] = o
                self._emit_layers(on_layer, i, o.k, o.v)
        return outs  # type: ignore[return-value]

    def _run_equal(self, token_lists: Sequence[Sequence[int]],
                   pad_to: int, snap_stride: int = 0
                   ) -> List[PrefillOutput]:
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
        self._count_launch((b, s, snap_stride))
        last = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32,
                            device=self.device)
        first, cache = forward_prefill(self.cfg, self.params, batch,
                                       last_index=last,
                                       snap_stride=snap_stride)
        first_host = first.tolist()
        layers = cache["layers"]
        outs: List[PrefillOutput] = []
        for i, ln in enumerate(lens):
            k, v = self._request_kv(layers, i, ln)
            outs.append(PrefillOutput(
                int(first_host[i]), k, v,
                _mamba_state(layers, self._mamba_order, i), ln,
                None, self._extract_snapshots(layers, i, ln, snap_stride,
                                              s, base=0)))
        return outs

    def _request_kv(self, layers: Tree, row: int, n: int):
        """(k, v) (attn_layers, n, kv_dim) of one batch row, or (None,
        None) for attention-free stacks. torch.stack copies: the
        per-request KV owns its memory."""
        if not self._attn_order:
            return None, None
        return tuple(torch.stack([layers[f"sub{sb}"][name][bk, row, :n]
                                  for bk, sb in self._attn_order])
                     for name in ("k", "v"))

    def _extract_snapshots(self, layers: Tree, row: int, valid: int,
                           snap_stride: int, s_pad: int, base: int
                           ) -> Optional[Dict[int, Tree]]:
        """Per-request boundary snapshots from the stacked prefill cache:
        {base + j*stride: {(blk, sub): conv tails + SSD state}} for every
        stride boundary inside the row's VALID tokens (later boundaries
        hold pad garbage and are never stored). ``base`` offsets them to
        absolute prompt positions for suffix-only runs."""
        if not snap_stride or not self._mamba_order:
            return None
        snaps: Dict[int, Tree] = {}
        for j in range(1, s_pad // snap_stride + 1):
            t = j * snap_stride
            if t > valid:
                break
            snaps[base + t] = _mamba_state(layers, self._mamba_order, row,
                                           j - 1)
        return snaps

    def run_suffix(self, suffix_tokens: Sequence[int],
                   prefix_kv: Optional[torch.Tensor] = None,
                   frames: Optional[object] = None,
                   on_layer: Optional[OnLayer] = None, *,
                   state: Optional[Tree] = None,
                   prefix_len: Optional[int] = None,
                   snap_stride: int = 0) -> PrefillOutput:
        """Suffix-only prefill after a prefix hit.

        ``prefix_kv``: (attn_layers, plen, 2*kv_dim), the cached prefix
        gathered from the paged pool, K and V packed as the pool stores
        them; None for attention-free stacks (``prefix_len`` then gives
        plen). ``state`` is the boundary snapshot of SSM/hybrid stacks,
        (blk, sub) -> conv tails + SSD state, which seeds every Mamba
        sublayer. The suffix is right-padded to its length bucket and an
        attention-only prefix to its own bucket, with the real prefix
        length passed to the flash kernel (padded prefix keys are masked
        from every softmax); a hybrid keeps the prefix at its exact
        length and pads the suffix so prefix ++ suffix fills the cold
        run's bucket, as JAX does. Returns a PrefillOutput whose k/v
        cover the FULL prompt (prefix stitched back on, as fresh
        tensors), whose ``mamba_state`` is the restored state advanced
        over the suffix, and whose ``snapshots`` (with ``snap_stride``)
        sit at absolute boundaries."""
        cfg = self.cfg
        if frames is not None:
            raise unported("encoder frames", 11)
        if self.requires_state_restore:
            assert state is not None, \
                f"{cfg.name}: SSM warm hit needs a state snapshot"
        s = len(suffix_tokens)
        assert s >= 1, "prefix hit must leave at least one suffix token"
        plen = int(prefix_kv.shape[1]) if prefix_kv is not None \
            else int(prefix_len)
        assert prefix_len is None or int(prefix_len) == plen
        # capacity-MoE and SSD-chunk hits land on aligned boundaries (the
        # pool's aligned acquire guarantees it)
        assert plen % self.prefix_align == 0, (plen, self.prefix_align)
        if prefix_kv is not None and self._mamba_order:
            s_pad = self._bucket_len(plen + s) - plen
        else:
            s_pad = self._bucket_len(s)
        period, nblk = block_period(cfg), num_blocks(cfg)
        prefix: Optional[Tree] = None
        k_pre = v_pre = None
        p_pad = 0
        if prefix_kv is not None:
            p_pad = plen if self._mamba_order else self._bucket_len(plen)
            if p_pad != plen:
                prefix_kv = F.pad(prefix_kv, (0, 0, 0, p_pad - plen))
            kvd = cfg.kv_dim
            k_pre, v_pre = prefix_kv[..., :kvd], prefix_kv[..., kvd:]
            attn_idx = {pair: li for li, pair in enumerate(self._attn_order)}
            prefix = {}
            for sb in range(period):
                if (0, sb) not in attn_idx:
                    prefix[f"sub{sb}"] = {}   # Mamba sub: state, not KV
                    continue
                rows = [attn_idx[(bk, sb)] for bk in range(nblk)]
                # (num_blocks, b=1, p_pad, kv_dim)
                prefix[f"sub{sb}"] = {"k": k_pre[rows][:, None],
                                      "v": v_pre[rows][:, None]}
        ssm_init: Optional[Tree] = None
        if state is not None:
            mamba_subs = {sb for _, sb in self._mamba_order}
            # snapshot leaves stacked over blocks, batch dim 1
            ssm_init = {f"sub{sb}": {
                k2: torch.stack([state[(bk, sb)][k2][None]
                                 for bk in range(nblk)])
                for k2 in SSM_LEAVES} if sb in mamba_subs else {}
                for sb in range(period)}
        toks = list(suffix_tokens) + [0] * (s_pad - s)
        batch = {"tokens": torch.tensor([toks], dtype=torch.int32,
                                        device=self.device)}
        first, cache = forward_prefill(
            cfg, self.params, batch,
            last_index=torch.tensor([s - 1], dtype=torch.int32,
                                    device=self.device),
            prefix=prefix, prefix_len=plen, ssm_init=ssm_init,
            snap_stride=snap_stride)
        self.compute_tokens += s
        self.padded_tokens += (s_pad - s) + (p_pad - plen if p_pad else 0)
        self.reused_tokens += plen
        self.prefix_prefills += 1
        if state is not None:
            self.state_restores += 1
        self._count_launch(("suffix", p_pad, s_pad, snap_stride))
        layers = cache["layers"]
        k, v = self._request_kv(layers, 0, s)
        if k is not None:
            # stitch with the REAL prefix rows only (bucket pads sliced off)
            k = torch.cat([k_pre[:, :plen].to(k.dtype), k], dim=1)
            v = torch.cat([v_pre[:, :plen].to(v.dtype), v], dim=1)
        out = PrefillOutput(
            int(first.item()), k, v,
            _mamba_state(layers, self._mamba_order, 0), plen + s, None,
            self._extract_snapshots(layers, 0, s, snap_stride, s_pad,
                                    base=plen))
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
    to the device only after admissions and evictions; Mamba conv tails
    and SSD state live in block-stacked slot buffers
    (``caches.decode_slot_state``), seeded at admission and stepped in
    place. A step is one
    ``forward_decode_step`` that writes the pool in place and one
    device->host copy of the argmax."""

    def __init__(self, cfg: ModelConfig, params: Tree, pool: PagedKVPool,
                 *, max_slots: int = 8, fused: Optional[bool] = None,
                 spec=None):
        check_served(cfg)
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
        allocation (prompt + generation room) must be in place. Its
        Mamba state (``out.mamba_state``) is copied into the slot."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free decode slot")
            slot = free[0]
        for (bk, sb), st in (out.mamba_state or {}).items():
            buf = self._slot_layers[f"sub{sb}"]
            for k2 in SSM_LEAVES:
                buf[k2][bk, slot].copy_(st[k2])
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
