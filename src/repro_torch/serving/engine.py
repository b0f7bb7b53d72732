"""Real-compute P/D engines for the in-process mini-cluster, in PyTorch.

Counterpart of ``src/repro/serving/engine.py`` for every family (dense,
MoE, SSM, hybrid, the VLM backbone and the encoder-decoder).
PrefillEngine runs prefill batches (whole, suffix-only after a prefix
hit, or in aligned chunks) and hands out per-request KV, cross-attention
KV, Mamba hand-off state and recurrent-state snapshots; DecodeEngine runs
continuous-batched decode over a paged KV pool and per-slot Mamba and
cross-attention state, one fused iteration per step (or, with ``spec=``,
one speculative iteration retiring 1..k+1 tokens per slot).

Hot-loop shape discipline, as in the JAX engines:

  * prefill batches are right-padded to power-of-two length BUCKETS
    (from PREFILL_BUCKET_MIN) and run through one forward; padding is
    exact by the model's pad-invariance contract (padded queries attend
    to nothing, pads take no MoE capacity and leave the SSD recurrence
    untouched). Suffix-only (prefix-reuse) prefills also bucket the
    prefix KV length (hybrid stacks keep it exact, as JAX does), and the
    real prefix length is a 0-d int32 on the device. On the card a
    prefill forward (a bucket, a suffix, a chunk) at a JAX jit key the
    engine meets again is ONE CUDA graph, replayed (``serving/
    step_graph.py``, the counterpart of the shared
    ``_jit_forward_prefill``), so a warm suffix captures once per
    (prefix bucket, suffix bucket), never per prefix length;
  * the decode iteration runs over fixed-shape slot tensors (padded
    (max_slots,) tokens / positions / mask / caps and a power-of-two
    bucketed block table), static buffers written in place only when
    slot membership changes. Every slot's pool row is written on every
    step, the ones that must not land into the pool's drop block, so no
    shape depends on the active set. On the card the step is ONE CUDA
    graph per shape key, replayed (``serving/step_graph.py``, the
    counterpart of ``decode_step_jit``); the pool is written in place,
    and a step makes exactly one device->host copy (the argmax).

The legacy baselines stay as constructor arguments for measurement:
``PrefillEngine(bucket_prefill=False)`` runs equal-length sub-batches at
their exact lengths (through graphs keyed per exact length, JAX's own
cost for that baseline), ``PrefillEngine(jit_prefill=False)`` the eager
forward, ``DecodeEngine(fused=False)`` the eager step (the active slots
only, a block table built per step at its exact width).
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
from repro_torch.models.modeling import (forward_decode_step, forward_prefill,
                                         forward_spec_decode_step)
from repro_torch.models.params import block_period, num_blocks, tree_map
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.speculative import SpecConfig
from repro_torch.serving import spans, step_graph
from repro_torch.serving.step_graph import StepGraphs

Tree = dict

# layer-streaming callback: (batch_index, attn_layer_index, k_layer
# (tokens, kv_dim), v_layer, network_depth_fraction), invoked in network
# order so a transfer scheduler can ship layer i while later layers are
# still in flight (per-layer triggering, paper Fig. 10)
OnLayer = Callable[[int, int, torch.Tensor, torch.Tensor, float], None]

# smallest prefill length bucket; buckets double up to cfg.max_seq_len
PREFILL_BUCKET_MIN = 16
# card bytes an engine's prefill graphs may keep (outputs and static
# inputs) before the least recently run are dropped
PREFILL_GRAPH_BUDGET = 4 << 30


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


def _cross_kv(cfg: ModelConfig, layers: Tree, row: int) -> Optional[Tree]:
    """{(blk, sub): (xk, xv)} (enc_seq, kv_dim) of batch row ``row`` of a
    stacked prefill cache, or None for a decoder-only stack. Each sub's
    leaves are copied once for all blocks, so the result owns its
    memory."""
    if not cfg.is_encoder_decoder:
        return None
    period = block_period(cfg)
    own = {sb: (layers[f"sub{sb}"]["xk"][:, row].clone(),
                layers[f"sub{sb}"]["xv"][:, row].clone())
           for sb in range(period)}
    return {(bk, sb): (own[sb][0][bk], own[sb][1][bk])
            for bk in range(num_blocks(cfg)) for sb in range(period)}


def _signature(tree) -> tuple:
    """The shapes and dtypes of a nested dict of tensors, its structure
    included: the part of a jit key the inputs give."""
    if isinstance(tree, dict):
        return tuple((k, _signature(tree[k])) for k in sorted(tree))
    return tuple(tree.shape), tree.dtype


def _frames_batch(frames: Sequence, device: torch.device) -> torch.Tensor:
    """Stub encoder frames (arrays or tensors of (enc_seq, d)) as one f32
    batch on ``device``, as JAX's jnp.asarray makes f32 of them."""
    return torch.stack([torch.as_tensor(f, dtype=torch.float32,
                                        device=device) for f in frames])


@dataclass
class PrefillOutput:
    first_token: int
    k: Optional[torch.Tensor]        # (attn_layers, tokens, kv_dim)
    v: Optional[torch.Tensor]
    mamba_state: Optional[Tree]      # (blk, sub) -> conv tails + SSD state
    prompt_len: int
    cross: Optional[Tree] = None     # enc-dec: (blk, sub) -> (xk, xv)
    # recurrent-state snapshots for the prefix store: absolute token
    # boundary -> (blk, sub) -> {"conv_x", "conv_b", "conv_c", "state"}
    snapshots: Optional[Dict[int, Tree]] = None


class PrefillEngine:
    """Batched prefill on real params; emits per-request KV, Mamba state
    and (enc-dec) cross-attention KV.

    ``run_suffix`` is the prefix-reuse fast path: given a gathered prefix
    KVCache it runs the forward over only the uncached suffix tokens
    (an encoder-decoder reruns its encoder over the request's frames).
    ``iter_chunks`` / ``run_chunked`` prefill a prompt in aligned chunks
    through the same machinery. ``compute_tokens`` counts real prompt
    tokens pushed through the forward; bucket padding is ledgered in
    ``padded_tokens``. ``prefill_batches`` / ``bucket_hits`` count
    launches and how many landed on an already-seen shape bucket.

    ``bucket_prefill=False`` (the measured baseline) groups prompts by
    exact length and runs suffix-only prefills unpadded; SSM/hybrid
    stacks then serve cold, as in JAX (their warm-state contract needs
    the bucketed geometry).

    Every forward goes through ``_prefill``, JAX's shared jitted prefill:
    one key per jit key (``step_graph.prefill_compile_count()``), and on
    the card one CUDA graph per key, captured at the key's second forward
    (the first runs eagerly, so a key met once costs the eager forward)
    and replayed after it over static input buffers the graph owns. The
    graphs keep at most PREFILL_GRAPH_BUDGET bytes, the least recently
    run dropped first. A failed capture or replay raises.
    ``jit_prefill=False`` runs the eager forward instead, with the prefix
    length as a host int: the measured baseline, not a fallback."""

    def __init__(self, cfg: ModelConfig, params: Tree, *,
                 bucket_prefill: Optional[bool] = None,
                 jit_prefill: Optional[bool] = None):
        self.bucket_prefill = bucket_prefill is not False
        self.jit_prefill = jit_prefill is not False
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
        self.chunked_prefills = 0    # prompts completed via iter_chunks
        self.chunked_chunks = 0      # individual chunk launches
        self._shapes_seen: set = set()
        self.graphs = StepGraphs(self.device, capture_at=2,
                                 budget=PREFILL_GRAPH_BUDGET)

    def graph_bytes(self) -> int:
        """Card memory the prefill graphs keep: their outputs in the graph
        pool and their static inputs."""
        return self.graphs.held_bytes

    def _prefill(self, tokens: torch.Tensor, last_index: torch.Tensor, *,
                 frames: Optional[torch.Tensor] = None,
                 prefix: Optional[Tree] = None, prefix_len: int = 0,
                 ssm_init: Optional[Tree] = None, snap_stride: int = 0
                 ) -> Tuple[torch.Tensor, Tree]:
        """``forward_prefill`` of (b, s) int32 ``tokens`` (on any device)
        -> (first (b,), {"layers", "pos"}), JAX's ``_prefill``. With
        ``jit_prefill`` the key is counted and the forward takes the
        prefix length as a 0-d int32: eagerly on the CPU and at a key's
        first forward on the card, then over the key's static buffers in
        a graph (``StepGraphs.run``), whose outputs the next forward at
        the key rewrites."""
        cfg, dev = self.cfg, self.device
        if not self.jit_prefill:
            batch = {"tokens": tokens.to(dev)}
            if frames is not None:
                batch["frames"] = frames
            return forward_prefill(cfg, self.params, batch,
                                   last_index=last_index.to(dev),
                                   prefix=prefix, prefix_len=prefix_len,
                                   ssm_init=ssm_init,
                                   snap_stride=snap_stride)
        inputs = {"tokens": tokens, "last_index": last_index,
                  "prefix_len": torch.full((), prefix_len, dtype=torch.int32,
                                           device=dev)}
        for name, t in (("frames", frames), ("prefix", prefix),
                        ("ssm_init", ssm_init)):
            if t is not None:
                inputs[name] = t
        key = (cfg, self.params["embed"].dtype, dev.type, snap_stride,
               _signature(inputs))
        step_graph.prefill_keys.add(key)

        def fwd(st: Tree) -> Tree:
            batch = {"tokens": st["tokens"]}
            if "frames" in st:
                batch["frames"] = st["frames"]
            first, cache = forward_prefill(
                cfg, self.params, batch, last_index=st["last_index"],
                prefix=st.get("prefix"), prefix_len=st["prefix_len"],
                ssm_init=st.get("ssm_init"), snap_stride=snap_stride)
            return {"first": first, "layers": cache["layers"],
                    "pos": cache["pos"]}
        out = self.graphs.run(key, fwd, inputs)
        return out["first"], {"layers": out["layers"], "pos": out["pos"]}

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
        (``prefix_align``). Exact-length engines keep SSM/hybrid stacks
        cold."""
        if self._mamba_order and not self.bucket_prefill:
            return False
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
        buckets, one forward per bucket. ``frames`` (one (enc_seq, d) stub
        per prompt) feeds an encoder-decoder's encoder. ``on_layer``
        streams each request's per-layer (k, v) in network order.
        ``snap_stride`` > 0 (a multiple of the SSD chunk, from the serving
        node) makes Mamba sublayers emit snapshots at stride boundaries
        into each output's ``snapshots``. An exact-length engine groups
        the prompts by length instead, unpadded."""
        by_len: Dict[int, List[int]] = {}
        for i, t in enumerate(token_lists):
            key = self._bucket_len(len(t)) if self.bucket_prefill else len(t)
            by_len.setdefault(key, []).append(i)
        outs: List[Optional[PrefillOutput]] = [None] * len(token_lists)
        for ln, idxs in by_len.items():
            sub = self._run_equal(
                [token_lists[i] for i in idxs],
                [frames[i] for i in idxs] if frames is not None else None,
                pad_to=ln, snap_stride=snap_stride)
            for i, o in zip(idxs, sub):
                outs[i] = o
                self._emit_layers(on_layer, i, o.k, o.v)
        return outs  # type: ignore[return-value]

    def _run_equal(self, token_lists: Sequence[Sequence[int]],
                   frames: Optional[Sequence], pad_to: int,
                   snap_stride: int = 0) -> List[PrefillOutput]:
        b = len(token_lists)
        lens = [len(t) for t in token_lists]
        s = pad_to
        assert s >= max(lens), (s, lens)
        toks = np.zeros((b, s), np.int32)
        for i, t in enumerate(token_lists):
            toks[i, :len(t)] = t
        fr = None
        if self.cfg.is_encoder_decoder:
            assert frames is not None, "enc-dec prefill needs frames"
            fr = _frames_batch(frames, self.device)
        self.compute_tokens += sum(lens)
        self.padded_tokens += b * s - sum(lens)
        self._count_launch((b, s, snap_stride))
        last = torch.tensor([ln - 1 for ln in lens], dtype=torch.int32)
        first, cache = self._prefill(torch.from_numpy(toks), last, frames=fr,
                                     snap_stride=snap_stride)
        first_host = first.tolist()
        layers = cache["layers"]
        outs: List[PrefillOutput] = []
        for i, ln in enumerate(lens):
            k, v = self._request_kv(layers, i, ln)
            outs.append(PrefillOutput(
                int(first_host[i]), k, v,
                _mamba_state(layers, self._mamba_order, i), ln,
                _cross_kv(self.cfg, layers, i),
                self._extract_snapshots(layers, i, ln, snap_stride, s,
                                        base=0)))
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
        sublayer; ``frames`` (enc_seq, d) feed an encoder-decoder's
        encoder, which reruns in full. The suffix is right-padded to its length bucket and an
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
        assert self.supports_prefix_reuse, cfg.name
        if not self.bucket_prefill:
            s_pad = s
        elif prefix_kv is not None and self._mamba_order:
            s_pad = self._bucket_len(plen + s) - plen
        else:
            s_pad = self._bucket_len(s)
        period, nblk = block_period(cfg), num_blocks(cfg)
        prefix: Optional[Tree] = None
        k_pre = v_pre = None
        p_pad = 0
        if prefix_kv is not None:
            p_pad = plen if self._mamba_order or not self.bucket_prefill \
                else self._bucket_len(plen)
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
        fr = None
        if cfg.is_encoder_decoder:
            assert frames is not None, "enc-dec prefill needs frames"
            fr = _frames_batch([frames], self.device)
        first, cache = self._prefill(
            torch.tensor([toks], dtype=torch.int32),
            torch.tensor([s - 1], dtype=torch.int32), frames=fr,
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
            _mamba_state(layers, self._mamba_order, 0), plen + s,
            _cross_kv(cfg, layers, 0),
            self._extract_snapshots(layers, 0, s, snap_stride, s_pad,
                                    base=plen))
        self._emit_layers(on_layer, 0, k, v)
        return out

    # ------------------------------------------------- chunked prefill
    def chunk_bounds(self, n: int, chunk_tokens: int) -> List[int]:
        """Interior cut points for a chunked prefill of an ``n``-token
        prompt: multiples of ``chunk_tokens`` rounded down to
        ``prefix_align`` (never below it), so each continuation is a
        legal ``run_suffix``; the last chunk keeps >= 1 token."""
        align = max(self.prefix_align, 1)
        step = max(align, (int(chunk_tokens) // align) * align)
        return list(range(step, n, step))

    def iter_chunks(self, tokens: Sequence[int], *, chunk_tokens: int,
                    frames: Optional[object] = None):
        """Chunked prefill (DynaServe-style): a cold first chunk, then
        ``run_suffix`` continuations over the stitched KV and (SSM/hybrid)
        the advanced recurrent state. Yields ``(n_chunk_tokens, out)``
        after each chunk, so an event-driven caller can interleave decode
        steps between chunks; the last ``out`` covers the whole prompt
        and gives ``run([tokens])[0]``'s first token."""
        toks = list(tokens)
        n = len(toks)
        cuts = [0] + self.chunk_bounds(n, chunk_tokens) + [n]
        out: Optional[PrefillOutput] = None
        for lo, hi in zip(cuts, cuts[1:]):
            chunk = toks[lo:hi]
            if lo == 0:
                out = self.run(
                    [chunk],
                    frames=[frames] if frames is not None else None)[0]
            else:
                pkv = None
                if out.k is not None:
                    pkv = torch.cat([out.k, out.v], dim=-1)
                out = self.run_suffix(
                    chunk, prefix_kv=pkv, frames=frames,
                    state=out.mamba_state
                    if self.requires_state_restore else None,
                    prefix_len=lo)
            self.chunked_chunks += 1
            yield hi - lo, out
        self.chunked_prefills += 1

    def run_chunked(self, tokens: Sequence[int], *, chunk_tokens: int,
                    frames: Optional[object] = None) -> PrefillOutput:
        """Drain ``iter_chunks``; returns the full-prompt output."""
        out: Optional[PrefillOutput] = None
        for _, out in self.iter_chunks(tokens, chunk_tokens=chunk_tokens,
                                       frames=frames):
            pass
        assert out is not None
        return out


class DecodeEngine:
    """Continuous-batched paged decode over a PagedKVPool.

    Slot state lives in static fixed-shape tensors over ``max_slots``
    (tokens, positions, active mask, caps, and one power-of-two bucketed
    block table per bucket), written in place only after admissions and
    evictions; Mamba conv tails and SSD state, and an encoder-decoder's
    cross KV, live in block-stacked slot buffers
    (``caches.decode_slot_state``), seeded at admission (the Mamba state
    then stepped in place). A step is one ``forward_decode_step``, which
    writes the pool and the static buffers in place, and one
    device->host copy of the argmax; on the card it is a CUDA graph
    replayed per shape key (``StepGraphs``; the first step at a key
    runs eagerly and captures).

    ``fused=False`` keeps the eager baseline: each step gathers the
    active slots' state, builds their block table at its exact width and
    runs the layer loop at that batch (the JAX loop's per-layer pool copy
    is an artefact of functional updates; the pool is written in place).

    ``spec=`` (a ``SpecConfig``) runs ``forward_spec_decode_step``: draft
    and target in one step, 1..k+1 tokens retiring per slot (``step()``
    then maps slots to token LISTS). The draft's paged KV rides the
    target's block tables in an engine-owned storage, its slot state in a
    second buffer tree, and its prompt is prefilled at admission by an
    engine-owned draft PrefillEngine (``admit(prompt=)``). Greedy
    speculation is lossless: the stream and, bit for bit, the pool equal
    plain greedy decode's."""

    def __init__(self, cfg: ModelConfig, params: Tree, pool: PagedKVPool,
                 *, max_slots: int = 8, fused: Optional[bool] = None,
                 spec: Optional[SpecConfig] = None):
        self.cfg = cfg
        self.params = params
        self.pool = pool
        self.max_slots = max_slots
        self.fused = fused is not False
        self.spec = spec
        dev = pool.device
        self.device = dev
        if spec is not None:
            if not self.fused:
                raise ValueError("speculative decode runs the fused step")
            if cfg.is_encoder_decoder:
                raise ValueError("speculative decode does not cover enc-dec "
                                 "families (the draft would need its own "
                                 "encoder pass per admission)")
            d_attn = len(_layer_order(spec.draft_cfg, attn=True))
            # with a drop block, as the pool's full_storage
            self._d_storage = torch.zeros(
                (max(d_attn, 1), pool.num_blocks + 1, pool.block_size,
                 2 * spec.draft_cfg.kv_dim), dtype=pool.dtype, device=dev)
            self._d_slot_layers = decode_slot_state(spec.draft_cfg,
                                                    max_slots, device=dev)
            # cold draft prefill at admission (the draft has no prefix
            # store; its cache is rebuilt per admission)
            self._d_prefill = PrefillEngine(spec.draft_cfg, spec.draft_params)
        # host mirrors (admission bookkeeping) ...
        self.rid: List[Optional[int]] = [None] * max_slots
        self.pos = np.zeros(max_slots, np.int64)      # tokens so far
        self.last_tok = np.zeros(max_slots, np.int32)
        # ... and the static fixed-shape device state of the fused step,
        # written in place (a captured step reads them at fixed addresses)
        self._slot_layers = decode_slot_state(cfg, max_slots, device=dev)
        self._tokens = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._pos = torch.zeros(max_slots, dtype=torch.int32, device=dev)
        self._active = torch.zeros(max_slots, dtype=torch.bool, device=dev)
        self._table_w = 1                             # pow2 table bucket
        self._tables: Dict[int, torch.Tensor] = {}    # bucket -> table
        self._caps = np.zeros(max_slots, np.int64)    # tokens allocatable
        self._caps_dev = torch.zeros(max_slots, dtype=torch.int32,
                                     device=dev)
        self._dirty = True        # host mirrors ahead of device tensors
        self.graphs = StepGraphs(dev)
        self.fused_steps = 0
        self.eager_steps = 0
        self.spec_steps = 0       # speculative iterations
        self.spec_emitted = 0     # tokens retired by those iterations

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
        Mamba state (``out.mamba_state``) and cross KV (``out.cross``)
        are copied into the slot. In ``spec=`` mode the caller also
        passes the ``prompt`` tokens: only the target's prefill crossed
        the wire, so the draft is prefilled here."""
        if slot is None:
            free = self.free_slots()
            if not free:
                raise RuntimeError("no free decode slot")
            slot = free[0]
        if self.spec is not None and prompt is None:
            raise ValueError("spec-mode admission needs the prompt tokens "
                             "(the draft model prefills at the decode node)")
        for (bk, sb), st in (out.mamba_state or {}).items():
            buf = self._slot_layers[f"sub{sb}"]
            for k2 in SSM_LEAVES:
                buf[k2][bk, slot].copy_(st[k2])
        for (bk, sb), (xk, xv) in (out.cross or {}).items():
            buf = self._slot_layers[f"sub{sb}"]
            buf["xk"][bk, slot].copy_(xk)
            buf["xv"][bk, slot].copy_(xv)
        if self.spec is not None:
            self._admit_draft(slot, list(prompt), blocks)
        self.rid[slot] = rid
        self.pos[slot] = out.prompt_len
        self.last_tok[slot] = out.first_token
        self._dirty = True
        return slot

    def _admit_draft(self, slot: int, prompt: List[int],
                     blocks: Sequence[int]):
        """Cold draft prefill and slot seeding: the draft's prompt KV goes
        into the draft storage at the TARGET's blocks (the draft rides the
        target's block tables), its Mamba state into the draft slot
        state."""
        d_out = self._d_prefill.run([prompt])[0]
        if d_out.k is not None:
            bs = self.pool.block_size
            toks = np.arange(d_out.prompt_len)
            dev = self.device
            blk = torch.from_numpy(np.asarray(list(blocks),
                                              np.int64)[toks // bs]).to(dev)
            off = torch.from_numpy(toks % bs).to(dev)
            self._d_storage[:, blk, off] = torch.cat(
                [d_out.k, d_out.v], dim=-1).to(self._d_storage.dtype)
        for (bk, sb), st in (d_out.mamba_state or {}).items():
            buf = self._d_slot_layers[f"sub{sb}"]
            for k2 in SSM_LEAVES:
                buf[k2][bk, slot].copy_(st[k2])

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
    def step(self) -> Dict[int, List[int]]:
        """One decode iteration over all active slots: {slot: [token, ...]},
        one token per slot (a burst of 1), or 1..k+1 in ``spec=`` mode."""
        if self.spec is not None:
            return self._step_spec()
        if self.fused:
            return self._step_fused()
        return self._step_eager()

    @property
    def _table(self) -> torch.Tensor:
        """The static block table of the current bucket."""
        t = self._tables.get(self._table_w)
        if t is None:
            t = self._tables[self._table_w] = torch.full(
                (self.max_slots, self._table_w), -1, dtype=torch.int32,
                device=self.device)
        return t

    def _sync_device(self):
        """Write the host slot mirrors into the static device tensors, in
        place (after admissions/evictions only: host->device copies)."""
        need = max((len(self.pool.owned(r)) for r in self.rid
                    if r is not None), default=1)
        while self._table_w < need:
            self._table_w *= 2
        bs = self.pool.block_size
        self._caps = np.asarray(
            [len(self.pool.owned(r)) * bs if r is not None else 0
             for r in self.rid], np.int64)
        for buf, host in (
                (self._tokens, self.last_tok),
                (self._pos, self.pos.astype(np.int32)),
                (self._active, np.asarray([r is not None for r in self.rid])),
                (self._table, self.pool.block_tables(list(self.rid),
                                                     self._table_w)),
                (self._caps_dev, self._caps.astype(np.int32))):
            buf.copy_(torch.from_numpy(host))
        self._dirty = False

    def _state_key(self) -> tuple:
        """The shape key of a fused step beyond the configs: JAX's static
        arguments and the shapes that retrace it, and the pool's address
        (a graph replays fixed addresses)."""
        st = self.pool.full_storage
        return (self.cfg, self.pool.block_size, self.max_slots,
                self._table_w, st.dtype, tuple(st.shape), st.data_ptr(),
                tuple((sub, k, tuple(v.shape))
                      for sub, c in sorted(self._slot_layers.items())
                      for k, v in sorted(c.items())))

    def _check_room(self, slots: List[int], caps) -> None:
        """A position past a slot's allocation (``caps[j]`` tokens for
        ``slots[j]``) would index past its block table: fail loudly."""
        for s_i, cap in zip(slots, caps):
            if self.pos[s_i] >= cap:
                raise IndexError(
                    f"slot {s_i} (rid {self.rid[s_i]}): token position "
                    f"{int(self.pos[s_i])} outside its "
                    f"{int(cap)}-token block allocation")

    def _run_step(self, key, step: Callable[[], torch.Tensor],
                  sp: Optional[spans.Span]) -> np.ndarray:
        """Run the fused step at ``key`` (a graph on the card) and read its
        output back: the step's ONE host sync. ``sp`` is the step's open
        ``decode.prep`` span, or None while the recorder is off."""
        g = self.graphs
        if sp is not None:
            sp = spans.then(sp, "decode.replay")
            before = g.replays, g.captures
        out = g.run(key, step)
        if sp is not None:
            sp.attrs["mode"] = "replayed" if g.replays > before[0] else \
                "captured" if g.captures > before[1] else "eager"
            sp = spans.then(sp, "decode.readback")
        self.pool.set_storage(self.pool.full_storage)   # written in place
        self.fused_steps += 1
        out_np = out.cpu().numpy()
        if sp is not None:
            spans.finish(sp)
        return out_np

    def _step_fused(self) -> Dict[int, List[int]]:
        act = self.active_slots()
        if not act:
            return {}
        sp = spans.begin("decode.prep", dirty=self._dirty) if spans.on() \
            else None
        if self._dirty:
            self._sync_device()
        self._check_room(act, self._caps[act])
        table = self._table

        def step() -> torch.Tensor:
            nxt, toks, pos, _, _ = forward_decode_step(
                self.cfg, self.params, self.pool.full_storage, table,
                self._tokens, self._pos, self._active, self._slot_layers,
                block_size=self.pool.block_size)
            self._tokens.copy_(toks)
            self._pos.copy_(pos)
            return nxt

        key = self._state_key()
        step_graph.decode_keys.add(key)
        out_np = self._run_step(key, step, sp)
        out: Dict[int, List[int]] = {}
        for s_i in act:
            self.pos[s_i] += 1
            self.last_tok[s_i] = out_np[s_i]
            out[s_i] = [int(out_np[s_i])]
        return out

    def _step_spec(self) -> Dict[int, List[int]]:
        """One speculative iteration: {slot: emitted tokens}, 1..k+1 per
        active slot, with the fused step's loud overflow check and still
        ONE device->host copy (the packed (slots, k+2) matrix)."""
        act = self.active_slots()
        if not act:
            return {}
        sp = spans.begin("decode.prep", dirty=self._dirty) if spans.on() \
            else None
        if self._dirty:
            self._sync_device()
        self._check_room(act, self._caps[act])
        k = self.spec.k
        table = self._table

        def step() -> torch.Tensor:
            packed, toks, pos, _, _, _, _ = forward_spec_decode_step(
                self.cfg, self.spec.draft_cfg, self.params,
                self.spec.draft_params, self.pool.full_storage,
                self._d_storage, table, self._tokens, self._pos,
                self._active, self._caps_dev, self._slot_layers,
                self._d_slot_layers, block_size=self.pool.block_size, k=k)
            self._tokens.copy_(toks)
            self._pos.copy_(pos)
            return packed

        d = self._d_storage
        key = (self.spec.draft_cfg, k, d.data_ptr(), tuple(d.shape),
               tuple((sub, kk, tuple(v.shape))
                     for sub, c in sorted(self._d_slot_layers.items())
                     for kk, v in sorted(c.items())), self._state_key())
        step_graph.spec_keys.add(key)
        out_np = self._run_step(key, step, sp)   # the packed matrix
        self.spec_steps += 1
        out: Dict[int, List[int]] = {}
        for s_i in act:
            n = int(out_np[s_i, k + 1])
            emit = [int(t) for t in out_np[s_i, :n]]
            self.pos[s_i] += n
            self.last_tok[s_i] = emit[-1]
            self.spec_emitted += n
            out[s_i] = emit
        return out

    def _step_eager(self) -> Dict[int, List[int]]:
        """The eager baseline: the active slots only, their block table
        built this step at the width of the largest allocation, their
        Mamba state gathered out of the slot buffers and written back."""
        act = self.active_slots()
        if not act:
            return {}
        dev = self.device
        n_act = len(act)
        act_t = torch.tensor(act, dtype=torch.int64, device=dev)
        toks = torch.from_numpy(self.last_tok[act].copy()).to(dev)
        pos = torch.from_numpy(self.pos[act].astype(np.int32)).to(dev)
        owned = [len(self.pool.owned(self.rid[s])) for s in act]
        self._check_room(act, [n * self.pool.block_size for n in owned])
        nblocks = max(owned)
        bt = torch.from_numpy(self.pool.block_tables(
            [self.rid[s] for s in act], nblocks)).to(dev)
        layers = tree_map(lambda x: x[:, act_t], self._slot_layers)
        nxt, _, _, storage, layers = forward_decode_step(
            self.cfg, self.params, self.pool.full_storage, bt, toks, pos,
            torch.ones(n_act, dtype=torch.bool, device=dev), layers,
            block_size=self.pool.block_size)
        self.pool.set_storage(storage)       # written in place
        for sub, c in layers.items():
            for k2 in SSM_LEAVES:
                if k2 in c:
                    self._slot_layers[sub][k2][:, act_t] = c[k2]
        self.eager_steps += 1
        self._dirty = True       # device token/pos mirrors are now stale
        out_np = nxt.cpu().numpy()
        out: Dict[int, List[int]] = {}
        for j, s_i in enumerate(act):
            self.pos[s_i] += 1
            self.last_tok[s_i] = out_np[j]
            out[s_i] = [int(out_np[j])]
        return out
