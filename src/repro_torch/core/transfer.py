"""Block-free D2D KVCache transfer (paper §3.6) + link timing model (§2.2.3).

Two transfer modes between a paged sender pool and a paged receiver pool:

  * block-fixed (the baseline the paper criticizes): one message per block;
    every message pays the control/confirmation overhead -> poor bandwidth
    utilization (Fig. 4).
  * block-free (P/D-Serve): the sender linearizes the request's blocks into
    ONE contiguous buffer (kernels.kv_gather), a single message moves the
    bytes, and the receiver restores discrete blocks with RecvScatter
    (kernels.kv_scatter). Per-layer triggering is supported by slicing the
    contiguous buffer at layer boundaries (offset/length arithmetic).

The LinkModel gives transfer *time*; the byte movement itself is executed
for real on the torch pools (the CUDA gather/scatter kernels on the card)
so tests can assert bit-exact delivery. Counterpart of
``src/repro/core/transfer.py``.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class LinkModel:
    """t = n_msgs * c_ctrl + bytes / bw (+ multi-hop conflict jitter)."""
    bandwidth: float = 25e9        # bytes/s effective D2D (RDMA, ~200Gb/s)
    c_ctrl: float = 30e-6          # per-message control/confirmation cost
    hops: int = 1                  # ToR only = 1; ToR+spine = 2+
    conflict_prob: float = 0.0     # chance a multi-hop transfer conflicts
    conflict_penalty: float = 0.15 # seconds added on conflict (paper: 100s of ms)

    def time(self, nbytes: int, n_msgs: int,
             rng: Optional[random.Random] = None) -> float:
        t = n_msgs * self.c_ctrl + nbytes / self.bandwidth
        if self.hops > 1 and self.conflict_prob > 0 and rng is not None:
            if rng.random() < self.conflict_prob:
                t += rng.uniform(0.3, 1.0) * self.conflict_penalty
        return t


def layer_slices(layers: int, nbytes: int) -> List[Tuple[int, int]]:
    """(byte_offset, byte_length) of each layer's slice of the linearized
    block-free buffer (Fig. 10 offset/length arithmetic): the sender
    gathers blocks into ONE contiguous (layers, tokens, width) buffer, so
    layer ``i`` occupies one equal contiguous stripe."""
    layers = max(1, layers)
    assert nbytes % layers == 0, (nbytes, layers)
    stride = nbytes // layers
    return [(i * stride, stride) for i in range(layers)]


@dataclass
class TransferResult:
    nbytes: int
    n_msgs: int
    time_s: float
    mode: str
    per_layer: bool = False


class KVTransferEngine:
    """Moves a request's KV blocks from a sender pool to a receiver pool.

    Pools are `repro_torch.serving.kvcache.PagedKVPool`s sharing block geometry
    (paper: P and D use the same per-index device layout, so each transfer
    is shard-local). Timing comes from the LinkModel; data movement happens
    on the actual arrays via the gather/scatter ops so correctness is
    testable end to end.
    """

    def __init__(self, link: LinkModel = LinkModel(), *,
                 seed: int = 0):
        self.link = link
        self.rng = random.Random(seed)
        self.stats: List[TransferResult] = []

    # -------------------------------------------------------------- modes
    def transfer_block_fixed(self, src_pool, src_blocks: Sequence[int],
                             dst_pool, dst_blocks: Sequence[int]
                             ) -> TransferResult:
        """Baseline: one message per block per layer — discrete transfers
        with per-message confirmation (paper Fig. 4a)."""
        assert len(src_blocks) == len(dst_blocks)
        nbytes = 0
        n_msgs = 0
        for s, d in zip(src_blocks, dst_blocks):
            blk = src_pool.read_block(s)          # (layers, block, kv)
            dst_pool.write_block(d, blk)
            nbytes += blk.numel() * blk.element_size()
            n_msgs += blk.shape[0]                # one message per layer-block
        t = self.link.time(nbytes, n_msgs, self.rng)
        res = TransferResult(nbytes, n_msgs, t, "block_fixed")
        self.stats.append(res)
        return res

    def transfer_block_free(self, src_pool, src_blocks: Sequence[int],
                            dst_pool, dst_blocks: Sequence[int], *,
                            per_layer: bool = False) -> TransferResult:
        """P/D-Serve: gather blocks to ONE contiguous buffer at the sender,
        move bytes as a whole (or one message per layer when the per-layer
        trigger is enabled), RecvScatter restores blocks at the receiver."""
        assert len(src_blocks) == len(dst_blocks)
        buf = src_pool.gather_contiguous(src_blocks)   # (layers, tokens, kv)
        # "wire": a single byte-array move; offset/length per layer is
        # computable from (layer index, prompt len, kv width) — Fig. 10.
        dst_pool.scatter_contiguous(buf, dst_blocks)
        nbytes = buf.numel() * buf.element_size()
        n_msgs = buf.shape[0] if per_layer else 1
        t = self.link.time(nbytes, n_msgs, self.rng)
        res = TransferResult(nbytes, n_msgs, t, "block_free", per_layer)
        self.stats.append(res)
        return res
