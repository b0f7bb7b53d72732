"""Model configuration system.

A single generic config describes every assigned architecture family:
dense GQA transformers, MoE (shared + routed experts), Mamba2 SSD, hybrid
(attention/mamba interleave a la Jamba), encoder-decoder (Whisper) and
VLM decoders with stubbed modality frontends.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple


# Layer kinds used in `layer_pattern`.
ATTN = "attn"
MAMBA = "mamba"


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    num_shared_experts: int = 0
    d_ff_expert: int = 0        # per-expert ffn hidden dim (routed and shared)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # capacity accounting window (tokens): expert slots are counted
    # inside fixed windows of this many consecutive tokens per row,
    # aligned to the row start. Window-local counting is what makes
    # capacity dispatch right-pad-invariant (pads route to a null slot
    # and the slot threshold comes from the window's VALID token count)
    # and prefix-transparent (a suffix-only prefill whose prefix length
    # is a multiple of the window sees exactly the windows a full
    # prefill would give its suffix tokens).
    capacity_window: int = 16
    # which layers are MoE: "all" | "every_other" | "none"
    layout: str = "all"
    # dispatch algorithm: "capacity" (GShard-style scatter, may drop) or
    # "sorted" (argsort + ragged_dot, dropless — §Perf E-series lever)
    dispatch: str = "capacity"


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64          # Mamba2 "P"
    expand: int = 2
    conv_kernel: int = 4
    n_groups: int = 1
    chunk: int = 256            # SSD chunk length


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # sliding-window attention (None = full causal). Used by long_500k decode.
    sliding_window: Optional[int] = None
    # hybrid interleave: one entry per layer in a repeating block,
    # e.g. ("attn",) for pure transformers, ("attn",)+("mamba",)*7 for Jamba.
    layer_block: Tuple[str, ...] = (ATTN,)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # encoder-decoder (whisper): encoder layer count; 0 = decoder-only.
    encoder_layers: int = 0
    encoder_seq: int = 0        # fixed encoder length (e.g. 1500 audio frames)
    # modality frontend stub: None | "audio" | "vision".
    frontend: Optional[str] = None
    max_seq_len: int = 131072

    # ---- derived ----
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return ATTN not in self.layer_block

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kind list of length num_layers."""
        blk = self.layer_block
        reps = -(-self.num_layers // len(blk))
        return tuple((blk * reps)[: self.num_layers])

    def moe_layer_mask(self) -> Tuple[bool, ...]:
        if self.moe is None or self.moe.layout == "none":
            return tuple(False for _ in range(self.num_layers))
        if self.moe.layout == "all":
            return tuple(True for _ in range(self.num_layers))
        if self.moe.layout == "every_other":
            return tuple(i % 2 == 1 for i in range(self.num_layers))
        raise ValueError(self.moe.layout)

    @property
    def ssm_cfg(self) -> SSMConfig:
        assert self.ssm is not None
        return self.ssm

    # -- parameter count (for 6ND roofline term) --
    def param_count(self, active_only: bool = False) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.hd
        n = 0
        emb = self.vocab_size * d
        n += emb
        if not self.tie_embeddings:
            n += emb  # lm head
        kinds = self.layer_kinds()
        moe_mask = self.moe_layer_mask()
        for i in range(self.num_layers):
            n += 2 * d  # two norms
            if kinds[i] == ATTN:
                n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qkv_bias:
                    n += self.q_dim + 2 * self.kv_dim
            else:
                s = self.ssm_cfg
                d_in = s.expand * d
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                nheads = d_in // s.head_dim
                n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
                n += conv_dim * s.conv_kernel
                n += nheads * 2 + d_in  # A_log, D, dt_bias approx
                n += d_in * d  # out_proj
            if moe_mask[i]:
                m = self.moe
                ffe = m.d_ff_expert or ff
                per_exp = 3 * d * ffe
                if active_only:
                    n += (m.top_k + m.num_shared_experts) * per_exp
                    n += d * m.num_experts  # router
                else:
                    n += (m.num_experts + m.num_shared_experts) * per_exp
                    n += d * m.num_experts
            elif ff > 0:
                n += 3 * d * ff  # gated mlp
        # encoder (whisper)
        for _ in range(self.encoder_layers):
            n += 2 * d
            n += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            n += 3 * d * ff
        if self.is_encoder_decoder:
            # decoder cross-attention per layer
            n += self.num_layers * (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d)
        n += d  # final norm
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        period = len(self.layer_block)
        if self.moe is not None and self.moe.layout == "every_other":
            period = period * 2 // math.gcd(period, 2)
        kw = dict(
            name=self.name + "-reduced",
            num_layers=max(min(self.num_layers, 2), period),
            d_model=min(self.d_model, 128),
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            max_seq_len=4096,
        )
        nh = min(self.num_heads, 4)
        nkv = min(self.num_kv_heads, nh)
        # keep GQA ratio flavour: if original had grouped kv, keep 2 kv heads
        if self.num_kv_heads < self.num_heads:
            nkv = max(1, nh // 2)
        kw.update(num_heads=nh, num_kv_heads=nkv, head_dim=32)
        if self.moe is not None:
            kw["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_expert=min(self.moe.d_ff_expert or 256, 64),
            )
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16, chunk=32)
        if self.encoder_layers:
            kw["encoder_layers"] = 2
            kw["encoder_seq"] = 16
        if self.sliding_window is not None:
            kw["sliding_window"] = min(self.sliding_window, 64)
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# Sliding window used for dense archs on long_500k (sub-quadratic variant).
LONG_CONTEXT_WINDOW = 8192
