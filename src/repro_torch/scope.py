"""What this port does not cover yet, and where it is planned.

Everything outside the port's current scope raises NotImplementedError
naming the ROADMAP.md queue A item that brings it, rather than silently
degrading to something else.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

ITEMS = {
    11: "encoder-decoder and VLM layers",
    12: "legacy baselines (eager decode, staged tick shim, exact-length "
        "prefill)",
    13: "chunked prefill and decode-side prefill absorption",
    14: "speculative decoding",
    15: "fault injection and recovery",
    16: "autoscaling, RatioAdjuster and P/D role flips",
}


def unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md queue A item {item} "
        f"({ITEMS[item]})")


def check_served(cfg: ModelConfig) -> None:
    """The port serves decoder-only stacks (dense, MoE, SSM and hybrid);
    raise for encoder-decoder and VLM families."""
    if cfg.is_encoder_decoder or cfg.frontend is not None:
        raise unported(f"{cfg.name}: encoder-decoder/VLM", 11)
