"""What this port does not cover yet, and where it is planned.

The port serves all 11 config families (the whisper encoder-decoder and
the pixtral VLM backbone among them), chunked prefill with decode-side
absorption, fault injection and recovery, the RatioAdjuster with its
role flips and the autoscaler (ROADMAP.md queue A items 1-11, 13, 15 and
16). Everything else raises NotImplementedError naming the queue A item
that brings it, rather than silently degrading to something else: the
eager decode loop, the staged tick shim and exact-length prefill (12),
``spec=`` (14), and sliding-window attention, which only the TPU launch
drivers reach (18).
"""
from __future__ import annotations

ITEMS = {
    12: "legacy baselines (eager decode, staged tick shim, exact-length "
        "prefill)",
    14: "speculative decoding",
    18: "launch and distribution (sliding-window attention)",
}


def unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md queue A item {item} "
        f"({ITEMS[item]})")
