"""What this port does not cover yet, and where it is planned.

The port serves all 11 config families (the whisper encoder-decoder and
the pixtral VLM backbone among them), chunked prefill with decode-side
absorption, fault injection and recovery, the RatioAdjuster with its
role flips and the autoscaler, the legacy baselines (eager decode, the
staged tick shim, exact-length prefill), speculative decoding (ROADMAP.md
queue A items 1-16) and the cluster simulator layer with its P/D groups,
regions and MLOps, priced by H100 serving profiles (item 20). Training
(item 17) has no module yet. What is left raises NotImplementedError
naming the queue A item that brings it, rather than silently degrading
to something else: sliding-window attention, which only the TPU launch
drivers reach (18).
"""
from __future__ import annotations

ITEMS = {
    18: "launch and distribution (sliding-window attention)",
}


def unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md queue A item {item} "
        f"({ITEMS[item]})")
