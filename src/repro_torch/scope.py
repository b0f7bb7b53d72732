"""What this port does not cover yet, and where it is planned.

The port serves all 11 config families (the whisper encoder-decoder and
the pixtral VLM backbone among them), chunked prefill with decode-side
absorption, fault injection and recovery, the RatioAdjuster with its
role flips and the autoscaler, the legacy baselines (eager decode, the
staged tick shim, exact-length prefill), speculative decoding (ROADMAP.md
queue A items 1-16), the cluster simulator layer with its P/D groups,
regions and MLOps, priced by H100 serving profiles (item 20), and
training: the loss and its gradients (attention's through a hand-written
backward kernel), AdamW, the data pipeline, checkpoints in the JAX
package's format and the launcher (item 17). What is left raises
NotImplementedError naming the queue A item that brings it, rather than
silently degrading to something else: sliding-window attention, which
only the TPU launchers reach (18).
"""
from __future__ import annotations

ITEMS = {
    18: "launch and distribution (sliding-window attention)",
}


def unported(feature: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported yet: ROADMAP.md queue A item {item} "
        f"({ITEMS[item]})")
