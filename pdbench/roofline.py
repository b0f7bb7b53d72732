"""The yardstick's peaks and the operations and bytes of the work the
window asked for, from the configuration's shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates):
3.35 TB/s of HBM and 495 TFLOP/s in TF32. No float32-accurate product on
the card runs faster than one TF32 pass (three passes make a 3xTF32
product), so every operation bound and ``mfu`` divide by 495 TFLOP/s and
no implementation of the same work can read over 100%. The card's power
limit is read beside them, since a card set below 700 W runs slower.

The formulas count each input byte read once and each output byte
written once, and the operations these inputs need (real rows, not bucket
padding). The kernel formulas are those of ``chip_smoke.py``'s phase 2,
frozen here.
"""
from __future__ import annotations

import subprocess
from typing import Optional

PEAK_FLOPS = 495e12      # TF32, dense
PEAK_BW = 3.35e12        # bytes/s of HBM3
F32 = 4


def power_limit() -> Optional[str]:
    """``name, power.limit`` of the cards as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def _dims(c: dict):
    hd = c["head_dim"]
    return hd, c["num_heads"] * hd, c["num_kv_heads"] * hd


def matmul_params_per_token(c: dict) -> int:
    """Weights a token multiplies through: attention projections, the
    feed-forward (a MoE token's router, top-k routed and shared experts)
    in every layer, and the LM head."""
    d, L = c["d_model"], c["num_layers"]
    _, qd, kvd = _dims(c)
    per_layer = 2 * d * qd + 2 * d * kvd
    m = c.get("moe")
    if m:
        f = m["d_ff_expert"]
        per_layer += d * m["num_experts"] \
            + (m["top_k"] + m["num_shared_experts"]) * 3 * d * f
    else:
        per_layer += 3 * d * c["d_ff"]
    return L * per_layer + d * c["vocab_size"]


def attention_pairs(prefix: int, new: int) -> int:
    """Causal (query, key) pairs of ``new`` rows after ``prefix`` cached
    rows: each row against the prefix and the new rows up to itself."""
    return new * prefix + new * (new + 1) // 2


def attention_flops(c: dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` in every layer and query head."""
    hd, qd, _ = _dims(c)
    return 4.0 * pairs * qd * c["num_layers"]


def forward_flops(c: dict, prefix: int, new: int) -> float:
    """Model operations of ``new`` tokens after ``prefix`` cached ones:
    every matmul weight twice per token, plus attention."""
    return 2.0 * new * matmul_params_per_token(c) \
        + attention_flops(c, attention_pairs(prefix, new))


def flash_prefill_bytes(c: dict, prefix: int, new: int) -> float:
    """One prompt's flash prefill in every layer: q and k, v of the new
    rows and k, v of the prefix read, the output and the row's
    log-sum-exp per head written."""
    _, qd, kvd = _dims(c)
    per_layer = (new * (2 * qd + 2 * kvd) + prefix * 2 * kvd
                 + new * c["num_heads"]) * F32
    return float(per_layer * c["num_layers"])


def paged_attention_bytes(c: dict, contexts, table_entries: int) -> float:
    """One decode step's paged attention in every layer: each active row's
    query read and output written, its context's K and V pages, the block
    table and the lengths."""
    _, qd, kvd = _dims(c)
    rows = len(contexts)
    per_layer = (2 * rows * qd + sum(contexts) * 2 * kvd) * F32 \
        + table_entries * 4 + rows * 4
    return float(per_layer * c["num_layers"])


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BW)
