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
padding). The model's operations are counted by the configuration's
reference module (``spec.reference``); the kernel byte counts here are
those of ``chip_smoke.py``'s phase 2 for the grouped-query attention
kernels, frozen here (a later kernel's counts sit beside its reader).
"""
from __future__ import annotations

import subprocess
from typing import Optional

from pdbench import spec

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
    """Weights a token multiplies through, as the configuration's
    reference module counts them."""
    return spec.reference(c).matmul_params_per_token(c)


def attention_pairs(prefix: int, new: int) -> int:
    """Causal (query, key) pairs of ``new`` rows after ``prefix`` cached
    rows: each row against the prefix and the new rows up to itself."""
    return new * prefix + new * (new + 1) // 2


def attention_flops(c: dict, pairs: int) -> float:
    """Attention's operations over ``pairs`` (query, key) pairs in every
    layer, as the configuration's reference module counts them."""
    return spec.reference(c).attention_flops(c, pairs)


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
