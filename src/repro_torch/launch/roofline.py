"""Roofline terms of a planned step on the card.

Counterpart of ``src/repro/launch/roofline.py``, at the published rates
of one NVIDIA H100 80GB HBM3 at 700 W (``launch/mesh.py``):

compute term    = flops per card / the peak of the planned dtype
memory term     = max(bytes per card, the analytic floor) / the HBM rate
collective term = not counted (None, with the reason): no multi-card run
                  exists to count it

Flops and bytes come from ``launch/cost.py``'s count of the whole step on
``meta``, divided by the cards. Memory per card is the arguments' shard
bytes (params, optimizer state, cache, batch, by their specs): there is
no compiled memory analysis to add temporaries from, so ``fits`` says
whether the arguments fit.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.cost import Cost


def analytic_bytes_floor(*, params_bytes_dev: float, cache_bytes_dev: float,
                         tokens_dev: float, d_model: int, num_layers: int,
                         kind: str) -> float:
    """Lower bound on per-device HBM traffic for one step, independent of
    backend lowering noise. decode: weights + cache read once; prefill:
    weights once + activations ~8 tensor-touches/layer + cache write;
    train: weights fwd+bwd+remat reads, grad write/read, fp32 opt state
    read+write, activations ~12 touches/layer."""
    act = tokens_dev * d_model * 2.0 * num_layers
    if kind == "decode":
        return (params_bytes_dev + cache_bytes_dev
                + 8 * tokens_dev * d_model * 2)
    if kind == "prefill":
        return params_bytes_dev + cache_bytes_dev + 8 * act
    # train: 3 weight passes (fwd, remat-fwd, bwd) + bf16 grads (w+r) +
    # fp32 moments r+w (=8x bf16 param bytes) + fp32 master update
    return 3 * params_bytes_dev + 2 * params_bytes_dev \
        + 8 * params_bytes_dev + 12 * act


@dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: Optional[float]
    coll_note: str
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    dominant: str
    model_flops_total: float
    useful_ratio: float       # MODEL_FLOPS / (counted flops * chips)
    chips: int
    mem_per_dev_bytes: int
    fits_hbm: bool
    dtype: str
    peak_flops: float         # the rate the compute term divides by
    bytes_floor: float = 0.0

    def to_dict(self):
        return asdict(self)


def analyze(cost: Cost, *, chips: int, model_flops_total: float,
            bytes_floor: float = 0.0, dtype: str = "bfloat16",
            mem_per_dev_bytes: int = 0) -> Roofline:
    flops = cost.flops / chips
    nbytes = cost.bytes / chips
    peak = mesh_lib.PEAK_FLOPS[dtype]
    compute_s = flops / peak
    memory_s = max(nbytes, bytes_floor) / mesh_lib.HBM_BW
    terms = {"compute": compute_s, "memory": memory_s}
    return Roofline(
        flops_per_dev=flops, bytes_per_dev=nbytes,
        coll_bytes_per_dev=cost.coll_bytes, coll_note=cost.coll_note,
        compute_s=compute_s, memory_s=memory_s, collective_s=None,
        dominant=max(terms, key=terms.get),
        model_flops_total=model_flops_total,
        useful_ratio=model_flops_total / max(cost.flops, 1.0),
        chips=chips, mem_per_dev_bytes=int(mem_per_dev_bytes),
        fits_hbm=mem_per_dev_bytes <= mesh_lib.card_memory_bytes(),
        dtype=dtype, peak_flops=peak, bytes_floor=bytes_floor)
