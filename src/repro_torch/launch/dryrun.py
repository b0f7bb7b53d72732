"""Plan one (arch, shape, mesh) step on the card without running it.

    python -m repro_torch.launch.dryrun --arch granite-3-8b \
        --shape long_500k [--multi-pod] [--mode decode_opt] [--out F.json]

Counterpart of ``src/repro/launch/dryrun.py``. JAX lowers and compiles
the step for a 256- or 512-chip mesh of fake host devices; the port
traces the whole step on the ``meta`` device (no storage, no card, no
``nvcc``), counts its flops and bytes (``launch/cost.py``), sizes each
argument's shard by the rule tables (``distribution/sharding.py``) and
prints the roofline terms at the card's published rates
(``launch/roofline.py``) in one line. Every number it prints is planned,
not measured.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Mapping

import torch

from repro_torch.configs import ALIASES, get_config
from repro_torch.distribution.ctx import ACT_RULES_EP
from repro_torch.distribution.sharding import shard_factor
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as roofline_lib
from repro_torch.launch.cost import count
from repro_torch.launch.specs import input_specs
from repro_torch.models import caches as caches_lib
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import param_count_actual
from repro_torch.models.steps import (decode_window, make_prefill_step,
                                      make_serve_step, make_train_step)

MICROBATCHES = (1, 2, 4, 8, 16)


def model_flops_total(cfg, shape) -> float:
    """6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode), N = active
    params excluding the embedding lookup (tied embeddings count once as
    the head)."""
    n = cfg.param_count(active_only=True)
    if not cfg.tie_embeddings:
        n -= cfg.vocab_size * cfg.d_model  # lookup-only embedding
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def skip_reason(arch: str, shape_name: str) -> str:
    if arch == "whisper-base" and shape_name == "long_500k":
        return ("skip: encoder-decoder with hard 448-token decoder limit; "
                "512k windowed decoder is out-of-family (DESIGN.md)")
    return ""


def args_bytes_per_dev(args, specs, mesh_shape: Mapping[str, int]) -> int:
    """Bytes of one card's shard of every argument leaf."""
    if isinstance(args, dict):
        return sum(args_bytes_per_dev(args[k], specs[k], mesh_shape)
                   for k in args)
    if isinstance(args, (list, tuple)):
        return sum(args_bytes_per_dev(a, s, mesh_shape)
                   for a, s in zip(args, specs))
    return args.numel() * args.element_size() \
        // shard_factor(specs, mesh_shape)


def auto_microbatches(cfg, shape, chips: int, args, mem_per_dev: int):
    """(gradient-accumulation factor, the train step's cost at it): the
    smallest factor in MICROBATCHES dividing the batch whose counted peak
    of the step's own tensors, spread over the cards, fits the card's
    memory beside the arguments' shards (the largest if none does)."""
    hbm = mesh_lib.card_memory_bytes()
    mbs = [m for m in MICROBATCHES if shape.global_batch % m == 0]
    for m in mbs:
        cost = count(make_train_step(cfg, microbatches=m), *args)
        if mem_per_dev + cost.peak_bytes / chips <= hbm:
            break
    return m, cost


def plan_one(arch: str, shape_name: str, mesh_shape: Mapping[str, int], *,
             mode: str = "", param_dtype: torch.dtype = torch.bfloat16
             ) -> dict:
    """The plan of one step: the roofline terms per card, the arguments'
    bytes per card, and how long the trace took."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    chips = math.prod(mesh_shape.values())
    mode = mode or shape.kind
    args, specs = input_specs(cfg, shape, mesh_shape, mode=mode,
                              param_dtype=param_dtype)
    mem_dev = args_bytes_per_dev(args, specs, mesh_shape)
    itemsize = torch.empty((), dtype=param_dtype).element_size()
    t0 = time.perf_counter()
    mb = 1
    if shape.kind == "train":
        mb, cost = auto_microbatches(cfg, shape, chips, args, mem_dev)
    elif shape.kind == "prefill":
        step = make_prefill_step(
            cfg, act_rules=ACT_RULES_EP if mode.endswith("_ep") else None)
        cost = count(step, *args)
    else:
        p_abs, cache, tok = args
        # a full cache: the position sets no shape, so no count
        cache = dict(cache, pos=shape.seq_len - 1)
        cost = count(make_serve_step(cfg, window=decode_window(cfg, shape)),
                     p_abs, cache, tok)
    t_trace = time.perf_counter() - t0

    b, s = shape.global_batch, shape.seq_len
    p_dev = param_count_actual(cfg) * float(itemsize) / chips
    if shape.kind == "decode":
        cache_dev = caches_lib.cache_num_bytes(
            cfg, b, s, window=decode_window(cfg, shape),
            bytes_per_el=itemsize) / chips
        tokens_dev = b / chips
    else:
        cache_dev = (caches_lib.cache_num_bytes(cfg, b, s,
                                                bytes_per_el=itemsize)
                     / chips if shape.kind == "prefill" else 0.0)
        tokens_dev = b * s / chips
    floor = roofline_lib.analytic_bytes_floor(
        params_bytes_dev=p_dev, cache_bytes_dev=cache_dev,
        tokens_dev=tokens_dev, d_model=cfg.d_model,
        num_layers=cfg.num_layers, kind=shape.kind)
    rl = roofline_lib.analyze(
        cost, chips=chips, model_flops_total=model_flops_total(cfg, shape),
        bytes_floor=floor, dtype=str(param_dtype).split(".")[1],
        mem_per_dev_bytes=mem_dev)
    return {"arch": arch, "shape": shape_name,
            "mesh": "x".join(str(n) for n in mesh_shape.values()),
            "mode": mode, "chips": chips, "microbatches": mb,
            "t_trace": t_trace, "kernels": cost.kernels,
            "peak_bytes_per_dev": cost.peak_bytes / chips,
            "roofline": rl.to_dict()}


def summary(r: dict) -> str:
    rl = r["roofline"]
    return (f"[dryrun] {r['arch']} x {r['shape']} x {r['mesh']} "
            f"mode={r['mode']} OK (planned, not measured) "
            f"compute={rl['compute_s'] * 1e3:.2f}ms "
            f"memory={rl['memory_s'] * 1e3:.2f}ms collective=not counted "
            f"dominant={rl['dominant']} "
            f"mem/dev={rl['mem_per_dev_bytes'] / 2**30:.2f}GiB "
            f"fits={rl['fits_hbm']} dtype={rl['dtype']} "
            f"microbatches={r['microbatches']} (trace {r['t_trace']:.1f}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="plan a step on the card")
    ap.add_argument("--arch", required=True, choices=sorted(ALIASES))
    ap.add_argument("--shape", required=True, choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="", help="override sharding mode "
                    "(e.g. decode_opt)")
    ap.add_argument("--out", default="", help="write JSON result here")
    a = ap.parse_args(argv)

    mesh_shape = mesh_lib.production_mesh_shape(a.multi_pod)
    reason = skip_reason(a.arch, a.shape)
    if reason:
        result = {"arch": a.arch, "shape": a.shape,
                  "mesh": "x".join(str(n) for n in mesh_shape.values()),
                  "skipped": reason}
        print(reason)
    else:
        result = plan_one(a.arch, a.shape, mesh_shape, mode=a.mode)
        print(summary(result))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
