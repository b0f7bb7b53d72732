"""Meta-device stand-ins for every input of a step, and their specs.

Counterpart of ``src/repro/launch/specs.py``: ``input_specs(cfg, shape,
mesh_shape)`` builds the arguments of the step the shape exercises
(train / prefill / decode, the decode cache windowed at ``long_500k``) as
tensors on ``meta``, which hold shapes and dtypes and no storage, and
the spec of every leaf (``distribution.sharding``) on a mesh of that
shape. One difference: the cache, the VLM's embeddings and the encoder's
frames are in ``param_dtype`` (the port serves its activations and
caches in the params' dtype), where JAX keeps them in bf16 whatever the
params; at the default bf16 the two agree.
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch

from repro_torch.distribution.sharding import (ShardingRules,
                                               batch_axes_for, make_specs)
from repro_torch.models import caches as caches_lib
from repro_torch.models import params as params_lib
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.models.params import tree_map
from repro_torch.models.steps import decode_window

Tree = Any


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Tree:
    b, s = shape.global_batch, shape.seq_len
    batch: Tree = {}
    if shape.kind in ("train", "prefill"):
        if cfg.frontend == "vision":
            batch["embeds"] = _meta((b, s, cfg.d_model), dtype)
        else:
            batch["tokens"] = _meta((b, s), torch.int32)
        if cfg.is_encoder_decoder:
            batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s), torch.int32)
    return batch


def abstract_opt_state(params_abs: Tree) -> Tree:
    def f32(t: torch.Tensor) -> torch.Tensor:
        return _meta(t.shape, torch.float32)
    return {"mu": tree_map(f32, params_abs), "nu": tree_map(f32, params_abs),
            "step": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                mesh_shape: Mapping[str, int], *, mode: Optional[str] = None,
                param_dtype: torch.dtype = torch.bfloat16
                ) -> Tuple[Tuple[Tree, ...], Tuple[Tree, ...]]:
    """(abstract_args, specs) for the step of ``shape``."""
    rules = ShardingRules.for_mode(mode or shape.kind)
    p_abs = params_lib.abstract_params(cfg, dtype=param_dtype)
    p_spec = make_specs(params_lib.param_axes(cfg), p_abs, mesh_shape,
                        rules.params)

    if shape.kind in ("train", "prefill"):
        batch = batch_specs(cfg, shape, param_dtype)
        b_spec = make_specs(batch_axes_for(batch), batch, mesh_shape,
                            rules.batch)
        if shape.kind == "prefill":
            return (p_abs, batch), (p_spec, b_spec)
        opt = abstract_opt_state(p_abs)
        opt_spec = {"mu": p_spec, "nu": p_spec, "step": ()}
        return (p_abs, opt, batch), (p_spec, opt_spec, b_spec)

    if shape.kind == "decode":
        b, s = shape.global_batch, shape.seq_len
        window = decode_window(cfg, shape)
        cache = caches_lib.abstract_cache(cfg, b, s, window=window,
                                          dtype=param_dtype)
        c_spec = make_specs(caches_lib.cache_axes(cfg, b, s, window=window),
                            cache, mesh_shape, rules.cache)
        tok = _meta((b,), torch.int32)
        t_spec = make_specs(("batch",), tok, mesh_shape, rules.batch)
        return (p_abs, cache, tok), (p_spec, c_spec, t_spec)

    raise ValueError(shape.kind)
