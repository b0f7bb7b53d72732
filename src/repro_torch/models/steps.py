"""The training step, and the decode window policy.

Counterpart of ``src/repro/models/steps.py``: ``make_train_step`` and
``decode_window``. The prefill and serve steps of the JAX module are the
engines' business here (``serving/engine.py`` calls ``forward_prefill``
and ``forward_decode_step`` directly), and the port does not jit, so
there is nothing to lower.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.config import (LONG_CONTEXT_WINDOW, ModelConfig,
                                       ShapeConfig)
from repro_torch.models.modeling import forward_train
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamWConfig, adamw_update

Tree = Dict[str, Any]


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    """Sliding-window policy: long_500k on attention archs uses the
    ring-buffer windowed variant (sub-quadratic); everything else is full."""
    if shape.kind != "decode":
        return None
    if shape.seq_len > 131072 and not cfg.attn_free:
        return min(LONG_CONTEXT_WINDOW, shape.seq_len)
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, shape.seq_len)
    return None


def make_train_step(cfg: ModelConfig, opt: AdamWConfig = AdamWConfig(),
                    remat: bool = True, microbatches: int = 1):
    """train_step(params, opt_state, batch) -> (params, opt_state,
    metrics): the loss's gradients, AdamW. The params are trained in
    place (and made to require grad). ``microbatches`` > 1 accumulates
    f32 gradients over that many equal slices of the batch, one after the
    other, and averages them and the metrics."""

    def grads_of(params: Tree, batch: Tree):
        loss, metrics = forward_train(cfg, params, batch, remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            list(grads)

    def train_step(params: Tree, opt_state: Tree, batch: Tree):
        for p in tree_leaves(params):
            p.requires_grad_(True)
        if microbatches <= 1:
            loss, metrics, grads = grads_of(params, batch)
        else:
            def resh(x: torch.Tensor) -> torch.Tensor:
                b = x.shape[0]
                assert b % microbatches == 0, (b, microbatches)
                return x.reshape((microbatches, b // microbatches)
                                 + tuple(x.shape[1:]))

            mb = {k: resh(v) for k, v in batch.items()}
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)
                     for p in tree_leaves(params)]
            losses, metricses = [], []
            for i in range(microbatches):
                loss_i, m_i, g_i = grads_of(
                    params, {k: v[i] for k, v in mb.items()})
                for acc, x in zip(grads, g_i):
                    acc.add_(x.float())
                losses.append(loss_i)
                metricses.append(m_i)
            grads = [g / microbatches for g in grads]
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in metricses]).mean()
                       for k in metricses[0]}
        params, opt_state, gnorm = adamw_update(
            params, tree_unflatten(params, grads), opt_state, opt)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step
