"""Step functions: train, prefill and one-token serve, and the decode
window policy.

Counterpart of ``src/repro/models/steps.py``:

  * train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  * prefill_step(params, batch) -> (first_token, cache)
  * serve_step(params, cache, tokens) -> (next_token, cache)   [ONE token]

The serving engines call ``forward_prefill`` and the fused decode step
directly; these steps are what the planner (``launch/dryrun.py``) traces
on ``meta``, what the artifact store warms up, and what the long-context
window runs through (``decode_window``). The port does not jit, so there
is nothing to lower; the prefill and serve steps run under
``torch.no_grad``, and the serve step writes the cache in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.distribution.ctx import sharding_ctx
from repro_torch.models.config import (LONG_CONTEXT_WINDOW, ModelConfig,
                                       ShapeConfig)
from repro_torch.models.modeling import (forward_decode, forward_prefill,
                                         forward_train)
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


def make_prefill_step(cfg: ModelConfig, window: Optional[int] = None,
                      mesh=None, act_rules=None):
    def prefill_step(params: Tree, batch: Tree):
        with sharding_ctx(mesh, act_rules), torch.no_grad():
            return forward_prefill(cfg, params, batch, window=window)

    return prefill_step


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None,
                    mesh=None):
    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor):
        with sharding_ctx(mesh), torch.no_grad():
            return forward_decode(cfg, params, cache, tokens, window=window)

    return serve_step
