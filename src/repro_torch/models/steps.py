"""Step functions: train, prefill and one-token serve, and the decode
window policy.

Counterpart of ``src/repro/models/steps.py``:

  * train_step(params, opt_state, batch) -> (params, opt_state, metrics)
  * prefill_step(params, batch) -> (first_token, cache)
  * serve_step(params, cache, tokens) -> (next_token, cache)   [ONE token]

The serving engines call ``forward_prefill`` and the fused decode step
directly; these steps are what the planner (``launch/dryrun.py``) traces
on ``meta``, what the artifact store warms up, and what the long-context
window runs through (``decode_window``). The prefill and serve steps run
under ``torch.no_grad``, and the serve step writes the cache in place.

On the card the serve step is JAX's compiled serve executable: one CUDA
graph per shape key (b, the token dtype, the cache's leaf shapes and
dtypes), captured at the key's first step (``serving/step_graph.py``'s
``StepGraphs``) and replayed. A graph reads and writes fixed addresses,
so each key owns a ring: the cache's layers, a token buffer and a
``pos`` buffer (a 0-d int32, as JAX keeps ``pos``). The key's first
cache becomes its ring; a later cache of the same shapes is copied into
it on admission, the counterpart of donating the cache to JAX's step,
and the sequence that held the ring, if its cache is still referenced,
first gets its state back in tensors of its own. The cache a step
returns holds the ring's layers, and passing it back replays at once. A
graph also reads the params at their addresses: another params object
at the same key replaces the graph with a new capture. On the CPU and on
``meta`` the step runs eagerly and writes the given cache in place.
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

import torch

from repro_torch.distribution.ctx import sharding_ctx
from repro_torch.models.config import (LONG_CONTEXT_WINDOW, ModelConfig,
                                       ShapeConfig)
from repro_torch.models.modeling import (forward_decode, forward_prefill,
                                         forward_train)
from repro_torch.models.params import tree_leaves, tree_unflatten
from repro_torch.serving.step_graph import StepGraphs
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
        leaves = tree_leaves(params)
        # a leaf the batch does not reach (the embed table when a VLM
        # batch brings its own embeddings) gets a zero gradient, as under
        # jax.grad: AdamW then keeps its moments at zero and still decays
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

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


class _Layers(dict):
    """The layers of a cache the serve step returned: a dict (so a
    weak reference can tell whether its sequence is still held)."""


class _Ring:
    """One shape key of the serve step on the card: its graph and the
    tensors the graph runs over (see the module docstring)."""

    def __init__(self, params: Tree, layers: Tree, tokens: torch.Tensor):
        self.params = params
        self.layers = {sub: dict(c) for sub, c in layers.items()}
        self.tok = torch.empty_like(tokens)
        self.pos = torch.empty((), dtype=torch.int32, device=tokens.device)
        self.graphs = StepGraphs(tokens.device)
        self.owner = lambda: None     # weak ref to the layers handed out

    def admit(self, layers: Tree) -> None:
        """Copy ``layers`` into the ring, after handing the sequence that
        holds it, if still referenced, its state in tensors of its own."""
        held = self.owner()
        if held is not None:
            for c in held.values():
                for n in c:
                    c[n] = c[n].clone()
        for sub, c in self.layers.items():
            for n, t in c.items():
                t.copy_(layers[sub][n])

    def hand_out(self) -> _Layers:
        out = _Layers({sub: dict(c) for sub, c in self.layers.items()})
        self.owner = weakref.ref(out)
        return out


def make_serve_step(cfg: ModelConfig, window: Optional[int] = None,
                    mesh=None):
    """serve_step(params, cache, tokens) -> (next (b,), cache): one token
    through ``forward_decode`` with a new "pos" returned (the earlier
    cache's is untouched). The given cache is donated: use the one
    returned. On the card a replayed CUDA graph after the first step of
    each shape key (see the module docstring); ``serve_step.graphs``
    holds each key's ``StepGraphs`` (captures, replays, capture wall)."""
    rings: Dict[tuple, _Ring] = {}
    graphs: Dict[tuple, StepGraphs] = {}

    def eager(params: Tree, cache: Tree, tokens: torch.Tensor):
        with sharding_ctx(mesh), torch.no_grad():
            return forward_decode(cfg, params, cache, tokens, window=window)

    def ring_for(params: Tree, layers: Tree, tokens: torch.Tensor):
        """(the ring of this step, the layers to return), admitting
        ``layers`` unless they are the ring's own."""
        for ring in rings.values():
            if ring.params is params and ring.owner() is layers:
                return ring, layers
        key = (tokens.shape[0], tokens.dtype,
               tuple((sub, n, tuple(t.shape), t.dtype)
                     for sub, c in layers.items() for n, t in c.items()))
        ring = rings.get(key)
        if ring is None or ring.params is not params:
            ring = rings[key] = _Ring(params, layers, tokens)
            graphs[key] = ring.graphs
        else:
            ring.admit(layers)
        return ring, ring.hand_out()

    def serve_step(params: Tree, cache: Tree, tokens: torch.Tensor):
        if not tokens.is_cuda:
            return eager(params, cache, tokens)
        ring, layers = ring_for(params, cache["layers"], tokens)
        ring.tok.copy_(tokens)
        ring.pos.copy_(cache["pos"])

        def step() -> torch.Tensor:
            nxt, new = eager(params, {"layers": ring.layers,
                                      "pos": ring.pos}, ring.tok)
            ring.pos.copy_(new["pos"])
            return nxt

        nxt = ring.graphs.run("serve", step)
        # the graph's output and pos buffer are rewritten by every replay
        return nxt.clone(), {"layers": layers, "pos": ring.pos.clone()}

    serve_step.graphs = graphs
    return serve_step
