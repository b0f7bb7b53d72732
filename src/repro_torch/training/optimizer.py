"""Minimal AdamW over the port's param trees, f32 moments.

Counterpart of ``src/repro/training/optimizer.py``, with its arithmetic
in its order: the global-norm clip scales every gradient, the moments
update, the bias corrections divide them, and the weight decay is added
to the update, u = m^ / (sqrt(v^) + eps) + wd * p, then p -= lr * u.
``torch.optim.AdamW`` orders this differently (it decays p before the
step), so it is not used. Params and moments are updated IN PLACE, one
leaf at a time (JAX returned new trees): at full width params, grads and
both moments are already four copies of the model.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

Tree = Dict[str, Any]


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params: Tree) -> Tree:
    """Zero f32 moments beside every leaf and a step count of 0."""
    def zeros(p: torch.Tensor) -> torch.Tensor:
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Tree,
                 cfg: AdamWConfig = AdamWConfig()
                 ) -> Tuple[Tree, Tree, torch.Tensor]:
    """One step: (params, state, the gradients' global norm before the
    clip). ``params`` and the moments of ``state`` are updated in place
    and returned; ``state["step"]`` is a new tensor."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                            tree_leaves(state["mu"]),
                            tree_leaves(state["nu"])):
        g = g.float() * scale
        mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        nu.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.float()
        p.copy_(p.float() - cfg.lr * u)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, \
        gnorm
