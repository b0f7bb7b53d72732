"""Activation-sharding context.

Counterpart of ``src/repro/distribution/ctx.py``. The step makers
(``models/steps.py``) enter ``sharding_ctx(mesh)`` when given a mesh (a
torch DeviceMesh with named dims); ``constrain(x, logical_axes)`` then
resolves the axes by the divisibility-aware rules, as JAX does, and
redistributes a DTensor to that layout. A plain tensor is left alone, and
so is everything outside a context.

The port's modeling calls no ``constrain``: no tensor on its paths is a
DTensor, because sharded engines are out of this round's scope (ROADMAP
ground rules). The function is here so that a sharded engine has JAX's
activation rules to call.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Sequence

from repro_torch.distribution.sharding import (AxisRules, mesh_axes,
                                               placements, spec_from_axes)

ACT_RULES: AxisRules = {
    "batch": ("pod", "data"),
    # sequence-parallel residual stream at layer boundaries: off by
    # default, as in JAX (kept as a switchable rule)
    "seq_act": (),
    "q_heads_act": ("model",),
    "vocab": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "d_inner": ("model",),
    "cache_seq": ("data", "pod"),
    "embed": (),
    # MoE dispatch buffers: unmapped by default; the expert-parallel rules
    # pin them to the canonical EP layout
    "expert_act": (),
    "cap_act": (),
    None: (),
}

# expert-parallel activation rules (prefill_ep): dispatch buffers (E, C,
# d) live expert -> model, capacity -> data
ACT_RULES_EP: AxisRules = dict(ACT_RULES)
ACT_RULES_EP["expert_act"] = ("model",)
ACT_RULES_EP["cap_act"] = ("data", "pod")

_tls = threading.local()


@contextmanager
def sharding_ctx(mesh, rules: Optional[AxisRules] = None):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules or ACT_RULES) if mesh is not None else None
    try:
        yield
    finally:
        _tls.ctx = prev


def constrain(x, axes: Sequence[Optional[str]]):
    """``x`` laid out by ``axes`` under the active context: a DTensor is
    redistributed, a plain tensor returned as it is."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    spec = spec_from_axes(axes, tuple(x.shape), mesh_axes(mesh), rules)
    if not any(p is not None for p in spec):
        return x  # nothing resolved: leave the layout as it is
    return x.redistribute(mesh, placements(spec, mesh))
