"""Heterogeneous node classes of the autoscaler's shared node pool,
copied from ``src/repro/core/profiles.py``. The simulator's serving
profiles (derived there from a TPU's peak rates) are not part of the
port.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class NodeClass:
    """One hardware class in the shared autoscaler node pool.

    The real engines execute the same compute regardless of class (token
    streams are class-invariant); a class only scales the VIRTUAL
    service time its node charges the event clock — prefill-heavy nodes
    run prefill batches faster and decode steps slower, decode-heavy
    the inverse. ``role_bias`` steers the pool's lease choice: the
    autoscaler prefers a prefill-heavy node when growing the P side of
    a group, falling back to balanced then off-bias classes when the
    preferred inventory is exhausted. ``provision_level`` picks the
    ``core.mlops.substitute_ready_delay`` timeline a provisioning event
    pays before the node takes traffic (one stateless container:
    connect + model load + health)."""
    name: str
    role_bias: str = ""              # "P" | "D" | "" (no preference)
    prefill_scale: float = 1.0       # service-time multiplier (<1 faster)
    decode_scale: float = 1.0
    provision_level: str = "node_replace"


BALANCED = NodeClass("balanced")
PREFILL_HEAVY = NodeClass("prefill-heavy", role_bias="P",
                          prefill_scale=0.6, decode_scale=1.5)
DECODE_HEAVY = NodeClass("decode-heavy", role_bias="D",
                         prefill_scale=1.5, decode_scale=0.6)

NODE_CLASSES = {c.name: c for c in (BALANCED, PREFILL_HEAVY, DECODE_HEAVY)}
