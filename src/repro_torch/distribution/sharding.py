"""Logical-axis -> mesh-axis sharding rules with divisibility fallback.

Counterpart of ``src/repro/distribution/sharding.py``: the same rule
tables, modes and resolution (a mesh axis that does not divide a
dimension is dropped; within one leaf a mesh axis is used at most once,
dims resolved left to right). A mesh is given by its shape, a mapping
from axis name to size in the mesh's own order (``{"pod": 2, "data":
16, "model": 16}``), and a spec is the tuple JAX's ``PartitionSpec``
holds: per dim None, one axis name, or a tuple of names.

Layout. JAX splits a dim sharded over several mesh axes with the FIRST
axis named as the major one. ``local_slices`` computes each mesh
coordinate's slice by that convention, whatever the order. DTensor's
``Shard`` placements split a dim over several mesh dims with the LOWER
mesh dim as the major one, so ``placements`` can express a spec only
where its multi-axis entries name mesh axes in the mesh's order (axes of
size 1 split nothing and do not count). ``expert`` and ``cache_seq``
name ``("data", "pod")``, against the ``(pod, data, model)`` mesh: on a
multi-pod mesh a dim that both axes divide (deepseek-moe's 64 experts,
a batch-1 cache's sequence) gets a layout ``Shard`` cannot state, and
``placements`` refuses it rather than describe another layout. (Only a
private DTensor placement, ``_StridedShard``, could; the port uses no
private API.) The port's paths hold no DTensor: sharded engines are out
of this round's scope, and these rules feed the planner
(``launch/dryrun.py``) and the one-card mesh check of ``chip_smoke.py``.

Modes: see the JAX module (train / prefill / decode: 2D FSDP x TP;
decode_opt*: weight-stationary decode with the cache sharded by kv
heads, by sequence, or replicated; prefill_ep: experts over ``model``).
"""
from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

Tree = Any
AxisRules = Dict[Optional[str], Tuple[str, ...]]
Spec = Tuple[Any, ...]

# weights
PARAM_RULES_2D: AxisRules = {
    "embed": ("pod", "data"),
    "vocab": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "d_inner": ("model",),
    "expert": ("data", "pod"),
    "layers": (),
    None: (),
}

# weight-stationary decode: the contracting `embed` dim stays local
PARAM_RULES_TP: AxisRules = {
    "embed": (),
    "vocab": ("model",),
    "q_heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "d_inner": ("model",),
    "expert": ("data", "pod"),
    "layers": (),
    None: (),
}

# MoE expert-parallel over `model` (prefill): the per-expert ffn dim is
# replicated within the expert row
PARAM_RULES_EP = dict(PARAM_RULES_2D)
PARAM_RULES_EP["expert"] = ("model",)
PARAM_RULES_EP["ff"] = ()

CACHE_RULES: AxisRules = {
    "layers": (),
    "batch": ("pod", "data"),
    "cache_seq": ("data", "pod"),
    "kv_heads": ("model",),
    "d_inner": ("model",),
    None: (),
}

# the cache's sequence over `model` (flash-decoding style)
CACHE_RULES_SEQ: AxisRules = {
    "layers": (),
    "batch": ("pod", "data"),
    "cache_seq": ("model",),
    "kv_heads": (),
    "d_inner": ("model",),
    None: (),
}

# the KV cache replicated over `model`, only the Q heads sharded
CACHE_RULES_REPL: AxisRules = {
    "layers": (),
    "batch": ("pod", "data"),
    "cache_seq": (),
    "kv_heads": (),
    "d_inner": ("model",),
    None: (),
}

BATCH_RULES: AxisRules = {
    "batch": ("pod", "data"),
    "seq": (),
    "embed": (),
    None: (),
}


@dataclass(frozen=True)
class ShardingRules:
    params: AxisRules
    cache: AxisRules
    batch: AxisRules

    @staticmethod
    def for_mode(mode: str) -> "ShardingRules":
        if mode in ("train", "prefill", "decode"):
            return ShardingRules(PARAM_RULES_2D, CACHE_RULES, BATCH_RULES)
        if mode == "decode_opt":
            return ShardingRules(PARAM_RULES_TP, CACHE_RULES, BATCH_RULES)
        if mode == "prefill_ep":
            return ShardingRules(PARAM_RULES_EP, CACHE_RULES, BATCH_RULES)
        if mode == "decode_opt2":
            return ShardingRules(PARAM_RULES_TP, CACHE_RULES_SEQ,
                                 BATCH_RULES)
        if mode == "decode_opt3":
            return ShardingRules(PARAM_RULES_TP, CACHE_RULES_REPL,
                                 BATCH_RULES)
        raise ValueError(mode)


def spec_from_axes(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh_shape: Mapping[str, int], rules: AxisRules) -> Spec:
    """The spec of one leaf: each dim takes the mesh axes its logical
    axis maps to that divide it (and no earlier dim took); trailing
    unsharded dims are dropped, as PartitionSpec drops them."""
    used = set()
    parts = []
    for dim, ax in zip(shape, axes):
        got = []
        prod = 1
        for a in rules.get(ax, ()):
            if a in used or a not in mesh_shape:
                continue
            if dim % (prod * mesh_shape[a]) == 0:
                got.append(a)
                prod *= mesh_shape[a]
                used.add(a)
        parts.append(None if not got else got[0] if len(got) == 1
                     else tuple(got))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def make_specs(axes_tree: Tree, shapes_tree: Tree,
               mesh_shape: Mapping[str, int], rules: AxisRules) -> Tree:
    """The spec of every leaf of ``shapes_tree`` (tensors, or anything
    with ``.shape``) from the matching logical axes of ``axes_tree``."""
    if _is_axes(axes_tree):
        return spec_from_axes(axes_tree, tuple(shapes_tree.shape),
                              mesh_shape, rules)
    if isinstance(axes_tree, dict):
        return {k: make_specs(axes_tree[k], shapes_tree[k], mesh_shape,
                              rules) for k in axes_tree}
    raise TypeError(f"not a tree of axis tuples: {axes_tree!r}")


def batch_axes_for(batch_tree: Tree) -> Tree:
    """Logical axes of an input batch: dim 0 is the batch, the rest
    unsharded."""
    return {k: (("batch",) + (None,) * (x.dim() - 1) if x.dim() else ())
            for k, x in batch_tree.items()}


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_factor(spec: Spec, mesh_shape: Mapping[str, int]) -> int:
    """How many ways a leaf of this spec is split (its bytes on one
    device are its total over this)."""
    return math.prod(mesh_shape[a] for e in spec for a in _entry_axes(e))


def local_slices(spec: Spec, shape: Sequence[int],
                 mesh_shape: Mapping[str, int]
                 ) -> Dict[Tuple[int, ...], Tuple[slice, ...]]:
    """Each mesh coordinate's slice of a leaf, by JAX's convention (a dim
    split over axes (a1, a2, ...) is split into the product of their
    sizes, a1 major), as ``NamedSharding.devices_indices_map`` gives it.
    Coordinates are tuples in the mesh's axis order."""
    names = list(mesh_shape)
    out = {}
    for coord in itertools.product(*(range(mesh_shape[n]) for n in names)):
        at = dict(zip(names, coord))
        sl = []
        for d, size in enumerate(shape):
            axes = _entry_axes(spec[d]) if d < len(spec) else ()
            if not axes:
                sl.append(slice(0, size))
                continue
            idx, n = 0, 1
            for a in axes:
                idx = idx * mesh_shape[a] + at[a]
                n *= mesh_shape[a]
            chunk = size // n
            sl.append(slice(idx * chunk, (idx + 1) * chunk))
        out[coord] = tuple(sl)
    return out


def mesh_axes(mesh) -> Dict[str, int]:
    """A mesh's shape as {axis name: size} in its own order, from a torch
    DeviceMesh (its ``mesh_dim_names``) or such a mapping."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of a spec on ``mesh`` (a DeviceMesh with named
    dims, or its {name: size}): ``Shard(d)`` on each mesh dim that splits
    tensor dim d, ``Replicate()`` elsewhere. Raises ValueError for a dim
    split over mesh axes named against the mesh's order (see the module
    note): Shard would describe another layout."""
    from torch.distributed.tensor import Replicate, Shard
    shape = mesh_axes(mesh)
    names = list(shape)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        split = [names.index(a) for a in axes if shape[a] > 1]
        if split != sorted(split):
            raise ValueError(
                f"dim {d} of spec {spec} is split over mesh axes {axes} "
                f"against the mesh's order {tuple(names)}: DTensor's Shard "
                f"placements put the lower mesh dim major, JAX the first "
                f"axis named; use local_slices for this layout")
        for a in axes:
            out[names.index(a)] = Shard(d)
    return out


def distribute(tensor, spec: Spec, device_mesh):
    """``tensor`` as a DTensor laid out by ``spec`` on ``device_mesh``."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(tensor, device_mesh,
                             placements(spec, device_mesh))
