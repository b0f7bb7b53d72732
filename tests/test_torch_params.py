"""The port's param trees against the JAX package's: ``param_specs`` key
for key and shape for shape on the five dense families, exact value
transfer through ``params_from_numpy``, and the torch-native init."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.params import param_specs as jax_specs
from repro_torch.configs import get_config
from repro_torch.models.params import (init_params, param_specs,
                                       params_from_numpy, tree_leaves)
from torch_parity import SERVED_ARCHS, both_params


def _flat(tree, prefix=()):
    """(path, leaf) pairs of a nested dict, keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _spec_paths(tree):
    return {p: (s.shape, s.axes, s.init, s.scale) for p, s in _flat(tree)}


@pytest.mark.parametrize("arch", SERVED_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_jax(arch, reduced):
    cfg = get_config(arch)
    jcfg = jax_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert _spec_paths(param_specs(cfg)) == _spec_paths(jax_specs(jcfg))


@pytest.mark.parametrize("arch", SERVED_ARCHS)
def test_params_from_numpy_preserves_every_value(arch):
    _, jp, _, tp = both_params(arch)
    flat_j, flat_t = dict(_flat(jp)), dict(_flat(tp))
    assert set(flat_j) == set(flat_t)
    for path, arr in flat_j.items():
        t = flat_t[path]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(arr),
                                      err_msg=str(path))


def test_params_from_numpy_rejects_mismatched_trees():
    cfg, jp, pcfg, _ = both_params("granite-3-8b")
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        params_from_numpy(pcfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(KeyError):
        params_from_numpy(pcfg, missing, device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_params_shapes_inits_and_seed(dtype):
    cfg = get_config("qwen1.5-110b").reduced()      # has zero-init biases
    p1 = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                     dtype=dtype)
    p2 = init_params(cfg, torch.Generator().manual_seed(3), device="cpu",
                     dtype=dtype)
    specs = param_specs(cfg)
    leaves, spec_leaves = tree_leaves(p1), tree_leaves(specs)
    assert len(leaves) == len(spec_leaves)
    for x, y, s in zip(leaves, tree_leaves(p2), spec_leaves):
        assert tuple(x.shape) == s.shape and x.dtype == dtype
        assert torch.equal(x, y)                     # seeded
        if s.init == "ones":
            assert torch.all(x == 1)
        elif s.init == "zeros":
            assert torch.all(x == 0)
        else:
            assert 0.5 * s.scale < x.float().std() < 1.5 * s.scale
