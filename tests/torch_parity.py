"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Both stacks run identical weights: the JAX params of
``conftest.reduced_params`` (``init_params(cfg, PRNGKey(7))``) converted
through numpy with ``repro_torch.models.params.params_from_numpy``.
Inputs are made from a seed with numpy and handed to both. The port runs
on the CPU here, where every kernel call takes its plain PyTorch
version; the CUDA kernels themselves are compared with those plain
versions on the card (tests marked ``cuda``, and chip_smoke.py).

Tolerances, each with its reason:

* F32_TOL (1e-4, rtol and atol) on f32 logits, KV and attention outputs:
  torch and XLA sum in different orders;
* BF16_TOL (2e-2), as tests/test_kernels.py uses for bf16;
* copies (gather/scatter, pool bookkeeping) are bit-exact and greedy
  tokens are equal.
"""
import dataclasses

import jax
import numpy as np
import torch

from conftest import reduced_params
from repro_torch.configs import get_config as port_config
from repro_torch.models.params import params_from_numpy

# one intra-op thread per xdist worker: the port's CPU tensors are tiny
torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 2e-2

# the five dense decoder-only families the port serves
DENSE_ARCHS = ["granite-3-8b", "pangu-38b", "minicpm-2b",
               "mistral-nemo-12b", "qwen1.5-110b"]
# MoE, SSM (attention-free) and hybrid attention/Mamba/MoE families
MOE_SSM_ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b", "mamba2-2.7b",
                 "jamba-1.5-large-398b"]
SERVED_ARCHS = DENSE_ARCHS + MOE_SSM_ARCHS

_cache = {}


def both_params(arch):
    """(jax_cfg, jax_params, port_cfg, port_params) for a reduced arch,
    the port's params converted from the JAX ones (CPU)."""
    if arch not in _cache:
        cfg, jp = reduced_params(arch)
        pcfg = port_config(arch).reduced()
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg), arch
        tp = params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        _cache[arch] = (cfg, jp, pcfg, tp)
    return _cache[arch]


def np32(x):
    """Any array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=F32_TOL, ctx=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol,
                               err_msg=ctx)


def prompts(vocab, rng, lens):
    return [[int(t) for t in rng.integers(0, vocab, int(n))] for n in lens]
