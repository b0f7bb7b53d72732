"""The port's speculative step with acceptance that varies from step to
step, against the JAX package's: a self-draft with seeded noise on its
weight matrices (the same numpy arrays on both stacks) proposes tokens
the target accepts in part, so slots retire 1..k+1 tokens and the
per-slot rollback (the state at depth n_emit - 1, the pool rows past the
commit restored) runs on every family, Mamba state included.

Every step's bursts, the counters and the streams must equal JAX's, and
each stream must be a prefix of the port's plain greedy stream.
"""
import jax
import numpy as np
import pytest

from repro.serving.speculative import SpecConfig as JaxSpec
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.speculative import SpecConfig
from torch_parity import (both_params, moe_sorted, plain_streams, prompts,
                          spec_churn)

# noise scale (in units of each matrix's std) that mixes accepted and
# rejected proposals on the reduced family
NOISE = {"granite-3-8b": 0.3, "qwen2-moe-a2.7b": 0.1, "mamba2-2.7b": 1.0,
         "jamba-1.5-large-398b": 0.05}


@pytest.mark.parametrize("arch", sorted(NOISE))
def test_mixed_acceptance_rollback_matches_jax(arch):
    cfg, jp, pcfg, tp = both_params(arch)
    cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    rng = np.random.default_rng(0)
    sigma = NOISE[arch]
    noisy = jax.tree.map(
        lambda x: (x + sigma * x.std() * rng.normal(size=x.shape)).astype(
            x.dtype) if x.ndim >= 2 else x, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(5)
    toks = prompts(cfg.vocab_size, rng, rng.integers(5, 14, 3))
    j_rec, p_rec = [], []
    j_gen, j_cnt, _ = spec_churn("jax", cfg, jp, JaxSpec(cfg, noisy, k=3),
                                 toks, j_rec)
    p_gen, p_cnt, outs = spec_churn(
        "port", pcfg, tp,
        SpecConfig(pcfg, params_from_numpy(pcfg, noisy, device="cpu"), k=3),
        toks, p_rec)
    bursts = [len(b) for step in p_rec for b in step.values()]
    assert len(set(bursts)) >= 2, (arch, bursts)   # acceptance varies
    assert p_rec == j_rec
    assert p_gen == j_gen and p_cnt == j_cnt
    plain = plain_streams(pcfg, tp, outs)
    for rid, got in p_gen.items():
        assert got == plain[rid][:len(got)], (arch, rid)
