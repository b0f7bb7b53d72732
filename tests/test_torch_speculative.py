"""The port's b=1 speculation oracle (serving/speculative.py:
SpeculativeDecoder over dense caches) against the JAX package's, and the
oracle's own contracts: lossless against target-only greedy, one prefill
per model and an exact count of decode calls per round, and exact stats
when all proposals are accepted (the bonus token). The fused engine is
held to the oracle's stream.

Tokens and every SpecStats counter must be equal to JAX's (same target
and draft weights); there is no tolerance on integers.
"""
import jax
import numpy as np
import pytest
import torch

from parity_utils import BS
from repro.models.params import init_params as jax_init_params
from repro.serving.speculative import SpeculativeDecoder as JaxOracle
from repro_torch.models.modeling import forward_decode, forward_prefill
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.speculative import (SpecConfig, SpeculativeDecoder,
                                             _pad_cache)
from torch_parity import both_params, prompts

ARCH = "granite-3-8b"


def _one_layer_draft():
    """JAX's imperfect test draft (one layer, PRNGKey(99)) on both sides."""
    cfg, _, pcfg, _ = both_params(ARCH)
    jd_cfg = cfg.replace(num_layers=1, name="draft")
    pd_cfg = pcfg.replace(num_layers=1, name="draft")
    jd = jax_init_params(jd_cfg, jax.random.PRNGKey(99))
    return (jd_cfg, jd), (pd_cfg, params_from_numpy(
        pd_cfg, jax.tree.map(np.asarray, jd), device="cpu"))


def _stats(st):
    return (st.proposed, st.accepted, st.emitted, st.target_steps,
            st.draft_replay_tokens)


def _target_only(cfg, params, prompt, n):
    first, cache = forward_prefill(
        cfg, params, {"tokens": torch.tensor([prompt], dtype=torch.int32)})
    cache = _pad_cache(cache, len(prompt) + n + 2)
    out, tok = [int(first[0])], first
    while len(out) < n:
        tok, cache = forward_decode(cfg, params, cache, tok)
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("draft_same", [True, False])
def test_oracle_matches_jax_and_target_only(draft_same):
    cfg, jp, pcfg, tp = both_params(ARCH)
    if draft_same:
        jd, pd = (cfg, jp), (pcfg, tp)
    else:
        jd, pd = _one_layer_draft()
    prompt = prompts(cfg.vocab_size, np.random.default_rng(4), [9])[0]
    n = 10
    want_o = JaxOracle(cfg, jp, *jd, k=3)
    want = want_o.generate(prompt, n)
    got_o = SpeculativeDecoder(pcfg, tp, *pd, k=3)
    got = got_o.generate(prompt, n)
    assert got == want
    assert _stats(got_o.stats) == _stats(want_o.stats)
    assert got == _target_only(pcfg, tp, prompt, n)
    assert got_o.stats.emitted == n
    if draft_same:
        assert got_o.stats.acceptance > 0.9


def test_oracle_is_incremental_not_quadratic(monkeypatch):
    """One prefill per model, ever; per round k draft proposals, k+1
    verify positions and the accepted-suffix replay, counted exactly."""
    import repro_torch.serving.speculative as sp
    _, _, pcfg, tp = both_params(ARCH)
    _, (d_cfg, d_params) = _one_layer_draft()
    calls = {"prefill": 0, "decode": 0}
    real_p, real_d = sp.forward_prefill, sp.forward_decode

    def count_p(*a, **kw):
        calls["prefill"] += 1
        return real_p(*a, **kw)

    def count_d(*a, **kw):
        calls["decode"] += 1
        return real_d(*a, **kw)

    monkeypatch.setattr(sp, "forward_prefill", count_p)
    monkeypatch.setattr(sp, "forward_decode", count_d)
    k, n = 3, 10
    spec = SpeculativeDecoder(pcfg, tp, d_cfg, d_params, k=k)
    prompt = prompts(pcfg.vocab_size, np.random.default_rng(4), [9])[0]
    assert len(spec.generate(prompt, n)) == n
    assert calls["prefill"] == 2
    rounds = spec.stats.target_steps - 1
    assert calls["decode"] == \
        rounds * (2 * k + 1) + spec.stats.draft_replay_tokens
    assert spec.stats.draft_replay_tokens <= rounds * (k + 1)


def test_spec_stats_count_the_bonus_token_exactly():
    """A perfect draft at k=4 over 12 tokens: the prefill emits 1, three
    all-accepted rounds emit k+1 = 5 each (the 5th the bonus token), the
    overshoot is subtracted: 12 emitted over 4 target passes."""
    _, _, pcfg, tp = both_params(ARCH)
    spec = SpeculativeDecoder(pcfg, tp, pcfg, tp, k=4)
    prompt = prompts(pcfg.vocab_size, np.random.default_rng(5), [8])[0]
    out = spec.generate(prompt, 12)
    st = spec.stats
    assert len(out) == 12
    assert st.acceptance == 1.0
    assert st.target_steps == 4 and st.emitted == 12
    assert st.tokens_per_step == pytest.approx(12 / 4)
    assert st.proposed == 12 and st.accepted == 12


def test_spec_engine_matches_b1_oracle():
    """The fused multi-slot step emits the oracle's exact stream for the
    same draft and k."""
    _, _, pcfg, tp = both_params(ARCH)
    _, (d_cfg, d_params) = _one_layer_draft()
    prompt = prompts(pcfg.vocab_size, np.random.default_rng(21), [9])[0]
    n, k = 10, 4
    want = SpeculativeDecoder(pcfg, tp, d_cfg, d_params, k=k).generate(
        prompt, n)
    out, = PrefillEngine(pcfg, tp).run([prompt])
    pool = PagedKVPool(pcfg, num_blocks=48, block_size=BS, device="cpu")
    de = DecodeEngine(pcfg, tp, pool, max_slots=1,
                      spec=SpecConfig(d_cfg, d_params, k=k))
    pool.alloc(0, out.prompt_len + n + k + 2)
    pool.write_prefill(pool.owned(0)[: (out.prompt_len + BS - 1) // BS],
                       out.k, out.v)
    de.admit(0, out, pool.owned(0), prompt=prompt)
    got = [out.first_token]
    while len(got) < n:
        got.extend(de.step()[0])
    assert got[:n] == want


def test_oracle_refuses_encoder_decoder():
    _, _, pcfg, tp = both_params("whisper-base")
    with pytest.raises(ValueError, match="enc-dec"):
        SpeculativeDecoder(pcfg, tp, pcfg, tp)
