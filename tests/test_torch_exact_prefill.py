"""The port's exact-length prefill (PrefillEngine(bucket_prefill=False):
equal-length sub-batches, no padding; suffix-only runs unpadded) against
the JAX package's exact path.

Held to JAX's exact path within f32 1e-4 on KV, Mamba hand-off state and
cross KV, with equal first tokens and equal launch/padding counters; never
bitwise to the bucketed path (the reference itself is not bitwise stable
across padding geometry). SSM/hybrid stacks serve cold on an exact
engine, as in JAX.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.engine import PrefillEngine
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import assert_close, both_params, prompts

FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-base", "pixtral-12b"]
COUNTERS = ("prefill_batches", "bucket_hits", "compute_tokens",
            "padded_tokens", "reused_tokens", "prefix_prefills")


def _outputs_close(got, want, ctx):
    assert got.first_token == want.first_token, ctx
    assert got.prompt_len == want.prompt_len, ctx
    assert (got.k is None) == (want.k is None), ctx
    if got.k is not None:
        assert_close(got.k, want.k, ctx=f"{ctx} k")
        assert_close(got.v, want.v, ctx=f"{ctx} v")
    assert set(got.mamba_state or {}) == set(want.mamba_state or {}), ctx
    for key, st in (want.mamba_state or {}).items():
        for leaf, x in st.items():
            assert_close(got.mamba_state[key][leaf], x, ctx=f"{ctx} {leaf}")
    for key, (xk, xv) in (want.cross or {}).items():
        assert_close(got.cross[key][0], xk, ctx=f"{ctx} xk")
        assert_close(got.cross[key][1], xv, ctx=f"{ctx} xv")


@pytest.mark.parametrize("arch", FAMILIES)
def test_exact_prefill_matches_jax_exact(arch):
    """Ragged prompts (two share a length): one unpadded forward per
    distinct length on both stacks, outputs within 1e-4, no padding."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(7)
    toks = prompts(cfg.vocab_size, rng, [13, 9, 13, 21])
    frames = None
    if cfg.is_encoder_decoder:
        frames = [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
                   ).astype(np.float32) for _ in toks]
    jeng = JaxPrefill(cfg, jp, bucket_prefill=False)
    teng = PrefillEngine(pcfg, tp, bucket_prefill=False)
    assert not teng.bucket_prefill
    want = jeng.run(toks, frames=frames)
    got = teng.run(toks, frames=frames)
    for i, (g, w) in enumerate(zip(got, want)):
        _outputs_close(g, w, f"{arch} request {i}")
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.prefill_batches == 3 and teng.padded_tokens == 0
    assert teng.supports_prefix_reuse == jeng.supports_prefix_reuse
    assert teng.supports_prefix_reuse == (not teng._mamba_order)


def test_exact_warm_suffix_matches_jax():
    """A suffix-only prefill on an exact engine: the prefix at its true
    length, the 11-token suffix unpadded, within 1e-4 of JAX's."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    rng = np.random.default_rng(3)
    prefix, suffix = prompts(cfg.vocab_size, rng, [10, 11])
    jeng = JaxPrefill(cfg, jp, bucket_prefill=False)
    teng = PrefillEngine(pcfg, tp, bucket_prefill=False)
    jcold, = jeng.run([prefix + suffix])
    tcold, = teng.run([prefix + suffix])
    want = jeng.run_suffix(suffix, jnp.concatenate(
        [jcold.k[:, :10], jcold.v[:, :10]], axis=-1))
    got = teng.run_suffix(suffix, torch.cat([tcold.k[:, :10],
                                             tcold.v[:, :10]], dim=-1))
    _outputs_close(got, want, "warm")
    assert got.first_token == tcold.first_token
    for name in COUNTERS:
        assert getattr(teng, name) == getattr(jeng, name), name
    assert teng.padded_tokens == 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b"])
def test_exact_prefill_cluster_tokens_match_jax(arch):
    """1P:1D serving with exact-length prefill: the port's tokens equal
    JAX's, a repeated prefix hits on the attention stack and mamba2
    serves cold (no snapshot store on an exact engine)."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(4)
    base = prompts(cfg.vocab_size, rng, [40])[0]
    toks = [base, base[:32] + prompts(cfg.vocab_size, rng, [5])[0],
            prompts(cfg.vocab_size, rng, [17])[0]]
    kw = {"bucket_prefill": False}
    jfe = JaxFrontend(cfg, params=jp, flat_iids=True, prefill_kwargs=kw)
    fe = ClusterFrontend(pcfg, params=tp, device="cpu", flat_iids=True,
                         prefill_kwargs=kw)
    got, want = [], []
    for i, t in enumerate(toks):
        r = ServeRequest(rid=i, tokens=list(t), max_new_tokens=4)
        fe.run([r])
        jr = JaxRequest(rid=i, tokens=list(t), max_new_tokens=4)
        jfe.run([jr])
        assert r.done and jr.done
        got.append(r.generated)
        want.append(jr.generated)
    assert got == want
    st = fe.groups["default"].prefix_stats()
    assert st["hits"] == (0 if arch == "mamba2-2.7b" else 1), st
