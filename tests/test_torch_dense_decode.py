"""The port's dense-cache decode (models/modeling.py: attention_decode's
k_new/v_new form, block_decode, forward_decode), which the b=1
speculation oracle runs on, against the JAX package's, and the sampling
policies (serving/sampling.py).

Tolerance: f32 1e-4 (rtol and atol) on attention outputs and caches,
because torch and XLA sum in different orders; greedy tokens must be
equal at every step. Sample draws come from torch's generator and are
never compared with JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modeling as jm
from repro.serving.speculative import _pad_cache as jax_pad_cache
from repro_torch.models import modeling as tm
from repro_torch.serving import sampling
from repro_torch.serving.speculative import _pad_cache
from torch_parity import assert_close, both_params, prompts

# dense, MoE, SSM and the hybrid stack
FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b"]
_jit_decode = jax.jit(jm.forward_decode, static_argnames=("cfg", "window"))


def _t(x):
    return torch.from_numpy(np.array(x))


def test_attention_decode_new_token_form_matches_jax():
    """The current token passed as k_new/v_new against the cache before
    it is written, GQA 8/2 with a part-filled cache."""
    rng = np.random.default_rng(0)
    b, nq, nkv, hd, S, pos = 3, 8, 2, 16, 12, 7
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    kc, vc = (rng.normal(size=(b, S, nkv * hd)).astype(np.float32)
              for _ in range(2))
    kn, vn = (rng.normal(size=(b, nkv * hd)).astype(np.float32)
              for _ in range(2))
    got = tm.attention_decode(_t(q), _t(kc), _t(vc), nkv, pos,
                              k_new=_t(kn), v_new=_t(vn))
    want = jm.attention_decode(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), nkv, jnp.asarray(pos),
                               k_new=jnp.asarray(kn), v_new=jnp.asarray(vn))
    assert_close(got, want)
    # the same call over a ring of S slots under a window (the write
    # slot pos % S is masked, as JAX masks it)
    for w_pos in (pos, S + 5):
        got = tm.attention_decode(_t(q), _t(kc), _t(vc), nkv, w_pos,
                                  window=4, k_new=_t(kn), v_new=_t(vn))
        want = jm.attention_decode(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), nkv, jnp.asarray(w_pos),
                                   window=4, k_new=jnp.asarray(kn),
                                   v_new=jnp.asarray(vn))
        assert_close(got, want)


@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_decode_matches_jax_over_eight_steps(arch):
    """Two prompts prefilled into a dense cache, padded, then eight
    greedy forward_decode steps on both stacks: equal tokens every step,
    and the caches (written in place by the port) within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    toks = np.asarray(prompts(cfg.vocab_size, np.random.default_rng(6),
                              [9, 9]), np.int32)
    jfirst, jcache = jm.forward_prefill(cfg, jp,
                                        {"tokens": jnp.asarray(toks)})
    tfirst, tcache = tm.forward_prefill(pcfg, tp, {"tokens": _t(toks)})
    assert tfirst.tolist() == np.asarray(jfirst).tolist()
    horizon = toks.shape[1] + 9
    jcache, tcache = jax_pad_cache(jcache, horizon), _pad_cache(tcache,
                                                                horizon)
    jtok, ttok = jfirst, tfirst
    for step in range(8):
        jtok, jcache = _jit_decode(cfg, jp, jcache, jtok)
        ttok, tcache = tm.forward_decode(pcfg, tp, tcache, ttok)
        assert ttok.tolist() == np.asarray(jtok).tolist(), (arch, step)
        assert tcache["pos"] == int(jcache["pos"])
    for sub, c in tcache["layers"].items():
        for leaf, x in c.items():
            assert_close(x, np.asarray(jcache["layers"][sub][leaf]),
                         ctx=f"{arch} {sub}/{leaf}")


def test_forward_decode_whisper_cross_attends_like_jax():
    """The encoder-decoder's dense decode: every sublayer cross-attends
    over its cached encoder KV after the self-attention step."""
    cfg, jp, pcfg, tp = both_params("whisper-base")
    rng = np.random.default_rng(2)
    toks = np.asarray(prompts(cfg.vocab_size, rng, [6]), np.int32)
    frames = (rng.normal(size=(1, cfg.encoder_seq, cfg.d_model)) * 0.1
              ).astype(np.float32)
    jfirst, jcache = jm.forward_prefill(
        cfg, jp, {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)})
    tfirst, tcache = tm.forward_prefill(
        pcfg, tp, {"tokens": _t(toks), "frames": _t(frames)})
    jcache, tcache = jax_pad_cache(jcache, 12), _pad_cache(tcache, 12)
    jtok, ttok = jfirst, tfirst
    for step in range(4):
        jtok, jcache = _jit_decode(cfg, jp, jcache, jtok)
        ttok, tcache = tm.forward_decode(pcfg, tp, tcache, ttok)
        assert ttok.tolist() == np.asarray(jtok).tolist(), step
    assert_close(tcache["layers"]["sub0"]["k"],
                 np.asarray(jcache["layers"]["sub0"]["k"]))


def test_greedy_and_sample():
    g = torch.Generator().manual_seed(0)
    logits = torch.randn(4, 50, generator=g)
    assert torch.equal(sampling.greedy(logits),
                       logits.argmax(-1).to(torch.int32))
    # temperature <= 0 falls back to greedy
    for temp in (0.0, -1.0):
        assert torch.equal(sampling.sample(logits, g, temperature=temp),
                           sampling.greedy(logits))
    # top-k: draws land only among each row's k best
    top3 = logits.topk(3, dim=-1).indices
    for _ in range(20):
        d = sampling.sample(logits, g, temperature=2.0, top_k=3)
        assert d.dtype == torch.int32 and d.shape == (4,)
        assert all(int(d[r]) in top3[r].tolist() for r in range(4))
    # a seeded generator repeats its draws; leading dims are kept
    big = torch.randn(2, 3, 50, generator=g)
    a = sampling.sample(big, torch.Generator().manual_seed(5))
    b = sampling.sample(big, torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.shape == (2, 3)
    # a near-one-hot distribution draws its mode
    peaked = torch.full((2, 10), -50.0)
    peaked[0, 7] = peaked[1, 2] = 50.0
    assert sampling.sample(peaked, g).tolist() == [7, 2]
