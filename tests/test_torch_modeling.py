"""The port's forward passes against the JAX package's, on the nine
served decoder-only families at reduced size (five dense, two MoE,
mamba2, jamba) with identical weights, and on the reduced variants at
pangu-38b's 6 query heads a KV head and deepseek-moe-16b's top-6 routing
with 2 shared experts (``torch_parity.RATIO_VARIANTS``).

Tolerance: f32 1e-4 (rtol and atol) on activations, logits-derived KV
and pool contents, because torch and XLA sum in different orders;
greedy tokens must be equal. Prefill is held against the JAX default
(bucketed, pad-invariant) contract via ``last_index``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import caches as jcaches
from repro.models import modeling as jm
from repro_torch.models import modeling as tm
from torch_parity import (DENSE_ARCHS, F32_TOL, PANGU_G6, RATIO_VARIANTS,
                          SERVED_ARCHS, assert_close, both_params)

# every served family, then the ratio variants (both MoE dispatches)
SERVED = SERVED_ARCHS + list(RATIO_VARIANTS)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", DENSE_ARCHS + [PANGU_G6])
def test_rmsnorm_rope_attention_seq(arch):
    cfg, _, pcfg, _ = both_params(arch)
    rng = np.random.default_rng(0)
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    x = rng.normal(size=(2, 5, d)).astype(np.float32)
    w = rng.normal(size=(d,)).astype(np.float32)
    assert_close(tm.rmsnorm(_t(x), _t(w), cfg.norm_eps),
                 jm.rmsnorm(jnp.asarray(x), jnp.asarray(w), cfg.norm_eps))
    # sequence form (positions per token) and decode form (per row)
    xs = rng.normal(size=(2, 7, nq, hd)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)
    assert_close(tm.rope(_t(xs), _t(pos), cfg.rope_theta),
                 jm.rope(jnp.asarray(xs), jnp.asarray(pos), cfg.rope_theta))
    xd = rng.normal(size=(3, nkv, hd)).astype(np.float32)
    pd = np.array([0, 17, 250], np.int32)
    assert_close(tm.rope(_t(xd), _t(pd), cfg.rope_theta),
                 jm.rope(jnp.asarray(xd), jnp.asarray(pd), cfg.rope_theta))
    # GQA causal attention over a bucket-padded prefix, ragged queries
    s, P, plen = 12, 16, 11
    q = rng.normal(size=(2, s, nq, hd)).astype(np.float32)
    k = rng.normal(size=(2, P + s, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(2, P + s, nkv, hd)).astype(np.float32)
    qv = np.array([12, 7], np.int32)
    got = tm.attention_seq(_t(q), _t(k), _t(v), nkv, causal=True,
                           q_offset=plen, prefix_pad=P, q_valid=_t(qv))
    want = jm.attention_seq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            nkv, causal=True, q_offset=plen, prefix_pad=P,
                            q_valid=jnp.asarray(qv))
    assert_close(got, want)
    assert int(torch.count_nonzero(got[1, 7:])) == 0
    # plain causal attention, no prefix
    got = tm.attention_seq(_t(q), _t(k[:, :s]), _t(v[:, :s]), nkv,
                           causal=True)
    want = jm.attention_seq(jnp.asarray(q), jnp.asarray(k[:, :s]),
                            jnp.asarray(v[:, :s]), nkv, causal=True)
    assert_close(got, want)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_prefill_matches_jax(arch):
    """Ragged right-padded batch: first tokens equal; per-layer KV and
    Mamba hand-off state (conv tails at each row's valid boundary, SSD
    state) allclose; final hidden rows, logits at the last prompt
    position and the MoE aux loss allclose."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    last = np.array([15, 4, 10], np.int32)
    jf, jc = jm.forward_prefill(cfg, jp, {"tokens": jnp.asarray(toks)},
                                last_index=jnp.asarray(last))
    tf, tc = tm.forward_prefill(pcfg, tp, {"tokens": _t(toks)},
                                last_index=_t(last))
    assert tf.dtype == torch.int32
    assert tf.tolist() == np.asarray(jf).tolist()
    assert tc["pos"] == int(jc["pos"])
    assert set(tc["layers"]) == set(jc["layers"])
    for sub, c in jc["layers"].items():
        assert set(tc["layers"][sub]) == set(c), sub
        for name, want in c.items():
            want = np.asarray(want)
            got = tc["layers"][sub][name]
            assert tuple(got.shape) == want.shape, (sub, name)
            if name in ("k", "v"):
                for b, ln in enumerate(last + 1):
                    assert_close(got[:, b, :ln], want[:, b, :ln],
                                 ctx=f"{sub}/{name} row {b}")
            else:
                assert_close(got, want, ctx=f"{sub}/{name}")
    vl = last + 1
    jh, jaux, _ = jm.forward_seq(cfg, jp, {"tokens": jnp.asarray(toks)},
                                 collect_cache=False, remat=False,
                                 valid_len=jnp.asarray(vl))
    th, taux, _ = tm.forward_seq(pcfg, tp, {"tokens": _t(toks)},
                                 valid_len=_t(vl))
    for b, ln in enumerate(vl):
        assert_close(th[b, :ln], jh[b, :ln], ctx=f"hidden row {b}")
    rows = np.arange(3)
    assert_close(tm.lm_logits(pcfg, tp, th[rows, last]),
                 jm.lm_logits(cfg, jp, jh[rows, last]))
    assert_close(taux, jaux)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_decode_step_matches_jax(arch):
    """Eight fused decode iterations over a paged pool holding random
    prompt KV and random per-slot Mamba state, with two inactive slots
    (one with an all -1 table): the active slots' tokens are equal at
    every step, and the pool (written in place by the port, its dropped
    rows on the drop block after it) stays allclose to JAX's, untouched
    blocks included, as does the active slots' Mamba state (updated in
    place)."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(2)
    bs, nb, steps = 4, 24, 8
    L = max(1, sum(k == "attn" for k in cfg.layer_kinds()))
    W = 2 * cfg.kv_dim
    storage = rng.normal(size=(L, nb, bs, W)).astype(np.float32)
    pos = np.array([5, 0, 9, 3], np.int32)
    active = np.array([True, False, True, False])
    table = np.full((4, 8), -1, np.int32)
    blocks = rng.permutation(nb)
    table[0, :4] = blocks[:4]           # 5 + 8 tokens -> 4 blocks
    table[2, :5] = blocks[4:9]          # 9 + 8 tokens -> 5 blocks
    table[3, :1] = blocks[9:10]         # inactive but holding a block
    tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    slot_np = {sub: {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                     for k, v in c.items()}
               for sub, c in jcaches.decode_slot_state(cfg, 4).items()}

    j_st, j_tok, j_pos = jnp.asarray(storage), jnp.asarray(tokens), \
        jnp.asarray(pos)
    t_st = _t(np.concatenate([storage, np.zeros_like(storage[:, :1])], 1))
    t_tok, t_pos = _t(tokens), _t(pos)
    j_sl = jax.tree.map(jnp.asarray, slot_np)
    t_sl = {sub: {k: _t(v) for k, v in c.items()}
            for sub, c in slot_np.items()}
    ptr = t_st.data_ptr()
    bt_j, act_j = jnp.asarray(table), jnp.asarray(active)
    bt_t, act_t = _t(table), _t(active)
    for step in range(steps):
        j_nxt, j_tok, j_pos, j_st, j_sl = jm.decode_step_jit(
            cfg, jp, j_st, bt_j, j_tok, j_pos, act_j, j_sl, block_size=bs)
        t_nxt, t_tok, t_pos, t_st, t_sl = tm.forward_decode_step(
            pcfg, tp, t_st, bt_t, t_tok, t_pos, act_t, t_sl,
            block_size=bs)
        assert t_nxt[active].tolist() == np.asarray(j_nxt)[active].tolist(), \
            f"step {step}"
        assert t_pos.tolist() == np.asarray(j_pos).tolist()
    assert t_st.data_ptr() == ptr        # the pool was written in place
    t_st = t_st[:, :nb]                  # the pool's own blocks
    assert_close(t_st, j_st, F32_TOL)
    untouched = np.setdiff1d(np.arange(nb), table[[0, 2]].ravel())
    assert np.array_equal(t_st.numpy()[:, untouched], storage[:, untouched])
    for sub, c in t_sl.items():
        for k, v in c.items():
            assert_close(v[:, active], np.asarray(j_sl[sub][k])[:, active],
                         ctx=f"{sub}/{k}")
