"""The port's encoder-decoder (whisper-base) and VLM backbone
(pixtral-12b) against the JAX package's, at reduced size with identical
weights: the encoder, cross-attention (prefill and decode), the
non-causal plain flash prefill, the prefill and the fused decode step,
and the whole serving path (both transfer modes, warm prefix hits inside
one frames namespace, misses across namespaces).

Tolerances: f32 1e-4 (rtol and atol) on activations, KV and logits
(torch and XLA sum in different orders); 1e-5 for the plain non-causal
flash prefill against JAX's attention_seq (one softmax over the same
f32 products); greedy tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import caches as jcaches
from repro.models import modeling as jm
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.kernels import ref
from repro_torch.models import modeling as tm
from repro_torch.models.params import tree_map
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import ENCDEC_ARCHS, assert_close, both_params, prompts

WHISPER, PIXTRAL = ENCDEC_ARCHS


def _t(x):
    return torch.from_numpy(np.array(x))


def _frames(cfg, rng, n):
    """Seeded stub frames (scale 0.1, as the launchers), f32, or None for
    a decoder-only stack."""
    if not cfg.is_encoder_decoder:
        return None
    return [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
             ).astype(np.float32) for _ in range(n)]


def _block0(params):
    return jax.tree.map(lambda x: x[0], params)


# ------------------------------------------------------------- modules

def test_noncausal_flash_prefill_plain_matches_jax():
    """ref.flash_prefill(causal=False) against JAX's
    attention_seq(causal=False) at s != sk with a ragged sk (77, not a
    multiple of the 64-row tile), GQA 4/2, and ragged q_valid: within
    1e-5; padded query rows exactly 0."""
    rng = np.random.default_rng(0)
    b, s, sk, nq, nkv, hd = 2, 20, 77, 4, 2, 32
    q = rng.normal(size=(b, s, nq, hd)).astype(np.float32)
    k = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
    for qv in (None, np.array([20, 13], np.int32)):
        got = ref.flash_prefill(_t(q), _t(k), _t(v), causal=False,
                                q_valid=None if qv is None else _t(qv))
        want = jm.attention_seq(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), nkv, causal=False,
                                q_valid=None if qv is None
                                else jnp.asarray(qv))
        assert_close(got, want, tol=1e-5)
        if qv is not None:
            assert int(torch.count_nonzero(got[1, 13:])) == 0
    # through the port's attention_seq (the CPU takes the plain version)
    got = tm.attention_seq(_t(q), _t(k), _t(v), nkv, causal=False)
    assert_close(got, jm.attention_seq(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), nkv, causal=False),
                 tol=1e-5)


def test_encoder_forward_matches_jax():
    cfg, jp, pcfg, tp = both_params(WHISPER)
    rng = np.random.default_rng(1)
    fr = np.stack(_frames(cfg, rng, 2))
    assert_close(tm.encoder_forward(pcfg, tp, _t(fr)),
                 jm.encoder_forward(cfg, jp, jnp.asarray(fr)))


def test_cross_attn_seq_matches_jax():
    """Decoder cross-attention of block 0 over a seeded encoder output:
    h and the cross KV (xk, xv) within 1e-4."""
    cfg, jp, pcfg, tp = both_params(WHISPER)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(2, 9, cfg.d_model)).astype(np.float32)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(
        np.float32)
    jh, (jxk, jxv) = jm.cross_attn_seq(
        _block0(jp["blocks"]["sub0"]), jnp.asarray(h), jnp.asarray(enc),
        cfg, return_kv=True)
    th, (txk, txv) = tm.cross_attn_seq(
        tree_map(lambda x: x[0], tp["blocks"]["sub0"]), _t(h), _t(enc),
        pcfg)
    assert_close(th, jh)
    assert_close(txk, jxk)
    assert_close(txv, jxv)


def test_attention_decode_matches_jax():
    """One query per row against a flat cache, every slot live (the
    decode step's cross-attention) and a shorter live prefix."""
    cfg, _, _, _ = both_params(WHISPER)
    rng = np.random.default_rng(3)
    b, S = 3, cfg.encoder_seq
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = rng.normal(size=(b, nq, hd)).astype(np.float32)
    kc = rng.normal(size=(b, S, nkv * hd)).astype(np.float32)
    vc = rng.normal(size=(b, S, nkv * hd)).astype(np.float32)
    for pos in (S, 5):
        assert_close(tm.attention_decode(_t(q), _t(kc), _t(vc), nkv, pos),
                     jm.attention_decode(jnp.asarray(q), jnp.asarray(kc),
                                         jnp.asarray(vc), nkv,
                                         jnp.asarray(pos)))


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_forward_seq_with_embeds_matches_jax(arch):
    """The VLM stub frontend: embeddings come in instead of tokens (with
    frames for the encoder-decoder); hidden states and every cache leaf
    within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(4)
    emb = (rng.normal(size=(2, 12, cfg.d_model)) * 0.1).astype(np.float32)
    jb, tb = {"embeds": jnp.asarray(emb)}, {"embeds": _t(emb)}
    fr = _frames(cfg, rng, 2)
    if fr is not None:
        jb["frames"], tb["frames"] = jnp.asarray(np.stack(fr)), \
            _t(np.stack(fr))
    jh, _, jc = jm.forward_seq(cfg, jp, jb, collect_cache=True, remat=False)
    th, _, tc = tm.forward_seq(pcfg, tp, tb)
    assert_close(th, jh)
    assert set(tc) == set(jc)
    for sub, c in jc.items():
        assert set(tc[sub]) == set(c), sub
        for name, want in c.items():
            assert_close(tc[sub][name], want, ctx=f"{sub}/{name}")


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_forward_prefill_matches_jax(arch):
    """Ragged right-padded batch: first tokens equal, self KV on the
    real rows and the cross KV within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    last = np.array([15, 4, 10], np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    fr = _frames(cfg, rng, 3)
    if fr is not None:
        jb["frames"], tb["frames"] = jnp.asarray(np.stack(fr)), \
            _t(np.stack(fr))
    jf, jc = jm.forward_prefill(cfg, jp, jb, last_index=jnp.asarray(last))
    tf, tc = tm.forward_prefill(pcfg, tp, tb, last_index=_t(last))
    assert tf.tolist() == np.asarray(jf).tolist()
    for sub, c in jc["layers"].items():
        assert set(tc["layers"][sub]) == set(c), sub
        for name, want in c.items():
            got, want = tc["layers"][sub][name], np.asarray(want)
            if name in ("k", "v"):
                for b, ln in enumerate(last + 1):
                    assert_close(got[:, b, :ln], want[:, b, :ln],
                                 ctx=f"{sub}/{name} row {b}")
            else:
                assert_close(got, want, ctx=f"{sub}/{name}")
    assert ("xk" in tc["layers"]["sub0"]) == (arch == WHISPER)


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_decode_step_with_cross_state_matches_jax(arch, monkeypatch):
    """Six fused decode iterations over a paged pool of random prompt KV
    and (whisper) random per-slot cross KV, two slots inactive: tokens
    equal and logits within 1e-4 on the active slots at every step
    (inactive rows are garbage by design, and the plain paged attention
    differs from JAX's on lens == 0 rows); the pool allclose; the cross
    KV untouched."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(6)
    bs, nb = 4, 24
    L = cfg.num_layers
    storage = rng.normal(size=(L, nb, bs, 2 * cfg.kv_dim)).astype(np.float32)
    pos = np.array([5, 0, 9, 3], np.int32)
    active = np.array([True, False, True, False])
    table = np.full((4, 8), -1, np.int32)
    blocks = rng.permutation(nb)
    table[0, :4], table[2, :5] = blocks[:4], blocks[4:9]
    tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    slot_np = {sub: {k: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                     for k, v in c.items()}
               for sub, c in jcaches.decode_slot_state(cfg, 4).items()}
    assert bool(slot_np["sub0"]) == (arch == WHISPER)
    logits = {"jax": [], "port": []}
    j_lm, t_lm = jm.lm_logits, tm.lm_logits

    def rec(side, fn):
        def call(*a):
            out = fn(*a)
            logits[side].append(np.asarray(out, np.float32)
                                if side == "jax" else out.numpy())
            return out
        return call
    monkeypatch.setattr(jm, "lm_logits", rec("jax", j_lm))
    monkeypatch.setattr(tm, "lm_logits", rec("port", t_lm))
    j_st, j_tok, j_pos = jnp.asarray(storage), jnp.asarray(tokens), \
        jnp.asarray(pos)
    t_st = _t(np.concatenate([storage, np.zeros_like(storage[:, :1])], 1))
    t_tok, t_pos = _t(tokens), _t(pos)
    j_sl = jax.tree.map(jnp.asarray, slot_np)
    t_sl = {sub: {k: _t(v) for k, v in c.items()}
            for sub, c in slot_np.items()}
    for step in range(6):
        j_nxt, j_tok, j_pos, j_st, j_sl = jm.forward_decode_step(
            cfg, jp, j_st, jnp.asarray(table), j_tok, j_pos,
            jnp.asarray(active), j_sl, block_size=bs)
        t_nxt, t_tok, t_pos, t_st, t_sl = tm.forward_decode_step(
            pcfg, tp, t_st, _t(table), t_tok, t_pos, _t(active), t_sl,
            block_size=bs)
        assert t_nxt[active].tolist() == np.asarray(j_nxt)[active].tolist()
        assert_close(logits["port"][-1][active], logits["jax"][-1][active],
                     ctx=f"logits step {step}")
    assert_close(t_st[:, :-1], j_st)     # the pool's own blocks
    for sub, c in t_sl.items():
        for k, v in c.items():
            assert np.array_equal(v.numpy(), slot_np[sub][k]), (sub, k)


# ------------------------------------------------------------- serving

def _serve(fe, cls, toks, frames, max_new=5):
    reqs = [cls(rid=i, tokens=list(t), max_new_tokens=max_new,
                frames=None if frames is None else frames[i])
            for i, t in enumerate(toks)]
    fe.run(reqs)
    assert all(r.done for r in reqs)
    return {r.rid: list(r.generated) for r in reqs}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_serving_tokens_match_jax(arch, overlap):
    """1P:1D, five seeded prompts (whisper: each with its own frames):
    greedy tokens equal JAX's; the cross KV crosses with the request (a
    state payload of 2 x layers x enc_seq x kv_dim f32 per request)."""
    cfg, jp, pcfg, tp = both_params(arch)
    toks = prompts(cfg.vocab_size, np.random.default_rng(3),
                   np.random.default_rng(4).integers(6, 40, 5))
    fr = _frames(cfg, np.random.default_rng(8), len(toks))
    pfe = ClusterFrontend(pcfg, params=tp, overlap_transfer=overlap,
                          device="cpu")
    got = _serve(pfe, ServeRequest, toks, fr)
    want = _serve(JaxFrontend(cfg, params=jp, overlap_transfer=overlap),
                  JaxRequest, toks, fr)
    assert got == want
    st = pfe.groups["default"].transfer_stats()
    assert st["jobs_admitted"] == len(toks)
    if overlap:
        per_req = 2 * cfg.num_layers * cfg.encoder_seq * cfg.kv_dim * 4
        assert st["state_payload_bytes"] == len(toks) * per_req


@pytest.mark.parametrize("arch", ENCDEC_ARCHS)
def test_warm_hit_and_frames_namespace(arch):
    """Requests sharing a 32-token prefix (and, for whisper, the same
    frames), served one after the other: the later ones are warm hits
    with the cold path's and JAX's tokens. A whisper request with the
    same tokens but other frames misses: its prefixes live in another
    namespace."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(9)
    shared = prompts(cfg.vocab_size, rng, [32])[0]
    toks = [shared + t for t in prompts(cfg.vocab_size, rng, [7, 10, 21])]
    fr = _frames(cfg, rng, 2)
    frames = None if fr is None else [fr[0]] * 3

    def sequential(fe, cls):
        out = []
        for i, t in enumerate(toks):
            req = cls(rid=i, tokens=list(t), max_new_tokens=4,
                      frames=None if frames is None else frames[i])
            fe.run([req])
            assert req.done
            out.append(list(req.generated))
        return out

    warm_fe = ClusterFrontend(pcfg, params=tp, device="cpu")
    warm = sequential(warm_fe, ServeRequest)
    g = warm_fe.groups["default"]
    stats = g.prefix_stats()
    assert stats["hits"] >= 2 and stats["reused_tokens"] >= 64
    cold = sequential(ClusterFrontend(pcfg, params=tp, prefix_cache=False,
                                      device="cpu"), ServeRequest)
    jax_warm = sequential(JaxFrontend(cfg, params=jp), JaxRequest)
    assert warm == cold == jax_warm
    if fr is not None:
        other = ServeRequest(rid=9, tokens=list(toks[1]), max_new_tokens=4,
                             frames=fr[1])
        assert g.prefills[0].prefix_affinity(other) == 0
        warm_fe.run([other])
        assert g.prefix_stats()["hits"] == stats["hits"]
        assert other.done
