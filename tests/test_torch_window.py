"""Sliding-window attention in the port against the JAX package: the
plain windowed flash prefill against JAX's ``attention_seq(window=)``,
windowed ``forward_prefill`` and the ring-buffer ``forward_decode``
through the wrap, on the dense, MoE, hybrid and VLM families, JAX's own
window cases (tests/test_parity.py) ported, and the prefill/decode
consistency the long-context path relies on.

Tolerances: the plain attention 1e-5 (f32, both sum the same pairs in
another order); logits and caches 1e-4 (torch_parity.F32_TOL); greedy
tokens equal. A window at or past the sequence changes no mask entry, so
it must give the unwindowed result bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import caches as jcaches
from repro.models import modeling as jm
from repro_torch.kernels import ref
from repro_torch.models import caches as tcaches
from repro_torch.models import modeling as tm
from torch_parity import assert_close, both_params

_jit_decode = jax.jit(jm.forward_decode, static_argnames=("cfg", "window"))
_jit_prefill = jax.jit(jm.forward_prefill, static_argnames=("cfg", "window"))
# dense, MoE, hybrid attention/Mamba/MoE, and the VLM backbone
FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
            "pixtral-12b"]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize(
    "b,s,nq,nkv,hd,q_offset,prefix_pad,q_valid,window", [
        (2, 24, 4, 2, 16, 0, None, None, 1),
        (2, 24, 4, 2, 16, 0, None, None, 7),
        (1, 40, 8, 2, 32, 0, None, None, 39),
        (2, 20, 4, 4, 16, 9, None, None, 12),          # q_offset
        (2, 16, 8, 2, 16, 5, 12, None, 10),            # padded prefix
        (2, 16, 8, 1, 16, 5, 12, [16, 9], 6),          # + q_valid, g = 8
        (3, 33, 6, 3, 8, 0, None, [33, 20, 1], 64),    # window > s
    ])
def test_plain_windowed_flash_prefill_matches_jax(b, s, nq, nkv, hd,
                                                  q_offset, prefix_pad,
                                                  q_valid, window):
    rng = np.random.default_rng(window + s)
    sk = (prefix_pad if prefix_pad is not None else q_offset) + s
    q = rng.normal(size=(b, s, nq, hd)).astype(np.float32)
    k, v = (rng.normal(size=(b, sk, nkv, hd)).astype(np.float32)
            for _ in range(2))
    qv = None if q_valid is None else np.asarray(q_valid, np.int32)
    got = ref.flash_prefill(_t(q), _t(k), _t(v), q_offset=q_offset,
                            prefix_pad=prefix_pad or 0,
                            q_valid=None if qv is None else _t(qv),
                            window=window)
    want = jm.attention_seq(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            nkv, causal=True, window=window,
                            q_offset=q_offset, prefix_pad=prefix_pad,
                            q_valid=None if qv is None else jnp.asarray(qv))
    assert_close(got, want, tol=1e-5)
    # the modeling entry point reaches the same function
    got2 = tm.attention_seq(_t(q), _t(k), _t(v), nkv, causal=True,
                            window=window, q_offset=q_offset,
                            prefix_pad=prefix_pad,
                            q_valid=None if qv is None else _t(qv))
    assert torch.equal(got, got2)


def _batch(cfg, rng, b, s):
    """Token ids (and the VLM's embeddings of them, made with numpy)."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "vision":
        emb = (rng.normal(size=(b, s, cfg.d_model)) * 0.1).astype(np.float32)
        return toks, {"embeds": jnp.asarray(emb)}, {"embeds": _t(emb)}
    return toks, {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}


@pytest.mark.parametrize("arch", FAMILIES)
def test_windowed_prefill_and_ring_decode_match_jax(arch):
    """A prompt of exactly W tokens prefilled under the window (its cache
    is the ring), then 2W + 3 ring decode steps (wrapping twice): equal
    tokens every step, the caches within 1e-4 after the prefill and at
    the end; the windowed hidden state's logits over a longer prompt,
    where the window bites, within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    W, b = 8, 2
    rng = np.random.default_rng(3)
    _, jb, tb = _batch(cfg, rng, b, W)
    jtok, jcache = _jit_prefill(cfg, jp, jb, window=W)
    with torch.no_grad():
        ttok, tcache = tm.forward_prefill(pcfg, tp, tb, window=W)
    assert ttok.tolist() == np.asarray(jtok).tolist()
    assert tcache["pos"] == int(jcache["pos"]) == W

    def caches_close(ctx):
        for sub, c in tcache["layers"].items():
            for leaf, x in c.items():
                assert_close(x, np.asarray(jcache["layers"][sub][leaf]),
                             ctx=f"{arch} {ctx} {sub}/{leaf}")
    caches_close("prefill")
    for step in range(2 * W + 3):
        jtok, jcache = _jit_decode(cfg, jp, jcache, jtok, window=W)
        with torch.no_grad():
            ttok, tcache = tm.forward_decode(pcfg, tp, tcache, ttok,
                                             window=W)
        assert ttok.tolist() == np.asarray(jtok).tolist(), (arch, step)
    assert tcache["pos"] == int(jcache["pos"]) == 3 * W + 3
    caches_close("decode")

    _, jb, tb = _batch(cfg, rng, b, 3 * W)
    jh, _, _ = jm.forward_seq(cfg, jp, jb, collect_cache=False,
                              remat=False, window=W)
    with torch.no_grad():
        th, _, _ = tm.forward_seq(pcfg, tp, tb, collect_cache=False,
                                  window=W)
    assert_close(tm.lm_logits(pcfg, tp, th[:, -1]),
                 jm.lm_logits(cfg, jp, jh[:, -1]), ctx=arch)


@pytest.mark.parametrize("arch", ["granite-3-8b", "mistral-nemo-12b"])
def test_windowed_decode_runs(arch):
    """JAX's test_parity case: ring decode from a zeroed windowed cache
    crosses the wrap twice with tokens in range and equal to JAX's."""
    cfg, jp, pcfg, tp = both_params(arch)
    W = 8
    jcache = jcaches.zeros_cache(cfg, 2, 64, window=W)
    tcache = tcaches.zeros_cache(pcfg, 2, 64, window=W, device="cpu")
    jtok = jnp.zeros((2,), jnp.int32)
    ttok = torch.zeros((2,), dtype=torch.int32)
    for i in range(2 * W + 3):
        jtok, jcache = _jit_decode(cfg, jp, jcache, jtok, window=W)
        with torch.no_grad():
            ttok, tcache = tm.forward_decode(pcfg, tp, tcache, ttok,
                                             window=W)
        assert bool(((ttok >= 0) & (ttok < pcfg.vocab_size)).all())
        assert ttok.tolist() == np.asarray(jtok).tolist(), (arch, i)
    assert tcache["pos"] == int(jcache["pos"]) == 2 * W + 3


def test_windowed_equals_full_within_window():
    """JAX's test_parity case: while pos < window, windowed decode equals
    full decode (and both equal JAX's)."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    W = 16
    c_win = tcaches.zeros_cache(pcfg, 1, W, window=W, device="cpu")
    c_full = tcaches.zeros_cache(pcfg, 1, W, device="cpu")
    jc = jcaches.zeros_cache(cfg, 1, W, window=W)
    t1 = t2 = torch.tensor([5], dtype=torch.int32)
    jt = jnp.asarray([5], jnp.int32)
    with torch.no_grad():
        for _ in range(W - 1):
            t1, c_win = tm.forward_decode(pcfg, tp, c_win, t1, window=W)
            t2, c_full = tm.forward_decode(pcfg, tp, c_full, t2)
            jt, jc = _jit_decode(cfg, jp, jc, jt, window=W)
            assert t1.tolist() == t2.tolist() == np.asarray(jt).tolist()


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b"])
def test_ring_decode_equals_windowed_prefill(arch):
    """The property the long-context path rests on: each token decoded on
    the ring equals the first token of a windowed prefill over the prompt
    and the tokens decoded before it (one longer prefill, read at each
    earlier position through last_index, gives them all)."""
    _, _, pcfg, tp = both_params(arch)
    W, n = 8, 8
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(
        rng.integers(0, pcfg.vocab_size, (1, W)).astype(np.int32))
    with torch.no_grad():
        tok, cache = tm.forward_prefill(pcfg, tp, {"tokens": prompt},
                                        window=W)
        seq = [tok]
        for _ in range(n):
            tok, cache = tm.forward_decode(pcfg, tp, cache, tok, window=W)
            seq.append(tok)
        full = torch.cat([prompt[0], torch.cat(seq[:n])])[None]
        ends = torch.arange(W - 1, W + n, dtype=torch.int32)
        firsts, _ = tm.forward_prefill(
            pcfg, tp, {"tokens": full.expand(len(ends), -1).contiguous()},
            window=W, last_index=ends)
    assert firsts.tolist() == torch.cat(seq).tolist()


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b"])
def test_window_past_the_sequence_equals_no_window(arch):
    """W >= s masks nothing more: first tokens and caches bit for bit."""
    _, _, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(8)
    toks = torch.from_numpy(
        rng.integers(0, pcfg.vocab_size, (2, 12)).astype(np.int32))
    last = torch.tensor([11, 6], dtype=torch.int32)
    with torch.no_grad():
        a, ca = tm.forward_prefill(pcfg, tp, {"tokens": toks},
                                   last_index=last)
        for w in (12, 40):
            b_, cb = tm.forward_prefill(pcfg, tp, {"tokens": toks},
                                        window=w, last_index=last)
            assert torch.equal(a, b_)
            for sub, c in ca["layers"].items():
                for leaf, x in c.items():
                    assert torch.equal(x, cb["layers"][sub][leaf]), (w, sub)


def test_ops_window_contract():
    """The public entry point: a window below 1 raises; non-causal
    attention ignores the window (JAX's mask sits under ``if causal``);
    under grad the window is refused, as the backward covers the training
    mask only (JAX trains without one)."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 12, 4, 16)).astype(
        np.float32)) for _ in range(3))
    with pytest.raises(ValueError, match="W >= 1"):
        ops.flash_prefill(q, k, v, window=0)
    assert torch.equal(ops.flash_prefill(q, k, v, causal=False, window=3),
                       ops.flash_prefill(q, k, v, causal=False))
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="sliding window"):
        ops.flash_prefill(qg, k, v, window=3)


@pytest.mark.parametrize("window", [None, 8])
def test_pos_is_an_int32_device_tensor_equal_to_jax(window):
    """``pos`` from forward_prefill and forward_decode equals JAX's in
    value and type (a 0-d int32), and a decode step returns a new tensor:
    the earlier cache's ``pos`` is unchanged (no aliasing)."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8))
    jtok, jcache = _jit_prefill(cfg, jp, {"tokens": jnp.asarray(toks,
                                                                jnp.int32)},
                                window=window)
    ttok, tcache = tm.forward_prefill(pcfg, tp, {"tokens": _t(toks.astype(
        np.int32))}, window=window)
    for c, jc in ((tcache, jcache),):
        assert isinstance(c["pos"], torch.Tensor) and c["pos"].dim() == 0
        assert c["pos"].dtype == torch.int32
        assert jnp.asarray(jc["pos"]).dtype == jnp.int32
        assert int(c["pos"]) == int(jc["pos"]) == 8
    if window is None:                  # room to decode past the prompt
        pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 4))  # noqa
        tcache = {"layers": {s: {n: pad(x) if n in ("k", "v") else x
                                 for n, x in c.items()}
                             for s, c in tcache["layers"].items()},
                  "pos": tcache["pos"]}
        jcache = jax.tree.map(      # granite's leaves: k, v and pos
            lambda a: jnp.pad(a, [(0, 0)] * 2 + [(0, 4), (0, 0)])
            if a.ndim == 4 else a, jcache)
    with torch.no_grad():
        for _ in range(3):
            before = tcache["pos"]
            kept = int(before)
            ttok, tcache = tm.forward_decode(pcfg, tp, tcache, ttok,
                                             window=window)
            jtok, jcache = _jit_decode(cfg, jp, jcache, jtok, window=window)
            assert tcache["pos"] is not before
            assert int(before) == kept
            assert tcache["pos"].dtype == torch.int32
            assert int(tcache["pos"]) == int(jcache["pos"]) == kept + 1
            assert ttok.tolist() == np.asarray(jtok).tolist()


def test_ring_serve_step_traces_on_meta():
    """The ring serve step (``make_serve_step(window=W)``) on meta
    tensors with ``pos`` a 0-d int32 meta tensor, as forward_prefill
    leaves it: no host read (which raises there), so the step is
    capturable; the new pos is a 0-d int32."""
    from repro_torch.launch.cost import count
    from repro_torch.models.params import abstract_params
    from repro_torch.models.steps import make_serve_step
    _, _, pcfg, _ = both_params("granite-3-8b")
    W, b = 16, 2
    cache = tcaches.abstract_cache(pcfg, b, 64, window=W,
                                   dtype=torch.float32)
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    seen = {}

    def step(prm, c, tk):
        nxt, new = make_serve_step(pcfg, window=W)(prm, c, tk)
        seen.update(pos=new["pos"], nxt=nxt)
        return nxt
    c = count(step, abstract_params(pcfg, torch.float32), cache,
              torch.empty((b,), dtype=torch.int32, device="meta"))
    assert c.matmul_flops > 0
    assert seen["pos"].dtype == torch.int32 and seen["pos"].dim() == 0
    assert tuple(seen["nxt"].shape) == (b,)


def test_serve_step_ring_admission_keeps_each_sequence():
    """The serve step's ring on the card (``steps._Ring``, here on CPU
    tensors): the first cache's layers become the ring; admitting
    another cache first hands the sequence that held the ring its state
    in tensors of its own, then copies the new one in; a sequence no
    longer referenced is not copied out."""
    import gc
    from repro_torch.models.steps import _Ring
    a = {"sub0": {"k": torch.zeros(2, 3), "v": torch.zeros(2, 3)}}
    ring = _Ring({}, a, torch.zeros(1, dtype=torch.int32))
    assert ring.layers["sub0"]["k"] is a["sub0"]["k"]     # adopted
    held_a = ring.hand_out()
    held_a["sub0"]["k"].fill_(1.0)                         # A steps
    b = {"sub0": {"k": torch.full((2, 3), 2.0),
                  "v": torch.full((2, 3), 3.0)}}
    ring.admit(b)
    held_b = ring.hand_out()
    assert held_a["sub0"]["k"] is not ring.layers["sub0"]["k"]
    assert torch.equal(held_a["sub0"]["k"], torch.ones(2, 3))
    assert torch.equal(held_a["sub0"]["v"], torch.zeros(2, 3))
    assert held_b["sub0"]["k"] is ring.layers["sub0"]["k"]
    assert torch.equal(ring.layers["sub0"]["v"], b["sub0"]["v"])
    assert ring.owner() is held_b
    del held_b
    gc.collect()
    assert ring.owner() is None
    kept = ring.layers["sub0"]["k"]
    ring.admit(held_a)
    assert ring.layers["sub0"]["k"] is kept
    assert torch.equal(kept, torch.ones(2, 3))
