"""The port's chunked prefill (PrefillEngine.chunk_bounds, iter_chunks,
run_chunked) against the JAX package's, on the families the JAX
chunked-prefill tests cover (granite, qwen2-moe with sorted dispatch,
mamba2, jamba) and on whisper, whose encoder reruns over the request's
frames in every chunk.

The cut points and chunk counts are integers and must be equal; the
full-prompt output of run_chunked (KV, Mamba hand-off state, cross KV)
is held to JAX's run_chunked within f32 1e-4 (torch and XLA sum in
different orders), its first token to JAX's and to the port's monolithic
prefill, and the greedy decode stream from it to the monolithic one's
and to JAX's.
"""
import numpy as np
import pytest

from parity_utils import BS, POOL_KW, admit
from repro.serving.engine import DecodeEngine as JaxDecode
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.kvcache import PagedKVPool as JaxPool
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.kvcache import PagedKVPool
from torch_parity import assert_close, both_params, bursts, moe_sorted

FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "whisper-base"]


def _engines(arch):
    cfg, jp, pcfg, tp = both_params(arch)
    return (moe_sorted(cfg), jp, JaxPrefill(moe_sorted(cfg), jp),
            moe_sorted(pcfg), tp, PrefillEngine(moe_sorted(pcfg), tp))


def _prompt(cfg, n, seed=11):
    rng = np.random.default_rng(seed)
    frames = None
    if cfg.is_encoder_decoder:
        frames = (rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
                  ).astype(np.float32)
    return list(map(int, rng.integers(0, cfg.vocab_size, n))), frames


@pytest.mark.parametrize("arch", FAMILIES)
def test_chunk_bounds_equal_jax(arch):
    _, _, jeng, _, _, teng = _engines(arch)
    assert teng.prefix_align == jeng.prefix_align
    for n in (7, 16, 17, 40, 123):
        for chunk_tokens in (8, 16, 32):
            assert teng.chunk_bounds(n, chunk_tokens) == \
                jeng.chunk_bounds(n, chunk_tokens), (n, chunk_tokens)


@pytest.mark.parametrize("arch", ["granite-3-8b", "whisper-base"])
def test_iter_chunks_counts_equal_jax(arch):
    """The yielded chunk sizes, the number of chunks and the engines'
    chunk, launch and token counters are equal to JAX's."""
    cfg, _, jeng, _, _, teng = _engines(arch)
    tokens, frames = _prompt(cfg, 50, seed=3)
    want = [n for n, _ in jeng.iter_chunks(tokens, chunk_tokens=16,
                                           frames=frames)]
    got = [n for n, _ in teng.iter_chunks(tokens, chunk_tokens=16,
                                          frames=frames)]
    assert got == want and sum(got) == len(tokens)
    assert len(got) == len(teng.chunk_bounds(len(tokens), 16)) + 1
    for name in ("chunked_prefills", "chunked_chunks", "prefill_batches",
                 "compute_tokens", "padded_tokens", "reused_tokens",
                 "prefix_prefills", "state_restores"):
        assert getattr(teng, name) == getattr(jeng, name), name


def _decode_stream(cfg, params, out, pool_cls, dec_cls, steps=8):
    pool = pool_cls(cfg, **POOL_KW, **({"device": "cpu"}
                                       if pool_cls is PagedKVPool else {}))
    dec = dec_cls(cfg, params, pool, max_slots=4)
    admit(pool, dec, 0, out, bs=BS)
    toks = [out.first_token]
    for _ in range(steps):
        emitted = bursts(dec.step())
        toks.extend(t for r in sorted(emitted) for t in emitted[r])
    assert pool.invariant_ok()
    return toks


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_chunked_matches_jax(arch):
    """A 37-token prompt in 12-token chunks (aligned per family): the
    output is within 1e-4 of JAX's run_chunked, the first token equals
    JAX's and the port's monolithic prefill's, and the decode stream
    from it equals the monolithic stream and JAX's chunked stream."""
    cfg, jp, jeng, pcfg, tp, teng = _engines(arch)
    tokens, frames = _prompt(cfg, 37)
    want = jeng.run_chunked(tokens, chunk_tokens=12, frames=frames)
    got = teng.run_chunked(tokens, chunk_tokens=12, frames=frames)
    mono = teng.run([tokens], frames=None if frames is None
                    else [frames])[0]
    assert got.first_token == want.first_token == mono.first_token
    assert got.prompt_len == want.prompt_len == len(tokens)
    assert (got.k is None) == (want.k is None)
    if got.k is not None:
        assert_close(got.k, want.k, ctx="k")
        assert_close(got.v, want.v, ctx="v")
    assert set(got.mamba_state or {}) == set(want.mamba_state or {})
    for key, st in (want.mamba_state or {}).items():
        for leaf, x in st.items():
            assert_close(got.mamba_state[key][leaf], x, ctx=f"{key}/{leaf}")
    assert set(got.cross or {}) == set(want.cross or {})
    for key, (xk, xv) in (want.cross or {}).items():
        assert_close(got.cross[key][0], xk, ctx=f"{key}/xk")
        assert_close(got.cross[key][1], xv, ctx=f"{key}/xv")
    stream = _decode_stream(pcfg, tp, got, PagedKVPool, DecodeEngine)
    assert stream == _decode_stream(pcfg, tp, mono, PagedKVPool,
                                    DecodeEngine)
    assert stream == _decode_stream(cfg, jp, want, JaxPool, JaxDecode)
