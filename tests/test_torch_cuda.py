"""The CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package (nor the parity
helpers that do), so it runs on a machine with the card and no JAX:

    env PYTHONPATH=src python3 -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Without a card every
test skips. Reduced widths; chip_smoke.py phase 2 makes the full-width
comparison. Tolerances: copies bit-exact, attention f32 1e-5 and bf16
2e-2 against the plain version on the same inputs, the attention
backward within 1e-4 of each gradient's largest entry.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.paged_attention import split_plan

TOLS = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


def _paged_inputs(rng, L, NB, BS, kvd, gqa, hd=32):
    nkv = kvd // hd
    nq = nkv * gqa
    B, MAXB = 4, min(4, NB)
    pages = rng.normal(size=(NB, BS, 2 * kvd))
    q = rng.normal(size=(B, nq, hd))
    bt = np.full((B, MAXB), -1, np.int32)
    lens = np.zeros(B, np.int32)
    for b in range(B - 1):            # the last row stays inactive
        nb = rng.integers(1, MAXB + 1)
        bt[b, :nb] = rng.permutation(NB)[:nb]
        lens[b] = rng.integers(1, nb * BS + 1)
    return q, pages, bt, lens


def _table(rng, lens, BS, maxb, NB):
    """A (B, maxb) table of distinct random blocks covering each row's
    lens, cut at maxb (rows with lens past maxb*BS fill the table)."""
    bt = torch.full((len(lens), maxb), -1, dtype=torch.int32)
    blocks = torch.from_numpy(rng.permutation(NB).astype(np.int32))
    cur = 0
    for b, ln in enumerate(lens):
        n = min(-(-ln // BS), maxb)
        bt[b, :n] = blocks[cur:cur + n]
        cur += n
    return bt



@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, at reduced
    widths (chip_smoke.py does the full-width comparison)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.kv_gather import kv_gather_cuda
    from repro_torch.kernels.kv_scatter import kv_scatter_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    dev = "cuda"
    rng = np.random.default_rng(0)
    st = torch.from_numpy(rng.normal(size=(3, 16, 4, 128)).astype(
        np.float32)).to(dev)
    idx = torch.tensor([5, 1, 9], dtype=torch.int32, device=dev)
    assert torch.equal(kv_gather_cuda(st, idx), ref.kv_gather(st, idx))
    buf = torch.randn(3, 12, 128, device=dev)
    a, b = st.clone(), st.clone()
    kv_scatter_cuda(a, buf, idx)
    assert torch.equal(a, ref.kv_scatter(b, buf, idx))
    q, pages, bt, lens = (torch.from_numpy(x).to(dev) for x in
                          _paged_inputs(rng, 1, 16, 4, 64, 4))
    q, pages = q.float(), pages.float()
    torch.testing.assert_close(paged_attention_cuda(q, pages, bt, lens),
                               ref.paged_attention(q, pages, bt, lens),
                               rtol=1e-5, atol=1e-5)
    qq = torch.randn(2, 48, 4, 32, device=dev)
    kk = torch.randn(2, 80, 2, 32, device=dev)
    vv = torch.randn(2, 80, 2, 32, device=dev)
    qv = torch.tensor([48, 30], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        flash_prefill_cuda(qq, kk, vv, 20, 32, qv),
        ref.flash_prefill(qq, kk, vv, 20, 32, qv), rtol=1e-5, atol=1e-5)
    # split and tile edges, f32 within 1e-5 and bf16 within 2e-2
    tols = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
    BS, maxb, NB = 16, 8, 64
    split = split_plan(8, 8, 2, 64, maxb, BS).split_tokens
    edge = [0, 1, 16, split - 1, split, split + 1, maxb * BS, 50]
    for (nq, nkv, hd), dt in itertools.product(
            ((8, 2, 64), (2, 2, 128), (16, 2, 128), (8, 1, 64)), tols):
        bt = torch.full((8, maxb), -1, dtype=torch.int32)
        blocks = torch.from_numpy(rng.permutation(NB).astype(np.int32))
        cur = 0
        for b, ln in enumerate(edge):
            n = -(-ln // BS)
            bt[b, :n] = blocks[cur:cur + n]
            cur += n
        bt[6, 3] = -1                         # a hole in a live range
        bt[7, 1] = NB + 2                     # past the pool
        q = torch.randn(8, nq, hd, device=dev).to(dt)
        pages = torch.randn(NB, BS, 2 * nkv * hd, device=dev).to(dt)
        lens = torch.tensor(edge, dtype=torch.int32, device=dev)
        got = paged_attention_cuda(q, pages, bt.to(dev), lens)
        want = ref.paged_attention(q, pages, bt.to(dev), lens)
        torch.testing.assert_close(got.float(), want.float(), rtol=tols[dt],
                                   atol=tols[dt])
        assert int(torch.count_nonzero(got[0])) == 0
    for (b, s, nq, nkv, hd, qo, pp, qvl), dt in itertools.product([
            (2, 16, 4, 1, 128, 0, 0, [16, 9]),
            (2, 100, 8, 2, 64, 0, 0, [100, 77]),      # s % 64 != 0
            (2, 90, 8, 2, 128, 45, 70, [90, 61]),     # across tiles
            (1, 64, 4, 4, 64, 33, 40, [64]),          # g = 1
            (2, 70, 16, 2, 128, 16, 16, [70, 5]),     # g = 8
            (1, 40, 4, 2, 32, 0, 0, [40])], tols):
        sk = (pp or qo) + s
        qq = torch.randn(b, s, nq, hd, device=dev).to(dt)
        kk = torch.randn(b, sk, nkv, hd, device=dev).to(dt)
        vv = torch.randn(b, sk, nkv, hd, device=dev).to(dt)
        qv = torch.tensor(qvl, dtype=torch.int32, device=dev)
        got = flash_prefill_cuda(qq, kk, vv, qo, pp, qv)
        torch.testing.assert_close(
            got.float(), ref.flash_prefill(qq, kk, vv, qo, pp, qv).float(),
            rtol=tols[dt], atol=tols[dt])
        for bi, n in enumerate(qvl):
            assert int(torch.count_nonzero(got[bi, n:])) == 0


@pytest.mark.cuda
def test_cuda_noncausal_flash_prefill_matches_plain():
    """The kernel's non-causal mode against its plain version on the
    card, f32 within 1e-5, at a ragged sk with GQA and q_valid (the
    full-width shapes are chip_smoke.py's)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((2, 70, 8, 64), generator=g, device="cuda")
    k = torch.randn((2, 77, 4, 64), generator=g, device="cuda")
    v = torch.randn((2, 77, 4, 64), generator=g, device="cuda")
    qv = torch.tensor([70, 13], dtype=torch.int32, device="cuda")
    torch.testing.assert_close(
        flash_prefill_cuda(q, k, v, q_valid=qv, causal=False),
        ref.flash_prefill(q, k, v, q_valid=qv, causal=False),
        rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3, 5])
def test_cuda_paged_attention_speculative_edges(B):
    """The shapes speculation and the eager step give paged attention: a
    batch of the active slots only (B not the engine's 8), and lens past
    MAXB*BS (micro-steps beyond a slot's capacity attend over at most
    the table's MAXB*BS tokens)."""
    _need_card()
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    rng = np.random.default_rng(B)
    BS, maxb, NB = 16, 8, 64
    lens_l = [maxb * BS + 1, maxb * BS + 4, 37, maxb * BS, 3][:B]
    bt = _table(rng, lens_l, BS, maxb, NB).to("cuda")
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    for (nq, nkv, hd), dt in itertools.product(
            ((32, 8, 128), (16, 16, 128), (8, 2, 64)), TOLS):
        q = torch.randn(B, nq, hd, device="cuda").to(dt)
        pages = torch.randn(NB, BS, 2 * nkv * hd, device="cuda").to(dt)
        got = paged_attention_cuda(q, pages, bt, lens)
        want = ref.paged_attention(q, pages, bt, lens)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dt],
                                   atol=TOLS[dt])
        # past the table, the row equals the same row cut at MAXB*BS
        cut = lens.clamp_max(maxb * BS)
        torch.testing.assert_close(
            got.float(), paged_attention_cuda(q, pages, bt, cut).float(),
            rtol=TOLS[dt], atol=TOLS[dt])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 65, 237, 302])
def test_cuda_flash_prefill_exact_lengths(s):
    """Exact-length prefill's shapes: causal at s not a whole tile and no
    q_valid, and a warm suffix at q_offset > 0 with prefix_pad 0 (the
    prefix at its true length)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    for (nq, nkv, hd), dt in itertools.product(
            ((32, 8, 128), (16, 16, 128), (8, 8, 64)), TOLS):
        for qo in (0, 48 + s % 7):
            q = torch.randn(1, s, nq, hd, device="cuda").to(dt)
            k = torch.randn(1, qo + s, nkv, hd, device="cuda").to(dt)
            v = torch.randn(1, qo + s, nkv, hd, device="cuda").to(dt)
            got = flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=0)
            want = ref.flash_prefill(q, k, v, q_offset=qo, prefix_pad=0)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOLS[dt], atol=TOLS[dt])


# the window mode's edges: W of 1, one under, at and one over a 64-row
# query tile and a 32-row key tile, s - 1, s and past it
WINDOWS = (1, 31, 32, 33, 63, 64, 65, 128, 236, 237, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,hd", [(32, 8, 128), (16, 16, 128),
                                       (8, 1, 64), (4, 1, 32)])
def test_cuda_windowed_flash_prefill_matches_plain(nq, nkv, hd):
    """The window mode against its plain version, f32 within 1e-5 and
    bf16 within 2e-2, at s = 237 (not a whole tile), with q_offset and a
    padded prefix across tiles and q_valid; padded rows exactly 0; a
    window at or past q_offset + s gives the causal output bit for bit."""
    _need_card()
    from repro_torch.kernels import flash_prefill as fp
    g = torch.Generator(device="cuda").manual_seed(hd)
    s = 237
    for dt, (qo, pp) in itertools.product(TOLS, ((0, 0), (45, 70),
                                                 (33, 0))):
        sk = (pp or qo) + s
        q = torch.randn((2, s, nq, hd), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((2, sk, nkv, hd), generator=g,
                            device="cuda").to(dt) for _ in range(2))
        qv = torch.tensor([s, 101], dtype=torch.int32, device="cuda")
        causal = fp.flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=pp,
                                       q_valid=qv)
        for w in WINDOWS:
            before = fp.window_launches
            got = fp.flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=pp,
                                        q_valid=qv, window=w)
            assert fp.window_launches == before + 1
            want = ref.flash_prefill(q, k, v, q_offset=qo, prefix_pad=pp,
                                     q_valid=qv, window=w)
            torch.testing.assert_close(got.float(), want.float(),
                                       rtol=TOLS[dt], atol=TOLS[dt])
            assert int(torch.count_nonzero(got[1, 101:])) == 0
            if w >= qo + s:
                assert torch.equal(got, causal), (dt, qo, pp, w)
    with pytest.raises(ValueError, match="window"):
        fp.flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=pp, window=0)


@pytest.mark.cuda
def test_cuda_store_loads_without_nvcc(tmp_path):
    """precompile builds the kernel library into a store; a process with
    no nvcc on PATH (and build.build disabled) loads it and launches
    flash prefill from the stored library, equal to the plain version."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.configs import get_config
    from repro_torch.launch.precompile import ArtifactStore
    from repro_torch.models.config import INPUT_SHAPES
    _need_card()
    store = ArtifactStore(tmp_path)
    man = store.precompile("granite-3-8b/long_500k",
                           get_config("granite-3-8b"),
                           INPUT_SHAPES["long_500k"])
    assert man["size_bytes"] > 0
    probe = f"""
import shutil, torch
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_prefill as fp
from repro_torch.launch.precompile import ArtifactStore
assert shutil.which("nvcc") is None
def no_build(*a, **k):
    raise AssertionError("a build was started")
build.build = no_build
build._nvcc = no_build
step, man = ArtifactStore({str(tmp_path)!r}).load("granite-3-8b/long_500k")
assert {str(tmp_path)!r} in build._lib._name
q = torch.randn(1, 64, 8, 64, device="cuda")
got = fp.flash_prefill_cuda(q, q[:, :, :2].contiguous(),
                            q[:, :, :2].contiguous(), window=16)
want = ref.flash_prefill(q, q[:, :, :2], q[:, :, :2], window=16)
torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
print(fp.launches, man["load_s"])
"""
    root = Path(__file__).resolve().parents[1]
    path = os.pathsep.join(p for p in os.environ.get("PATH", "").split(
        os.pathsep) if not (Path(p) / "nvcc").exists())
    env = dict(os.environ, PYTHONPATH=str(root / "src"), PATH=path)
    res = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[0] == "1"


def _bwd_close(got, want, name):
    """Within 1e-4 of the plain tensor's largest entry (the backward sums
    over every query row of a key, in another order than the plain
    einsum)."""
    tol = 1e-4 * max(1.0, want.abs().max().item())
    err = (got - want).abs().max().item()
    assert err <= tol, f"{name}: max|err| {err} > {tol}"


def _bwd_case(b, s, nq, nkv, hd, seed):
    """Seeded inputs of the backward and the forward kernel's o and LSE
    (held to the plain forward; its output with the LSE equals its
    output without, bit for bit)."""
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, s, nq, hd), generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((b, s, nkv, hd), generator=g, device="cuda")
            for _ in range(2))
    o, lse = flash_prefill_cuda(q, k, v, return_lse=True)
    assert torch.equal(o, flash_prefill_cuda(q, k, v))
    ro, rlse = ref.flash_prefill_fwd(q, k, v)
    torch.testing.assert_close(o, ro, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, rlse, rtol=1e-5, atol=1e-5)
    return q, k, v, o, lse, do


# the kernel's tile edges: one under, at and one over its streamed (32
# and 64 rows) and resident (64 and 128 rows) tiles, and twice them
@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 65, 237, 31, 63, 64, 127, 128, 129, 257])
@pytest.mark.parametrize("nq,nkv,hd", [(8, 8, 64), (16, 4, 128),
                                       (16, 2, 32), (8, 8, 32), (8, 8, 128),
                                       (16, 4, 32), (16, 4, 64), (16, 2, 64),
                                       (16, 2, 128)])
def test_cuda_flash_prefill_bwd_matches_plain(s, nq, nkv, hd):
    """The backward kernel against the plain FlashAttention-2 backward
    on the card (g 1, 4, 8 x hd 32, 64, 128; s at and around the tiles:
    s = 257 spans five 64-key tiles at hd 32 and 64, whose g > 1
    partials are summed in head order), fed the forward kernel's LSE."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    q, k, v, o, lse, do = _bwd_case(2, s, nq, nkv, hd, s + hd)
    got = flash_prefill_bwd_cuda(q, k, v, o, lse, do)
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(a, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,hd", [(8, 8, 64), (16, 4, 128),
                                       (16, 2, 32)])
def test_cuda_flash_prefill_bwd_is_bitwise_repeatable(nq, nkv, hd):
    """No atomics: two calls on the same inputs give the same bits."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    q, k, v, o, lse, do = _bwd_case(2, 300, nq, nkv, hd, 11)
    first = flash_prefill_bwd_cuda(q, k, v, o, lse, do)
    second = flash_prefill_bwd_cuda(q, k, v, o, lse, do)
    for name, a, w in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, w), name


@pytest.mark.cuda
def test_cuda_flash_prefill_fn_grads_match_plain():
    """ops.flash_prefill under grad on the card: FlashPrefillFn launches
    the forward (with LSE) and the backward kernel, and the gradients
    equal autograd of the plain forward."""
    _need_card()
    from repro_torch.kernels import flash_prefill, flash_prefill_bwd, ops
    g = torch.Generator(device="cuda").manual_seed(1)
    base = [torch.randn(shape, generator=g, device="cuda")
            for shape in ((2, 100, 8, 64), (2, 100, 2, 64), (2, 100, 2, 64))]
    do = torch.randn((2, 100, 8, 64), generator=g, device="cuda")
    before = (flash_prefill.launches, flash_prefill_bwd.launches)
    leaves = [x.clone().requires_grad_() for x in base]
    got = torch.autograd.grad(ops.flash_prefill(*leaves), leaves, do)
    assert (flash_prefill.launches, flash_prefill_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    plain = [x.clone().requires_grad_() for x in base]
    want = torch.autograd.grad(ref.flash_prefill(*plain), plain, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(a, w, name)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_tensors_that_require_grad():
    """A ctypes kernel's output carries no grad_fn: every wrapper raises
    on an input that requires grad while grad mode is on, and runs under
    torch.no_grad() (FlashPrefillFn's forward and backward run so)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    from repro_torch.kernels.kv_gather import kv_gather_cuda
    from repro_torch.kernels.kv_scatter import kv_scatter_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    dev = "cuda"
    st = torch.randn(2, 8, 4, 64, device=dev)
    idx = torch.tensor([3, 1], dtype=torch.int32, device=dev)
    buf = torch.randn(2, 8, 64, device=dev)
    q1 = torch.randn(3, 4, 32, device=dev)
    pages = torch.randn(8, 4, 128, device=dev)
    bt = torch.tensor([[0, 1], [2, -1], [3, 4]], dtype=torch.int32,
                      device=dev)
    lens = torch.tensor([7, 2, 5], dtype=torch.int32, device=dev)
    q, k, v = (torch.randn(1, 9, 2, 32, device=dev) for _ in range(3))
    o, lse = flash_prefill_cuda(q, k, v, return_lse=True)
    calls = {
        "kv_gather_cuda": (lambda t: kv_gather_cuda(t, idx), st),
        "kv_scatter_cuda": (lambda t: kv_scatter_cuda(st.clone(), t, idx),
                            buf),
        "paged_attention_cuda": (lambda t: paged_attention_cuda(
            t, pages, bt, lens), q1),
        "flash_prefill_cuda": (lambda t: flash_prefill_cuda(t, k, v), q),
        "flash_prefill_bwd_cuda": (lambda t: flash_prefill_bwd_cuda(
            t, k, v, o, lse, o), q),
    }
    for name, (call, x) in calls.items():
        leaf = x.clone().requires_grad_()
        with pytest.raises(RuntimeError, match=f"{name} got a tensor"):
            call(leaf)
        with torch.no_grad():
            call(leaf)


# ------------------------------------------------------------ step graphs

def _card_engine(arch, spec=None, room=24):
    """A reduced ``arch`` DecodeEngine on the card with 3 of 4 slots
    active (random params from a seeded generator); ``spec`` is None,
    "self" (the target drafts for itself, k = 4) or "draft" (draft_for)."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    from repro_torch.serving.speculative import SpecConfig, draft_for
    cfg = get_config(arch).reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (9, 13, 6)]
    frames = None
    if cfg.is_encoder_decoder:
        frames = [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
                   ).astype(np.float32) for _ in prompts]
    outs = PrefillEngine(cfg, params).run(prompts, frames=frames)
    sc = {None: None, "self": SpecConfig(cfg, params, k=4),
          "draft": draft_for(cfg, device="cuda")}[spec]
    pool = PagedKVPool(cfg, num_blocks=48, block_size=4, device="cuda")
    de = DecodeEngine(cfg, params, pool, max_slots=4, spec=sc)
    for rid, (out, p) in enumerate(zip(outs, prompts)):
        pool.alloc(rid, out.prompt_len + room)
        if out.k is not None:
            pool.write_prefill(pool.owned(rid)[:-(-out.prompt_len // 4)],
                               out.k, out.v)
        de.admit(rid, out, pool.owned(rid), prompt=p)
    return de


def _bursts(twin, de):
    out = twin["out"].cpu()
    if de.spec is None:
        return {s: [int(out[s])] for s in de.active_slots()}
    k = de.spec.k
    return {s: [int(t) for t in out[s, :int(out[s, k + 1])]]
            for s in de.active_slots()}


def _same(a, b):
    if isinstance(a, dict):
        return all(_same(a[k], b[k]) for k in a)
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,spec", [
    ("granite-3-8b", None), ("qwen2-moe-a2.7b", None), ("mamba2-2.7b", None),
    ("jamba-1.5-large-398b", None), ("whisper-base", None),
    ("pixtral-12b", None), ("granite-3-8b", "self"),
    ("granite-3-8b", "draft"), ("jamba-1.5-large-398b", "draft")])
def test_cuda_step_graph_replay_equals_eager(arch, spec):
    """The first step captures; each of the next three replays, and equals
    the same step run eagerly on clones of its inputs bit for bit: the
    tokens, the positions, the pool's blocks, the slot states (and the
    draft's pool and state)."""
    _need_card()
    from repro_torch.serving.step_graph import eager_twin
    de = _card_engine(arch, spec)
    de.step()
    assert de.graphs.captures == 1
    for _ in range(3):
        twin = eager_twin(de)()
        got = de.step()
        assert got == _bursts(twin, de)
        assert torch.equal(de._tokens, twin["tokens"])
        assert torch.equal(de._pos, twin["pos"])
        assert torch.equal(de.pool.storage, twin["storage"])
        assert _same(twin["slot_layers"], de._slot_layers)
        if spec is not None:
            assert torch.equal(de._d_storage[:, :-1], twin["d_storage"])
            assert _same(twin["d_slot_layers"], de._d_slot_layers)
    assert (de.graphs.captures, de.graphs.replays) == (1, 3)


@pytest.mark.cuda
def test_cuda_step_graph_captures_once_per_key_and_counts_replays():
    """Steady state replays one graph, an admission that crosses the
    table bucket captures one more, and every replay adds the step's
    paged-attention launches to the wrapper's counter (one per attention
    layer), as an eager step would."""
    _need_card()
    from repro_torch.kernels import paged_attention
    from repro_torch.serving import step_graph
    from repro_torch.serving.engine import PrefillEngine
    de = _card_engine("granite-3-8b", room=8)
    n_attn = de.cfg.num_layers
    base = step_graph.decode_step_cache_size()
    de.step()
    before = paged_attention.launches
    for _ in range(3):
        de.step()
    assert paged_attention.launches - before == 3 * n_attn
    assert (de.graphs.captures, de.graphs.replays) == (1, 3)
    de.evict(0)
    de.pool.release(0)
    rng = np.random.default_rng(2)       # a long one: bucket 8 -> 16
    long = [int(t) for t in rng.integers(0, de.cfg.vocab_size, 40)]
    o, = PrefillEngine(de.cfg, de.params).run([long])
    de.pool.alloc(9, o.prompt_len + 8)
    de.pool.write_prefill(de.pool.owned(9)[:10], o.k, o.v)
    de.admit(9, o, de.pool.owned(9))
    de.step()
    de.step()
    assert (de.graphs.captures, de.graphs.replays) == (2, 4)
    assert step_graph.decode_step_cache_size() - base == 2


@pytest.mark.cuda
def test_cuda_kv_copies_on_a_pool_with_its_drop_block():
    """gather/scatter on the pool's view of its own blocks (layers apart
    by NB + 1 blocks): equal to the plain versions bit for bit, the drop
    block untouched."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels.kv_gather import kv_gather_cuda
    from repro_torch.kernels.kv_scatter import kv_scatter_cuda
    from repro_torch.serving.kvcache import PagedKVPool
    pool = PagedKVPool(get_config("granite-3-8b").reduced(), num_blocks=16,
                       block_size=4, device="cuda")
    pool.full_storage.normal_()
    drop = pool.full_storage[:, -1].clone()
    st = pool.storage
    assert not st.is_contiguous()
    idx = torch.tensor([5, 1, 15], dtype=torch.int32, device="cuda")
    assert torch.equal(kv_gather_cuda(st, idx), ref.kv_gather(st, idx))
    assert torch.equal(kv_gather_cuda(st, idx, layer=1),
                       ref.kv_gather(st[1:2], idx)[0])
    L, _, BS, W = st.shape
    buf = torch.randn(L, 3 * BS, W, device="cuda")
    want = ref.kv_scatter(st.clone(), buf, idx)
    kv_scatter_cuda(st, buf, idx)
    assert torch.equal(st, want)
    kv_scatter_cuda(st, buf[L - 1].contiguous(), idx, layer=L - 1)
    assert torch.equal(st[L - 1], want[L - 1])
    assert torch.equal(pool.full_storage[:, -1], drop)


@pytest.mark.cuda
def test_cuda_failed_capture_raises():
    """A step that reads a tensor on the host cannot be captured: the
    sorted MoE dispatch sizes its groups with ``.tolist()``. Its warm-up
    step runs; the capture raises, and nothing falls back to eager.
    (Last in the file: a failed capture may leave the card's context
    unusable for later captures in the process.)"""
    _need_card()
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="sorted"))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    out, = PrefillEngine(cfg, params).run([[1, 2, 3, 4, 5, 6]])
    pool = PagedKVPool(cfg, num_blocks=8, block_size=4, device="cuda")
    de = DecodeEngine(cfg, params, pool, max_slots=2)
    pool.alloc(0, out.prompt_len + 4)
    pool.write_prefill(pool.owned(0)[:2], out.k, out.v)
    de.admit(0, out, pool.owned(0))
    with pytest.raises(RuntimeError):
        de.step()
    assert de.graphs.captures == 0
