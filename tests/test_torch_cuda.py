"""The CUDA kernels against their plain PyTorch versions on the card.

This file imports neither JAX nor the JAX package (nor the parity
helpers that do), so it runs on a machine with the card and no JAX:

    env PYTHONPATH=src python3 -m pytest --noconftest -m cuda -q \
        tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py imports JAX.) Without a card every
test skips. Reduced widths; chip_smoke.py phase 2 makes the full-width
comparison. Tolerances: copies bit-exact, attention f32 1e-5 and bf16
2e-2 against the plain version on the same inputs, the attention
backward within 1e-4 of each gradient's largest entry, the grouped
product of sorted MoE dispatch (and its gradients) f32 1e-5 and bf16
2e-2 of the largest entry (a weight gradient sums over a group's rows);
the skinny product of the decode step within SKINNY_FACTOR times
torch.matmul's own error against float64; step graphs and the ring serve
graph bit for bit against eager.
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


# 6 query heads a KV head (pangu-38b's 48/8), at its hd 128 and at 64, 32
G6_SHAPES = [(48, 8, 128), (12, 2, 64), (6, 1, 32)]


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,hd", G6_SHAPES)
def test_cuda_attention_at_six_query_heads_a_kv_head(nq, nkv, hd):
    """Paged attention and causal flash prefill at g = 6 (2 of paged
    attention's 8 head slots a CTA idle) against their plain versions,
    f32 within 1e-5 and bf16 within 2e-2, each call twice and bitwise
    equal: paged attention at the split edges with a hole and a block
    past the pool; flash prefill at the 256 bucket with q_valid and at a
    warm suffix after a padded prefix, with q_offset as an int and on the
    card (bitwise the same)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    rng = np.random.default_rng(nq)
    BS, maxb, NB = 16, 8, 64
    split = split_plan(8, nq, nkv, hd, maxb, BS).split_tokens
    edge = [0, 1, 16, split - 1, split, split + 1, maxb * BS, 50]
    bt = _table(rng, edge, BS, maxb, NB)
    bt[6, 3] = -1                         # a hole in a live range
    bt[7, 1] = NB + 2                     # past the pool
    bt, lens = bt.cuda(), torch.tensor(edge, dtype=torch.int32,
                                       device="cuda")
    for dt in TOLS:
        q = torch.randn(8, nq, hd, device="cuda").to(dt)
        pages = torch.randn(NB, BS, 2 * nkv * hd, device="cuda").to(dt)
        got = paged_attention_cuda(q, pages, bt, lens)
        assert torch.equal(got, paged_attention_cuda(q, pages, bt, lens))
        torch.testing.assert_close(
            got.float(), ref.paged_attention(q, pages, bt, lens).float(),
            rtol=TOLS[dt], atol=TOLS[dt])
        assert int(torch.count_nonzero(got[0])) == 0
        for b, s, qo, pp, qvl in ((2, 256, 0, 0, [256, 200]),
                                  (1, 160, 37, 64, [150])):
            sk = (pp or qo) + s
            qq = torch.randn(b, s, nq, hd, device="cuda").to(dt)
            kk, vv = (torch.randn(b, sk, nkv, hd, device="cuda").to(dt)
                      for _ in range(2))
            qv = torch.tensor(qvl, dtype=torch.int32, device="cuda")
            got = flash_prefill_cuda(qq, kk, vv, qo, pp, qv)
            qo_dev = torch.tensor(qo, dtype=torch.int32, device="cuda")
            assert torch.equal(got, flash_prefill_cuda(qq, kk, vv, qo_dev,
                                                       pp, qv))
            torch.testing.assert_close(
                got.float(),
                ref.flash_prefill(qq, kk, vv, qo, pp, qv).float(),
                rtol=TOLS[dt], atol=TOLS[dt])
            for bi, n in enumerate(qvl):
                assert int(torch.count_nonzero(got[bi, n:])) == 0


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
                                       (8, 1, 64), (4, 1, 32),
                                       (48, 8, 128)])
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


def _bwd_case(b, s, nq, nkv, hd, seed, sk=None):
    """Seeded inputs of the backward and the forward kernel's o and LSE
    (held to the plain forward; its output with the LSE equals its
    output without, bit for bit). Causal, or with ``sk`` key rows
    non-causal."""
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    causal = sk is None
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b, s, nq, hd), generator=g, device="cuda")
             for _ in range(2))
    k, v = (torch.randn((b, s if causal else sk, nkv, hd), generator=g,
                        device="cuda") for _ in range(2))
    o, lse = flash_prefill_cuda(q, k, v, causal=causal, return_lse=True)
    assert torch.equal(o, flash_prefill_cuda(q, k, v, causal=causal))
    ro, rlse = ref.flash_prefill_fwd(q, k, v, causal=causal)
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
                                       (16, 2, 128), (12, 2, 32),
                                       (12, 2, 64), (12, 2, 128)])
def test_cuda_flash_prefill_bwd_matches_plain(s, nq, nkv, hd):
    """The backward kernel against the plain FlashAttention-2 backward
    on the card (g 1, 4, 6, 8 x hd 32, 64, 128; s at and around the tiles:
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


# the non-causal mode's edges: s and sk apart (the decoder's rows against
# the encoder's frames and the other way), each on a tile edge or off it
NONCAUSAL_EDGES = [(1, 1), (1, 65), (65, 1), (31, 129), (129, 31),
                   (64, 64), (100, 237), (237, 100), (257, 63), (48, 300),
                   (257, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("s,sk", NONCAUSAL_EDGES)
@pytest.mark.parametrize("nq,nkv,hd", [(8, 8, 64), (16, 4, 128),
                                       (16, 2, 32), (8, 8, 32),
                                       (16, 4, 64), (8, 8, 128)])
def test_cuda_flash_prefill_bwd_noncausal_matches_plain(s, sk, nq, nkv, hd):
    """The non-causal backward (every key live, sk free) against the
    plain backward on the card, fed the forward kernel's non-causal LSE
    (g 1, 4, 8 x hd 32, 64, 128): keys past sk in the last tile masked,
    the dK/dV grid over sk's tiles and the dQ grid over s's."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    q, k, v, o, lse, do = _bwd_case(2, s, nq, nkv, hd, s + 3 * sk + hd,
                                    sk=sk)
    got = flash_prefill_bwd_cuda(q, k, v, o, lse, do, causal=False)
    want = ref.flash_prefill_bwd(q, k, v, o, lse, do, causal=False)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        _bwd_close(a, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("nq,nkv,hd", [(8, 8, 64), (16, 4, 128),
                                       (16, 2, 32)])
def test_cuda_flash_prefill_bwd_noncausal_is_bitwise_repeatable(nq, nkv,
                                                                hd):
    """The non-causal mode has no atomics either: two calls give the same
    bits (s = 100 decoder rows against sk = 300 frames)."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    q, k, v, o, lse, do = _bwd_case(2, 100, nq, nkv, hd, 12, sk=300)
    first = flash_prefill_bwd_cuda(q, k, v, o, lse, do, causal=False)
    second = flash_prefill_bwd_cuda(q, k, v, o, lse, do, causal=False)
    for name, a, w in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, w), name


@pytest.mark.cuda
def test_cuda_flash_prefill_bwd_geometry_by_mode():
    """The causal mode takes sk == s only; the non-causal one any sk >=
    1; with no query row the key gradients are zeros."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    q, k, v, o, lse, do = _bwd_case(1, 40, 4, 2, 32, 5, sk=24)
    with pytest.raises(ValueError, match="unsupported geometry"):
        flash_prefill_bwd_cuda(q, k, v, o, lse, do)
    empty = [x[:, :0].contiguous() for x in (q, o, do)]
    dq, dk, dv = flash_prefill_bwd_cuda(empty[0], k, v, empty[1],
                                        lse[:, :, :0].contiguous(),
                                        empty[2], causal=False)
    assert dq.shape == (1, 0, 4, 32)
    assert not dk.any() and not dv.any()


@pytest.mark.cuda
@pytest.mark.parametrize("s,sk", [(100, 100), (48, 300)])
def test_cuda_flash_prefill_fn_noncausal_grads_match_plain(s, sk):
    """ops.flash_prefill(causal=False) under grad on the card: the
    forward kernel's non-causal mode with the LSE and the non-causal
    backward kernel launch once each (no plain version, no SDPA), and the
    gradients equal autograd of the plain non-causal forward."""
    _need_card()
    from repro_torch.kernels import flash_prefill, flash_prefill_bwd, ops
    g = torch.Generator(device="cuda").manual_seed(2)
    base = [torch.randn(shape, generator=g, device="cuda")
            for shape in ((2, s, 8, 64), (2, sk, 8, 64), (2, sk, 8, 64))]
    do = torch.randn((2, s, 8, 64), generator=g, device="cuda")
    counters = lambda: (flash_prefill.launches,   # noqa: E731
                        flash_prefill.noncausal_launches,
                        flash_prefill_bwd.launches,
                        flash_prefill_bwd.noncausal_launches)
    before = counters()
    leaves = [x.clone().requires_grad_() for x in base]
    got = torch.autograd.grad(ops.flash_prefill(*leaves, causal=False),
                              leaves, do)
    assert counters() == tuple(c + 1 for c in before)
    plain = [x.clone().requires_grad_() for x in base]
    want = torch.autograd.grad(ref.flash_prefill(*plain, causal=False),
                               plain, do)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        _bwd_close(a, w, name)


# the key split of the non-causal mode (the forward, and the backward's
# dQ pass): sk one under, at and one over a key tile, one key, whisper's
# 1500 frames and 4097 (a last range of one key); s across a query tile
# and at whisper's 448 decoder rows
SPLIT_SK = [1, 31, 32, 33, 1500, 4097]
SPLIT_S = [1, 64, 65, 448]


@pytest.mark.cuda
@pytest.mark.parametrize("sk", SPLIT_SK)
@pytest.mark.parametrize("s", SPLIT_S)
def test_cuda_noncausal_flash_prefill_split_edges(s, sk):
    """The non-causal forward at the key split's boundaries (g 1, 4 x hd
    32, 64, 128, f32 and bf16; b = 2 with q_valid [0, s - 1]) against the
    plain version, f32 with its LSE; padded rows exactly 0 with LSE
    +inf, and two calls equal bit for bit (the ranges merge in a fixed
    order)."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    g_ = torch.Generator(device="cuda").manual_seed(s + 7 * sk)
    for (g, hd), dt in itertools.product(
            itertools.product((1, 4), (32, 64, 128)), TOLS):
        q = torch.randn((2, s, 2 * g, hd), generator=g_, device="cuda")
        k, v = (torch.randn((2, sk, 2, hd), generator=g_, device="cuda")
                for _ in range(2))
        q, k, v = q.to(dt), k.to(dt), v.to(dt)
        n = max(1, s - 1)
        qv = torch.tensor([0, n], dtype=torch.int32, device="cuda")
        got, lse = flash_prefill_cuda(q, k, v, q_valid=qv, causal=False,
                                      return_lse=True)
        again, lse2 = flash_prefill_cuda(q, k, v, q_valid=qv, causal=False,
                                         return_lse=True)
        assert torch.equal(got, again) and torch.equal(lse, lse2)
        want = ref.flash_prefill(q, k, v, q_valid=qv, causal=False)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOLS[dt],
                                   atol=TOLS[dt])
        if dt == torch.float32:
            _, rlse = ref.flash_prefill_fwd(q, k, v, causal=False)
            torch.testing.assert_close(lse[1, :, :n], rlse[1, :, :n],
                                       rtol=1e-5, atol=1e-5)
        assert int(torch.count_nonzero(got[0])) == 0
        assert int(torch.count_nonzero(got[1, n:])) == 0
        assert bool(torch.isinf(lse[0]).all())
        assert bool(torch.isinf(lse[1, :, n:]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sk", SPLIT_SK)
@pytest.mark.parametrize("s", SPLIT_S)
def test_cuda_noncausal_flash_prefill_bwd_split_edges(s, sk):
    """The non-causal backward at the dQ pass's key split boundaries (g 1,
    4 x hd 32, 64, 128) against the plain backward, and two calls equal
    bit for bit (the partial dQs sum in range order)."""
    _need_card()
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    for g, hd in itertools.product((1, 4), (32, 64, 128)):
        q, k, v, o, lse, do = _bwd_case(2, s, 2 * g, 2, hd, s + sk + hd,
                                        sk=sk)
        got = flash_prefill_bwd_cuda(q, k, v, o, lse, do, causal=False)
        again = flash_prefill_bwd_cuda(q, k, v, o, lse, do, causal=False)
        want = ref.flash_prefill_bwd(q, k, v, o, lse, do, causal=False)
        for name, a, b, w in zip(("dq", "dk", "dv"), got, again, want):
            assert torch.equal(a, b), name
            _bwd_close(a, w, f"{name} g={g} hd={hd}")


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

def _card_engine(arch, spec=None, room=24, dispatch=None):
    """A reduced ``arch`` (or ``configs.RATIO_VARIANTS`` entry)
    DecodeEngine on the card with 3 of 4 slots active (random params
    from a seeded generator); ``spec`` is None, "self" (the target drafts
    for itself, k = 4) or "draft" (draft_for); ``dispatch`` overrides the
    MoE dispatch ("sorted")."""
    from repro_torch.configs import RATIO_VARIANTS, get_config, ratio_variant
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    from repro_torch.serving.speculative import SpecConfig, draft_for
    cfg = ratio_variant(arch) if arch in RATIO_VARIANTS \
        else get_config(arch).reduced()
    if dispatch is not None:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  dispatch=dispatch))
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
    ("granite-3-8b", "draft"), ("jamba-1.5-large-398b", "draft"),
    ("pangu-38b-g6", None), ("deepseek-moe-16b-top6", None)])
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


# ------------------------------------------------------ grouped product

def _routed(rng, T, k, E, skip):
    """Seeded group offsets (E+1,) int32 on the card of T tokens routed
    top-k among E experts, none to the experts in ``skip`` (their groups
    stay empty)."""
    live = np.array([e for e in range(E) if e not in skip])
    ids = np.stack([rng.choice(live, k, replace=False) for _ in range(T)])
    flat = ids.reshape(-1)
    sizes = np.bincount(flat, minlength=E)
    return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                            .astype(np.int32)).cuda()


def _rel_close(got, want, tol, name):
    scale = max(1e-30, float(want.float().abs().max()))
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,N", [(8, 2048, 1408), (8, 1408, 2048),
                                   (256, 2048, 1408), (3, 64, 72)])
def test_cuda_grouped_mm_matches_plain(T, K, N, dtype):
    """The forward, the transposed (input-gradient) instantiation and the
    weight-gradient kernel against ``ref.grouped_mm``/``grouped_mm_dw`` on
    the card: qwen2-moe's decode (8 tokens x top-4 of 60 experts, gate/up
    and down shapes), a prefill chunk's (256 tokens), and a ragged shape
    off the 16-byte runs, with some experts left empty."""
    _need_card()
    from repro_torch.kernels import grouped_mm as gm
    E, k = 60, 4
    rng = np.random.default_rng(T + K)
    offsets = _routed(rng, T, k, E, skip={0, 7, 59})
    M = T * k
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, K, N), generator=g, device="cuda")
         / K ** 0.5).to(dtype)
    dy = torch.randn((M, N), generator=g, device="cuda").to(dtype)
    tol = TOLS[dtype]
    before = (gm.launches, gm.dx_launches, gm.dw_launches)
    _rel_close(gm.grouped_mm_cuda(x, w, offsets),
               ref.grouped_mm(x, w, offsets), tol, "forward")
    _rel_close(gm.grouped_mm_cuda(dy, w, offsets, trans=True),
               ref.grouped_mm(dy, w, offsets, trans=True), tol, "dx")
    dw = gm.grouped_mm_dw_cuda(x, dy, offsets, E)
    _rel_close(dw, ref.grouped_mm_dw(x, dy, offsets, E), tol, "dw")
    for e in (0, 7, 59):
        assert int(torch.count_nonzero(dw[e])) == 0
    torch.cuda.synchronize()
    assert (gm.launches, gm.dx_launches, gm.dw_launches) == tuple(
        b + 1 for b in before)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,K,N", [(8, 2048, 1408), (8, 1408, 2048),
                                   (2048, 2048, 1408), (2048, 1408, 2048)])
def test_cuda_grouped_mm_top6_of_64(T, K, N, dtype):
    """The forward at deepseek-moe-16b's serving shapes (top-6 of 64
    experts: M = 48 at a decode step of 8 tokens, the rows path; M = 12288
    in a 2048-token prefill chunk, the tiles path; gate/up and down)
    against ``ref.grouped_mm``, two calls bitwise equal, three experts
    empty."""
    _need_card()
    from repro_torch.kernels import grouped_mm as gm
    E, k = 64, 6
    offsets = _routed(np.random.default_rng(T + K), T, k, E,
                      skip={0, 33, 63})
    M = T * k
    assert gm.plan(M, K, N, E, dtype, False).path == (0 if T == 8 else 1)
    g = torch.Generator(device="cuda").manual_seed(T)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, K, N), generator=g, device="cuda")
         / K ** 0.5).to(dtype)
    got = gm.grouped_mm_cuda(x, w, offsets)
    assert torch.equal(got, gm.grouped_mm_cuda(x, w, offsets))
    _rel_close(got, ref.grouped_mm(x, w, offsets), TOLS[dtype], "forward")


# (E, group sizes: {expert: rows}, a list, or None for a seeded split that
# leaves the last two experts empty, M, K, N); M below 16E takes the rows
# path (kernels/grouped_mm.plan), M at 16E and above the tiles path
GROUPED_EDGES = {
    "one_expert_rows": (60, {13: 37}, 37, 256, 192),
    "one_expert_tiles": (4, {2: 300}, 300, 200, 136),
    "mid_tile_bounds": (4, [0, 70, 3, 127], 210, 200, 136),
    "below_threshold": (8, None, 127, 256, 192),
    "at_threshold": (8, None, 128, 256, 192),
    "unaligned_rows": (6, None, 50, 100, 36),
    "unaligned_tiles": (6, None, 200, 100, 36),
}


def _edge_offsets(case):
    """(group sizes, offsets on the card) of a GROUPED_EDGES case."""
    E, sizes, M, _, _ = GROUPED_EDGES[case]
    rng = np.random.default_rng(len(case))
    if sizes is None:
        sz = np.bincount(rng.integers(0, E - 2, M), minlength=E)
    elif isinstance(sizes, dict):
        sz = np.zeros(E, np.int64)
        for e, n in sizes.items():
            sz[e] = n
    else:
        sz = np.asarray(sizes)
    return sz, torch.from_numpy(np.concatenate([[0], np.cumsum(sz)])
                                .astype(np.int32)).cuda()


def _check_dw(x, dy, offsets, sz, E, tol, name):
    """The weight-gradient kernel against ``ref.grouped_mm_dw``: within
    tol of the largest entry, two calls bitwise equal, empty experts
    exactly zero; then with an Inf in the first dy row of every group but
    the first (in column e % N for expert e), the same entries non-finite
    as in the plain version (a stage that ran past a group's end into
    the next group's rows would spread that Inf into the group before)
    and the rest within tol."""
    from repro_torch.kernels import grouped_mm as gm
    got = gm.grouped_mm_dw_cuda(x, dy, offsets, E)
    again = gm.grouped_mm_dw_cuda(x, dy, offsets, E)
    _rel_close(got, ref.grouped_mm_dw(x, dy, offsets, E), tol, name)
    assert torch.equal(got, again), name
    empty = torch.from_numpy(np.asarray(sz) == 0).cuda()
    assert int(torch.count_nonzero(got[empty])) == 0, name
    starts = np.concatenate([[0], np.cumsum(sz)])[:-1]
    live = np.flatnonzero(np.asarray(sz))
    dy = dy.clone()
    for e in live[1:]:
        dy[int(starts[e]), int(e) % dy.shape[1]] = float("inf")
    got = gm.grouped_mm_dw_cuda(x, dy, offsets, E)
    want = ref.grouped_mm_dw(x, dy, offsets, E)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), f"{name}: Inf spread"
    _rel_close(got.masked_fill(~fin, 0), want.masked_fill(~fin, 0), tol,
               f"{name} with Inf")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["fwd", "trans", "dw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", GROUPED_EDGES)
def test_cuda_grouped_mm_edges(case, dtype, kind):
    """The forward, transposed product and weight gradient at the paths'
    edges: every row sent to one expert (a group longer than the rows
    path's 8-row pass, and one spanning several 64-row tiles), group
    bounds mid-tile (the weight gradient: a tile's last stage running
    into the next group's rows, which must not be summed) with rows past
    the last group, M on both sides of the rows/tiles threshold, and rows
    of 100 and 36 elements (off the 16-byte runs in bf16): against
    ``ref`` at TOLS, two calls bitwise equal (no atomics), rows past the
    last group (the weight gradient: empty experts) exactly zero."""
    _need_card()
    from repro_torch.kernels import grouped_mm as gm
    E, _, M, K, N = GROUPED_EDGES[case]
    sz, offsets = _edge_offsets(case)
    g = torch.Generator(device="cuda").manual_seed(M)
    if kind == "dw":
        assert gm.plan_dw(M, K, N, E, dtype).path == (
            0 if M < gm.ROWS_MEAN * E else 1)
        x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
        dy = torch.randn((M, N), generator=g, device="cuda").to(dtype)
        _check_dw(x, dy, offsets, sz, E, TOLS[dtype], case)
        return
    trans = kind == "trans"
    assert gm.plan(M, K, N, E, dtype, trans).path == (
        0 if M < gm.ROWS_MEAN * E else 1)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    w = (torch.randn((E, N, K) if trans else (E, K, N), generator=g,
                     device="cuda") / K ** 0.5).to(dtype)
    got = gm.grouped_mm_cuda(x, w, offsets, trans=trans)
    again = gm.grouped_mm_cuda(x, w, offsets, trans=trans)
    _rel_close(got, ref.grouped_mm(x, w, offsets, trans=trans),
               TOLS[dtype], case)
    assert torch.equal(got, again)
    assert int(torch.count_nonzero(got[int(sz.sum()):])) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(2048, 1408), (1408, 2048)])
def test_cuda_grouped_mm_dw_train_shape(K, N, dtype):
    """The weight gradient at a full-width qwen2-moe training step's
    shapes (4 x 1024 tokens x top-4 of 60 experts: M = 16384, the gate/up
    product K = 2048, N = 1408 and the down product K = 1408, N = 2048;
    the tiles path), three experts empty."""
    _need_card()
    from repro_torch.kernels import grouped_mm as gm
    E = 60
    rng = np.random.default_rng(16)
    offsets = _routed(rng, 4096, 4, E, skip={0, 31, 59})
    sz = np.diff(offsets.cpu().numpy())
    M = 4 * 4096
    assert gm.plan_dw(M, K, N, E, dtype).path == 1
    g = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((M, K), generator=g, device="cuda").to(dtype)
    dy = torch.randn((M, N), generator=g, device="cuda").to(dtype)
    _check_dw(x, dy, offsets, sz, E, TOLS[dtype], "train shape")


@pytest.mark.cuda
def test_cuda_grouped_mm_fn_grads_match_plain():
    """Through autograd (GroupedMMFn) on the card against the plain
    version's autograd gradient, f32."""
    _need_card()
    from repro_torch.kernels import ops
    rng = np.random.default_rng(4)
    offsets = _routed(rng, 12, 2, 6, skip={3})
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((24, 96), generator=g, device="cuda")
    w = torch.randn((6, 96, 40), generator=g, device="cuda") / 10
    dy = torch.randn((24, 40), generator=g, device="cuda")
    tx, tw = x.clone().requires_grad_(), w.clone().requires_grad_()
    got = torch.autograd.grad(ops.grouped_mm(tx, tw, offsets), (tx, tw), dy)
    px, pw = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = torch.autograd.grad(ref.grouped_mm(px, pw, offsets), (px, pw), dy)
    for a, b, name in zip(got, want, ("dx", "dw")):
        _rel_close(a, b, 1e-5, name)


@pytest.mark.cuda
def test_cuda_sorted_step_graph_replay_equals_eager():
    """Sorted MoE dispatch (the grouped kernel, offsets on the card) in
    the fused step: captured at the first step, each replay equal to the
    eager step on clones bit for bit, the kernel launched by replays."""
    _need_card()
    _sorted_replays("qwen2-moe-a2.7b")


@pytest.mark.cuda
def test_cuda_sorted_step_graph_at_top6_of_8():
    """The same at deepseek-moe-16b's routing: top-6 of 8 with 2 shared."""
    _need_card()
    _sorted_replays("deepseek-moe-16b-top6")


def _sorted_replays(arch):
    from repro_torch.kernels import grouped_mm as gm
    from repro_torch.serving.step_graph import eager_twin
    de = _card_engine(arch, dispatch="sorted")
    de.step()
    assert de.graphs.captures == 1
    before = gm.launches
    for _ in range(3):
        twin = eager_twin(de)()
        got = de.step()
        assert got == _bursts(twin, de)
        assert torch.equal(de._tokens, twin["tokens"])
        assert torch.equal(de._pos, twin["pos"])
        assert torch.equal(de.pool.storage, twin["storage"])
        assert _same(twin["slot_layers"], de._slot_layers)
    n_moe = sum(de.cfg.moe_layer_mask())      # one entry a layer
    # three eager twins and three replays, three products a MoE layer
    assert gm.launches - before == 6 * 3 * n_moe
    assert (de.graphs.captures, de.graphs.replays) == (1, 3)


@pytest.mark.cuda
def test_cuda_ring_serve_step_replay_equals_eager():
    """The ring serve step (``make_serve_step(window=W)``): the first step
    captures, each replay equals forward_decode run eagerly on clones of
    the ring bit for bit (token, pos, every ring leaf), the earlier
    cache's pos is untouched, and the ring wraps."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models.modeling import forward_decode, forward_prefill
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.steps import make_serve_step
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    W = 16
    prompt = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (1, W)).astype(np.int32)).cuda()
    with torch.no_grad():
        tok, ring = forward_prefill(cfg, params, {"tokens": prompt},
                                    window=W)
    assert ring["pos"].dtype == torch.int32 and int(ring["pos"]) == W
    step = make_serve_step(cfg, window=W)
    tok, ring = step(params, ring, tok)
    graphs, = step.graphs.values()
    assert graphs.captures == 1
    for _ in range(W + 3):
        twin = {"layers": tree_map(lambda t: t.clone(), ring["layers"]),
                "pos": ring["pos"].clone()}
        with torch.no_grad():
            want_tok, want = forward_decode(cfg, params, twin, tok.clone(),
                                            window=W)
        old_pos = ring["pos"]
        tok, ring = step(params, ring, tok)
        assert torch.equal(tok, want_tok)
        assert torch.equal(ring["pos"], want["pos"])
        assert int(old_pos) + 1 == int(ring["pos"])
        assert _same(want["layers"], ring["layers"])
    assert (graphs.captures, graphs.replays) == (1, W + 3)


@pytest.mark.cuda
def test_cuda_ring_serve_step_admits_a_second_cache():
    """Two sequences of one shape through one ring serve step: the
    second is admitted into the ring (no second capture), the first is
    admitted back, and each step equals forward_decode run eagerly on a
    clone of its own sequence bit for bit; another params object at the
    same shapes replaces the graph with a new capture."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models.modeling import forward_decode, forward_prefill
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.steps import make_serve_step
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    W = 16
    rng = np.random.default_rng(6)

    def clone(c):
        return {"layers": tree_map(lambda t: t.clone(), c["layers"]),
                "pos": c["pos"].clone()}

    def prefill(n):          # a prompt of W tokens leaves a valid ring
        prompt = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (1, n)).astype(np.int32)).cuda()
        with torch.no_grad():
            return forward_prefill(cfg, params, {"tokens": prompt},
                                   window=W)

    def eager(c, tok, prm=params):
        with torch.no_grad():
            return forward_decode(cfg, prm, clone(c), tok.clone(), window=W)

    seqs = [prefill(W), prefill(W)]
    step = make_serve_step(cfg, window=W)
    for i in (0, 1, 0, 0, 1, 1, 0):
        tok, cache = seqs[i]
        want_tok, want = eager(cache, tok)
        seqs[i] = step(params, cache, tok)
        assert torch.equal(seqs[i][0], want_tok)
        assert torch.equal(seqs[i][1]["pos"], want["pos"])
        assert _same(want["layers"], seqs[i][1]["layers"])
    graphs, = step.graphs.values()
    assert (graphs.captures, graphs.replays) == (1, 6)
    other = tree_map(lambda t: t.clone(), params)
    tok, cache = seqs[0]
    want_tok, want = eager(cache, tok, other)
    got_tok, got = step(other, cache, tok)
    assert torch.equal(got_tok, want_tok) and _same(want["layers"],
                                                   got["layers"])
    new, = step.graphs.values()
    assert new is not graphs and new.captures == 1


# ---------------------------------------------------------- prefill graphs

@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 24], ids=["causal", "window"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,nq,nkv,hd,qo,pp", [
    (2, 90, 8, 2, 128, 45, 70),       # a padded prefix across tiles
    (1, 64, 4, 4, 64, 33, 40),
    (2, 70, 16, 2, 32, 16, 16),       # prefix_pad == q_offset
    (1, 48, 4, 2, 64, 0, 32),         # an empty prefix in its bucket
    (2, 40, 8, 2, 128, 24, 0)])       # no prefix_pad: P = sk - s
def test_cuda_flash_prefill_device_q_offset_is_bitwise_the_int(
        b, s, nq, nkv, hd, qo, pp, dt, window):
    """flash_prefill.cu reading q_offset from a device int32 equals its
    int form bit for bit (causal, window, prefix-pad cases); captured in
    a graph at one offset and replayed after the device value changed,
    it equals the int form at the new offset."""
    _need_card()
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    P = pp or qo
    sk = P + s
    g = torch.Generator(device="cuda").manual_seed(5)
    qq, kk, vv = (torch.randn(sh, device="cuda", generator=g).to(dt)
                  for sh in ((b, s, nq, hd), (b, sk, nkv, hd),
                             (b, sk, nkv, hd)))
    qv = torch.tensor([s, s - 7][:b], dtype=torch.int32, device="cuda")
    off = torch.tensor(qo, dtype=torch.int32, device="cuda")
    want = flash_prefill_cuda(qq, kk, vv, qo, pp, qv, window=window)
    got = flash_prefill_cuda(qq, kk, vv, off, P, qv, window=window)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got.float(), ref.flash_prefill(qq, kk, vv, qo, pp, qv,
                                       window=window).float(),
        rtol=TOLS[dt], atol=TOLS[dt])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_prefill_cuda(qq, kk, vv, off, P, qv, window=window)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_prefill_cuda(qq, kk, vv, off, P, qv, window=window)
    for new in sorted({0, P // 2, P}):
        off.fill_(new)
        graph.replay()
        assert torch.equal(out, flash_prefill_cuda(qq, kk, vv, new, P, qv,
                                                   window=window)), new


def _card_params(arch, dispatch=None):
    """A reduced ``arch`` on the card, random params from a seed."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config(arch).reduced()
    if dispatch is not None:
        import dataclasses
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  dispatch=dispatch))
    return cfg, init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")


def _same_output(a, b):
    """Two PrefillOutputs bit for bit (tokens, KV, Mamba state, cross KV,
    snapshots)."""
    assert (a.first_token, a.prompt_len) == (b.first_token, b.prompt_len)
    for x, y in ((a.k, b.k), (a.v, b.v)):
        assert (x is None) == (y is None)
        assert x is None or torch.equal(x, y)
    trees = [(a.mamba_state, b.mamba_state), (a.cross, b.cross)]
    assert (a.snapshots or {}).keys() == (b.snapshots or {}).keys()
    trees += [(a.snapshots[t], b.snapshots[t]) for t in a.snapshots or {}]
    for ta, tb in trees:
        assert (ta is None) == (tb is None)
        for key in ta or {}:
            xa, xb = ta[key], tb[key]
            if isinstance(xa, dict):
                assert all(torch.equal(xa[k], xb[k]) for k in xa), key
            else:
                assert all(torch.equal(p, q) for p, q in zip(xa, xb)), key


def _clone_output(o):
    import copy
    c = copy.copy(o)
    for f in ("k", "v"):
        if getattr(o, f) is not None:
            setattr(c, f, getattr(o, f).clone())
    from repro_torch.models.params import tree_map
    if o.mamba_state is not None:
        c.mamba_state = {k: tree_map(torch.clone, v)
                         for k, v in o.mamba_state.items()}
    if o.cross is not None:
        c.cross = {k: tuple(t.clone() for t in v) for k, v in o.cross.items()}
    if o.snapshots is not None:
        c.snapshots = {t: {k: tree_map(torch.clone, v)
                           for k, v in snap.items()}
                       for t, snap in o.snapshots.items()}
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("arch,dispatch", [
    ("granite-3-8b", None), ("qwen2-moe-a2.7b", "sorted"),
    ("mamba2-2.7b", None), ("whisper-base", None)],
    ids=["granite", "qwen2-moe-sorted", "mamba2", "whisper"])
def test_cuda_prefill_graph_replay_equals_eager(arch, dispatch):
    """A bucketed wave runs eagerly (a key's first forward); a second wave
    of new lengths in those buckets captures one graph per bucket and a
    third replays them, with no new key; warm suffixes (mamba2: from a
    snapshot) at three prefix lengths of one prefix bucket run eagerly,
    capture and replay one key: every output equals jit_prefill=False's
    on the same prompts bit for bit, and a replayed output still equals
    itself after the next replay at its key (the engine hands out
    copies, never the graph's buffers)."""
    _need_card()
    from repro_torch.serving import step_graph
    from repro_torch.serving.engine import PrefillEngine
    cfg, params = _card_params(arch, dispatch)
    rng = np.random.default_rng(6)

    def wave(lens):
        pr = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
              for n in lens]
        fr = None
        if cfg.is_encoder_decoder:
            fr = [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
                   ).astype(np.float32) for _ in lens]
        return pr, fr
    pe = PrefillEngine(cfg, params)
    eager = PrefillEngine(cfg, params, jit_prefill=False)
    stride = pe.prefix_align if pe.requires_state_restore else 0
    keys0 = step_graph.prefill_compile_count()
    waves = [wave(n) for n in ((37, 50, 20), (40, 61, 29), (35, 52, 31),
                               (33, 45, 17))]
    counts = []
    for pr, fr in waves[:3]:
        got = pe.run(pr, frames=fr, snap_stride=stride)
        for a, b in zip(got, eager.run(pr, frames=fr, snap_stride=stride)):
            _same_output(a, b)
        counts.append((pe.graphs.captures, pe.graphs.replays))
    assert counts == [(0, 0), (2, 0), (2, 2)], counts
    kept = [(o, _clone_output(o)) for o in got]
    pe.run(waves[3][0], frames=waves[3][1], snap_stride=stride)  # replays
    for o, c in kept:
        _same_output(o, c)
    assert step_graph.prefill_compile_count() - keys0 == 2
    # warm suffixes at three prefix lengths of one prefix bucket: one key
    pr, fr = waves[0]
    cold = eager.run([pr[1]], frames=fr[:1] if fr else None,
                     snap_stride=stride)[0]
    plens = (stride,) * 3 if stride else (20, 26, 23)   # prefix bucket 32
    for i, plen in enumerate(plens):
        pkv = None if cold.k is None else torch.cat(
            [cold.k[:, :plen], cold.v[:, :plen]], dim=-1)
        kw = dict(state=cold.snapshots[plen]) if stride else {}
        args = (pr[1][plen:], pkv, fr[0] if fr else None)
        a = pe.run_suffix(*args, prefix_len=plen, snap_stride=stride, **kw)
        b = eager.run_suffix(*args, prefix_len=plen, snap_stride=stride,
                             **kw)
        _same_output(a, b)
        assert (pe.graphs.captures, pe.graphs.replays) == \
            (2 + (i > 0), 4 + (i > 1))
    assert step_graph.prefill_compile_count() - keys0 == 3
    assert eager.graphs.captures == 0 and eager.graph_bytes() == 0
    assert pe.graph_bytes() > 0


@pytest.mark.cuda
def test_cuda_prefill_graphs_keep_their_budget():
    """Ragged serving meets many keys: (b, bucket) pairs, each met twice
    so that it is captured. With a budget of a few keys, the engine drops
    its least recently run graphs, so what the graphs keep and the
    card's allocated memory stay within the budget and one key, however
    many keys it met; a dropped key met again is eager, then captured
    again, and still equals the eager prefill."""
    _need_card()
    from repro_torch.serving.engine import PrefillEngine
    cfg, params = _card_params("granite-3-8b")
    rng = np.random.default_rng(8)
    one = PrefillEngine(cfg, params)
    probe = [[int(t) for t in rng.integers(0, cfg.vocab_size, 60)]] * 4
    for _ in range(2):
        one.run(probe)
    key_bytes = one.graph_bytes()          # the largest key below
    del one
    budget = 3 * key_bytes
    pe = PrefillEngine(cfg, params)
    pe.graphs.budget = budget
    eager = PrefillEngine(cfg, params, jit_prefill=False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    shapes = [(b, n) for b in (1, 2, 3, 4) for n in (12, 24, 60)]
    for b, n in shapes:
        batch = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
                 for _ in range(b)]
        for _ in range(2):
            pe.run(batch)
            assert pe.graph_bytes() <= budget
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - base <= budget + key_bytes
    g = pe.graphs
    assert g.captures == len(shapes)
    assert g.evictions == g.captures - len(g._graphs) > 0
    batch = [[int(t) for t in rng.integers(0, cfg.vocab_size, 12)]]
    for i in range(3):                     # the first key, dropped first
        for a, b in zip(pe.run(batch), eager.run(batch)):
            _same_output(a, b)
    assert pe.graphs.captures == len(shapes) + 1
    assert pe.graph_bytes() <= budget


@pytest.mark.cuda
def test_cuda_prefill_replay_adds_the_kernels_launches():
    """A replayed prefill adds its flash prefill launches (one per
    attention layer) to the wrapper's counter, as an eager forward
    would."""
    _need_card()
    from repro_torch.kernels import flash_prefill
    from repro_torch.serving.engine import PrefillEngine
    cfg, params = _card_params("granite-3-8b")
    pe = PrefillEngine(cfg, params)
    pe.run([[1, 2, 3, 4, 5]])
    pe.run([[4, 5, 6]])
    before = flash_prefill.launches
    pe.run([[7, 8, 9]])
    assert flash_prefill.launches - before == cfg.num_layers
    assert (pe.graphs.captures, pe.graphs.replays) == (1, 1)


_HOST_READ_PREFILL = """
import torch
from repro_torch.configs import get_config
from repro_torch.models.params import init_params
from repro_torch.serving import engine
cfg = get_config("granite-3-8b").reduced()
params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
real = engine.forward_prefill
calls = []
def reads_the_host(*a, prefix_len=0, **kw):
    calls.append(len(calls))
    int(prefix_len)                     # .item() on a device tensor
    return real(*a, prefix_len=prefix_len, **kw)
engine.forward_prefill = reads_the_host
pe = engine.PrefillEngine(cfg, params)
pe.run([[1, 2, 3]])                     # eager: the key's first forward
try:
    pe.run([[1, 2, 3]])
except RuntimeError as e:
    print("RAISED", len(calls), pe.graphs.captures, type(e).__name__)
"""


@pytest.mark.cuda
def test_cuda_prefill_host_read_raises_at_capture():
    """A prefill forward that reads a tensor on the host (here
    ``int(prefix_len)``) runs eagerly at its key's first forward; at the
    second it runs its warm-up and then fails its capture, loudly: nothing falls back to eager. In a process of its
    own, as a failed capture may leave the card's context unusable for
    later captures."""
    _need_card()
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=str(src))
    r = subprocess.run([sys.executable, "-c", _HOST_READ_PREFILL],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "RAISED 3 0" in r.stdout, (r.stdout, r.stderr[-2000:])


# ------------------------------------------------------------ skinny product

# every dense product of the benchmark's two decode steps that takes the
# kernel: (K, N, trans); wv is wk's shape, wo wq's (deepseek's router, N =
# 64, is narrower than a tile and stays x @ w)
SKINNY_SHAPES = [(4096, 4096, False), (4096, 1024, False),
                 (4096, 12800, False), (12800, 4096, False),
                 (4096, 49155, True), (2048, 2048, False),
                 (2048, 2816, False), (2816, 2048, False),
                 (2048, 102400, False)]
# the kernel's largest error against a float64 product of the same f32
# inputs, within this many times torch.matmul's (TF32 off); 2.6 at worst
# on the card, at M = 1, where torch's GEMV sums more accurately than its
# GEMMs (chip_smoke.py phase 2's SKINNY_FACTOR)
SKINNY_FACTOR = 4.0


def _skinny_operands(K, N, trans, M, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((M, K), generator=g, device="cuda")
    if trans:
        w = (torch.randn((N, K), generator=g, device="cuda") / K ** 0.5).T
    else:
        w = torch.randn((K, N), generator=g, device="cuda") / K ** 0.5
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 7, 26, 32])
@pytest.mark.parametrize("K,N,trans", SKINNY_SHAPES)
def test_cuda_skinny_mm_is_f32_accurate(K, N, trans, M):
    """The skinny product at every decode shape of both cells (both
    layouts; N = 49155 and 102400, which no tile divides) against a
    float64 product of the same f32 inputs: its largest error within
    SKINNY_FACTOR times torch.matmul's; two launches bitwise equal."""
    _need_card()
    from repro_torch.kernels import skinny_mm as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w = _skinny_operands(K, N, trans, M, seed=K + N + M)
    got, = sk.skinny_mm_cuda(x, w)
    assert torch.equal(got, sk.skinny_mm_cuda(x, w)[0])
    want = x.double() @ w.double()
    err = float((got.double() - want).abs().max())
    lib = float(((x @ w).double() - want).abs().max())
    assert err <= SKINNY_FACTOR * lib, (err, lib)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 32])
@pytest.mark.parametrize("K,Ns", [(4096, (4096, 1024, 1024)),
                                  (4096, (12800, 12800)),
                                  (2048, (2048, 2048, 2048)),
                                  (2048, (2816, 2816)), (256, (132, 4096))])
def test_cuda_skinny_mm_products_of_one_x(K, Ns, M):
    """Products of one x in one launch (q, k, v; gate, up; and widths no
    tile divides): each within SKINNY_FACTOR times torch.matmul's error
    against float64, two launches bitwise equal."""
    _need_card()
    from repro_torch.kernels import skinny_mm as sk
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(K + M)
    x = torch.randn((M, K), generator=g, device="cuda")
    ws = [torch.randn((K, N), generator=g, device="cuda") / K ** 0.5
          for N in Ns]
    got = sk.skinny_mm_cuda(x, *ws)
    again = sk.skinny_mm_cuda(x, *ws)
    for w, y, y2 in zip(ws, got, again):
        assert torch.equal(y, y2)
        want = x.double() @ w.double()
        err = float((y.double() - want).abs().max())
        lib = float(((x @ w).double() - want).abs().max())
        assert err <= SKINNY_FACTOR * lib, (w.shape, err, lib)


@pytest.mark.cuda
def test_cuda_skinny_mm_replay_equals_eager():
    """A call captured in a CUDA graph and replayed (twice, so the tiles'
    counters are found clean) equals an eager one bit for bit, at a
    shape whose tiles several CTAs share and at one where one CTA covers
    each; rows in three dims and a strided row view (a prefill batch's
    last positions) too."""
    _need_card()
    from repro_torch.kernels import skinny_mm as sk
    for K, N, trans in ((4096, 4096, False), (256, 49155, True)):
        x, w = _skinny_operands(K, N, trans, 32, seed=5)
        eager, = sk.skinny_mm_cuda(x, w)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sk.skinny_mm_cuda(x, w)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, = sk.skinny_mm_cuda(x, w)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager)
    h = torch.randn((4, 9, 256), device="cuda")
    w = torch.randn((256, 128), device="cuda")
    x3 = h[:, :1, :].contiguous()
    assert torch.equal(sk.skinny_mm_cuda(x3, w)[0][:, 0],
                       sk.skinny_mm_cuda(x3[:, 0], w)[0])
    last = h[:, -1, :]
    assert sk.row_stride(last) == 9 * 256
    assert torch.equal(sk.skinny_mm_cuda(last, w)[0],
                       sk.skinny_mm_cuda(last.contiguous(), w)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("tied", [True, False])
def test_cuda_decode_step_takes_the_skinny_product(tied, monkeypatch):
    """A reduced granite decode step graph (4 slots, 4 KV heads so that wk
    and wv are a column tile wide; the head tied, as in the benchmark, or
    not): every dense product of each replayed step goes through the
    skinny kernel (7 a layer and the head, in 4 launches a layer: q, k
    and v in one, gate and up in one; by the wrapper's launch counter),
    and the tokens equal those of the same engine with every product left
    to cuBLAS."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, skinny_mm
    from repro_torch.models.params import init_params
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    cfg = get_config("granite-3-8b").reduced().replace(tie_embeddings=tied,
                                                       num_kv_heads=4)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, n)]
               for n in (9, 13, 6)]

    def run(steps):
        outs = PrefillEngine(cfg, params).run(prompts)
        pool = PagedKVPool(cfg, num_blocks=48, block_size=4, device="cuda")
        de = DecodeEngine(cfg, params, pool, max_slots=4)
        for rid, (out, p) in enumerate(zip(outs, prompts)):
            pool.alloc(rid, out.prompt_len + 24)
            pool.write_prefill(pool.owned(rid)[:-(-out.prompt_len // 4)],
                               out.k, out.v)
            de.admit(rid, out, pool.owned(rid), prompt=p)
        got = [de.step()]
        before = skinny_mm.launches
        got += [de.step() for _ in range(steps)]
        assert de.graphs.replays == steps
        return got, skinny_mm.launches - before
    got, launched = run(4)
    assert launched == 4 * (4 * cfg.num_layers + 1)
    monkeypatch.setattr(ops, "skinny_mm_applies", lambda x, *ws: False)
    want, none = run(4)
    assert none == 0
    assert got == want


@pytest.mark.cuda
def test_cuda_failed_capture_raises():
    """A step that reads a tensor on the host cannot be captured: here a
    step function that calls ``.item()``, run through ``StepGraphs.run``
    (every step of the port reads its sizes on the card since sorted MoE
    dispatch went to the grouped kernel). Its warm-up step runs; the
    capture raises, and nothing falls back to eager.
    (Last in the file: a failed capture may leave the card's context
    unusable for later captures in the process.)"""
    _need_card()
    from repro_torch.serving.step_graph import StepGraphs
    graphs = StepGraphs(torch.device("cuda"))
    buf = torch.zeros(4, device="cuda")
    calls = []

    def step():
        calls.append(len(calls))
        buf.add_(1)
        n = int(buf.sum().item())        # a host read
        return buf * n
    with pytest.raises(RuntimeError):
        graphs.run("host-read", step)
    assert calls == [0, 1]               # the warm-up, then the capture
    assert graphs.captures == 0
