"""The port's plain kernel versions against the JAX oracles
(src/repro/kernels/ref.py) and the Pallas kernels in interpret mode, on
the shapes and dtypes of tests/test_kernels.py; the CUDA kernels against
the plain versions on the card (marked ``cuda``: skipped without one).

Tolerances: copies bit-exact; attention f32 1e-4 (torch and XLA sum in
other orders), bf16 2e-2 as in tests/test_kernels.py. On the card the
kernels must match the plain versions within 1e-5 (f32).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_prefill import flash_prefill_pallas
from repro.kernels.kv_gather import kv_gather_pallas
from repro.kernels.kv_scatter import kv_scatter_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import SPLIT_TOKENS, split_plan
from torch_parity import BF16_TOL, F32_TOL, assert_close, np32

SHAPES = [
    # (L, NB, BS, kvd), as tests/test_kernels.py
    (1, 4, 8, 64),
    (3, 16, 16, 128),
    (6, 32, 16, 256),
    (2, 8, 4, 64),
]
DTYPES = {"f32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _pair(arr, dt):
    """The same values as a torch tensor and a jnp array of dtype dt."""
    t = torch.from_numpy(np.asarray(arr, np.float32)).to(DTYPES[dt][0])
    # an independent copy: in-place port kernels must not reach the jnp
    return t, jnp.asarray(np.array(np32(t)), DTYPES[dt][1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kv_gather_matches_jax(shape, dt):
    L, NB, BS, kvd = shape
    rng = np.random.default_rng(0)
    st_t, st_j = _pair(rng.normal(size=(L, NB, BS, 2 * kvd)), dt)
    idx = rng.permutation(NB)[: NB // 2].astype(np.int32)
    got = ops.kv_gather(st_t, torch.from_numpy(idx))
    assert got.data_ptr() != st_t.data_ptr()
    for want in (jref.kv_gather(st_j, jnp.asarray(idx)),
                 kv_gather_pallas(st_j, jnp.asarray(idx), interpret=True)):
        np.testing.assert_array_equal(np32(got), np32(want))
    for layer in (0, L - 1):
        np.testing.assert_array_equal(
            np32(ops.kv_gather_layer(st_t, torch.from_numpy(idx), layer)),
            np32(got[layer]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_kv_scatter_matches_jax(shape, dt):
    L, NB, BS, kvd = shape
    rng = np.random.default_rng(2)
    st_t, st_j = _pair(rng.normal(size=(L, NB, BS, 2 * kvd)), dt)
    n = max(1, NB // 3)
    idx = rng.permutation(NB)[:n].astype(np.int32)
    buf_t, buf_j = _pair(rng.normal(size=(L, n * BS, 2 * kvd)), dt)
    ptr = st_t.data_ptr()
    got = ops.kv_scatter(st_t, buf_t, torch.from_numpy(idx))
    assert got.data_ptr() == ptr and st_t.data_ptr() == ptr  # in place
    for want in (jref.kv_scatter(st_j, buf_j, jnp.asarray(idx)),
                 kv_scatter_pallas(st_j, buf_j, jnp.asarray(idx),
                                   interpret=True)):
        np.testing.assert_array_equal(np32(got), np32(want))


@pytest.mark.parametrize("seed", range(6))
def test_gather_scatter_roundtrip_and_untouched_blocks(seed):
    rng = np.random.default_rng(seed)
    NB = int(rng.integers(4, 24))
    BS = int(rng.choice([4, 8, 16]))
    L = int(rng.integers(1, 5))
    kvd = int(rng.choice([32, 64]))
    n = int(rng.integers(1, NB + 1))
    storage = torch.from_numpy(rng.normal(size=(L, NB, BS, 2 * kvd)).astype(
        np.float32))
    perm = rng.permutation(NB)
    idx = torch.from_numpy(perm[:n].astype(np.int32))
    back = storage.clone()
    ops.kv_scatter(back, ops.kv_gather(storage, idx), idx)
    assert torch.equal(back, storage)
    other = storage.clone()
    ops.kv_scatter(other, torch.zeros(L, n * BS, 2 * kvd), idx)
    keep = torch.from_numpy(perm[n:].astype(np.int64))
    assert torch.equal(other[:, keep], storage[:, keep])
    assert int(torch.count_nonzero(other[:, idx.long()])) == 0
    layer = int(rng.integers(0, L))
    one = storage.clone()
    ops.kv_scatter_layer(one, torch.zeros(n * BS, 2 * kvd), idx, layer)
    rest = [i for i in range(L) if i != layer]
    assert torch.equal(one[rest], storage[rest])
    assert int(torch.count_nonzero(one[layer, idx.long()])) == 0


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


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("gqa", [1, 4])
def test_paged_attention_matches_jax(shape, dt, gqa):
    """Active rows against the JAX oracle; every row, including the
    inactive one (lens == 0, all -1 table), against the Pallas kernel."""
    L, NB, BS, kvd = shape
    tol = DTYPES[dt][2]
    rng = np.random.default_rng(3)
    q, pages, bt, lens = _paged_inputs(rng, L, NB, BS, kvd, gqa)
    q_t, q_j = _pair(q, dt)
    p_t, p_j = _pair(pages, dt)
    got = ops.paged_attention(q_t, p_t, torch.from_numpy(bt),
                              torch.from_numpy(lens))
    assert got.dtype == q_t.dtype
    want = jref.paged_attention(q_j, p_j, jnp.asarray(bt), jnp.asarray(lens))
    assert_close(got[:-1], want[:-1], tol, "active rows vs JAX ref")
    kern = paged_attention_pallas(q_j, p_j, jnp.asarray(bt),
                                  jnp.asarray(lens), interpret=True)
    assert_close(got, kern, tol, "all rows vs Pallas kernel")
    assert int(torch.count_nonzero(got[-1])) == 0


@pytest.mark.parametrize("seed", range(4))
def test_paged_attention_is_permutation_invariant(seed):
    """Physical block placement must not change the output."""
    rng = np.random.default_rng(seed)
    NB, BS, kvd, hd, n_seq = 16, 8, 64, 32, 3
    nkv = kvd // hd
    q = torch.from_numpy(rng.normal(size=(n_seq, nkv * 2, hd)).astype(
        np.float32))
    tokens = [rng.normal(size=(rng.integers(1, 3) * BS, 2 * kvd))
              for _ in range(n_seq)]
    lens = torch.tensor([int(rng.integers(1, len(t) + 1)) for t in tokens],
                        dtype=torch.int32)

    def build(order_seed):
        prm = np.random.default_rng(order_seed).permutation(NB)
        pages = np.zeros((NB, BS, 2 * kvd), np.float32)
        bt = np.full((n_seq, 4), -1, np.int32)
        cursor = 0
        for i, t in enumerate(tokens):
            nb = len(t) // BS
            blocks = prm[cursor: cursor + nb]
            cursor += nb
            for j, b in enumerate(blocks):
                pages[b] = t[j * BS:(j + 1) * BS]
            bt[i, :nb] = blocks
        return torch.from_numpy(pages), torch.from_numpy(bt)

    o1 = ops.paged_attention(q, *build(1), lens)
    o2 = ops.paged_attention(q, *build(2), lens)
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)


def _jax_flash_rows(q, k, v, q_offset, prefix_pad, q_valid, dt):
    """The JAX oracle on (b, s, nq, hd) / (b, sk, nkv, hd) inputs with a
    per-row q_valid: heads flattened into the batch, K/V repeated per
    group, one call per batch row (the oracle takes a scalar q_valid)."""
    b, s, nq, hd = q.shape
    g = nq // k.shape[2]
    outs = []
    for bi in range(b):
        qq = np.moveaxis(q[bi], 1, 0)                    # (nq, s, hd)
        kk = np.repeat(np.moveaxis(k[bi], 1, 0), g, axis=0)
        vv = np.repeat(np.moveaxis(v[bi], 1, 0), g, axis=0)
        o = jref.flash_prefill(*(jnp.asarray(x, DTYPES[dt][1])
                                 for x in (qq, kk, vv)),
                               q_offset=q_offset, prefix_pad=prefix_pad,
                               q_valid=int(q_valid[bi]))
        outs.append(np.moveaxis(np32(o), 0, 1))
    return np.stack(outs)


FLASH_CASES = [
    # (b, s, nq, nkv, hd, q_offset, prefix_pad, q_valid per row)
    (2, 16, 4, 2, 32, 0, 0, [16, 9]),
    (2, 48, 4, 2, 32, 20, 32, [48, 30]),
    (1, 48, 4, 4, 64, 16, 0, [40]),
    (2, 300, 4, 2, 32, 0, 0, [300, 257]),
    (1, 300, 8, 2, 32, 37, 64, [299]),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_prefill_matches_jax_ref(case, dt):
    b, s, nq, nkv, hd, qo, pp, qv = case
    tol = DTYPES[dt][2]
    sk = (pp or qo) + s
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=sh) for sh in
               ((b, s, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd)))
    ts = [_pair(x, dt)[0] for x in (q, k, v)]
    got = ops.flash_prefill(*ts, q_offset=qo, prefix_pad=pp,
                            q_valid=torch.tensor(qv, dtype=torch.int32))
    assert got.dtype == ts[0].dtype
    want = _jax_flash_rows(*(np32(t) for t in ts), qo, pp, qv, dt)
    assert_close(got, want, tol)
    for bi, n in enumerate(qv):
        assert int(torch.count_nonzero(got[bi, n:])) == 0


@pytest.mark.parametrize("s,hd,qo,pp,qv", [(128, 64, 0, 0, 0),
                                           (128, 64, 100, 128, 90),
                                           (256, 32, 0, 0, 200)])
@pytest.mark.parametrize("dt", list(DTYPES))
def test_flash_prefill_matches_pallas(s, hd, qo, pp, qv, dt):
    """Against the Pallas kernel in interpret mode (which needs s and sk
    to be multiples of its 128-row tiles), MHA layout."""
    tol = DTYPES[dt][2]
    bh = 2
    sk = (pp or qo) + s
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=sh) for sh in
               ((bh, s, hd), (bh, sk, hd), (bh, sk, hd)))
    pairs = [_pair(x, dt) for x in (q, k, v)]
    got = ops.flash_prefill(*(t[:, :, None] for t, _ in pairs),
                            q_offset=qo, prefix_pad=pp,
                            q_valid=torch.full((bh,), qv or s,
                                               dtype=torch.int32))
    want = flash_prefill_pallas(*(j for _, j in pairs), q_offset=qo,
                                prefix_pad=pp, q_valid=qv, interpret=True)
    assert_close(got[:, :, 0], want, tol)


def test_ops_route_by_device_and_never_fall_back():
    """CPU tensors take the plain version; any other non-CUDA device is
    refused rather than quietly computed elsewhere."""
    st = torch.randn(2, 4, 4, 64)
    idx = torch.tensor([2, 0], dtype=torch.int32)
    assert torch.equal(ops.kv_gather(st, idx), ref.kv_gather(st, idx))
    with pytest.raises(ValueError, match="no kernel"):
        ops.kv_gather(st.to("meta"), idx.to("meta"))


@pytest.mark.parametrize("B,nq,nkv,hd,maxb,bs", [
    (8, 32, 8, 128, 32, 16),     # granite-3-8b's decode step
    (4, 8, 2, 32, 4, 4),
    (3, 48, 8, 128, 7, 8),       # g = 6, ranges of 4 blocks
    (1, 4, 4, 64, 1, 16),        # one block: one range
    (2, 8, 8, 64, 5, 48),        # a block wider than SPLIT_TOKENS
    (5, 16, 2, 128, 3, 12),      # split_tokens not a multiple of 16
    (0, 32, 8, 128, 32, 16),     # no sequence: nothing launches
])
def test_paged_split_plan_covers_every_token(B, nq, nkv, hd, maxb, bs):
    """The split kernel's ranges tile [0, MAXB*BS) exactly, each a whole
    number of blocks, none empty past the end; the scratch matches."""
    plan = split_plan(B, nq, nkv, hd, maxb, bs)
    S, split = plan.splits, plan.split_tokens
    assert S >= 1 and split >= SPLIT_TOKENS and split % bs == 0
    owner = np.zeros(maxb * bs, np.int64)
    for sidx in range(S):
        owner[sidx * split:(sidx + 1) * split] += 1
    assert (owner == 1).all()
    assert (S - 1) * split < max(maxb * bs, 1)
    assert plan.grid == (nkv, B, S)
    assert plan.part_shape == (B, nq, S, hd)
    assert plan.stat_shape == (B, nq, S)
    assert plan.kernel_launches == (2 if B else 0)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel against its plain version on the card, at reduced
    widths (chip_smoke.py does the full-width comparison)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
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
