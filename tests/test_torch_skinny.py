"""The routing rule of the skinny product (``kernels/skinny_mm.py``) and
what surrounds the kernel, on the CPU.

``models/modeling.py:_mm`` and ``lm_logits`` send ``x @ w`` to
``ops.skinny_mm`` when both operands are f32 on one card, x has at most
32 rows, w is row-major (K, N) or the transpose of a row-major (N, K),
and nothing requires grad under grad mode; everything else stays
``x @ w``. Here the kernel entry is stubbed: ``skinny_mm.on_card`` is
made to call a CPU tensor a card's where a test asks for the card's
route, and ``ops.skinny_mm`` records its calls. The kernel itself is
tested on the card (``tests/test_torch_cuda.py -k skinny``).
"""
import functools

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels import skinny_mm as sk
from repro_torch.launch.cost import count
from repro_torch.models import modeling
from repro_torch.models.caches import decode_slot_state
from repro_torch.models.params import abstract_params, init_params


@pytest.fixture
def calls(monkeypatch):
    """Stub the kernel entry: record (x, ws) and return [x @ w for w in
    ws]."""
    got = []

    def stub(x, *ws):
        got.append((x, ws))
        return [x @ w for w in ws]
    monkeypatch.setattr(ops, "skinny_mm", stub)
    return got


@pytest.fixture
def as_card(monkeypatch):
    """Let CPU tensors stand for a card's in the routing rule."""
    monkeypatch.setattr(sk, "on_card",
                        lambda t: t.device.type in ("cpu", "cuda"))


def _nn(K, N, dtype=torch.float32):
    return torch.randn(K, N, dtype=dtype)


def _t(K, N, dtype=torch.float32):
    return torch.randn(N, K, dtype=dtype).T


def _x(M, K, dtype=torch.float32):
    return torch.randn(M, K, dtype=dtype)


# (x, w) pairs that must stay x @ w even where CPU tensors stand for a
# card's (with as_card), by the rule's other conditions
PLAIN = {
    "bf16": lambda: (_x(4, 64, torch.bfloat16), _nn(64, 128, torch.bfloat16)),
    "f16": lambda: (_x(4, 64, torch.float16), _nn(64, 128, torch.float16)),
    "f64": lambda: (_x(4, 64, torch.float64), _nn(64, 128, torch.float64)),
    "mixed f32 @ bf16": lambda: (_x(4, 64), _nn(64, 128, torch.bfloat16)),
    "mixed bf16 @ f32": lambda: (_x(4, 64, torch.bfloat16), _nn(64, 128)),
    "33 rows": lambda: (_x(33, 64), _nn(64, 128)),
    "160 rows (a spec step)": lambda: (_x(160, 64), _nn(64, 128)),
    "33 rows in 3 dims": lambda: (_x(33, 64).reshape(3, 11, 64),
                                  _nn(64, 128)),
    "no rows": lambda: (_x(0, 64), _nn(64, 128)),
    "N not a multiple of 4": lambda: (_x(4, 64), _nn(64, 130)),
    "K not a multiple of 4": lambda: (_x(4, 62), _nn(62, 128)),
    "N under a tile (a router)": lambda: (_x(4, 64), _nn(64, 64)),
    "N under a tile, transposed": lambda: (_x(4, 64), _t(64, 124)),
    "w column slice": lambda: (_x(4, 64), _nn(64, 256)[:, 1:129]),
    "w strided columns": lambda: (_x(4, 64), _nn(64, 256)[:, ::2]),
    "w rows 130 apart": lambda: (_x(4, 64), _nn(64, 130)[:, :128]),
    "w.T of a column slice": lambda: (_x(4, 64), _t(65, 128)[1:]),
    "x columns strided": lambda: (_x(4, 128)[:, ::2], _nn(64, 128)),
    "x rows 66 apart": lambda: (_x(4, 66)[:, :64], _nn(64, 128)),
    "x off 16 bytes": lambda: (_x(1, 65).view(-1)[1:].view(1, 64),
                               _nn(64, 128)),
    "3-d w (capacity experts)": lambda: (_x(4, 64), torch.randn(2, 64, 32)),
    "1-d w": lambda: (_x(4, 64), torch.randn(64)),
}


@pytest.mark.parametrize("case", sorted(PLAIN))
def test_skinny_rule_leaves_other_operands_to_matmul(case, calls, as_card):
    x, w = PLAIN[case]()
    assert not ops.skinny_mm_applies(x, w)
    if w.dim() == 2 and x.shape[-1] == w.shape[0]:
        got = modeling._mm(x, w)
        dt = torch.promote_types(x.dtype, w.dtype)
        assert torch.equal(got, x.to(dt) @ w.to(dt))
    assert calls == []


@pytest.mark.parametrize("where", ["cpu", "meta"])
def test_skinny_rule_leaves_cpu_and_meta_tensors_to_matmul(where, calls):
    """Without the stand-in, CPU tensors (and meta tensors) of every
    shape the kernel takes stay x @ w: the CPU tests and the planner's
    count see the products they always saw."""
    for M in (1, 32):
        for w in (_nn(64, 128), _t(64, 128)):
            x = _x(M, 64)
            if where == "meta":
                x, w = x.to("meta"), w.to("meta")
            assert not ops.skinny_mm_applies(x, w)
            y = modeling._mm(x, w)
            assert y.shape == (M, 128) and y.device.type == where
    assert calls == []


@pytest.mark.parametrize("needs", ["x", "w"])
def test_skinny_rule_leaves_grad_to_matmul(needs, calls, as_card):
    """An operand that requires grad under grad mode stays x @ w (and
    keeps its gradient); under no_grad it takes the kernel."""
    x, w = _x(8, 64), _nn(64, 128)
    (x if needs == "x" else w).requires_grad_(True)
    assert not ops.skinny_mm_applies(x, w)
    modeling._mm(x, w).sum().backward()
    assert calls == []
    assert (x if needs == "x" else w).grad is not None
    with torch.no_grad():
        modeling._mm(x, w)
    assert len(calls) == 1


@pytest.mark.parametrize("M", [1, 7, 26, 32])
@pytest.mark.parametrize("lay", ["nn", "t"])
def test_skinny_rule_takes_card_operands_of_few_rows(M, lay, calls,
                                                     as_card):
    """f32 operands on a card with at most 32 rows, w row-major (K, N) or
    the transpose of a row-major (N, K), go to the kernel entry."""
    w = _nn(64, 136) if lay == "nn" else _t(64, 130)
    x = _x(M, 64)
    assert ops.skinny_mm_applies(x, w)
    assert sk.layout(w) == ((False, 136) if lay == "nn" else (True, 64))
    y = modeling._mm(x, w)
    assert len(calls) == 1 and calls[0][0] is x and calls[0][1] == (w,)
    assert torch.equal(y, x @ w)


def test_skinny_rule_takes_rows_in_any_leading_dims(calls, as_card):
    """x (32, 1, K) (the decode step's FFN input) and a row slice of a
    wider tensor (a prefill batch's last positions) are rows the kernel
    reads without a copy."""
    w = _nn(64, 128)
    x3 = _x(32, 64).reshape(32, 1, 64)
    h = _x(4 * 5, 64).reshape(4, 5, 64)
    for x, ld in ((x3, 64), (h[:, -1, :], 5 * 64)):
        assert sk.row_stride(x) == ld
        y = modeling._mm(x, w)
        assert y.shape == x.shape[:-1] + (128,)
    assert len(calls) == 2


@pytest.mark.parametrize("tied", [True, False])
def test_lm_logits_takes_the_rule(tied, calls, as_card):
    """The head: a tied embed.T (the transposed layout) or an untied
    lm_head (row-major), each through the kernel entry at few rows."""
    cfg = get_config("granite-3-8b").reduced().replace(tie_embeddings=tied)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert cfg.vocab_size >= sk.TILE
    h = _x(3, cfg.d_model)
    got = modeling.lm_logits(cfg, params, h)
    w = params["embed"].T if tied else params["lm_head"]
    w_got, = calls[0][1]
    assert len(calls) == 1 and w_got.data_ptr() == w.data_ptr()
    assert sk.layout(w_got)[0] is tied
    assert torch.equal(got, h @ w)


def test_decode_step_sends_every_dense_product(calls, as_card):
    """A reduced granite decode step over 4 slots (CPU tensors standing
    for a card's; 4 KV heads, so that wk and wv are a column tile wide):
    every dense product goes to the kernel entry, 7 a layer and the head,
    in 4 launches a layer (q, k, v in one, gate and up in one) and the
    head's."""
    cfg = get_config("granite-3-8b").reduced().replace(num_kv_heads=4)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ms, T, nb, bs = 4, 4, 16, 4
    st = torch.zeros(cfg.num_layers, nb + 1, bs, 2 * cfg.kv_dim)
    bt = torch.arange(ms * T, dtype=torch.int32).reshape(ms, T) % nb
    with torch.no_grad():
        modeling.forward_decode_step(
            cfg, params, st, bt, torch.zeros(ms, dtype=torch.int32),
            torch.arange(ms, dtype=torch.int32),
            torch.ones(ms, dtype=torch.bool),
            decode_slot_state(cfg, ms), block_size=bs)
    assert len(calls) == 4 * cfg.num_layers + 1
    assert sum(len(ws) for _, ws in calls) == 7 * cfg.num_layers + 1
    assert all(x.shape[:-1].numel() == ms for x, _ in calls)


def _decode_cost(cfg):
    p = abstract_params(cfg)
    ms, T, nb, bs = 4, 8, 16, 4
    meta = functools.partial(torch.empty, device="meta")
    st = meta(cfg.num_layers, nb + 1, bs, 2 * cfg.kv_dim)
    i32 = functools.partial(meta, dtype=torch.int32)
    return count(lambda prm, s, bt, tk, ps, ac, sl:
                 modeling.forward_decode_step(cfg, prm, s, bt, tk, ps, ac, sl,
                                              block_size=bs),
                 p, st, i32(ms, T), i32(ms), i32(ms),
                 meta(ms, dtype=torch.bool),
                 decode_slot_state(cfg, ms, device="meta"))


def test_decode_step_count_on_meta_is_unchanged(monkeypatch):
    """The planner's count of a decode step on meta: the same flops and
    bytes as with every product plain x @ w, and no skinny kernel
    charged (a meta tensor never takes the kernel)."""
    cfg = get_config("granite-3-8b").reduced()
    got = _decode_cost(cfg)
    assert "skinny_mm" not in got.kernels

    def old_mm(x, w):
        if x.dtype != w.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            return x.to(dt) @ w.to(dt)
        return x @ w
    monkeypatch.setattr(modeling, "_mm", old_mm)
    want = _decode_cost(cfg)
    assert (got.matmul_flops, got.kernel_flops, got.bytes, got.peak_bytes) \
        == (want.matmul_flops, want.kernel_flops, want.bytes,
            want.peak_bytes)
    assert got.matmul_flops > 0


def test_skinny_mm_on_meta_is_charged():
    """ops.skinny_mm called on meta tensors (the planner never routes
    there, but the meta contract holds): 2 M K N flops, its operands'
    bytes, an empty output of the right shape."""
    x = torch.empty(32, 1, 64, device="meta")
    w = torch.empty(64, 48, device="meta")
    c = count(lambda a, b: ops.skinny_mm(a, b)[0], x, w)
    assert c.kernels["skinny_mm"] == {
        "calls": 1, "flops": 2.0 * 32 * 64 * 48,
        "bytes": 4.0 * (32 * 64 + 64 * 48 + 32 * 48)}


@pytest.mark.parametrize("shape", [(1, 4, 4), (7, 64, 40), (32, 128, 12),
                                   (26, 3, 5)])
def test_ref_skinny_mm_is_matmul(shape):
    M, K, N = shape
    x, w = _x(M, K), _nn(K, N)
    assert torch.equal(ref.skinny_mm(x, w), x @ w)
    assert torch.equal(ops.skinny_mm(x, w)[0], x @ w)
    wt = _t(K, N)
    assert torch.equal(ref.skinny_mm(x, wt), x @ wt)


# the skinny launches of the benchmark's decode steps (K, the products'
# N), and edges
PLAN_SHAPES = [(4096, (4096, 1024, 1024)), (4096, (4096,)),
               (4096, (12800, 12800)), (12800, (4096,)), (4096, (49155,)),
               (2048, (2048, 2048, 2048)), (2048, (2816, 2816)),
               (2816, (2048,)), (2048, (102400,)), (4, (128,)),
               (4, (100000, 200, 131)), (100000, (128,)), (36, (130,))]


@pytest.mark.parametrize("K,Ns", PLAN_SHAPES)
def test_skinny_grid_is_within_the_entry_limits(K, Ns):
    """Every grid the wrapper launches passes the C entry's checks: no
    CTA without an iteration, at most RESIDENT an SM, and the scratch a
    slot for each (CTA, tile) pair a run touches (the kernel's runs: CTA c
    takes iterations [c I / G, (c + 1) I / G), its partial of tile t goes
    to slot c + t, and iteration i is CTA ((i + 1) G - 1) // I's)."""
    for sms in (132, 114, 1):
        G = sk.ctas(K, Ns, sms)
        iters = sk.iterations(K, Ns)
        assert 1 <= G <= min(iters, sk.RESIDENT * sms)
        tiles, spt = sum(-(-N // sk.TILE) for N in Ns), -(-K // sk.STAGE)
        assert iters == tiles * spt == sk.tiles(Ns) * spt
        assert sk.scratch(Ns, G) == (G + tiles) * 32 * sk.TILE
        slots = set()
        for c in range(G):
            a, b = c * iters // G, (c + 1) * iters // G
            assert b > a
            for i in (a, b - 1):
                assert ((i + 1) * G - 1) // iters == c
            for tile in range(a // spt, (b - 1) // spt + 1):
                assert c + tile not in slots
                slots.add(c + tile)
        assert max(slots) < G + tiles


def test_products_of_one_x_share_a_launch(calls, as_card):
    """q, k and v (or gate and up) go to the kernel in one launch where
    all take it together; weights of two layouts, or one narrower than a
    tile, split the launch: each product takes its own route."""
    x = _x(4, 64)
    q, k, v = _nn(64, 256), _nn(64, 128), _nn(64, 128)
    got = modeling._mm_shared(x, q, k, v)
    assert len(calls) == 1 and calls[0][1] == (q, k, v)
    assert all(torch.equal(a, x @ b) for a, b in zip(got, (q, k, v)))
    assert not ops.skinny_mm_applies(x, q, _t(64, 128))
    assert not ops.skinny_mm_applies(x, q, k, v, q)     # four
    calls.clear()
    got = modeling._mm_shared(x, q, _t(64, 128), _nn(64, 64))
    assert [c[1][0].shape for c in calls] == [(64, 256), (64, 128)]
    assert got[2].shape == (4, 64)


@pytest.mark.parametrize("case", ["cpu", "bf16", "33 rows", "w strided",
                                  "two layouts", "four products"])
def test_skinny_mm_cuda_refuses_what_it_does_not_take(case):
    """The wrapper checks before it launches and raises (there is no
    fallback): a CPU tensor, another dtype, more than 32 rows, a weight in
    neither layout, weights of two layouts, more than three products."""
    x, w = _x(4, 64), _nn(64, 128)
    if case == "bf16":
        x, w = x.bfloat16(), w.bfloat16()
    elif case == "33 rows":
        x = _x(33, 64)
    elif case == "w strided":
        w = _nn(64, 256)[:, ::2]
    ws = {"two layouts": (w, _t(64, 128)), "four products": (w,) * 4}
    with pytest.raises(ValueError):
        sk.skinny_mm_cuda(x, *ws.get(case, (w,)))
