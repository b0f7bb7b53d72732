"""The port's MoE layer against the JAX package's, on the reduced MoE
families (4 experts top-2, capacity factor 1.25, window 16) and on
deepseek-moe-16b's routing ratio (top-6 of 8 experts with 2 shared:
``torch_parity.DEEPSEEK_TOP6``) with identical weights.

Routing is discrete, so it is held exactly: top-k expert ids, and the
capacity buffer (which token sits in which expert slot, bit for bit,
which pins slots and keep masks). To keep that honest every input here
is checked first: the smallest gap between a token's k-th and (k+1)-th
router probability must be well above the f32 tolerance, so a mismatch
is a fault and not a near-tie. Outputs and the aux loss are held to the
f32 tolerance, 1e-4 (torch and XLA sum in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import modeling as jm
from repro_torch.models import modeling as tm
from torch_parity import DEEPSEEK_TOP6, F32_TOL, assert_close, both_params

MOE_ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b", "jamba-1.5-large-398b",
             DEEPSEEK_TOP6]
# a near-tie closer than this could flip between frameworks
MIN_GAP = 1e-3


def _moe_params(arch):
    """(cfg, pcfg, jax MoE params, port MoE params) of the first MoE
    sublayer of block 0."""
    cfg, jp, pcfg, tp = both_params(arch)
    sub = f"sub{cfg.moe_layer_mask().index(True)}"
    jmoe = jax.tree.map(lambda a: a[0], jp["blocks"][sub]["moe"])
    pmoe = {k: (v[0] if not isinstance(v, dict)
                else {k2: v2[0] for k2, v2 in v.items()})
            for k, v in tp["blocks"][sub]["moe"].items()}
    return cfg, pcfg, jmoe, pmoe


def _tokens(cfg, jmoe, n, seed):
    """n seeded token rows whose top-k routing has no near-tie: rows are
    drawn one by one and a row whose k-th and (k+1)-th probabilities lie
    within MIN_GAP is drawn again."""
    rng = np.random.default_rng(seed)
    k = cfg.moe.top_k
    router = np.asarray(jmoe["router"])

    def gap(x):
        probs = np.asarray(jax.nn.softmax(jnp.asarray(x @ router), -1))
        srt = -np.sort(-probs, axis=-1)
        return srt[:, k - 1] - srt[:, k]
    rows = []
    while len(rows) < n:
        x = (rng.normal(size=(1, cfg.d_model)) * 4).astype(np.float32)
        if gap(x)[0] > MIN_GAP:
            rows.append(x[0])
    x = np.stack(rows)
    assert gap(x).min() > MIN_GAP
    return x


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_router_matches_jax(arch):
    cfg, pcfg, jmoe, pmoe = _moe_params(arch)
    x = _tokens(cfg, jmoe, 48, seed=1)
    jg, ji, ja = jm._moe_router(jmoe, jnp.asarray(x), cfg)
    tg, ti, ta = tm._moe_router(pmoe, _t(x), pcfg)
    assert ti.tolist() == np.asarray(ji).tolist()
    assert_close(tg, jg)
    assert_close(ta, ja)


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.3, 0.2, 0.3, 0.2], [0.25] * 4])
    vals, idx = tm._top_k(probs, 2)
    want = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want[1]).tolist() == [[0, 2], [0, 1]]
    assert_close(vals, want[0])


def _capture_jax_buffer(monkeypatch):
    """Record the capacity buffer JAX builds: its first ``constrain``
    call in _moe_dispatch_capacity receives xe (E, G*C, d). Only this
    test module's view of the attribute changes."""
    seen = []

    def constrain(a, axes):
        seen.append(np.asarray(a))
        return a
    monkeypatch.setattr(jm, "constrain", constrain)
    return seen


# (rows, tokens per row, valid per row or None): full rows of one
# window where W*K*cf/E = 16*2*1.25/4 = 10 (top-6 of 8: 16*6*1.25/8 =
# 15) is an exact integer (the c_thr clamp case), rows with bucket-tail
# pads, rows not a multiple of the window, and the decode step's
# one-token rows
CASES = [(1, 16, None), (3, 16, [16, 9, 5]), (2, 20, [20, 13]),
         (2, 40, [37, 16]), (8, 1, None)]


@pytest.mark.parametrize("rows,s,valid", CASES)
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  DEEPSEEK_TOP6])
def test_capacity_dispatch_matches_jax(arch, rows, s, valid, monkeypatch):
    """Slots held bit for bit (the buffer of tokens in expert slots),
    outputs and aux loss within 1e-4, pad rows get zero expert output."""
    cfg, pcfg, jmoe, pmoe = _moe_params(arch)
    x = _tokens(cfg, jmoe, rows * s, seed=2 + rows + s)
    seen = _capture_jax_buffer(monkeypatch)
    jv = None if valid is None else jnp.asarray(valid, jnp.int32)
    tv = None if valid is None else torch.tensor(valid, dtype=torch.int32)
    jy, ja = jm._moe_dispatch_capacity(jmoe, jnp.asarray(x), cfg, rows, jv)
    ty, ta = tm._moe_dispatch_capacity(pmoe, _t(x), pcfg, rows, tv)
    _, _, idx = tm._route(pmoe, _t(x), pcfg)
    xe, slot, keep, onehot, _ = tm._capacity_dispatch(_t(x), idx, pcfg,
                                                      rows, tv)
    assert np.array_equal(xe.numpy(), seen[0])      # same token, same slot
    assert int(keep.sum()) == int((np.abs(seen[0]).sum(-1) > 0).sum())
    assert int(onehot.sum()) == rows * s * cfg.moe.top_k if valid is None \
        else sum(valid) * cfg.moe.top_k
    assert_close(ty, jy)
    assert_close(ta, ja)
    if valid is not None and not cfg.moe.num_shared_experts:
        for r, v in enumerate(valid):
            assert int(torch.count_nonzero(ty[r * s + v:(r + 1) * s])) == 0


def test_clamp_case_keeps_at_most_capacity():
    """W*K*cf/E is an exact integer here: the per-window threshold must
    not pass the buffer's C slots, so no expert keeps more than C tokens
    of a window and no slot index reaches the next expert's."""
    cfg, pcfg, jmoe, pmoe = _moe_params("qwen2-moe-a2.7b")
    m = cfg.moe
    assert 16 * m.top_k / m.num_experts * m.capacity_factor == 10.0
    x = _tokens(cfg, jmoe, 64, seed=5)
    _, _, idx = tm._route(pmoe, _t(x), pcfg)
    xe, slot, keep, onehot, _ = tm._capacity_dispatch(_t(x), idx, pcfg, 1)
    C = 10
    G = 64 // 16
    kept = slot[keep]
    assert int(kept.max()) < G * m.num_experts * C
    per = torch.bincount(kept // C, minlength=G * m.num_experts)
    assert int(per.max()) <= C


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b",
                                  DEEPSEEK_TOP6])
def test_sorted_dispatch_matches_jax(arch):
    cfg, pcfg, jmoe, pmoe = _moe_params(arch)
    scfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="sorted"))
    spcfg = pcfg.replace(moe=dataclasses.replace(pcfg.moe,
                                                 dispatch="sorted"))
    x = _tokens(cfg, jmoe, 40, seed=7)
    jy, ja = jm.moe_ffn(jmoe, jnp.asarray(x), scfg)
    ty, ta = tm.moe_ffn(pmoe, _t(x), spcfg)
    assert_close(ty, jy)
    assert_close(ta, ja)


@pytest.mark.parametrize("rows,valid", [(1, [70]), (2, [40, 23])])
def test_moe_ffn_chunked_path_matches_jax(rows, valid, monkeypatch):
    """Token chunking, made to happen at 80 tokens by a small
    MOE_TOKEN_CHUNK on both sides: one row of 80 goes in five 16-token
    chunks (the largest window-aligned divisor); two rows go one at a
    time, each 40-token row padded to two 32-token chunks (no aligned
    divisor). Chunks align with the capacity windows, so the chunked
    output is also the unchunked one."""
    monkeypatch.setattr(jm, "MOE_TOKEN_CHUNK", 32)
    monkeypatch.setattr(tm, "MOE_TOKEN_CHUNK", 32)
    cfg, pcfg, jmoe, pmoe = _moe_params("qwen2-moe-a2.7b")
    x = _tokens(cfg, jmoe, 80, seed=11)
    jy, ja = jm.moe_ffn(jmoe, jnp.asarray(x), cfg, rows,
                        jnp.asarray(valid, jnp.int32))
    ty, ta = tm.moe_ffn(pmoe, _t(x), pcfg, rows,
                        torch.tensor(valid, dtype=torch.int32))
    assert_close(ty, jy)
    assert_close(ta, ja)
    # and the chunked result is the unchunked one
    monkeypatch.setattr(tm, "MOE_TOKEN_CHUNK", 1 << 15)
    uy, _ = tm.moe_ffn(pmoe, _t(x), pcfg, rows,
                       torch.tensor(valid, dtype=torch.int32))
    assert_close(ty, uy)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-1.5-large-398b"])
def test_sorted_decode_step_traces_on_meta(arch):
    """The fused decode step with sorted dispatch runs on meta tensors
    under the cost counter: a host read of a tensor raises there, so the
    step (offsets built on the device, the grouped product three times a
    MoE layer) is capturable; the counter charges the grouped kernel and
    never ``torch.bincount``."""
    from repro_torch.launch.cost import count
    from repro_torch.models.caches import decode_slot_state
    from repro_torch.models.params import abstract_params
    from torch_parity import moe_sorted
    _, _, pcfg, _ = both_params(arch)
    pcfg = moe_sorted(pcfg)
    p = abstract_params(pcfg)
    ms, T, nb, bs = 4, 8, 16, 4
    n_attn = sum(kd == "attn" for kd in pcfg.layer_kinds())

    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    st = meta(max(n_attn, 1), nb + 1, bs, 2 * pcfg.kv_dim)
    args = (st, meta(ms, T, dtype=torch.int32), meta(ms, dtype=torch.int32),
            meta(ms, dtype=torch.int32), meta(ms, dtype=torch.bool))
    c = count(lambda prm, s, bt, tk, ps, ac, sl: tm.forward_decode_step(
        pcfg, prm, s, bt, tk, ps, ac, sl, block_size=bs),
        p, *args, decode_slot_state(pcfg, ms, device="meta"))
    n_moe = sum(pcfg.moe_layer_mask())
    assert c.kernels["grouped_mm"]["calls"] == 3 * n_moe
    m = pcfg.moe
    assert c.kernels["grouped_mm"]["flops"] == n_moe * 2 * ms * m.top_k \
        * 3 * pcfg.d_model * m.d_ff_expert
