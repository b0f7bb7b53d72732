"""The key split of non-causal attention on the CPU: the split plans of
the forward (``flash_prefill.split_plan``) and of the backward's dQ pass
(``flash_prefill_bwd.dq_split``) as pure functions of shapes and SM count,
the plain version of the forward's merge (``ref.flash_prefill_combine``)
against the unsplit plain forward and JAX's ``attention_seq(causal=False)``,
and the plain backward's partial dQs over the same ranges, summed in
order, against ``jax.vjp``. The CUDA kernels that split are held to their
plain versions on the card (``tests/test_torch_cuda.py``, chip_smoke.py
phase 2).

Tolerance: 1e-5 (absolute and relative, f32) everywhere; rows past
q_valid exactly 0 with lse +inf.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.modeling import attention_seq
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import (KEY_TILE, SPLIT_WAVES,
                                               KeySplit, key_split,
                                               split_plan)
from repro_torch.kernels.flash_prefill_bwd import dq_split

TOL = 1e-5
H100_SMS = 132
SK_EDGES = (1, 31, 32, 33, 1500, 4097)
# whisper-base (8/8 heads of 64): (b, s, sk) of the served encoder and
# prefill cross-attention, and of training's encoder and cross-attention,
# with the ranges each plan gives there on an H100
WHISPER = {
    "served encoder": ((2, 1500, 1500), 1, None),
    "served cross-attention": ((4, 64, 1500), 8, None),
    "trained encoder": ((8, 1500, 1500), 1, 1),
    "trained cross-attention": ((8, 448, 1500), 2, 5),
}


def _ranges(plan: KeySplit, sk: int):
    if plan.splits == 1:
        return [(0, sk)]
    return [(j * plan.keys, min(sk, (j + 1) * plan.keys))
            for j in range(plan.splits)]


@pytest.mark.parametrize("sk", SK_EDGES)
@pytest.mark.parametrize("b,s,nq,hd", [(1, 1, 2, 64), (2, 64, 8, 64),
                                       (4, 64, 8, 64), (2, 448, 8, 32),
                                       (1, 65, 4, 128), (8, 1500, 8, 64)])
def test_split_ranges_cover_the_keys_and_none_is_empty(sk, b, s, nq, hd):
    for causal in (True, False):
        plans = [(split_plan(b, s, sk, nq, hd, causal=causal, window=None,
                             sms=H100_SMS), KEY_TILE),
                 (dq_split(b, s, sk, nq, hd, causal=causal, sms=H100_SMS),
                  64 if hd == 32 else 32)]
        for plan, tile in plans:
            if causal:
                assert plan == KeySplit(1, 0)
            if plan.splits > 1:
                assert plan.keys % tile == 0
            ranges = _ranges(plan, sk)
            assert ranges[0][0] == 0 and ranges[-1][1] == sk
            assert all(lo < hi for lo, hi in ranges)
            assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("window", [None, 1, 4096])
@pytest.mark.parametrize("b,s,sk", [(1, 64, 64), (4, 64, 1500),
                                    (2, 1500, 1500)])
def test_causal_and_window_modes_never_split(window, b, s, sk):
    assert split_plan(b, s, sk, 8, 64, causal=True, window=window,
                      sms=H100_SMS) == KeySplit(1, 0)
    assert dq_split(b, s, sk, 8, 64, causal=True, sms=H100_SMS) \
        == KeySplit(1, 0)


@pytest.mark.parametrize("sms,per_sm", [(132, 3), (132, 2), (114, 1), (8, 3)])
def test_grids_of_about_four_waves_are_not_split(sms, per_sm):
    waves = -(-int(SPLIT_WAVES * sms * per_sm * 10) // 10)
    for ctas in (waves, 4 * sms * per_sm, 40 * sms * per_sm):
        assert key_split(ctas, 4097, KEY_TILE, sms, per_sm) \
            == KeySplit(1, 0)
    # a grid that leaves most SMs idle is split where the keys allow it,
    # and not where they do not
    assert key_split(sms // 4 or 1, 4097, KEY_TILE, sms, per_sm).splits > 1
    assert key_split(1, 4 * KEY_TILE, KEY_TILE, sms, per_sm).splits == 1


@pytest.mark.parametrize("shape", sorted(WHISPER))
def test_whisper_shapes_split_as_documented(shape):
    (b, s, sk), fwd, dq = WHISPER[shape]
    assert split_plan(b, s, sk, 8, 64, causal=False, window=None,
                      sms=H100_SMS).splits == fwd
    if dq is not None:
        assert dq_split(b, s, sk, 8, 64, causal=False,
                        sms=H100_SMS).splits == dq


def test_split_plans_depend_on_shapes_and_sms_only():
    def plan(sms):
        return split_plan(4, 64, 1500, 8, 64, causal=False, window=None,
                          sms=sms)
    assert plan(132) == plan(132)
    # fewer SMs: fewer ranges fill them
    assert plan(66).splits < plan(132).splits


def _inputs(rng, b, s, sk, nq, nkv, hd):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, s, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd),
                          (b, s, nq, hd))]


def _jax_attention(q, k, v, nkv, q_valid=None):
    qv = None if q_valid is None else jnp.asarray(q_valid)
    return np.asarray(jax.jit(lambda a, b_, c: attention_seq(
        a, b_, c, nkv, causal=False, q_valid=qv))(q, k, v))


# (b, s, sk, nq, nkv, hd, keys a range, q_valid)
COMBINE_CASES = [
    (2, 20, 77, 8, 4, 32, 32, [20, 0]),
    (1, 65, 130, 4, 4, 64, 64, None),
    (2, 33, 33, 4, 2, 32, 32, [5, 33]),
    (2, 9, 257, 2, 1, 64, 96, [0, 9]),
    (1, 1, 4097, 2, 2, 32, 1024, None),
]


@pytest.mark.parametrize("case", COMBINE_CASES)
def test_plain_combine_matches_the_unsplit_forward_and_jax(case):
    b, s, sk, nq, nkv, hd, keys, qv_l = case
    rng = np.random.default_rng(s * 31 + sk)
    q, k, v, _ = _inputs(rng, b, s, sk, nq, nkv, hd)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    qv = None if qv_l is None else torch.tensor(qv_l, dtype=torch.int32)
    ranges = _ranges(KeySplit(-(-sk // keys), keys), sk)
    assert len(ranges) > 1 or sk <= keys
    parts, lses = zip(*(ref.flash_prefill_fwd(tq, tk[:, lo:hi], tv[:, lo:hi],
                                              causal=False)
                        for lo, hi in ranges))
    out, lse = ref.flash_prefill_combine(torch.stack(parts),
                                         torch.stack(lses), q_valid=qv)
    want = ref.flash_prefill(tq, tk, tv, q_valid=qv, causal=False)
    torch.testing.assert_close(out, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out.numpy(), _jax_attention(q, k, v, nkv, qv_l),
                               rtol=TOL, atol=TOL)
    _, want_lse = ref.flash_prefill_fwd(tq, tk, tv, causal=False)
    for bi in range(b):
        n = s if qv_l is None else qv_l[bi]
        torch.testing.assert_close(lse[bi, :, :n], want_lse[bi, :, :n],
                                   rtol=TOL, atol=TOL)
        assert torch.count_nonzero(out[bi, n:]) == 0
        assert bool(torch.isinf(lse[bi, :, n:]).all())
        assert bool((lse[bi, :, n:] > 0).all())


@pytest.mark.parametrize("b,s,sk,nq,nkv,hd,keys", [
    (2, 20, 77, 8, 4, 32, 32),
    (1, 48, 300, 4, 4, 64, 96),
    (2, 64, 33, 4, 2, 32, 32),
    (1, 7, 1500, 2, 2, 32, 512),
])
def test_partial_dq_over_key_ranges_sums_to_jax_vjp(b, s, sk, nq, nkv, hd,
                                                    keys):
    rng = np.random.default_rng(s + 3 * sk + hd)
    q, k, v, do = _inputs(rng, b, s, sk, nq, nkv, hd)

    @jax.jit
    def dq_of(q_, k_, v_, do_):
        _, vjp = jax.vjp(lambda a, b_, c: attention_seq(
            a, b_, c, nkv, causal=False), q_, k_, v_)
        return vjp(do_)[0]
    want = np.asarray(dq_of(*map(jnp.asarray, (q, k, v, do))))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_prefill_fwd(tq, tk, tv, causal=False)
    ranges = _ranges(KeySplit(-(-sk // keys), keys), sk)
    dq = torch.zeros_like(tq)
    for lo, hi in ranges:      # in range order, as the kernel sums them
        dq = dq + ref.flash_prefill_bwd(tq, tk[:, lo:hi], tv[:, lo:hi], o,
                                        lse, tdo, causal=False)[0]
    np.testing.assert_allclose(dq.numpy(), want, rtol=TOL, atol=TOL)
    assert math.isfinite(float(dq.abs().max()))
