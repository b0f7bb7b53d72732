"""The gradient of the port's flash prefill on the CPU: the plain
FlashAttention-2 backward (``kernels/ref.py:flash_prefill_bwd``) against
``jax.vjp`` of the JAX package's ``attention_seq``, causal (sk == s) and
non-causal (sk != s both ways: the whisper encoder and cross-attention),
and against torch autograd of the plain forward, and ``FlashPrefillFn``
(what ``ops.flash_prefill`` runs under grad) by
``torch.autograd.gradcheck`` in f64 in both modes. The CUDA backward
kernel is held to the plain version on the card
(``tests/test_torch_cuda.py``, chip_smoke.py phase 2).

Tolerances: F32_TOL (1e-4) against JAX, whose sums run in another order;
1e-5 between two torch computations of the same f32 function; gradcheck
at its f64 defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.modeling import attention_seq
from repro_torch.kernels import ops, ref
from torch_parity import assert_close


def _qkvdo(rng, b, s, nq, nkv, hd, dtype=np.float32, sk=None):
    sk = s if sk is None else sk
    return [rng.normal(size=shape).astype(dtype)
            for shape in ((b, s, nq, hd), (b, sk, nkv, hd),
                          (b, sk, nkv, hd), (b, s, nq, hd))]


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("s", [1, 17, 64, 100])
def test_plain_backward_matches_jax_vjp(g, hd, s):
    nkv = 2
    q, k, v, do = _qkvdo(np.random.default_rng(s * 7 + hd + g), 2, s,
                         nkv * g, nkv, hd)

    @jax.jit
    def fwd_vjp(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: attention_seq(
            a, b, c, nkv, causal=True), q_, k_, v_)
        return out, vjp(do_)
    out, want = fwd_vjp(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_prefill_fwd(tq, tk, tv)
    assert_close(o, out)
    assert lse.shape == (2, nkv * g, s) and lse.dtype == torch.float32
    got = ref.flash_prefill_bwd(tq, tk, tv, o, lse, tdo)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        assert_close(a, w, ctx=name)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("s,sk", [(1, 16), (17, 16), (64, 100), (100, 33),
                                  (48, 48)])
def test_plain_noncausal_backward_matches_jax_vjp(g, s, sk):
    """Non-causal: every key live, sk free (the encoder's s == sk and
    cross-attention's decoder rows against encoder frames)."""
    nkv, hd = 2, 32
    q, k, v, do = _qkvdo(np.random.default_rng(s * 31 + sk + g), 2, s,
                         nkv * g, nkv, hd, sk=sk)

    @jax.jit
    def fwd_vjp(q_, k_, v_, do_):
        out, vjp = jax.vjp(lambda a, b, c: attention_seq(
            a, b, c, nkv, causal=False), q_, k_, v_)
        return out, vjp(do_)
    out, want = fwd_vjp(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = ref.flash_prefill_fwd(tq, tk, tv, causal=False)
    assert_close(o, out)
    assert lse.shape == (2, nkv * g, s) and lse.dtype == torch.float32
    got = ref.flash_prefill_bwd(tq, tk, tv, o, lse, tdo, causal=False)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape
        assert_close(a, w, ctx=name)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_autograd_of_plain_forward(causal):
    q, k, v, do = map(torch.from_numpy, _qkvdo(
        np.random.default_rng(3), 2, 37, 8, 2, 32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_prefill(*leaves, causal=causal),
                               leaves, do)
    o, lse = ref.flash_prefill_fwd(q, k, v, causal=causal)
    got = ref.flash_prefill_bwd(q, k, v, o, lse, do, causal=causal)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", [(1, 5, 2, 1, 8), (2, 7, 4, 2, 8)])
def test_flash_prefill_fn_gradcheck_f64(shape):
    b, s, nq, nkv, hd = shape
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _qkvdo(
        np.random.default_rng(5), b, s, nq, nkv, hd, np.float64))
    assert torch.autograd.gradcheck(ops.FlashPrefillFn.apply, (q, k, v))


@pytest.mark.parametrize("shape", [(1, 5, 9, 2, 1, 8), (2, 7, 3, 4, 2, 8),
                                   (1, 6, 6, 4, 4, 8)])
def test_flash_prefill_fn_gradcheck_noncausal_f64(shape):
    b, s, sk, nq, nkv, hd = shape
    q, k, v, _ = (torch.from_numpy(x).requires_grad_() for x in _qkvdo(
        np.random.default_rng(6), b, s, nq, nkv, hd, np.float64, sk=sk))
    assert torch.autograd.gradcheck(
        lambda a, b_, c: ops.FlashPrefillFn.apply(a, b_, c, False),
        (q, k, v))


def test_ops_flash_prefill_is_differentiable_and_unchanged_without_grad():
    """Under grad, ops.flash_prefill goes through FlashPrefillFn and its
    gradients are the plain forward's; without grad (serving) it returns
    the plain forward's output and records nothing."""
    q, k, v, do = map(torch.from_numpy, _qkvdo(
        np.random.default_rng(9), 2, 20, 4, 2, 32))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_prefill(*leaves)
    assert out.grad_fn is not None \
        and "FlashPrefillFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_prefill(*plain), plain, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        served = ops.flash_prefill(*leaves)
    assert served.grad_fn is None
    assert torch.equal(served, ref.flash_prefill(q, k, v))


@pytest.mark.parametrize("sk", [6, 11])
def test_noncausal_gradient_runs_and_equals_plain(sk):
    """Under grad, ops.flash_prefill(causal=False) goes through
    FlashPrefillFn (sk == s and sk != s) and its gradients are autograd's
    of the plain non-causal forward. A window is ignored there, as in the
    forward (it masks causal attention only)."""
    q, k, v, do = map(torch.from_numpy, _qkvdo(
        np.random.default_rng(sk), 2, 6, 4, 2, 32, sk=sk))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_prefill(*leaves, causal=False, window=3)
    assert "FlashPrefillFn" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, leaves, do)
    plain = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_prefill(*plain, causal=False),
                               plain, do)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mask,kw", [
    ("window", {"window": 3}),
    ("prefix", {"q_offset": 4, "prefix_pad": 4}),
    ("q_valid", {"q_valid": torch.tensor([6, 3], dtype=torch.int32)}),
])
def test_gradient_under_other_masks_raises(mask, kw):
    q, k, v, _ = map(torch.from_numpy, _qkvdo(
        np.random.default_rng(1), 2, 6, 4, 2, 32))
    if "prefix_pad" in kw:
        k, v = (torch.cat([x, x[:, :4]], dim=1) for x in (k, v))
    q.requires_grad_()
    with pytest.raises(NotImplementedError, match=mask.replace("-", ".")):
        ops.flash_prefill(q, k, v, **kw)
    with torch.no_grad():           # serving the same mask is fine
        ops.flash_prefill(q, k, v, **kw)
