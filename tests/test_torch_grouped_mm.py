"""The grouped matrix product of sorted MoE dispatch (``kernels.ops.
grouped_mm``, the port's ``lax.ragged_dot``) against the JAX package's,
on the CPU, where it takes its plain version (``ref.grouped_mm``); the
CUDA kernel is held to that plain version on the card
(``tests/test_torch_cuda.py``, chip_smoke.py phase 2).

* the product against ``jax.lax.ragged_dot`` on seeded inputs: 1e-5 in
  f32 (one short sum per entry, ordered differently), BF16_TOL in bf16
  (both round the f32 sum to bf16), over empty groups, every row in one
  group, the first and last expert only, rows past the last group, and
  M = 0;
* its input and weight gradients (``GroupedMMFn``'s backward) against
  ``jax.vjp`` of ``ragged_dot``, within 1e-4 of each gradient's largest
  entry;
* the group offsets the dispatch builds on the device, equal (``==``)
  to ``jnp.bincount``'s cumsum, and its order to ``jnp.argsort``'s;
* ``forward_train`` with ``dispatch="sorted"`` on reduced qwen2-moe:
  the loss within F32_TOL and every gradient leaf within 1e-4 of the
  largest entry of JAX's leaf (``jax.value_and_grad``);
* the kernel's launch plan (``kernels.grouped_mm.plan``: path, K-splits,
  tile width, scratch) and the weight gradient's (``plan_dw``: path,
  slab) a function of the shapes and dtype alone, within the limits the
  C entry checks.
"""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM
from repro.models import modeling as jm
from repro_torch.kernels import grouped_mm as gmk
from repro_torch.kernels import ops
from repro_torch.models import modeling as tm
from repro_torch.models.params import (_leaf_paths, tree_leaves, tree_map,
                                       tree_unflatten)
from torch_parity import BF16_TOL, assert_close, both_params, moe_sorted

E, K, N = 5, 24, 20
# group sizes: empty groups, one group holding every row, the first and
# the last expert only, rows past the last group (zeros), no row at all
SIZES = {"empty_groups": ([3, 0, 5, 0, 2], 10),
         "one_group": ([0, 0, 10, 0, 0], 10),
         "first_and_last": ([4, 0, 0, 0, 6], 10),
         "rows_past_groups": ([2, 1, 0, 0, 3], 8),
         "no_rows": ([0, 0, 0, 0, 0], 0)}
DTYPES = {"f32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}


def _inputs(sizes, M, seed, trans=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = (rng.normal(size=(E, N, K) if trans else (E, K, N))
         / np.sqrt(K)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return x, w, offsets


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SIZES)
def test_grouped_mm_matches_ragged_dot(case, dtype):
    sizes, M = SIZES[case]
    tdt, jdt, tol = DTYPES[dtype]
    x, w, offsets = _inputs(sizes, M, seed=len(case))
    want = jax.lax.ragged_dot(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                              jnp.asarray(sizes, jnp.int32))
    got = ops.grouped_mm(torch.from_numpy(x).to(tdt),
                         torch.from_numpy(w).to(tdt),
                         torch.from_numpy(offsets))
    assert got.dtype == tdt and tuple(got.shape) == (M, N)
    assert_close(got, want, tol=tol)
    past = int(offsets[-1])
    assert int(torch.count_nonzero(got[past:])) == 0


@pytest.mark.parametrize("case", SIZES)
def test_grouped_mm_grads_match_jax_vjp(case):
    sizes, M = SIZES[case]
    x, w, offsets = _inputs(sizes, M, seed=11 + len(case))
    dy = np.random.default_rng(3).normal(size=(M, N)).astype(np.float32)
    gs = jnp.asarray(sizes, jnp.int32)
    _, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, gs),
                     jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = ops.grouped_mm(tx, tw, torch.from_numpy(offsets))
    assert y.grad_fn is not None and "GroupedMMFn" in type(y.grad_fn).__name__
    dx, dw = torch.autograd.grad(y, (tx, tw), torch.from_numpy(dy))
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want, np.float32)
        tol = 1e-4 * max(1e-30, float(np.abs(want).max(initial=0.0)))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # an empty group's weight gradient is exactly zero
    for e, n in enumerate(sizes):
        if n == 0:
            assert int(torch.count_nonzero(dw[e])) == 0


def test_grouped_mm_transposed_is_the_input_gradient_product():
    """The transposed form (w (E, N, K), x[r] @ w[e]^T) equals ragged_dot
    against the transposed weights."""
    sizes, M = SIZES["empty_groups"]
    x, w, offsets = _inputs(sizes, M, seed=5, trans=True)
    want = jax.lax.ragged_dot(jnp.asarray(x),
                              jnp.asarray(w).transpose(0, 2, 1),
                              jnp.asarray(sizes, jnp.int32))
    got = ops._grouped(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(offsets), trans=True)
    assert_close(got, want, tol=1e-5)


@pytest.mark.parametrize("T,k,E_,seed", [(8, 4, 60, 0), (40, 2, 4, 1),
                                         (1, 1, 3, 2), (16, 6, 64, 3)])
def test_group_offsets_equal_bincount_cumsum(T, k, E_, seed):
    rng = np.random.default_rng(seed)
    flat = rng.integers(0, E_, T * k).astype(np.int64)
    order, offsets = tm._group_offsets(torch.from_numpy(flat), E_)
    want = np.concatenate([[0], np.cumsum(np.asarray(
        jnp.bincount(jnp.asarray(flat), length=E_)))])
    assert offsets.dtype == torch.int32
    assert offsets.tolist() == want.tolist()
    assert order.tolist() == np.asarray(jnp.argsort(jnp.asarray(flat),
                                                    stable=True)).tolist()


def test_forward_train_sorted_matches_jax():
    """Training through the sorted dispatch: loss and every gradient leaf
    against jax.value_and_grad, reduced qwen2-moe, remat off."""
    cfg, jp, pcfg, tp = both_params("qwen2-moe-a2.7b")
    cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    np_batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1).batch(0)
    jb = {k_: jnp.asarray(v) for k_, v in np_batch.items()}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.forward_train(cfg, p, jb, remat=False),
        has_aux=True))(jp)
    params = tree_map(lambda t: t.detach().clone().requires_grad_(), tp)
    batch = {k_: torch.from_numpy(v) for k_, v in np_batch.items()}
    loss, _ = tm.forward_train(pcfg, params, batch, remat=False)
    grads = tree_unflatten(params, torch.autograd.grad(
        loss, tree_leaves(params)))
    assert_close(loss, jloss, ctx="loss")
    paths = list(_leaf_paths(grads))
    want_leaves = jax.tree.leaves(jgrads)
    assert len(paths) == len(want_leaves)
    for (path, got), want in zip(paths, want_leaves):
        want = np.asarray(want, np.float32)
        tol = 1e-4 * max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol,
                                   err_msg="/".join(path))
    moe = grads["blocks"]["sub0"]["moe"]
    assert all(moe[w].abs().max() > 0 for w in ("w_gate", "w_up", "w_down"))


# (M, K, N, E) of grouped calls: qwen2-moe's decode step (gate/up, down),
# its speculative step (8 slots x 5 tokens), a prefill chunk, M on both
# sides of the rows/tiles threshold, deepseek-moe's and jamba's decode,
# one row, K = 0, and the card tests' shapes
PLAN_SHAPES = [(32, 2048, 1408, 60), (32, 1408, 2048, 60),
               (160, 2048, 1408, 60), (8192, 2048, 1408, 60),
               (959, 2048, 1408, 60), (960, 2048, 1408, 60),
               (48, 2048, 1408, 64), (16, 8192, 24576, 16),
               (16, 24576, 8192, 16), (1, 64, 72, 60), (12, 0, 72, 60),
               (37, 256, 192, 60), (127, 256, 192, 8), (50, 100, 36, 6)]


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,E", PLAN_SHAPES)
def test_grouped_plan_is_a_function_of_the_shapes(M, K, N, E, dtype, trans):
    """The plan takes no offsets (the group sizes stay on the card), is
    the same on every call, and stays within what
    ``csrc/grouped_mm.cu:grouped_mm`` accepts: K-ranges of a multiple of
    8 covering K with no empty split, a pass's x rows within the staging
    buffer, grid dims within 65535, the forward's fixed tile width; no
    scratch for TRANS with one K-range."""
    tdt = DTYPES[dtype][0]
    assert list(inspect.signature(gmk.plan).parameters) == [
        "M", "K", "N", "E", "dtype", "trans"]
    p = gmk.plan(M, K, N, E, tdt, trans)
    assert p == gmk.plan(M, K, N, E, tdt, trans)
    assert p.path == (0 if M < gmk.ROWS_MEAN * E else 1)
    if p.path == 1:
        assert p.scratch(M, N) == 0
        return
    assert p.kc % 8 == 0 and p.kc >= 8
    assert p.splits * p.kc >= K and (K == 0 or (p.splits - 1) * p.kc < K)
    xsize = torch.empty((), dtype=tdt).element_size() if trans else 4
    assert gmk.ROW_CHUNK[trans] * p.kc * xsize <= gmk.X_BYTES[trans]
    assert 1 <= p.splits <= 65535 and -(-N // p.nt) <= 65535
    assert trans or p.nt == gmk.FWD_COLS
    direct = trans and p.splits == 1
    assert p.scratch(M, N) == (0 if direct else p.splits * M * N)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,E", PLAN_SHAPES)
def test_grouped_dw_plan_is_a_function_of_the_shapes(M, K, N, E, dtype):
    """The weight gradient's plan takes no offsets, is the same on every
    call, takes the rows path exactly while M < ROWS_MEAN * E (the
    forward's threshold), and stays within what
    ``csrc/grouped_mm.cu:grouped_mm_dw`` accepts: slabs of a multiple of
    4 dw rows, at most DW_MAX_KC, CTAs of a multiple of 32 threads, at
    most DW_CHUNK, every grid dimension within 65535 (the tensor cores'
    tile list within int32)."""
    tdt = DTYPES[dtype][0]
    assert list(inspect.signature(gmk.plan_dw).parameters) == [
        "M", "K", "N", "E", "dtype"]
    p = gmk.plan_dw(M, K, N, E, tdt)
    assert p == gmk.plan_dw(M, K, N, E, tdt)
    assert p.path == (0 if M < gmk.ROWS_MEAN * E else 1)
    assert E <= 65535
    if p.path == 0:
        # grid (ceil(P / threads), ceil(K / kc), E), P the 16-byte pieces
        # of a dw row, one a thread
        pieces = -(-N // (16 // torch.empty((), dtype=tdt).element_size()))
        assert p.kc % 4 == 0 and 4 <= p.kc <= gmk.DW_MAX_KC
        assert p.threads % 32 == 0 and 32 <= p.threads <= gmk.DW_CHUNK
        assert p.threads < pieces + 32    # no warp without a piece
        assert -(-pieces // p.threads) <= 65535
        assert -(-K // p.kc) <= 65535
        return
    # the CUDA cores' grid (ceil(N / 128), ceil(K / 128), E); the tensor
    # cores' tile list (E x 128-row x 256-column tiles) an int32
    assert -(-K // 128) <= 65535
    assert E * -(-K // 128) * -(-N // 256) < 2 ** 31


def test_grouped_plan_fills_the_card_at_decode():
    """At qwen2-moe's decode shapes (M = 32 of 60 experts) the rows path
    gives the experts that can hold a row (min(E, M) = 32) between a
    third of and twice CTA_TARGET CTAs with work, in f32 and bf16,
    forward and TRANS; TRANS reads whole rows (no K-split, no scratch)."""
    for dt in (torch.float32, torch.bfloat16):
        for K, N in ((2048, 1408), (1408, 2048)):
            for trans in (False, True):
                p = gmk.plan(32, K, N, 60, dt, trans)
                ctas = 32 * p.splits * -(-N // p.nt)
                assert p.path == 0
                target = gmk.CTA_TARGET
                assert target // 3 <= ctas <= 2 * target, \
                    (dt, K, N, trans, p, ctas)
                assert not trans or (p.splits == 1 and p.scratch(32, N) == 0)
