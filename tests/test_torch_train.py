"""The port's training path against the JAX package's on the CPU, with
identical weights and SyntheticLM batches: ``forward_train``'s loss and
every gradient leaf against ``jax.value_and_grad`` (remat on and off),
``chunked_loss`` over several chunks, ``make_train_step`` (one and two
microbatches) and ``adamw_update``. On the CPU attention's gradient is
the plain FlashAttention-2 backward (``FlashPrefillFn``).

Tolerances: F32_TOL (1e-4) on losses and norms; each gradient leaf
within 1e-4 x the largest entry of JAX's leaf (torch and XLA sum
in other orders, and a gradient sums over every token); the optimizer
1e-6 on identical inputs; 3-step losses 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLM
from repro.models import modeling as jm
from repro.models.steps import make_train_step as jax_train_step
from repro.training import optimizer as jopt
from repro_torch.models import modeling as tm
from repro_torch.models.params import (_leaf_paths, tree_leaves, tree_map,
                                       tree_unflatten)
from repro_torch.models.steps import make_train_step
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from torch_parity import assert_close, both_params, moe_sorted

ARCHS = ["granite-3-8b", "minicpm-2b", "qwen2-moe-a2.7b", "mamba2-2.7b"]
SORTED = "qwen2-moe-a2.7b:sorted"   # with dispatch="sorted"
B, S = 2, 64


def _batches(cfg, n=1):
    data = SyntheticLM(cfg.vocab_size, S, B, seed=1)
    return [data.batch(i) for i in range(n)]


def _fresh(tree):
    """A private copy of the port's params (steps train in place)."""
    return tree_map(lambda x: x.detach().clone(), tree)


def _assert_leaves_close(got_tree, want_leaves, ctx):
    """Leaf by leaf (JAX's flattening order): |got - want| <= 1e-4 x
    max |want| (floored at 1e-30)."""
    paths = list(_leaf_paths(got_tree))
    assert len(paths) == len(want_leaves), ctx
    for (path, got), want in zip(paths, want_leaves):
        want = np.asarray(want, np.float32)
        tol = 1e-4 * max(1e-30, float(np.abs(want).max()))
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=tol,
                                   err_msg=f"{ctx} {'/'.join(path)}")


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_loss_and_grads_match_jax(arch, remat):
    cfg, jp, pcfg, tp = both_params(arch)
    (np_batch,) = _batches(cfg)
    jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
    (jloss, jmetrics), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.forward_train(cfg, p, jb, remat=remat),
        has_aux=True))(jp)

    params = tree_map(lambda x: x.requires_grad_(), _fresh(tp))
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    loss, metrics = tm.forward_train(pcfg, params, batch, remat=remat)
    grads = tree_unflatten(params, torch.autograd.grad(
        loss, tree_leaves(params)))
    assert_close(loss, jloss, ctx="loss")
    for k in ("lm_loss", "aux_loss"):
        assert_close(metrics[k], jmetrics[k], ctx=k)
    _assert_leaves_close(grads, jax.tree.leaves(jgrads), f"{arch} grad")
    if not cfg.attn_free:
        # attention's projections get their gradient through the backward
        sub = grads["blocks"]["sub0"]
        for w in ("wq", "wk", "wv"):
            assert sub[w].abs().max() > 0, w


@pytest.mark.parametrize("arch", ["granite-3-8b", "minicpm-2b"])
def test_chunked_loss_matches_jax(arch):
    """Four 16-row chunks (forward_train's 512-row chunks need s > 512):
    the loss and its gradients in h and in the output embedding (tied
    for minicpm, a separate lm_head for granite)."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(2)
    h = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    wkey = "embed" if cfg.tie_embeddings else "lm_head"

    def jloss(h_, w_):
        return jm.chunked_loss(cfg, dict(jp, **{wkey: w_}), h_,
                               jnp.asarray(labels), chunk=16)
    want, (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(h), jp[wkey])
    th = torch.from_numpy(h).requires_grad_()
    tw = tp[wkey].detach().clone().requires_grad_()
    got = tm.chunked_loss(pcfg, dict(tp, **{wkey: tw}), th,
                          torch.from_numpy(labels), chunk=16)
    dh, dw = torch.autograd.grad(got, (th, tw))
    assert_close(got, want)
    _assert_leaves_close({"h": dh, "w": dw}, [jdh, jdw], arch)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS + [SORTED])
def test_train_step_matches_jax(arch, microbatches):
    """Three steps of ``make_train_step`` against JAX's from the same
    params and batches (SORTED: qwen2-moe with dispatch="sorted", its
    experts through the grouped product's ``GroupedMMFn`` under AdamW, as
    chip_smoke.py phase 16 trains it). The first step's gradients are
    read from the first moment (after step 1, mu = (1 - b1) * clip scale
    * g) and held leaf by leaf; metrics within F32_TOL; the three losses
    within 1e-3.
    The params after a step are NOT compared: on step 1 the update is
    m^ / (sqrt(v^) + eps) ~ sign(g), so an entry whose gradient is near 0
    can take either sign in the two frameworks and move by a whole lr."""
    cfg, jp, pcfg, tp = both_params(arch.split(":")[0])
    if arch == SORTED:
        cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    opt = AdamWConfig()
    batches = _batches(cfg, 3)
    jstep = jax.jit(jax_train_step(cfg, jopt.AdamWConfig(),
                                   microbatches=microbatches))
    step = make_train_step(pcfg, opt, microbatches=microbatches)
    jstate, params = jopt.adamw_init(jp), _fresh(tp)
    state = adamw_init(params)
    jparams, losses, jlosses = jp, [], []
    for i, nb in enumerate(batches):
        jparams, jstate, jmetrics = jstep(
            jparams, jstate, {k: jnp.asarray(v) for k, v in nb.items()})
        params, state, metrics = step(
            params, state, {k: torch.from_numpy(v) for k, v in nb.items()})
        if i == 0:
            for k in ("loss", "lm_loss", "aux_loss", "grad_norm"):
                assert_close(metrics[k], jmetrics[k], ctx=k)
            _assert_leaves_close(
                tree_map(lambda m: m / (1 - opt.b1), state["mu"]),
                [np.asarray(m) / (1 - opt.b1)
                 for m in jax.tree.leaves(jstate["mu"])], f"{arch} g")
        losses.append(float(metrics["loss"]))
        jlosses.append(float(jmetrics["loss"]))
    assert int(state["step"]) == int(jstate["step"]) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("fresh", [True, False])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])
def test_adamw_update_matches_jax(fresh, grad_scale):
    """One update on identical numpy params, grads and state (fresh from
    adamw_init, or at step 3 with random moments), with the global-norm
    clip inactive (0.01) and active (10.0)."""
    rng = np.random.default_rng(4)
    shapes = {"a": {"w": (3, 5), "b": (5,)}, "c": (2, 2, 3)}

    def rand(f):
        return {"a": {k: f(s).astype(np.float32)
                      for k, s in shapes["a"].items()},
                "c": f(shapes["c"]).astype(np.float32)}
    p = rand(lambda s: rng.normal(size=s))
    g = rand(lambda s: rng.normal(size=s) * grad_scale)
    cfg = AdamWConfig(lr=1e-2)
    if fresh:
        mu = rand(np.zeros)
        nu = rand(np.zeros)
        step = 0
    else:
        mu = rand(lambda s: rng.normal(size=s) * 0.01)
        nu = rand(lambda s: np.abs(rng.normal(size=s)) * 1e-3)
        step = 3
    jst = {"mu": jax.tree.map(jnp.asarray, mu),
           "nu": jax.tree.map(jnp.asarray, nu),
           "step": jnp.asarray(step, jnp.int32)}
    jp, jst, jn = jopt.adamw_update(jax.tree.map(jnp.asarray, p),
                                    jax.tree.map(jnp.asarray, g), jst,
                                    jopt.AdamWConfig(lr=1e-2))
    tt = lambda tree: tree_map(torch.from_numpy, tree)   # noqa: E731
    st = {"mu": tt(mu), "nu": tt(nu),
          "step": torch.tensor(step, dtype=torch.int32)}
    if fresh:
        zero = adamw_init(tt(p))
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(zero["mu"]) + tree_leaves(zero["nu"]),
            tree_leaves(st["mu"]) + tree_leaves(st["nu"])))
    tp_, st, n = adamw_update(tt(p), tt(g), st, cfg)
    np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
    assert int(st["step"]) == int(jst["step"]) == step + 1
    for got, want in ((tp_, jp), (st["mu"], jst["mu"]),
                      (st["nu"], jst["nu"])):
        for a, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w),
                                       rtol=1e-6, atol=1e-6)
