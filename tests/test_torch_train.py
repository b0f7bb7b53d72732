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

# every family the JAX package trains, reduced
ARCHS = ["granite-3-8b", "minicpm-2b", "qwen2-moe-a2.7b", "mamba2-2.7b",
         "deepseek-moe-16b", "jamba-1.5-large-398b", "mistral-nemo-12b",
         "pangu-38b", "qwen1.5-110b", "whisper-base", "pixtral-12b"]
SORTED = "qwen2-moe-a2.7b:sorted"   # with dispatch="sorted"
B, S = 2, 64


def _batches(cfg, n=1):
    """SyntheticLM batches; whisper also gets seeded stub ``frames`` (b,
    encoder_seq, d) and pixtral seeded ``embeds`` (b, s, d) in place of
    its tokens (the VLM stub frontend), each at scale 0.1 as JAX's
    smoke tests make them."""
    data = SyntheticLM(cfg.vocab_size, S, B, seed=1)
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        nb = data.batch(i)
        if cfg.frontend == "vision":
            nb = {"embeds": (rng.normal(size=(B, S, cfg.d_model)) * 0.1
                             ).astype(np.float32), "labels": nb["labels"]}
        if cfg.is_encoder_decoder:
            nb["frames"] = (rng.normal(size=(B, cfg.encoder_seq,
                                             cfg.d_model)) * 0.1
                            ).astype(np.float32)
        out.append(nb)
    return out


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
    # pixtral's embed table is not reached when the batch brings embeds:
    # no gradient, where jax.grad gives exact zeros
    leaves = tree_leaves(params)
    grads = tree_unflatten(params, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    assert_close(loss, jloss, ctx="loss")
    for k in ("lm_loss", "aux_loss"):
        assert_close(metrics[k], jmetrics[k], ctx=k)
    _assert_leaves_close(grads, jax.tree.leaves(jgrads), f"{arch} grad")
    # attention's projections get their gradient through the backward:
    # the causal mode in each attention sublayer, the non-causal one in
    # whisper's encoder (and so pos_embed, which only the encoder reads)
    # and its cross-attention (wkx, wvx read the encoder's output)
    reached = [(f"blocks/{n}/{w}", sub[w])
               for n, sub in grads["blocks"].items() if "wq" in sub
               for w in ("wq", "wk", "wv", "wkx", "wvx") if w in sub]
    if cfg.is_encoder_decoder:
        enc = grads["encoder"]
        reached += [("encoder/pos_embed", enc["pos_embed"])] + [
            (f"encoder/{w}", enc["blocks"]["sub0"][w])
            for w in ("wq", "wk", "wv")]
    assert bool(reached) != cfg.attn_free, arch
    for name, g in reached:
        assert g.abs().max() > 0, name


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
@pytest.mark.parametrize("arch", ARCHS[:4] + ["whisper-base", "pixtral-12b",
                                              SORTED])
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


@pytest.mark.parametrize("arch", ["whisper-base", "pixtral-12b"])
def test_one_train_step_matches_jax_leaf_by_leaf(arch):
    """One ``make_train_step`` step against JAX's on whisper (frames) and
    pixtral (embeds, so the embed table is not reached): every leaf's
    gradient (from the first moment) and second moment against JAX's. A
    leaf with an exactly zero gradient in JAX (pixtral's embed) has
    exactly zero moments in the port too, and its update is the weight
    decay alone: p (1 - lr wd), equal to JAX's new leaf within 1e-6."""
    cfg, jp, pcfg, tp = both_params(arch)
    opt = AdamWConfig()
    (nb,) = _batches(cfg)
    jparams, jstate, jmetrics = jax.jit(jax_train_step(
        cfg, jopt.AdamWConfig()))(jp, jopt.adamw_init(jp),
                                  {k: jnp.asarray(v) for k, v in nb.items()})
    params, state, metrics = make_train_step(pcfg, opt)(
        _fresh(tp), adamw_init(tp),
        {k: torch.from_numpy(v) for k, v in nb.items()})
    for k in ("loss", "lm_loss", "aux_loss", "grad_norm"):
        assert_close(metrics[k], jmetrics[k], ctx=k)
    for key in ("mu", "nu"):
        _assert_leaves_close(state[key], jax.tree.leaves(jstate[key]),
                             f"{arch} {key}")
    unreached = 0
    for (path, p0), p1, mu, nu, jmu, jnew in zip(
            _leaf_paths(tp), tree_leaves(params), tree_leaves(state["mu"]),
            tree_leaves(state["nu"]), jax.tree.leaves(jstate["mu"]),
            jax.tree.leaves(jparams)):
        if np.any(np.asarray(jmu)):
            continue
        unreached += 1
        assert not mu.any() and not nu.any(), path
        decayed = p0 * (1 - opt.lr * opt.weight_decay)
        np.testing.assert_allclose(p1.detach().numpy(), decayed.numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(p1.detach().numpy(), np.asarray(jnew),
                                   rtol=1e-6, atol=1e-6)
    # pixtral's embed is the one leaf its embeds batch does not reach
    assert unreached == (cfg.frontend == "vision"), (arch, unreached)


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
