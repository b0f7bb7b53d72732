"""The graphed prefill (``PrefillEngine._prefill``), against the JAX
package's shared jitted prefill, on the CPU.

On the card every prefill forward is one CUDA graph per JAX jit key; here
it runs eagerly over the same static inputs (the prefix length a 0-d
int32 tensor), and:

* ``step_graph.prefill_compile_count()`` moves as JAX's
  ``prefill_compile_count()`` does on the same traffic, in the four
  scenarios JAX pins (a ragged wave and a second wave in its buckets;
  six warm suffixes in two (prefix bucket, suffix bucket) pairs; 24
  ragged lengths in batches of 4; a warm snapshot restore). Both counts
  are process wide, so every scenario runs on its own renamed config:
  no earlier test in the worker has seen its keys on either side;
* ``forward_prefill`` with a tensor ``prefix_len`` equals the int form
  bit for bit, and an engine with ``jit_prefill=False`` equals the
  graphed one bit for bit;
* the plain flash prefill takes ``q_offset`` as a tensor, bit for bit
  the int form, and holds JAX's Pallas kernel in interpret mode;
* the prefill forward with a tensor prefix length runs on ``meta`` under
  ``launch.cost.count``, where a host read of a tensor raises: the path a
  graph captures reads nothing on the host.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill_pallas
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.engine import prefill_compile_count as jax_count
from repro_torch.kernels import ref
from repro_torch.launch.cost import count
from repro_torch.models.caches import SSM_LEAVES
from repro_torch.models.modeling import forward_prefill
from repro_torch.models.params import (abstract_params, block_period,
                                       num_blocks, tree_map)
from repro_torch.serving import step_graph
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.engine import PrefillEngine
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import both_params, moe_sorted, np32, prompts

_tag = itertools.count()


def _renamed(arch, sorted_moe=False):
    """(jax_cfg, jax_params, port_cfg, port_params) of a reduced arch
    under a config name no other test uses, so both packages start this
    test with no key of it."""
    cfg, jp, pcfg, tp = both_params(arch)
    if sorted_moe:
        cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    name = f"{cfg.name}#prefill-graph-{next(_tag)}"
    return cfg.replace(name=name), jp, pcfg.replace(name=name), tp


def _counted(side, fn):
    """(fn()'s value, the side's prefill compile-count delta over it)."""
    cnt = jax_count if side == "jax" else step_graph.prefill_compile_count
    c0 = cnt()
    out = fn()
    return out, cnt() - c0


def _engine(side, cfg, params, **kw):
    return (JaxPrefill if side == "jax" else PrefillEngine)(cfg, params,
                                                           **kw)


def _firsts(outs):
    return [o.first_token for o in outs]


def _pkv(side, out, plen):
    if out.k is None:
        return None
    if side == "jax":
        return jnp.concatenate([out.k[:, :plen], out.v[:, :plen]], axis=-1)
    return torch.cat([out.k[:, :plen], out.v[:, :plen]], dim=-1)


# ------------------------------------------------------- compile counts

@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b", "whisper-base"])
def test_ragged_waves_count_as_jax(arch):
    """tests/test_bucketed_prefill.py's ragged leg: exact-length and
    bucketed engines over ragged prompts, then a second wave of new
    lengths in the same bucket, which adds no key on either side."""
    deltas, firsts = {}, {}
    for side in ("jax", "port"):
        cfg, jp, pcfg, tp = _renamed(arch)
        c, p = (cfg, jp) if side == "jax" else (pcfg, tp)
        rng = np.random.default_rng(9)
        p1 = prompts(c.vocab_size, rng, (5, 13, 8))
        p2 = prompts(c.vocab_size, rng, (7, 12, 6))
        fr = None
        if c.is_encoder_decoder:
            fr = [(rng.normal(size=(c.encoder_seq, c.d_model)) * 0.1
                   ).astype(np.float32) for _ in range(3)]
        exact = _engine(side, c, p, bucket_prefill=False)
        bucketed = _engine(side, c, p)
        o_e, d_e = _counted(side, lambda: exact.run(p1, frames=fr))
        o_b, d_b = _counted(side, lambda: bucketed.run(p1, frames=fr))
        o_w, d_w = _counted(side, lambda: bucketed.run(p2, frames=fr))
        deltas[side] = (d_e, d_b, d_w)
        firsts[side] = (_firsts(o_e), _firsts(o_b), _firsts(o_w))
        assert bucketed.bucket_hits >= 1
    assert deltas["port"] == deltas["jax"], deltas
    assert deltas["port"][2] == 0 and deltas["port"][1] == 1, deltas
    assert firsts["port"] == firsts["jax"]


def test_suffix_keys_bounded_by_bucket_pairs_as_jax():
    """tests/test_bucketed_prefill.py's six (prefix, suffix) cases: the
    prefix KV padded to its bucket and the real length a device scalar,
    so the keys are the (prefix bucket, suffix bucket) pairs."""
    cases = [(17, 5), (20, 9), (25, 3), (31, 6), (16, 5), (9, 4)]
    deltas, firsts = {}, {}
    for side in ("jax", "port"):
        cfg, jp, pcfg, tp = _renamed("granite-3-8b")
        c, p = (cfg, jp) if side == "jax" else (pcfg, tp)
        pe = _engine(side, c, p)
        long = prompts(c.vocab_size, np.random.default_rng(13), (40,))[0]
        cold, = pe.run([long])

        def warm():
            return [pe.run_suffix(long[a:a + n], _pkv(side, cold, a))
                    .first_token for a, n in cases]
        firsts[side], deltas[side] = _counted(side, warm)
        pairs = {(pe._bucket_len(a), pe._bucket_len(n)) for a, n in cases}
    assert deltas["port"] == deltas["jax"] == len(pairs) == 2, deltas
    assert firsts["port"] == firsts["jax"]
    want = PrefillEngine(pcfg, tp, bucket_prefill=False,
                         jit_prefill=False).run([long[:17 + 5]])[0]
    assert firsts["port"][0] == want.first_token


def test_ragged_batches_count_as_jax():
    """tests/test_fused_decode.py's 24 ragged lengths in batches of 4:
    keys per (batch, bucket) shape, fewer than the lengths."""
    deltas, firsts = {}, {}
    for side in ("jax", "port"):
        cfg, jp, pcfg, tp = _renamed("granite-3-8b")
        c, p = (cfg, jp) if side == "jax" else (pcfg, tp)
        pe = _engine(side, c, p)
        rng = np.random.default_rng(2)
        lengths = list(range(5, 29))
        rng.shuffle(lengths)
        batches = [[list(map(int, rng.integers(0, c.vocab_size, n)))
                    for n in lengths[i:i + 4]]
                   for i in range(0, len(lengths), 4)]
        firsts[side], deltas[side] = _counted(
            side, lambda: [_firsts(pe.run(b)) for b in batches])
    assert deltas["port"] == deltas["jax"], deltas
    assert deltas["port"] < len(set(lengths))
    assert firsts["port"] == firsts["jax"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "jamba-1.5-large-398b"])
def test_warm_snapshot_suffix_adds_no_key_as_jax(arch):
    """tests/test_state_snapshot_reuse.py's second wave of warm restores:
    the same (prefix, suffix bucket, stride) shapes with other tokens and
    another boundary state add no key."""
    deltas, states = {}, {}
    for side in ("jax", "port"):
        cfg, jp, pcfg, tp = _renamed(arch)
        c, p = (cfg, jp) if side == "jax" else (pcfg, tp)
        pe = _engine(side, c, p)
        stride = pe.prefix_align
        rng = np.random.default_rng(31)
        p1, p2 = prompts(c.vocab_size, rng, (stride + 6, stride + 6))

        def warm(cold, pr):
            return pe.run_suffix(pr[stride:], _pkv(side, cold, stride),
                                 state=cold.snapshots[stride],
                                 prefix_len=stride, snap_stride=stride)
        (cold1, cold2), d_cold = _counted(side, lambda: (
            pe.run([p1], snap_stride=stride)[0],
            pe.run([p2], snap_stride=stride)[0]))
        _, d_w1 = _counted(side, lambda: warm(cold1, p1))
        hits = pe.bucket_hits
        w2, d_w2 = _counted(side, lambda: warm(cold2, p2))
        assert pe.bucket_hits == hits + 1
        assert w2.first_token == cold2.first_token
        deltas[side] = (d_cold, d_w1, d_w2)
        states[side] = w2
    assert deltas["port"] == deltas["jax"], deltas
    assert deltas["port"][2] == 0
    j, t = states["jax"], states["port"]
    for key in j.mamba_state:
        for leaf in SSM_LEAVES:
            np.testing.assert_allclose(np32(t.mamba_state[key][leaf]),
                                       np32(j.mamba_state[key][leaf]),
                                       rtol=1e-4, atol=1e-4)


def test_transfer_stats_reports_the_compile_count():
    """tests/test_bucketed_prefill.py's telemetry check, on the port."""
    _, _, pcfg, tp = _renamed("granite-3-8b")
    fe = ClusterFrontend(pcfg, params=tp, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [ServeRequest(rid=i, tokens=t, max_new_tokens=2)
            for i, t in enumerate(prompts(pcfg.vocab_size, rng, (9, 21)))]
    fe.run(reqs)
    ts = fe.groups["default"].transfer_stats()
    assert ts["prefill_compile_count"] >= 1.0
    assert ts["prefill_compile_count"] \
        == float(step_graph.prefill_compile_count())


# ------------------------------------------------ the tensor prefix length

def _prefix_inputs(pcfg, tp, b, s, P, rng, with_ssm):
    """A batch of b right-padded rows, a random prefix KV of P rows for
    every attention sub, and (with_ssm) hand-off states of a cold
    forward as the SSM restore."""
    kinds = pcfg.layer_kinds()[:block_period(pcfg)]
    nblk = num_blocks(pcfg)
    toks = torch.from_numpy(rng.integers(0, pcfg.vocab_size, (b, s))
                            .astype(np.int32))
    last = torch.tensor([s - 1 - 3 * i for i in range(b)],
                        dtype=torch.int32)
    prefix = {}
    for i, kd in enumerate(kinds):
        prefix[f"sub{i}"] = {} if kd != "attn" else {
            n: torch.from_numpy(rng.normal(size=(nblk, b, P, pcfg.kv_dim))
                                .astype(np.float32)) for n in ("k", "v")}
    ssm = None
    if with_ssm:
        _, cache = forward_prefill(pcfg, tp, {"tokens": toks},
                                   last_index=last)
        ssm = {f"sub{i}": ({k: cache["layers"][f"sub{i}"][k]
                            for k in SSM_LEAVES} if kd != "attn" else {})
               for i, kd in enumerate(kinds)}
    return toks, last, prefix, ssm


@pytest.mark.parametrize("arch,sorted_moe", [
    ("granite-3-8b", False), ("qwen2-moe-a2.7b", False),
    ("qwen2-moe-a2.7b", True), ("jamba-1.5-large-398b", False)],
    ids=["granite", "qwen2-moe-capacity", "qwen2-moe-sorted", "jamba"])
def test_tensor_prefix_len_is_bitwise_the_int(arch, sorted_moe):
    """forward_prefill over a padded prefix (P = 32) at prefix lengths 0,
    16 and 29: the 0-d int32 tensor form equals the int form bit for bit
    (first tokens, every cache leaf, pos)."""
    _, _, pcfg, tp = both_params(arch)
    if sorted_moe:
        pcfg = moe_sorted(pcfg)
    rng = np.random.default_rng(17)
    toks, last, prefix, ssm = _prefix_inputs(
        pcfg, tp, 2, 16, 32, rng, "mamba" in pcfg.layer_kinds())
    for plen in (0, 16, 29):
        kw = dict(last_index=last, prefix=prefix, ssm_init=ssm)
        f_i, c_i = forward_prefill(pcfg, tp, {"tokens": toks},
                                   prefix_len=plen, **kw)
        f_t, c_t = forward_prefill(
            pcfg, tp, {"tokens": toks},
            prefix_len=torch.tensor(plen, dtype=torch.int32), **kw)
        assert torch.equal(f_i, f_t), plen
        assert c_t["pos"].dtype == torch.int32 and c_t["pos"].dim() == 0
        assert torch.equal(c_i["pos"], c_t["pos"]), plen
        for sub, leaves in c_i["layers"].items():
            for name, a in leaves.items():
                assert torch.equal(a, c_t["layers"][sub][name]), \
                    (plen, sub, name)


@pytest.mark.parametrize("arch", ["granite-3-8b", "mamba2-2.7b",
                                  "jamba-1.5-large-398b", "whisper-base"])
def test_graphed_engine_is_bitwise_the_eager_one(arch):
    """The graphed engine's _prefill (static inputs, tensor prefix
    length) against jit_prefill=False (the eager forward, int prefix
    length): run, run_suffix and a chunked prefill, bit for bit."""
    _, _, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(23)
    pr = prompts(pcfg.vocab_size, rng, (45, 30))
    fr = None
    if pcfg.is_encoder_decoder:
        fr = [(rng.normal(size=(pcfg.encoder_seq, pcfg.d_model)) * 0.1
               ).astype(np.float32) for _ in range(2)]
    outs = {}
    for jit in (True, False):
        pe = PrefillEngine(pcfg, tp, jit_prefill=jit)
        stride = 32 if pe.requires_state_restore else 0
        cold = pe.run(pr, frames=fr, snap_stride=stride)
        plen = 32 if stride else 20
        kw = dict(state=cold[0].snapshots[plen]) if stride else {}
        warm = pe.run_suffix(pr[0][plen:], _pkv("port", cold[0], plen),
                             frames=fr[0] if fr else None,
                             prefix_len=plen, snap_stride=stride, **kw)
        chunked = pe.run_chunked(pr[0], chunk_tokens=16,
                                 frames=fr[0] if fr else None)
        outs[jit] = cold + [warm, chunked]
    for a, b in zip(outs[True], outs[False]):
        assert a.first_token == b.first_token
        assert a.prompt_len == b.prompt_len
        for x, y in ((a.k, b.k), (a.v, b.v)):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)
        for tree_a, tree_b in ((a.mamba_state, b.mamba_state),
                               (a.cross, b.cross)):
            if tree_a is None:
                assert tree_b is None
                continue
            for key in tree_a:
                xs, ys = tree_a[key], tree_b[key]
                xs = xs if isinstance(xs, tuple) else tuple(
                    xs[k] for k in SSM_LEAVES)
                ys = ys if isinstance(ys, tuple) else tuple(
                    ys[k] for k in SSM_LEAVES)
                assert all(torch.equal(x, y) for x, y in zip(xs, ys))
        assert (a.snapshots or {}).keys() == (b.snapshots or {}).keys()


def test_eager_engine_adds_no_key():
    """jit_prefill=False is the eager baseline: no key, as JAX's unjitted
    forward touches no jit cache."""
    _, _, pcfg, tp = _renamed("granite-3-8b")
    pe = PrefillEngine(pcfg, tp, jit_prefill=False)
    _, d = _counted("port", lambda: pe.run([[1, 2, 3], [4, 5]]))
    assert d == 0 and pe.graph_bytes() == 0 and pe.graphs.captures == 0


# ------------------------------------------------------ the plain kernel

@pytest.mark.parametrize("window", [None, 9], ids=["causal", "window"])
@pytest.mark.parametrize("qo,pp", [(21, 32), (0, 32), (32, 32), (16, 0)])
def test_plain_flash_tensor_q_offset_is_bitwise_the_int(window, qo, pp):
    rng = np.random.default_rng(4)
    s = 20
    sk = (pp or qo) + s
    q, k, v = (torch.from_numpy(rng.normal(size=sh).astype(np.float32))
               for sh in ((2, s, 4, 32), (2, sk, 2, 32), (2, sk, 2, 32)))
    qv = torch.tensor([20, 13], dtype=torch.int32)
    a = ref.flash_prefill(q, k, v, q_offset=qo, prefix_pad=pp, q_valid=qv,
                          window=window)
    b = ref.flash_prefill(q, k, v, prefix_pad=pp, q_valid=qv, window=window,
                          q_offset=torch.tensor(qo, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("qo,qv", [(100, 90), (37, 128), (1, 64)])
def test_plain_flash_tensor_q_offset_matches_pallas(qo, qv):
    """A padded prefix (prefix_pad 128 > q_offset) with the offset as a
    tensor, against JAX's Pallas kernel in interpret mode, f32, 1e-5."""
    bh, s, hd, pp = 2, 128, 64, 128
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=sh).astype(np.float32) for sh in
               ((bh, s, hd), (bh, pp + s, hd), (bh, pp + s, hd)))
    got = ref.flash_prefill(*(torch.from_numpy(x)[:, :, None]
                              for x in (q, k, v)),
                            q_offset=torch.tensor(qo, dtype=torch.int32),
                            prefix_pad=pp,
                            q_valid=torch.full((bh,), qv, dtype=torch.int32))
    want = flash_prefill_pallas(*(jnp.asarray(x) for x in (q, k, v)),
                                q_offset=qo, prefix_pad=pp, q_valid=qv,
                                interpret=True)
    np.testing.assert_allclose(np32(got[:, :, 0]), np32(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------------ meta

def _meta_tree(tree):
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), tree)


@pytest.mark.parametrize("arch,sorted_moe", [
    ("granite-3-8b", False), ("qwen2-moe-a2.7b", False),
    ("qwen2-moe-a2.7b", True), ("mamba2-2.7b", False),
    ("jamba-1.5-large-398b", False), ("whisper-base", False)],
    ids=["granite", "qwen2-moe-capacity", "qwen2-moe-sorted", "mamba2",
         "jamba", "whisper"])
def test_suffix_prefill_traces_on_meta(arch, sorted_moe):
    """A warm suffix forward (tensor prefix length, padded prefix, SSM
    restore with snapshots, frames) on meta tensors under the cost
    counter: no host read of a tensor, which raises there and at a CUDA
    graph capture; flash prefill charged once per attention layer (plus
    the encoder's and cross-attention's)."""
    _, _, pcfg, tp = both_params(arch)
    if sorted_moe:
        pcfg = moe_sorted(pcfg)
    rng = np.random.default_rng(3)
    has_ssm = "mamba" in pcfg.layer_kinds()
    s = 2 * pcfg.ssm_cfg.chunk if has_ssm else 16
    toks, last, prefix, ssm = _prefix_inputs(pcfg, tp, 2, s, 32, rng,
                                             has_ssm)
    if pcfg.attn_free:
        prefix = None
    batch = {"tokens": toks}
    if pcfg.is_encoder_decoder:
        batch["frames"] = torch.zeros((2, pcfg.encoder_seq, pcfg.d_model))
    stride = pcfg.ssm_cfg.chunk if has_ssm else 0
    args = _meta_tree({"params": abstract_params(pcfg), "batch": batch,
                       "last": last, "prefix": prefix or {},
                       "ssm": ssm or {},
                       "plen": torch.tensor(7, dtype=torch.int32)})

    def fwd(a):
        return forward_prefill(pcfg, a["params"], a["batch"],
                               last_index=a["last"],
                               prefix=a["prefix"] or None,
                               prefix_len=a["plen"],
                               ssm_init=a["ssm"] or None, snap_stride=stride)
    c = count(fwd, args)
    n_attn = sum(kd == "attn" for kd in pcfg.layer_kinds())
    n_flash = n_attn + (pcfg.encoder_layers + pcfg.num_layers
                        if pcfg.is_encoder_decoder else 0)
    assert c.kernels.get("flash_prefill", {}).get("calls", 0) == n_flash
