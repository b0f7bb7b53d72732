"""The fixed-shape decode steps behind the port's step graphs, against the
JAX package.

The fused and speculative steps write every slot's pool row on every
step and send the rows JAX drops (``mode="drop"``) to the pool's drop
block, so no shape depends on the active set: that is what lets the card
capture each step once per shape key as a CUDA graph
(``serving/step_graph.py``). Here, on the CPU, the steps run eagerly and:

* equal JAX's fused and speculative engines under slot churn: tokens
  equal, the pool's own blocks and the active slots' state within 1e-4
  (torch and XLA sum in different orders), with a slot at its ``caps``
  edge, inactive slots with -1 tables, and NaN in the drop block before
  every step (a read of it would reach the tokens);
* count shape keys as JAX counts compiles
  (``decode_step_cache_size``/``spec_decode_step_cache_size``, both
  packages side by side on JAX's churn of ``tests/test_fused_decode.py``
  and ``tests/test_spec_fused.py``);
* trace on ``meta`` under ``launch.cost.count`` for five families: a
  host read of a tensor raises there, so this pins both steps as
  capture-safe without a card.
"""
import functools

import numpy as np
import pytest
import torch

from parity_utils import BS, admit
from repro.models.modeling import decode_step_cache_size as jax_decode_size
from repro.models.modeling import \
    spec_decode_step_cache_size as jax_spec_size
from repro.serving.engine import DecodeEngine as JaxDecode
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.kvcache import PagedKVPool as JaxPool
from repro.serving.speculative import SpecConfig as JaxSpec
from repro_torch.launch.cost import count
from repro_torch.models.caches import decode_slot_state
from repro_torch.models.modeling import (forward_decode_step,
                                         forward_spec_decode_step)
from repro_torch.models.params import abstract_params
from repro_torch.serving import step_graph
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.speculative import SpecConfig
from torch_parity import (F32_TOL, assert_close, both_params, bursts,
                          prompts, spec_admit)

FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b", "pixtral-12b", "whisper-base"]
SPEC_FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                 "jamba-1.5-large-398b"]
META_FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
                 "jamba-1.5-large-398b", "whisper-base"]


def _frames(cfg, rng, n):
    if not cfg.is_encoder_decoder:
        return None
    return [(rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
             ).astype(np.float32) for _ in range(n)]


def _poison(de):
    """NaN into the port's drop blocks (the pool's and the draft's)."""
    de.pool.full_storage[:, -1] = float("nan")
    if de.spec is not None:
        de._d_storage[:, -1] = float("nan")


def _engine(side, cfg, params, nb, spec=None):
    if side == "jax":
        pool = JaxPool(cfg, num_blocks=nb, block_size=BS)
        return pool, JaxDecode(cfg, params, pool, max_slots=3, spec=spec)
    pool = PagedKVPool(cfg, num_blocks=nb, block_size=BS, device="cpu")
    return pool, DecodeEngine(cfg, params, pool, max_slots=3, spec=spec)


def _assert_state_close(pde, jde, slots, draft=False):
    name = "_d_slot_layers" if draft else "_slot_layers"
    for sub, c in getattr(pde, name).items():
        for k, v in c.items():
            want = np.asarray(getattr(jde, name)[sub][k])
            assert_close(v[:, slots], want[:, slots], ctx=f"{sub}/{k}")


@pytest.mark.parametrize("arch", FAMILIES)
def test_fused_step_equals_jax_under_churn(arch):
    """JAX's fused churn (admit 0, 1; three steps; admit 2; two steps;
    evict 0; three steps) with rid 1 at its caps edge (its last step
    writes its last owned row) and slot 0 inactive after the eviction:
    every step's tokens equal, then the pool's blocks and the live
    slots' state within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(5)
    toks = prompts(cfg.vocab_size, rng, rng.integers(5, 14, 3))
    frames = _frames(cfg, rng, 3)
    j_outs = JaxPrefill(cfg, jp).run(toks, frames=frames)
    p_outs = PrefillEngine(pcfg, tp).run(toks, frames=frames)
    edge = -(-(p_outs[1].prompt_len + 8) // BS) * BS - p_outs[1].prompt_len
    sides = {}
    for side, c, params, outs in (("jax", cfg, jp, j_outs),
                                  ("port", pcfg, tp, p_outs)):
        pool, de = _engine(side, c, params, 48)
        record = []

        def steps(n):
            for _ in range(n):
                if side == "port":
                    _poison(de)
                record.append(bursts(de.step()))

        slot0 = admit(pool, de, 0, outs[0])
        admit(pool, de, 1, outs[1], room=edge - 1)
        steps(3)
        admit(pool, de, 2, outs[2])
        steps(2)
        de.evict(slot0)
        pool.release(0)
        steps(3)
        sides[side] = (pool, de, record)
    (jpool, jde, jrec), (ppool, pde, prec) = sides["jax"], sides["port"]
    assert prec == jrec, arch
    # rid 1 wrote its allocation's last row on the last step
    assert pde.pos[1] == len(ppool.owned(1)) * BS
    assert_close(ppool.storage, np.asarray(jpool.storage), F32_TOL)
    _assert_state_close(pde, jde, [1, 2])


@pytest.mark.parametrize("arch", SPEC_FAMILIES)
def test_spec_step_equals_jax_under_churn(arch):
    """A perfect self-draft (k = 3): rid 0 with 2 tokens of room (caps
    clamp its burst to 2 and drop micro-steps 2 and 3 to the drop
    block), rid 1 with 17; then rid 0 evicted and rid 2 admitted into its
    slot, two more steps. Bursts equal JAX's at every step, the pool's
    blocks and both slot states within 1e-4."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(3)
    toks = prompts(cfg.vocab_size, rng, (6, 7, 9))
    j_outs = JaxPrefill(cfg, jp).run(toks)
    p_outs = PrefillEngine(pcfg, tp).run(toks)
    sides = {}
    for side, c, params, outs, spec in (
            ("jax", cfg, jp, j_outs, JaxSpec(cfg, jp, k=3)),
            ("port", pcfg, tp, p_outs, SpecConfig(pcfg, tp, k=3))):
        pool, de = _engine(side, c, params, 48, spec)
        record = []

        def steps(n):
            for _ in range(n):
                if side == "port":
                    _poison(de)
                record.append(bursts(de.step()))

        slot0 = spec_admit(pool, de, 0, outs[0], toks[0], room=2)
        spec_admit(pool, de, 1, outs[1], toks[1], room=17)
        steps(1)
        de.evict(slot0)
        pool.release(0)
        spec_admit(pool, de, 2, outs[2], toks[2], room=9)
        steps(2)
        sides[side] = (pool, de, record)
    (jpool, jde, jrec), (ppool, pde, prec) = sides["jax"], sides["port"]
    assert prec == jrec, arch
    assert [len(b) for b in prec[0].values()] == [2, 4]
    assert_close(ppool.storage, np.asarray(jpool.storage), F32_TOL)
    _assert_state_close(pde, jde, [0, 1])
    _assert_state_close(pde, jde, [0, 1], draft=True)


@pytest.mark.parametrize("draft", ["self", "noisy"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b"])
def test_spec_step_caps_guard_equals_jax(arch, draft):
    """One speculative step (the target as its own draft, k = 3) at the
    function level: slot 0 two tokens short of its capacity with its
    blocks filling the whole table, so micro-steps 2 and 3 would clamp
    onto its last block (rows it committed) without the caps guard; slot
    1 with room; slot 2 inactive with a -1 table; slot 3 inactive holding
    a block; NaN in both drop blocks. The draft reads the target's prompt
    KV ("self": every proposal accepted) or other random KV ("noisy":
    rejections, so the verify sweep's rows are restored). The packed
    tokens and positions equal JAX's, the pools' blocks and the live
    slots' state within 1e-4."""
    import jax
    import jax.numpy as jnp
    from repro.models import caches as jcaches
    from repro.models import modeling as jm
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(8)
    nb, k = 24, 3
    L = max(1, sum(kd == "attn" for kd in cfg.layer_kinds()))
    storage = rng.normal(size=(L, nb, BS, 2 * cfg.kv_dim)).astype(np.float32)
    d_storage = storage.copy() if draft == "self" else \
        rng.normal(size=storage.shape).astype(np.float32)
    table = np.full((4, 4), -1, np.int32)
    blocks = rng.permutation(nb)
    table[0], table[1, :2], table[3, :1] = blocks[:4], blocks[4:6], \
        blocks[6:7]
    pos = np.array([14, 3, 0, 2], np.int32)
    caps = np.array([16, 8, 0, 4], np.int32)
    active = np.array([True, True, False, False])
    tokens = rng.integers(0, cfg.vocab_size, 4).astype(np.int32)
    slot_np = {sub: {kk: (rng.normal(size=v.shape) * 0.3).astype(np.float32)
                     for kk, v in c.items()}
               for sub, c in jcaches.decode_slot_state(cfg, 4).items()}

    def nan_padded(x):
        return torch.from_numpy(np.concatenate(
            [x, np.full_like(x[:, :1], np.nan)], 1))

    j = jm.spec_decode_step_jit(
        cfg, cfg, jp, jp, jnp.asarray(storage), jnp.asarray(d_storage),
        jnp.asarray(table), jnp.asarray(tokens), jnp.asarray(pos),
        jnp.asarray(active), jnp.asarray(caps),
        jax.tree.map(jnp.asarray, slot_np), jax.tree.map(jnp.asarray, slot_np),
        block_size=BS, k=k)
    t_sl = [{sub: {kk: torch.from_numpy(v.copy()) for kk, v in c.items()}
             for sub, c in slot_np.items()} for _ in range(2)]
    t = forward_spec_decode_step(
        pcfg, pcfg, tp, tp, nan_padded(storage), nan_padded(d_storage),
        torch.from_numpy(table), torch.from_numpy(tokens),
        torch.from_numpy(pos), torch.from_numpy(active),
        torch.from_numpy(caps), t_sl[0], t_sl[1], block_size=BS, k=k)
    out = np.asarray(j[0])
    if draft == "self":
        assert out[0, k + 1] == 2 and out[1, k + 1] == k + 1
    else:
        assert out[1, k + 1] < k + 1
    assert t[0][:2].tolist() == out[:2].tolist()
    assert t[2].tolist() == np.asarray(j[2]).tolist()
    for got, want in ((t[3], j[3]), (t[4], j[4])):
        assert_close(got[:, :nb], np.asarray(want), F32_TOL)
    for got, want in ((t[5], j[5]), (t[6], j[6])):
        for sub, c in got.items():
            for kk, v in c.items():
                assert_close(v[:, :2], np.asarray(want[sub][kk])[:, :2],
                             ctx=f"{sub}/{kk}")


def _decode_key_churn(side, cfg, params):
    """tests/test_fused_decode.py's retrace churn: one key in steady
    state, one more when an admission crosses the table bucket. Returns
    the key-count deltas after the steady state and after the crossing."""
    size = jax_decode_size if side == "jax" else \
        step_graph.decode_step_cache_size
    rng = np.random.default_rng(5)
    toks = prompts(cfg.vocab_size, rng, rng.integers(5, 14, 3))
    pe = (JaxPrefill if side == "jax" else PrefillEngine)(cfg, params)
    outs = pe.run(toks)
    # a pool geometry no other test uses: fresh JAX compile keys
    pool, de = _engine(side, cfg, params, 41)
    base = size()
    slot = admit(pool, de, 0, outs[0])
    de.step()
    de.evict(slot)
    pool.release(0)
    admit(pool, de, 1, outs[1])           # same bucket: no new key
    de.step()
    de.step()
    steady = size() - base
    long_prompt = prompts(cfg.vocab_size, np.random.default_rng(0), [30])[0]
    out_long, = pe.run([long_prompt])
    admit(pool, de, 2, out_long, room=40)
    de.step()
    return steady, size() - base


def test_decode_step_cache_size_deltas_equal_jax():
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    want = _decode_key_churn("jax", cfg, jp)
    got = _decode_key_churn("port", pcfg, tp)
    assert got == want == (1, 2)


def _spec_key_churn(side, cfg, params, spec):
    """tests/test_spec_fused.py's retrace churn: emission counts of 2
    and 4 in one step, an eviction and an admission in the same bucket.
    Returns the key-count deltas after the first step and at the end,
    and the burst lengths seen."""
    size = jax_spec_size if side == "jax" else \
        step_graph.spec_decode_step_cache_size
    rng = np.random.default_rng(3)
    toks = prompts(cfg.vocab_size, rng, (6, 7, 5))
    pe = (JaxPrefill if side == "jax" else PrefillEngine)(cfg, params)
    outs = pe.run(toks)
    pool, de = _engine(side, cfg, params, 43, spec)
    slot0 = spec_admit(pool, de, 0, outs[0], toks[0], room=2)
    slot1 = spec_admit(pool, de, 1, outs[1], toks[1], room=17)
    base = size()
    first = de.step()
    after_first = size() - base
    seen = [len(first[slot0]), len(first[slot1])]
    de.evict(slot0)
    pool.release(0)
    spec_admit(pool, de, 2, outs[2], toks[2], room=6)
    for _ in range(2):
        seen += [len(b) for b in de.step().values()]
    return after_first, size() - base, seen


def test_spec_step_cache_size_deltas_equal_jax():
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    want = _spec_key_churn("jax", cfg, jp, JaxSpec(cfg, jp, k=3))
    got = _spec_key_churn("port", pcfg, tp, SpecConfig(pcfg, tp, k=3))
    assert got == want
    assert got[:2] == (1, 1) and got[2][:2] == [2, 4]


def test_cpu_steps_capture_nothing():
    """On the CPU a step runs eagerly; its key is counted, nothing is
    captured or replayed."""
    _, _, pcfg, tp = both_params("granite-3-8b")
    out, = PrefillEngine(pcfg, tp).run([[1, 2, 3, 4, 5]])
    pool, de = _engine("port", pcfg, tp, 16)
    admit(pool, de, 0, out)
    base = step_graph.decode_step_cache_size()
    de.step()
    de.step()
    assert step_graph.decode_step_cache_size() - base == 1
    assert (de.graphs.captures, de.graphs.replays) == (0, 0)


@pytest.mark.parametrize("spec", [False, True], ids=["fused", "spec"])
def test_eager_twin_equals_the_next_step(spec):
    """``eager_twin``, the card's reference for a replay, is the engine's
    next step: on the CPU (where the step itself runs eagerly) its first
    call equals that step bit for bit, and the engine is untouched."""
    _, _, pcfg, tp = both_params("jamba-1.5-large-398b")
    rng = np.random.default_rng(4)
    toks = prompts(pcfg.vocab_size, rng, (6, 9))
    outs = PrefillEngine(pcfg, tp).run(toks)
    pool, de = _engine("port", pcfg, tp, 16,
                       SpecConfig(pcfg, tp, k=3) if spec else None)
    for rid, out in enumerate(outs):
        spec_admit(pool, de, rid, out, toks[rid], room=9)
    de.step()
    before = pool.storage.clone()
    twin = step_graph.eager_twin(de)()
    assert torch.equal(pool.storage, before)
    got = de.step()
    out = twin["out"]
    want = {s: ([int(t) for t in out[s, :int(out[s, -1])]] if spec
                else [int(out[s])]) for s in de.active_slots()}
    assert got == want
    assert torch.equal(de._tokens, twin["tokens"])
    assert torch.equal(de._pos, twin["pos"])
    assert torch.equal(pool.storage, twin["storage"])
    for sub, c in de._slot_layers.items():
        for k, v in c.items():
            assert torch.equal(v, twin["slot_layers"][sub][k]), (sub, k)
    if spec:
        assert torch.equal(de._d_storage[:, :-1], twin["d_storage"])


# ------------------------------------------------------------------ meta

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", META_FAMILIES)
def test_steps_trace_on_meta(arch):
    """Both steps of a reduced family run on meta tensors under the cost
    counter: no host read of a tensor (which raises there) and the paged
    attention kernel charged once per attention layer and micro-step."""
    _, _, pcfg, _ = both_params(arch)
    p = abstract_params(pcfg)
    ms, T, nb, k = 4, 8, 16, 3
    n_attn = sum(kd == "attn" for kd in pcfg.layer_kinds())
    st = _meta(max(n_attn, 1), nb + 1, BS, 2 * pcfg.kv_dim)
    i32 = functools.partial(_meta, dtype=torch.int32)
    args = (st, i32(ms, T), i32(ms), i32(ms), _meta(ms, dtype=torch.bool))
    c = count(lambda prm, s, bt, tk, ps, ac, sl: forward_decode_step(
        pcfg, prm, s, bt, tk, ps, ac, sl, block_size=BS),
        p, *args, decode_slot_state(pcfg, ms, device="meta"))
    assert c.kernels.get("paged_attention", {}).get("calls", 0) == n_attn
    if pcfg.is_encoder_decoder:
        return          # speculation does not cover enc-dec families
    c = count(lambda prm, s, d, bt, tk, ps, ac, cp, sl, dsl:
              forward_spec_decode_step(pcfg, pcfg, prm, prm, s, d, bt, tk,
                                       ps, ac, cp, sl, dsl, block_size=BS,
                                       k=k),
              p, st, torch.empty_like(st), *args[1:], i32(ms),
              decode_slot_state(pcfg, ms, device="meta"),
              decode_slot_state(pcfg, ms, device="meta"))
    assert c.kernels.get("paged_attention", {}).get("calls", 0) \
        == 2 * (k + 1) * n_attn


@pytest.mark.parametrize("read", [lambda t: t.tolist(), lambda t: t.item(),
                                  lambda t: int(t), lambda t: t.cpu()],
                         ids=["tolist", "item", "int", "cpu"])
def test_meta_trace_refuses_host_reads(read):
    """The premise of the meta trace: a host read of a tensor raises."""
    with pytest.raises(Exception):
        count(lambda t: read(t.sum()), _meta(4))

