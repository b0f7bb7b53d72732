"""The port's speculative decode step (DecodeEngine(spec=...) over
forward_spec_decode_step) against the JAX package's, on the four
decoder-only families the JAX spec tests cover (granite, qwen2-moe with
sorted dispatch, mamba2, jamba), with identical target and draft weights.

Greedy tokens, the per-slot emission counts of every step (the packed
out matrix's n_emit column, seen as each slot's burst length) and the
spec_steps/spec_emitted counters must be equal. Against the port's own
plain fused step the streams must be equal and the pool bit-identical
(same shapes on the CPU, so no tolerance).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from parity_utils import BS
from repro.serving.engine import DecodeEngine as JaxDecode
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.speculative import SCENARIO_SPEC_K as JAX_SPEC_K
from repro.serving.speculative import SpecConfig as JaxSpec
from repro.serving.speculative import draft_for as jax_draft_for
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.frontend import ClusterFrontend
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.speculative import (SCENARIO_SPEC_K, SpecConfig,
                                             draft_for)
from torch_parity import (both_params, moe_sorted, plain_streams, prompts,
                          spec_admit as _admit, spec_churn as _churn,
                          spec_pool as _pool)

FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b",
            "jamba-1.5-large-398b"]


def _setup(arch, k=3, seed=99):
    """(jax side, port side): each (cfg, params, spec, prompts), the
    draft JAX's draft_for(seed) and its params carried over to the port."""
    cfg, jp, pcfg, tp = both_params(arch)
    cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    jd = jax_draft_for(cfg, seed=seed)
    pd = draft_for(pcfg, device="cpu")
    assert dataclasses.asdict(pd.draft_cfg) == dataclasses.asdict(jd.draft_cfg)
    pd_params = params_from_numpy(pd.draft_cfg,
                                  jax.tree.map(np.asarray, jd.draft_params),
                                  device="cpu")
    rng = np.random.default_rng(5)
    toks = prompts(cfg.vocab_size, rng, rng.integers(5, 14, 3))
    return ((cfg, jp, JaxSpec(jd.draft_cfg, jd.draft_params, k=k), toks),
            (pcfg, tp, SpecConfig(pd.draft_cfg, pd_params, k=k), toks))


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_matches_jax_and_plain_with_slot_churn(arch):
    """An imperfect draft (acceptance varies, bursts of 1..k+1): every
    step's bursts, the counters and the streams equal JAX's, and each
    stream is a prefix of the port's plain fused greedy stream."""
    jax_side, port_side = _setup(arch)
    j_rec, p_rec = [], []
    j_gen, j_cnt, _ = _churn("jax", *jax_side, j_rec)
    p_gen, p_cnt, outs = _churn("port", *port_side, p_rec)
    assert p_rec == j_rec, arch
    assert p_gen == j_gen
    assert p_cnt == j_cnt and p_cnt[0] == 4
    assert p_cnt[1] == sum(len(g) - 1 for g in p_gen.values())
    plain = plain_streams(port_side[0], port_side[1], outs)
    for rid, got in p_gen.items():
        assert len(got) >= 3
        assert got == plain[rid][:len(got)], (arch, rid)


@pytest.mark.parametrize("arch", ["granite-3-8b", "jamba-1.5-large-398b"])
def test_spec_pool_bit_identical_to_plain(arch):
    """One spec step with rejections: the committed pool rows equal the
    plain fused step's bit for bit, and every row the verify sweep wrote
    past the commit point is back to the fresh pool's zeros."""
    _, (pcfg, tp, spec, toks) = _setup(arch, k=4)
    out, = PrefillEngine(pcfg, tp).run(toks[:1])
    pl = out.prompt_len
    pool_s = _pool("port", pcfg)
    de_s = DecodeEngine(pcfg, tp, pool_s, max_slots=1, spec=spec)
    _admit(pool_s, de_s, 0, out, toks[0], room=12)
    n = len(de_s.step()[0])
    assert n < spec.k + 1, "the draft accepted everything: pick another seed"
    pool_p = _pool("port", pcfg)
    de_p = DecodeEngine(pcfg, tp, pool_p, max_slots=1)
    _admit(pool_p, de_p, 0, out, None, room=12)
    for _ in range(n):
        de_p.step()
    a = pool_s.read_tokens(pool_s.owned(0), pl + n)
    b = pool_p.read_tokens(pool_p.owned(0), pl + n)
    assert torch.equal(a, b)
    cap = len(pool_s.owned(0)) * BS
    tail = pool_s.read_tokens(pool_s.owned(0), cap)[:, pl + n:]
    assert int(torch.count_nonzero(tail)) == 0


def test_spec_matches_plain_on_warm_prefix_admission():
    """A suffix-only prefill feeds both paths the same stitched KV: the
    spec stream equals the plain one."""
    _, (pcfg, tp, spec, _) = _setup("granite-3-8b", k=4)
    rng = np.random.default_rng(11)
    prefix, suffix = prompts(pcfg.vocab_size, rng, [8, 5])
    pe = PrefillEngine(pcfg, tp)
    cold, = pe.run([prefix + suffix])
    warm = pe.run_suffix(suffix, torch.cat([cold.k[:, :8], cold.v[:, :8]],
                                           dim=-1))
    assert warm.first_token == cold.first_token
    gens = {}
    for sp in (None, spec):
        pool = _pool("port", pcfg)
        de = DecodeEngine(pcfg, tp, pool, max_slots=2, spec=sp)
        _admit(pool, de, 0, warm, prefix + suffix)
        gen = [warm.first_token]
        while len(gen) < 8:
            gen.extend(de.step()[0])
        gens[sp is None] = gen[:8]
    assert gens[True] == gens[False]


def test_spec_headroom_clamps_emission_like_jax():
    """A perfect draft (the target itself) with one slot two tokens short
    of its allocation: that slot retires 2 tokens, the other k+1 = 4, in
    the same step, on both stacks; later steps keep the plain stream."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    rng = np.random.default_rng(3)
    toks = prompts(cfg.vocab_size, rng, [6, 7])
    res = {}
    for side, c, p, sp in (("jax", cfg, jp, JaxSpec(cfg, jp, k=3)),
                           ("port", pcfg, tp, SpecConfig(pcfg, tp, k=3))):
        outs = (JaxPrefill if side == "jax" else PrefillEngine)(c, p).run(toks)
        pool = _pool(side, c, nb=40)
        de = (JaxDecode if side == "jax" else DecodeEngine)(
            c, p, pool, max_slots=2, spec=sp)
        s0 = _admit(pool, de, 0, outs[0], toks[0], room=2)
        s1 = _admit(pool, de, 1, outs[1], toks[1], room=17)
        first = de.step()
        assert len(first[s0]) == 2 and len(first[s1]) == 4, side
        de.evict(s0)
        pool.release(0)
        rest = [de.step()[s1] for _ in range(2)]
        res[side] = ({s: list(t) for s, t in first.items()},
                     [list(t) for t in rest])
        if side == "port":
            plain = plain_streams(pcfg, tp, outs)
            stream = [outs[1].first_token] + first[s1] + rest[0] + rest[1]
            assert stream == plain[1][:len(stream)]
            assert [outs[0].first_token] + first[s0] == plain[0][:3]
    assert res["port"] == res["jax"]


def test_spec_refuses_encoder_decoder():
    _, _, pcfg, tp = both_params("whisper-base")
    pool = PagedKVPool(pcfg, num_blocks=16, block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="enc-dec"):
        DecodeEngine(pcfg, tp, pool, spec=SpecConfig(pcfg, tp))
    _, _, gcfg, gp = both_params("granite-3-8b")
    pool = PagedKVPool(gcfg, num_blocks=16, block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="fused"):
        DecodeEngine(gcfg, gp, pool, fused=False, spec=SpecConfig(gcfg, gp))


@pytest.mark.parametrize("arch", FAMILIES + ["pixtral-12b"])
def test_draft_for_config_and_k_equal_jax(arch):
    """The scenario-aware draft: the same config as JAX's (same vocab,
    whole blocks, hybrid periods intact) and the same depth per
    scenario; its params are seeded (the same seed draws the same
    numbers)."""
    cfg, _, pcfg, _ = both_params(arch)
    assert SCENARIO_SPEC_K == JAX_SPEC_K
    for sc in list(SCENARIO_SPEC_K) + ["unknown"]:
        j = jax_draft_for(cfg, sc)
        p = draft_for(pcfg, sc, device="cpu")
        assert dataclasses.asdict(p.draft_cfg) == \
            dataclasses.asdict(j.draft_cfg), (arch, sc)
        assert p.k == j.k
    again = draft_for(pcfg, device="cpu").draft_params["embed"]
    assert torch.equal(draft_for(pcfg, device="cpu").draft_params["embed"],
                       again)


def test_frontend_resolves_spec_per_scenario():
    """``spec="auto"`` picks draft_for per scenario group (write drafts
    deeper than summarize), a dict speculates on some groups only, and
    every group's tokens equal a plain frontend's."""
    _, _, pcfg, tp = both_params("granite-3-8b")
    topo = {"write": (1, 1), "summarize": (1, 1)}

    def serve(**kw):
        fe = ClusterFrontend(pcfg, params=tp, topology=topo, device="cpu",
                             **kw)
        rng = np.random.default_rng(8)
        reqs = [ServeRequest(rid=i, tokens=t, max_new_tokens=6,
                             scenario=sc)
                for i, (t, sc) in enumerate(zip(
                    prompts(pcfg.vocab_size, rng, [9, 5, 12, 7]),
                    ["write", "summarize"] * 2))]
        fe.run(reqs)
        assert all(r.done for r in reqs)
        return fe, {r.rid: r.generated for r in reqs}

    _, plain = serve()
    fe, auto = serve(spec="auto")
    ks = {sc: g.decodes[0].engine.spec.k for sc, g in fe.groups.items()}
    assert ks == {"write": SCENARIO_SPEC_K["write"],
                  "summarize": SCENARIO_SPEC_K["summarize"]}
    assert auto == plain
    fe, mixed = serve(spec={"write": "auto"})
    assert fe.groups["summarize"].decodes[0].engine.spec is None
    assert fe.groups["write"].decodes[0].engine.spec_steps > 0
    assert mixed == plain
