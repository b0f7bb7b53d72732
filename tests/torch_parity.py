"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*).

Both stacks run identical weights: the JAX params of
``conftest.reduced_params`` (``init_params(cfg, PRNGKey(7))``) converted
through numpy with ``repro_torch.models.params.params_from_numpy``.
Inputs are made from a seed with numpy and handed to both. The port runs
on the CPU here, where every kernel call takes its plain PyTorch
version; the CUDA kernels themselves are compared with those plain
versions on the card (tests marked ``cuda``, and chip_smoke.py).

Tolerances, each with its reason:

* F32_TOL (1e-4, rtol and atol) on f32 logits, KV and attention outputs:
  torch and XLA sum in different orders;
* BF16_TOL (2e-2), as tests/test_kernels.py uses for bf16;
* copies (gather/scatter, pool bookkeeping) are bit-exact and greedy
  tokens are equal.
"""
import dataclasses

import jax
import numpy as np
import torch

from conftest import reduced_params
from parity_utils import BS
from repro.serving.engine import DecodeEngine as JaxDecode
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro.serving.kvcache import PagedKVPool as JaxPool
from repro_torch.configs import RATIO_VARIANTS, ratio_variant
from repro_torch.configs import get_config as port_config
from repro_torch.models.params import params_from_numpy
from repro_torch.serving.engine import DecodeEngine, PrefillEngine
from repro_torch.serving.kvcache import PagedKVPool

# one intra-op thread per xdist worker: the port's CPU tensors are tiny
torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 2e-2

# the five dense decoder-only families
DENSE_ARCHS = ["granite-3-8b", "pangu-38b", "minicpm-2b",
               "mistral-nemo-12b", "qwen1.5-110b"]
# MoE, SSM (attention-free) and hybrid attention/Mamba/MoE families
MOE_SSM_ARCHS = ["qwen2-moe-a2.7b", "deepseek-moe-16b", "mamba2-2.7b",
                 "jamba-1.5-large-398b"]
# the nine decoder-only families that take token batches alone
SERVED_ARCHS = DENSE_ARCHS + MOE_SSM_ARCHS
# the encoder-decoder (frames feed its encoder) and the VLM backbone
ENCDEC_ARCHS = ["whisper-base", "pixtral-12b"]
ALL_ARCHS = SERVED_ARCHS + ENCDEC_ARCHS

# the reduced variants at pangu-38b's 6 query heads a KV head and
# deepseek-moe-16b's top-6 of 8 + 2 shared (capacity, then sorted)
PANGU_G6, DEEPSEEK_TOP6, DEEPSEEK_TOP6_SORTED = RATIO_VARIANTS

_cache = {}


def both_params(arch):
    """(jax_cfg, jax_params, port_cfg, port_params) for a reduced arch or
    a ``repro_torch.configs.RATIO_VARIANTS`` name (built by each
    package's ``get_config``), the port's params converted from the JAX
    ones (CPU)."""
    if arch not in _cache:
        if arch in RATIO_VARIANTS:
            from repro.configs import get_config as jax_config
            from repro.models.params import init_params
            cfg = ratio_variant(arch, jax_config)
            jp = init_params(cfg, jax.random.PRNGKey(7))
            pcfg = ratio_variant(arch)
        else:
            cfg, jp = reduced_params(arch)
            pcfg = port_config(arch).reduced()
        assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg), arch
        tp = params_from_numpy(pcfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
        _cache[arch] = (cfg, jp, pcfg, tp)
    return _cache[arch]


def np32(x):
    """Any array or tensor -> float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def assert_close(got, want, tol=F32_TOL, ctx=""):
    np.testing.assert_allclose(np32(got), np32(want), rtol=tol, atol=tol,
                               err_msg=ctx)


def prompts(vocab, rng, lens):
    return [[int(t) for t in rng.integers(0, vocab, int(n))] for n in lens]


# ------------------------------------------------ control-plane parity
# The control plane (faults, role flips, autoscaling) runs on Python
# floats and random.Random once a DeterministicService charges the
# virtual time, so the port is held to the JAX package event for event
# and bit for bit: no tolerance anywhere below.

def moe_sorted(cfg):
    """Lossless sorted MoE dispatch for a config with MoE layers (the
    capacity dispatch drops tokens batch-dependently, so chaos parity
    pins the sorted path, as the JAX package's chaos tests do)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch="sorted"))


def seeded_requests(cls, vocab, n, *, seed=3, max_new=6, lo=5, hi=12,
                    rid0=0, **kw):
    """``n`` requests of ``cls`` with seeded prompts of lo..hi-1 tokens
    (the JAX package's chaos-test prompts)."""
    rng = np.random.default_rng(seed)
    return [cls(rid=rid0 + i,
                tokens=[int(t) for t in rng.integers(
                    0, vocab, int(rng.integers(lo, hi)))],
                max_new_tokens=max_new, **kw) for i in range(n)]


def control_signature(fe, reqs):
    """Everything the control plane decides, as plain Python data:
    tokens and flags per request, and per group the event log, the
    MetaStore audit log, the fault controller's log and ledger, the
    transfer/scale/recovery ledger, the flips, the adjuster's decisions
    and wait votes, and the autoscaler's ops and pool ledger."""
    sig = {"tokens": {r.rid: (list(r.generated), r.done, r.shed,
                              r.readmits) for r in reqs},
           "meta": (list(fe.meta.events), fe.meta.n_events),
           "gateway": fe.gateway_stats()}
    for sc, g in fe.groups.items():
        sig[sc] = {
            "event_log": list(g.event_log),
            "ratio": g.ratio,
            "iids": ([n.iid for n in g.prefills], [n.iid for n in g.decodes]),
            "flips": (list(g.flips), g.n_flips),
            "ft_log": list(g.ft.log) if g.ft is not None else None,
            "ft_walls": list(g.ft.recovery_walls) if g.ft is not None
            else None,
        }
        adj = fe.adjusters.get(sc)
        if adj is not None:
            sig[sc]["decisions"] = (list(adj.decisions),
                                    list(adj.wait_votes))
    sc = fe.autoscaler
    if sc is not None:
        sig["scale_ops"] = [dataclasses.astuple(op) for op in sc.ops]
        sig["scale_ledger"] = sc.ledger()
    return sig


def transfer_ledgers(port_fe, jax_fe):
    """Each group's transfer_stats() of both sides, over the port's keys
    (the JAX package adds its absorption counters), without
    ``prefill_compile_count``: both packages count compile keys process
    wide, over every earlier test in the worker, so only its deltas on
    the same traffic compare (tests/test_torch_prefill_graph.py)."""
    out = {}
    for sc, g in port_fe.groups.items():
        mine = g.transfer_stats()
        mine.pop("prefill_compile_count")
        theirs = jax_fe.groups[sc].transfer_stats()
        out[sc] = (mine, {k: theirs[k] for k in mine})
    return out


def assert_pools_clean(group):
    for node in group.prefills + group.decodes:
        assert node.pool.invariant_ok(), node.iid


# ------------------------------------------------ speculative decode
# Engine-level drivers shared by the spec parity files: the same schedule
# on the JAX package's engines ("jax") and the port's ("port").

def bursts(res):
    """One DecodeEngine.step's {slot: [token, ...]}: the port's form on both
    sides (the JAX package's plain step gives one int per slot)."""
    return {s: t if isinstance(t, list) else [t] for s, t in res.items()}


def spec_pool(side, cfg, nb=48):
    if side == "jax":
        return JaxPool(cfg, num_blocks=nb, block_size=BS)
    return PagedKVPool(cfg, num_blocks=nb, block_size=BS, device="cpu")


def spec_admit(pool, de, rid, out, prompt, room=20):
    pool.alloc(rid, out.prompt_len + room)
    if out.k is not None:
        pool.write_prefill(
            pool.owned(rid)[: (out.prompt_len + BS - 1) // BS], out.k, out.v)
    return de.admit(rid, out, pool.owned(rid),
                    prompt=prompt if de.spec is not None else None)


def spec_churn(side, cfg, params, spec, toks, record):
    """JAX's spec churn schedule (admit 0, 1; two steps; admit 2; a step;
    evict 0; a step), every step's {slot: burst} appended to ``record``."""
    pe = (JaxPrefill if side == "jax" else PrefillEngine)(cfg, params)
    outs = pe.run(toks)
    pool = spec_pool(side, cfg)
    de = (JaxDecode if side == "jax" else DecodeEngine)(
        cfg, params, pool, max_slots=3, spec=spec)
    gen = {rid: [out.first_token] for rid, out in enumerate(outs)}

    def steps(n):
        for _ in range(n):
            res = de.step()
            record.append({s: list(t) for s, t in sorted(res.items())})
            for slot, burst in res.items():
                gen[de.rid[slot]].extend(burst)

    slot0 = spec_admit(pool, de, 0, outs[0], toks[0])
    spec_admit(pool, de, 1, outs[1], toks[1])
    steps(2)
    spec_admit(pool, de, 2, outs[2], toks[2])
    steps(1)
    de.evict(slot0)
    pool.release(0)
    steps(1)
    assert pool.invariant_ok()
    return gen, (de.spec_steps, de.spec_emitted, de.fused_steps), outs


def plain_streams(cfg, params, outs, steps=16):
    pool = spec_pool("port", cfg, nb=64)
    de = DecodeEngine(cfg, params, pool, max_slots=len(outs))
    gen = {}
    for rid, out in enumerate(outs):
        spec_admit(pool, de, rid, out, None)
        gen[rid] = [out.first_token]
    for _ in range(steps):
        for slot, burst in de.step().items():
            gen[de.rid[slot]].extend(burst)
    return gen


def sim_profiles():
    """(jax_profile, port_profile): the one serving profile the simulator
    parity tests share, JAX's ``profile_for(granite-3-8b)`` converted
    field by field into the port's ``ServingProfile``. Both simulators
    get it explicitly, so neither side's ``profile_for`` constants enter
    the comparison."""
    from repro.configs import get_config as jax_config
    from repro.core.profiles import profile_for
    from repro_torch.core.profiles import ServingProfile
    jp = profile_for(jax_config("granite-3-8b"))
    return jp, ServingProfile(**dataclasses.asdict(jp))


def sim_trace(sim, reqs):
    """Everything a simulator run leaves behind, in comparable form: the
    completed and failed rid sequences, the D2D times in order and every
    request's lifecycle fields."""
    return ([r.rid for r in sim.completed], [r.rid for r in sim.failed],
            list(getattr(sim, "d2d_times", [])),
            [dataclasses.asdict(r) for r in reqs])
