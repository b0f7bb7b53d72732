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
from repro_torch.configs import get_config as port_config
from repro_torch.models.params import params_from_numpy

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

_cache = {}


def both_params(arch):
    """(jax_cfg, jax_params, port_cfg, port_params) for a reduced arch,
    the port's params converted from the JAX ones (CPU)."""
    if arch not in _cache:
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
    (the JAX package adds its compile count and absorption counters)."""
    out = {}
    for sc, g in port_fe.groups.items():
        mine = g.transfer_stats()
        theirs = jax_fe.groups[sc].transfer_stats()
        out[sc] = (mine, {k: theirs[k] for k in mine})
    return out


def assert_pools_clean(group):
    for node in group.prefills + group.decodes:
        assert node.pool.invariant_ok(), node.iid
