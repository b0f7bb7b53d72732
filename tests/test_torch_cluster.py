"""The port's whole serving path against the JAX package's: granite-3-8b
and the MoE, SSM and hybrid families reduced, 1P:1D, identical weights,
seeded prompts. Greedy tokens must be equal per request in both transfer
modes and on a warm prefix hit (the suffix-only prefill through
run_suffix, restoring a recurrent-state snapshot for mamba2 and
jamba)."""
import gc
import os
import subprocess
import sys
import weakref
from pathlib import Path

import numpy as np
import pytest

from repro.serving.cluster import MiniCluster as JaxMiniCluster
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.configs import get_config
from repro_torch.serving.cluster import MiniCluster, ServeRequest
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import MOE_SSM_ARCHS, both_params, prompts

ARCH = "granite-3-8b"
FAMILIES = [ARCH] + MOE_SSM_ARCHS
ROOT = Path(__file__).resolve().parents[1]


def _serve(mc, cls, toks, max_new=5):
    reqs = [cls(rid=i, tokens=list(t), max_new_tokens=max_new)
            for i, t in enumerate(toks)]
    mc.run(reqs)
    assert all(r.done for r in reqs)
    return {r.rid: list(r.generated) for r in reqs}


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("arch", FAMILIES)
def test_minicluster_tokens_match_jax(arch, overlap):
    cfg, jp, pcfg, tp = both_params(arch)
    toks = prompts(cfg.vocab_size, np.random.default_rng(3),
                   np.random.default_rng(4).integers(6, 40, 5))
    jmc = JaxMiniCluster(cfg, params=jp, overlap_transfer=overlap)
    pmc = MiniCluster(pcfg, params=tp, overlap_transfer=overlap,
                      device="cpu")
    want = _serve(jmc, JaxRequest, toks)
    got = _serve(pmc, ServeRequest, toks)
    assert got == want
    jt = jmc.frontend.groups["default"].transfer_stats()
    pt = pmc.frontend.groups["default"].transfer_stats()
    assert pt["jobs_admitted"] == jt["jobs_admitted"] == len(toks)
    assert pt["overlapped"] == jt["overlapped"] == float(overlap)


@pytest.mark.parametrize("arch", FAMILIES)
def test_warm_prefix_hit_matches_cold_and_jax(arch):
    """Requests sharing a 64-token prefix, served one after the other:
    the later ones are warm hits (suffix-only prefill over the gathered
    prefix KV, window-aligned for capacity MoE, from the 32- and 64-token
    snapshots for mamba2 and jamba) and emit the cold path's and JAX's
    tokens."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(9)
    shared = prompts(cfg.vocab_size, rng, [64])[0]
    toks = [shared + t for t in prompts(cfg.vocab_size, rng, [7, 10, 40])]

    def sequential(fe, cls):
        out = []
        for i, t in enumerate(toks):
            req = cls(rid=i, tokens=list(t), max_new_tokens=4)
            fe.run([req])
            assert req.done
            out.append(list(req.generated))
        return out

    warm_fe = ClusterFrontend(pcfg, params=tp, device="cpu")
    warm = sequential(warm_fe, ServeRequest)
    stats = warm_fe.groups["default"].prefix_stats()
    assert stats["hits"] >= 2 and stats["reused_tokens"] >= 128
    if arch in ("mamba2-2.7b", "jamba-1.5-large-398b"):
        assert stats["snap_hits"] >= 2 and stats["state_restores"] >= 2
    cold = sequential(ClusterFrontend(pcfg, params=tp, prefix_cache=False,
                                      device="cpu"), ServeRequest)
    jax_warm = sequential(JaxFrontend(cfg, params=jp), JaxRequest)
    assert warm == cold == jax_warm


def test_gateway_backoff_serves_overload_with_jax_tokens():
    """Timed arrivals at a one-slot prefill node: the requests it turns
    away back off at the gateway and are served later, with the tokens
    the JAX frontend gives (greedy decode does not depend on timing)."""
    cfg, jp, pcfg, tp = both_params(ARCH)
    toks = prompts(cfg.vocab_size, np.random.default_rng(12), [9, 14, 20])

    def overload(fe, cls):
        reqs = [cls(rid=i, tokens=list(t), max_new_tokens=3)
                for i, t in enumerate(toks)]
        for r in reqs:
            fe.submit(r, at=0.0)
        fe.serve(watch=reqs)
        assert all(r.done and not r.shed for r in reqs)
        return {r.rid: list(r.generated) for r in reqs}

    fe = ClusterFrontend(pcfg, params=tp, device="cpu",
                         prefill_kwargs={"batch_size": 1})
    got = overload(fe, ServeRequest)
    assert fe.gateway_stats()["gw_requeues"] > 0
    want = overload(JaxFrontend(cfg, params=jp,
                                prefill_kwargs={"batch_size": 1}),
                    JaxRequest)
    assert got == want


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("kind", ["frontend", "minicluster"])
def test_dropped_cluster_frees_its_params(kind, overlap):
    """A cluster that served requests and is dropped frees its params,
    groups and pools at once, with the cycle collector off: the groups'
    callbacks (gateway capacity hook, transfer scheduler's target pick
    and admission) keep no strong reference back to their owners."""
    cfg = get_config(ARCH).reduced()
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        if kind == "frontend":
            owner = ClusterFrontend(cfg, device="cpu",
                                    overlap_transfer=overlap)
            fe = owner
        else:
            owner = MiniCluster(cfg, device="cpu", overlap_transfer=overlap)
            fe = owner.frontend
        reqs = [ServeRequest(rid=i, tokens=list(t), max_new_tokens=3)
                for i, t in enumerate(prompts(
                    cfg.vocab_size, np.random.default_rng(5), [9, 20, 33]))]
        fe.run(reqs)
        assert all(r.done for r in reqs)
        alive = [weakref.ref(x) for x in (
            owner, fe.groups["default"], fe.params["embed"],
            fe.groups["default"].prefills[0].pool)]
        del owner, fe
        assert [r() is None for r in alive] == [True] * len(alive)
    finally:
        if enabled:
            gc.enable()


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new-tokens", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "4/4 completed" in res.stdout
