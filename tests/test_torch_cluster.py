"""The port's whole serving path against the JAX package's: granite-3-8b
reduced, 1P:1D, identical weights, seeded prompts. Greedy tokens must be
equal per request in both transfer modes and on a warm prefix hit (the
suffix-only prefill through run_suffix)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.serving.cluster import MiniCluster as JaxMiniCluster
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.serving.cluster import MiniCluster, ServeRequest
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import both_params, prompts

ARCH = "granite-3-8b"
ROOT = Path(__file__).resolve().parents[1]


def _serve(mc, cls, toks, max_new=5):
    reqs = [cls(rid=i, tokens=list(t), max_new_tokens=max_new)
            for i, t in enumerate(toks)]
    mc.run(reqs)
    assert all(r.done for r in reqs)
    return {r.rid: list(r.generated) for r in reqs}


@pytest.mark.parametrize("overlap", [True, False])
def test_minicluster_tokens_match_jax(overlap):
    cfg, jp, pcfg, tp = both_params(ARCH)
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


def test_warm_prefix_hit_matches_cold_and_jax():
    """Two requests sharing a 32-token prefix, served one after the
    other: the second is a warm hit (suffix-only prefill over the
    gathered prefix KV) and emits the cold path's and JAX's tokens."""
    cfg, jp, pcfg, tp = both_params(ARCH)
    rng = np.random.default_rng(9)
    shared = prompts(cfg.vocab_size, rng, [32])[0]
    toks = [shared + t for t in prompts(cfg.vocab_size, rng, [7, 10])]

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
    assert stats["hits"] > 0 and stats["reused_tokens"] >= 32
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


def test_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new-tokens", "3"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "4/4 completed" in res.stdout
