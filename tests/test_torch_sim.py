"""The port's cluster simulator against the JAX package's, exactly: both
run the same float arithmetic in the same order on the same seeded
``random.Random`` streams, so requests, metrics dicts, event sequences
and every request's lifecycle stamps are equal (``==``), given one
shared, explicitly passed serving profile (``torch_parity.sim_profiles``).
"""
import dataclasses

import pytest

from repro.configs import get_config as jax_config
from repro.core import aggregated as j_agg
from repro.core import cluster_sim as j_sim
from repro.core import perf_model as j_pm
from repro.core import profiles as j_prof
from repro.core import requests as j_req
from repro_torch.configs import get_config as port_config
from repro_torch.core import aggregated as p_agg
from repro_torch.core import cluster_sim as p_sim
from repro_torch.core import perf_model as p_pm
from repro_torch.core import profiles as p_prof
from repro_torch.core import requests as p_req
from torch_parity import sim_profiles, sim_trace

HORIZON = 20.0


def _asdicts(reqs):
    return [dataclasses.asdict(r) for r in reqs]


@pytest.mark.parametrize("tidal,seed,rate", [
    (False, 0, 8.0), (False, 17, 60.0), (True, 3, 30.0)])
def test_workload_streams_equal(tidal, seed, rate):
    """Every field of every request, the default scenarios and a custom
    one; tidal traffic over a whole day at a low rate."""
    horizon = 86400.0 / 40 if tidal else HORIZON
    sc_j = j_req.Scenario("svc/x", "svc", 512, 2, 128, 32, 64, 16, 3.0)
    sc_p = p_req.Scenario("svc/x", "svc", 512, 2, 128, 32, 64, 16, 3.0)
    for scs_j, scs_p in ((j_req.DEFAULT_SCENARIOS, p_req.DEFAULT_SCENARIOS),
                         ([sc_j], [sc_p])):
        assert [dataclasses.asdict(s) for s in scs_j] \
            == [dataclasses.asdict(s) for s in scs_p]
        gj = j_req.WorkloadGenerator(scs_j, base_rps=rate, seed=seed,
                                     tidal=tidal)
        gp = p_req.WorkloadGenerator(scs_p, base_rps=rate, seed=seed,
                                     tidal=tidal)
        rj, rp = gj.arrivals(horizon), gp.arrivals(horizon)
        assert rj and _asdicts(rj) == _asdicts(rp)
        # an explicit rate and single draws continue the same streams
        assert _asdicts(gj.arrivals(5.0, rate=rate / 2)) \
            == _asdicts(gp.arrivals(5.0, rate=rate / 2))
        assert dataclasses.asdict(gj.make_request(1.5)) \
            == dataclasses.asdict(gp.make_request(1.5))
    for t in (0.0, 3600.0, 43200.0, 86399.0, 100000.0):
        assert j_req.tidal_rate(8.0, t) == p_req.tidal_rate(8.0, t)
        assert j_req.tidal_rate(8.0, t, period=600.0, trough=0.1) \
            == p_req.tidal_rate(8.0, t, period=600.0, trough=0.1)


@pytest.mark.parametrize("per_layer", [False, True])
@pytest.mark.parametrize("mode", ["block_free", "block_fixed"])
@pytest.mark.parametrize("policy", ["ondemand", "baseline"])
def test_run_workload_equal(policy, mode, per_layer):
    """The metrics dict, the completed and failed rid sequences, the D2D
    times and every request's stamps, at a load where both policies fail
    requests (2P:4D at 60 req/s of the default scenarios)."""
    jprof, pprof = sim_profiles()
    out = []
    for sim_mod, req_mod, prof in ((j_sim, j_req, jprof),
                                   (p_sim, p_req, pprof)):
        reqs = req_mod.WorkloadGenerator(base_rps=60, seed=5).arrivals(
            HORIZON)
        cfg = sim_mod.SimConfig(profile=prof, transfer_mode=mode,
                                per_layer_transfer=per_layer)
        sim = sim_mod.ClusterSim(cfg, n_prefill=2, n_decode=4,
                                 policy=policy, seed=1)
        m = sim_mod.run_workload(sim, reqs, HORIZON + 15)
        out.append((m, sim_trace(sim, reqs), sim.clock.t))
    assert out[0] == out[1]
    m = out[0][0]
    assert m["completed"] > 0 and m["failed"] > 0, m


def test_aggregated_run_equal():
    """AggregatedSim.run: the metrics dict, the completed and failed
    sequences and every request's stamps."""
    jprof, pprof = sim_profiles()
    out = []
    for agg_mod, req_mod, prof in ((j_agg, j_req, jprof),
                                   (p_agg, p_req, pprof)):
        reqs = req_mod.WorkloadGenerator(base_rps=40, seed=21).arrivals(
            HORIZON)
        sim = agg_mod.AggregatedSim(prof, n_instances=4, b_p=4, b_d=6,
                                    seed=1)
        m = sim.run(reqs, HORIZON + 15)
        out.append((m, sim_trace(sim, reqs)))
    assert out[0] == out[1]
    assert out[0][0]["completed"] > 0


def test_serving_profile_and_profile_for():
    """ServingProfile's costs equal JAX's on the same fields; the port's
    profile_for keeps JAX's arithmetic at the H100's rates and the f32
    the port serves: KV and params bytes twice bf16's, the prefill rate
    and decode floors scaled by the ratio of the two chips' rates."""
    jprof, pprof = sim_profiles()
    for tokens, hit in ((1, 0), (512, 0), (8000, 3000), (100, 400)):
        assert jprof.ttft(tokens, hit) == pprof.ttft(tokens, hit)
    for n in (0, 1, 8, 16):
        assert jprof.tpot(n) == pprof.tpot(n)
    for arch in ("granite-3-8b", "qwen2-moe-a2.7b", "mamba2-2.7b"):
        j = j_prof.profile_for(jax_config(arch))
        p = p_prof.profile_for(port_config(arch))
        assert p.kv_bytes_per_token == 2 * j.kv_bytes_per_token
        assert p.params_bytes == 2 * j.params_bytes
        assert p.prefill_tok_rate == pytest.approx(
            j.prefill_tok_rate * 67e12 / 197e12, rel=1e-12)
        assert p.tpot_base == pytest.approx(
            j.tpot_base * 2 * 819e9 / 3.35e12, rel=1e-12)
        assert p.tpot_per_req == pytest.approx(
            j.tpot_per_req * 2 * 819e9 / 3.35e12, rel=1e-12)
        assert (p.prefill_fixed, p.prefix_reuse_eff) \
            == (j.prefill_fixed, j.prefix_reuse_eff)
    assert p_prof.CARDS_PER_INSTANCE == j_prof.CHIPS_PER_INSTANCE == 8


def test_perf_model_helpers_equal():
    """mismatch, continuous_ratio and BottleneckMonitor's recommendations
    over a seeded record stream that degrades twice (once on each side)."""
    import random
    rng = random.Random(4)
    for _ in range(50):
        kw = dict(ttft_bs=rng.uniform(0.05, 2.0), b_p=rng.randint(1, 16),
                  r_pre=rng.uniform(0.2, 1.0),
                  tpot_bs=rng.uniform(0.005, 0.1), b_d=rng.randint(4, 64),
                  gen_tokens=rng.uniform(8, 512), xi=rng.uniform(0, 0.1))
        jp, pp = j_pm.InstanceProfile(**kw), p_pm.InstanceProfile(**kw)
        assert j_pm.continuous_ratio(jp) == p_pm.continuous_ratio(pp)
        total = rng.randint(4, 40)
        for n_p in range(1, total):
            assert j_pm.mismatch(jp, n_p, total - n_p) \
                == p_pm.mismatch(pp, n_p, total - n_p)
    mons = (j_pm.BottleneckMonitor(window=20),
            p_pm.BottleneckMonitor(window=20))
    recs = ([], [])
    for i in range(300):
        phase = i // 60
        e2e = 1.0 + 0.4 * phase + rng.uniform(0, 0.1)
        ttft = (0.2 if phase % 2 else 0.5) * e2e
        if i % 37 == 0:
            e2e = -1.0          # ignored sample
        for mon, rec in zip(mons, recs):
            mon.record(ttft, e2e)
            rec.append(mon.recommendation())
    assert recs[0] == recs[1]
    assert {"more_prefill", "more_decode"} <= set(recs[0])
    assert mons[0]._e2e == mons[1]._e2e
