"""The port's P/D groups, MLOps, regions and prefix-cache registries
against the JAX package's, exactly: event timelines, MetaStore state,
fault records, scale and ratio decisions, routing, and every lookup of
the prefix caches under drawn operation sequences."""
import dataclasses
import itertools

import pytest
from hypothesis import given, settings, strategies as st

from repro.core import cluster_sim as j_sim
from repro.core import group as j_group
from repro.core import mlops as j_mlops
from repro.core import perf_model as j_pm
from repro.core import prefix_cache as j_pc
from repro.core import regions as j_reg
from repro.core import requests as j_req
from repro.core import zookeeper as j_zk
from repro_torch.core import cluster_sim as p_sim
from repro_torch.core import group as p_group
from repro_torch.core import mlops as p_mlops
from repro_torch.core import perf_model as p_pm
from repro_torch.core import prefix_cache as p_pc
from repro_torch.core import regions as p_reg
from repro_torch.core import requests as p_req
from repro_torch.core import zookeeper as p_zk
from torch_parity import sim_profiles, sim_trace

SIDES = ((j_group, j_mlops, j_pm, j_zk), (p_group, p_mlops, p_pm, p_zk))


@pytest.fixture
def fresh_iids(monkeypatch):
    """Both packages number instances from one module-level counter;
    restart both so the two sides name their instances alike."""
    for g in (j_group, p_group):
        monkeypatch.setattr(g, "_iid", itertools.count())


def _meta_state(meta, gids):
    return ({iid: dataclasses.asdict(m) for iid, m in meta.instances.items()},
            {g: (meta.group_members(g, "P"), meta.group_members(g, "D"))
             for g in gids})


def _timeline(g):
    return [dataclasses.asdict(e) for e in g.timeline]


def test_group_workflows_equal(fresh_iids):
    """PDGroup setup, adjust_ratio (grow, shrink, swap) and a rolling
    upgrade over three groups: equal event timelines, completion times,
    ratios and MetaStore state, in both storage tiers."""
    out = []
    for group_mod, _, _, zk in SIDES:
        meta = zk.MetaStore()
        groups = [group_mod.PDGroup(f"g{i}", f"s{i}", meta, storage=st_)
                  for i, st_ in enumerate(("ssd", "sfs", "ssd"))]
        ts = [g.setup(10.0 * i, 2 + i, 3) for i, g in enumerate(groups)]
        ts.append(groups[0].adjust_ratio(300.0, 3, 4))
        ts.append(groups[0].adjust_ratio(ts[-1], 3, 2))
        ts.append(groups[1].adjust_ratio(400.0, 1, 5))
        ts.append(groups[2].rolling_upgrade(500.0, groups))
        out.append((ts, [_timeline(g) for g in groups],
                    [g.ratio for g in groups],
                    _meta_state(meta, [g.gid for g in groups])))
    assert out[0] == out[1]


def test_mlops_decisions_equal(fresh_iids):
    """Recovery under a seeded NodeMonitor (its FaultRecords), tidal
    auto-scaling over a day, and ratio moves from a BottleneckMonitor:
    equal decisions, records, timelines and MetaStore state."""
    out = []
    for group_mod, mlops_mod, pm, zk in SIDES:
        meta = zk.MetaStore()
        g = group_mod.PDGroup("svcA/chat#g0", "svcA/chat", meta)
        t = g.setup(0.0, 2, 4)
        ml = mlops_mod.MLOps(meta, mlops_mod.NodeMonitor(
            seed=4, fault_rate_per_hour=2.0))
        prof = pm.InstanceProfile(ttft_bs=0.4, b_p=4, r_pre=0.8,
                                  tpot_bs=0.03, b_d=16, gen_tokens=200)
        mon = pm.BottleneckMonitor(window=10)
        acts = []
        k = 0
        while t < 86400.0:
            acts.append(ml.auto_scale(t, g, base_rps=40.0,
                                      rps_capacity_per_pair=11.0))
            acts.append([dataclasses.asdict(r) for r in
                         ml.check_and_recover(t, g, dt_hours=0.5)])
            for _ in range(5):
                k += 1
                e2e = 1.0 + (k // 40) * 0.3
                mon.record((0.6 if (k // 40) % 2 else 0.2) * e2e, e2e)
            acts.append(ml.maybe_adjust_ratio(t, g, mon, prof))
            acts.append(g.ratio)
            t += 1800.0
        acts.append(ml.recommend_ratio(prof, 12))
        victim = g.members("D")[0]
        acts.append(dataclasses.asdict(
            ml.recover(t, g, victim, "device_reset")))
        out.append((acts, [dataclasses.asdict(r) for r in ml.faults],
                    ml.scale_events, _timeline(g),
                    _meta_state(meta, [g.gid])))
    assert out[0] == out[1]
    acts = out[0][0]
    assert out[0][1], "the monitor should have injected faults"
    assert "scale_out" in acts and "scale_in" in acts
    assert "more_prefill" in acts or "more_decode" in acts
    for lvl in ("recoverable", "device_reset", "node_replace"):
        assert j_mlops.substitute_ready_delay(lvl, storage="sfs") \
            == p_mlops.substitute_ready_delay(lvl, storage="sfs")


def _router(reg, sim_mod, prof, sc_name, names):
    regions = [reg.Region(n, {sc_name: sim_mod.ClusterSim(
        sim_mod.SimConfig(profile=prof), n_prefill=2, n_decode=4,
        policy="ondemand", seed=1 + i)}) for i, n in enumerate(names)]
    return reg.ServiceRouter(regions, seed=0), regions


@pytest.mark.parametrize("case", ["balance", "fail", "restore", "all_down"])
def test_service_router_equal(case):
    """ServiceRouter route, region failure mid-run, restore, and every
    region down: equal metrics (routed counts, drops) and per-region
    completed and failed sequences."""
    jprof, pprof = sim_profiles()
    out = []
    for reg, sim_mod, req_mod, prof in ((j_reg, j_sim, j_req, jprof),
                                        (p_reg, p_sim, p_req, pprof)):
        sc = req_mod.Scenario("svc/x", "svc", 512, 2, 128, 32, 64, 16, 3.0)
        names = ["r1"] if case == "all_down" else ["r1", "r2", "r3"]
        router, regions = _router(reg, sim_mod, prof, sc.name, names)
        reqs = req_mod.WorkloadGenerator([sc], base_rps=15,
                                         seed=4).arrivals(30.0)
        kw = {}
        if case == "all_down":
            router.fail_region("r1")
        elif case == "fail":
            kw = dict(fail_at=12.0, fail_region="r2")
        elif case == "restore":
            router.fail_region("r3")
            router.restore_region("r3")
            router.fail_region("r1")
        m = router.run(reqs, 45.0, **kw)
        out.append((m, [sim_trace(r.sims[sc.name], []) for r in regions],
                    [r.healthy for r in regions]))
    assert out[0] == out[1]
    m = out[0][0]
    assert (m["dropped"] > 0) == (case == "all_down"), m


def _pc_state(c):
    """A PrefixCache's counters, hit rate and entries in LRU order."""
    return (c.used, c.hits, c.misses, c.evictions, c.state_bytes,
            c.hit_rate, len(c),
            [dataclasses.asdict(e) for e in c._entries.values()])


def _ops(kinds):
    return st.lists(st.tuples(st.sampled_from(kinds), st.integers(0, 9),
                              st.integers(1, 64)), min_size=1, max_size=40)


@settings(max_examples=25, deadline=None)
@given(budget=st.integers(1 << 8, 1 << 14),
       bpt=st.sampled_from([4, 16, 64]), state=st.sampled_from([0, 96]),
       ops=_ops(["lookup", "insert", "drop"]))
def test_prefix_cache_equal(budget, bpt, state, ops):
    """PrefixCache: equal lookups and insert results, equal counters and
    LRU order, invariant_ok on both after every operation."""
    caches = (j_pc.PrefixCache(budget, bpt, state),
              p_pc.PrefixCache(budget, bpt, state))
    for op, pid, ln in ops:
        args = (f"p{pid}",) if op == "drop" else (f"p{pid}", ln)
        got = [getattr(c, op)(*args) for c in caches]
        assert got[0] == got[1]
        assert caches[0].invariant_ok() and caches[1].invariant_ok()
        assert _pc_state(caches[0]) == _pc_state(caches[1])
        assert (f"p{pid}" in caches[0]) == (f"p{pid}" in caches[1])


@settings(max_examples=25, deadline=None)
@given(hbm=st.integers(100, 2000), host=st.integers(100, 5000),
       ops=_ops(["lookup", "insert"]))
def test_tiered_prefix_cache_equal(hbm, host, ops):
    """TieredPrefixCache: equal (tokens, load seconds) lookups, spills and
    promotions, invariant_ok on both after every operation."""
    caches = (j_pc.TieredPrefixCache(hbm, host, 10),
              p_pc.TieredPrefixCache(hbm, host, 10))
    for op, pid, ln in ops:
        got = [getattr(c, op)(f"p{pid}", ln) for c in caches]
        assert got[0] == got[1]
        assert caches[0].invariant_ok() and caches[1].invariant_ok()
        state = [(c.host_hits, _pc_state(c.hbm), _pc_state(c.host))
                 for c in caches]
        assert state[0] == state[1]
