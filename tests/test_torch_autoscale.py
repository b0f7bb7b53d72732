"""The port's SLO-goodput autoscaler (repro_torch/serving/autoscale.py)
against the JAX package's, event for event.

The GoodputModel capacity law and the NodePool accounting are pure
Python and must give JAX's numbers exactly. Served end to end under a
DeterministicService, a burst then a trickle must scale the group up and
back down with the same scale ops, ledgers, MetaStore audit log and
tokens as JAX (absorption off on both sides: tests/test_torch_absorb.py
holds the absorb rung), and a crash during a scale op stays
deterministic and token-identical to a static run.
"""
import pytest

from repro.core.mlops import GoodputModel as JaxGoodput
from repro.core.mlops import SLOSpec as JaxSLO
from repro.serving.autoscale import AutoScaler as JaxScaler
from repro.serving.autoscale import NodePool as JaxPool
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.faults import DeterministicService as JaxService
from repro.serving.faults import FaultEvent as JaxEvent
from repro.serving.faults import FaultPlan as JaxPlan
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.core.mlops import GoodputModel, SLOSpec
from repro_torch.core.profiles import NODE_CLASSES
from repro_torch.serving.autoscale import AutoScaler, NodePool
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                        FaultPlan)
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import (assert_pools_clean, both_params,
                          control_signature, seeded_requests,
                          transfer_ledgers)

ARCH = "granite-3-8b"
SIDES = {
    "jax": dict(Frontend=JaxFrontend, Request=JaxRequest, Plan=JaxPlan,
                Event=JaxEvent, Service=JaxService, SLO=JaxSLO,
                Goodput=JaxGoodput, Pool=JaxPool, Scaler=JaxScaler),
    "port": dict(Frontend=ClusterFrontend, Request=ServeRequest,
                 Plan=FaultPlan, Event=FaultEvent,
                 Service=DeterministicService, SLO=SLOSpec,
                 Goodput=GoodputModel, Pool=NodePool, Scaler=AutoScaler),
}
# slow prefill: the burst is TTFT-bound at ~50 req/s per node, so a
# 500 req/s burst forces the scaler's hand
SVC = dict(prefill_base_s=0.02, prefill_per_token_s=5e-4)
SLO = dict(ttft_s=0.06, tpot_s=0.01)


def _frontend(side, events=(), **kw):
    cfg, jp, pcfg, tp = both_params(ARCH)
    S = SIDES[side]
    kw.setdefault("topology", {"default": (1, 1)})
    kw.setdefault("prefill_kwargs", {"batch_size": 2})
    if events:
        kw.update(faults=S["Plan"]([S["Event"](*e) for e in events]),
                  health_timeout_s=0.05,
                  fault_kwargs={"heartbeat_s": 0.02,
                                "recover_delay_s": 0.05})
    if side == "port":
        kw["device"] = "cpu"
    return S["Frontend"](pcfg if side == "port" else cfg,
                         params=tp if side == "port" else jp,
                         service_model=S["Service"](**SVC),
                         absorb_prefill=False, **kw)


def _scaler(side, fe, inventory):
    S = SIDES[side]
    pool = S["Pool"](inventory, provision_scale=0.002)
    return pool, S["Scaler"](fe, pool, S["SLO"](**SLO), period_s=0.05,
                             window_s=0.5, cooldown_s=0.1)


def _burst(side, fe, *, n=60, trickle=10, max_new=4):
    R = SIDES[side]["Request"]
    vocab = fe.cfg.vocab_size
    rs = seeded_requests(R, vocab, n, max_new=max_new, slo_deadline_s=4.0)
    for i, r in enumerate(rs):
        fe.submit(r, at=0.002 * i)            # 500 req/s for n*2 ms
    tail = seeded_requests(R, vocab, trickle, seed=9, rid0=1000,
                           max_new=max_new, slo_deadline_s=4.0)
    for i, r in enumerate(tail):
        fe.submit(r, at=1.0 + 0.2 * i)        # idle-ish tail: shrink
    return rs + tail


def _tokens(reqs):
    return {r.rid: tuple(r.generated) for r in reqs}


# --------------------------------------------------- capacity law, pool

@pytest.mark.parametrize("stats", [
    {},
    {"prefill_batch_median_s": 0.01},
    {"prefill_batch_median_s": 0.02, "decode_step_median_s": 0.002},
    {"prefill_batch_median_s": 0.07, "decode_step_median_s": 0.002},
    {"prefill_batch_median_s": 0.02, "decode_step_median_s": 0.02},
    {"prefill_batch_median_s": 0.013, "decode_step_median_s": 0.0031},
])
def test_goodput_model_matches_jax(stats):
    """from_stats gating, headroom, both capacities, goodput and
    nodes_needed on the same inputs: equal floats."""
    def law(side):
        S = SIDES[side]
        m = S["Goodput"].from_stats(S["SLO"](**SLO), stats, batch_size=2,
                                    decode_slots=8, gen_tokens=4.0)
        if m is None:
            return None
        return (m.prefill_headroom(),
                [m.prefill_capacity(n) for n in (0.5, 1.0, 2.0, 2.6)],
                [m.decode_capacity(n) for n in (0.5, 1.0, 2.0, 2.6)],
                [m.goodput(r, 1.0, 1.6) for r in (5.0, 50.0, 5000.0)],
                [m.nodes_needed(r) for r in (1.0, 75.0, 900.0)])

    assert law("port") == law("jax")
    if len(stats) < 2:
        assert law("port") is None


def test_node_pool_matches_jax():
    """Role-biased lease order, idempotent release (a crashed node is
    never counted twice), adopt, provisioning delay and the ledger, on
    one script of calls."""
    def script(side):
        pool = SIDES[side]["Pool"](
            {"balanced": 1, "prefill-heavy": 1, "decode-heavy": 1},
            provision_scale=0.5)
        out = [getattr(pool.lease(role, iid), "name", None)
               for role, iid in (("P", "a"), ("P", "b"), ("D", "c"),
                                 ("P", "d"))]
        out += [pool.release(x) for x in ("a", "a", "never", "c")]
        pool.adopt("decode-heavy")
        pool.adopt("unknown-class")
        out += [pool.lease("D", "e").name, dict(pool.free),
                dict(pool.leases)]
        out += [pool.provision_delay(pool.classes[n])
                for n in sorted(pool.classes)]
        return out, pool.ledger()

    mine = script("port")
    assert mine == script("jax")
    leases = mine[0][:4]
    assert leases == ["prefill-heavy", "balanced", "decode-heavy", None]
    assert mine[0][4:8] == [True, False, False, True]
    assert sorted(NODE_CLASSES) == ["balanced", "decode-heavy",
                                    "prefill-heavy"]


# --------------------------------------------------- scale up / down

def test_burst_scales_up_then_trickle_scales_down():
    sigs, runs = {}, {}
    for side in ("port", "jax"):
        fe = _frontend(side)
        pool, sc = _scaler(side, fe, {"prefill-heavy": 2,
                                      "decode-heavy": 2})
        rs = _burst(side, fe)
        fe.serve(watch=rs, max_events=500_000)
        g = fe.groups["default"]
        assert all(r.done and not r.shed for r in rs)
        st = g.transfer_stats()
        assert st["scale_up_done"] >= 1            # burst forced a lease
        assert st["scale_down_done"] >= 1          # trickle drained it
        assert st["scale_up_done"] == st["scale_up_started"]
        assert st["scale_down_done"] == st["scale_down_started"]
        led = pool.ledger()
        assert led["pool_leased"] == 0.0 and led["pool_free"] == 4.0
        assert led["pool_leases_total"] == led["pool_releases_total"]
        assert [n.iid for n in g.prefills] == ["g0/P0"]
        assert [n.iid for n in g.decodes] == ["g0/D0"]
        ups = [o for o in sc.ops if o.kind == "up"]
        assert ups and all(o.ncls == "prefill-heavy" for o in ups
                           if o.role == "P")
        assert_pools_clean(g)
        sigs[side] = control_signature(fe, rs)
        runs[side] = fe
    assert sigs["port"] == sigs["jax"]
    for sc_name, (mine, theirs) in transfer_ledgers(
            runs["port"], runs["jax"]).items():
        assert mine == theirs, sc_name


def test_adjuster_stands_down_during_scale_op():
    """While a scale op is in flight the RatioAdjuster stands down and
    forgets a half-confirmed flip; with the op cleared it is live again
    and the run completes on both sides alike."""
    sigs = {}
    for side in ("port", "jax"):
        fe = _frontend(side, topology={"default": (2, 2)},
                       adjust_ratio=True)
        adj = fe.adjusters["default"]
        g = fe.groups["default"]
        adj._last_want = "P->D"                    # half-confirmed flip
        g.scale_op = object()                      # scale in flight
        assert adj.maybe_adjust(adj.interval, backlog=50) is None
        assert adj._last_want is None
        g.scale_op = None
        rs = seeded_requests(SIDES[side]["Request"], fe.cfg.vocab_size, 12)
        for i, r in enumerate(rs):
            fe.submit(r, at=0.001 * i)
        fe.serve(watch=rs, max_events=200_000)
        assert all(r.done for r in rs)
        assert_pools_clean(g)
        sigs[side] = control_signature(fe, rs)
    assert sigs["port"] == sigs["jax"]


# --------------------------------------------------- chaos composition

def _chaos_run(side, events, inventory):
    fe = _frontend(side, events, topology={"default": (1, 2)},
                   prefill_kwargs={"batch_size": 1})
    pool, sc = _scaler(side, fe, inventory)
    rs = _burst(side, fe, n=40, trickle=6)
    fe.serve(watch=rs, max_events=500_000)
    return fe, pool, rs


@pytest.mark.parametrize("case", [
    ("g0/D0", 0.0513, {"prefill-heavy": 1, "balanced": 1}),
    ("g0/S0", 0.3, {"prefill-heavy": 2}),
])
def test_crash_during_scale_deterministic_and_token_identical(case):
    """Crash a decode node mid-burst while the scaler provisions, or the
    node the scaler leased: the same plan gives identical audit logs and
    ledgers twice, equal to JAX's; every served request is
    token-identical to a fault-free static run; a crashed leased node is
    never counted twice in the pool."""
    target, t_crash, inventory = case
    ref = _frontend("port", topology={"default": (2, 3)},
                    prefill_kwargs={"batch_size": 1})
    ref_rs = _burst("port", ref, n=40, trickle=6)
    ref.serve(watch=ref_rs, max_events=500_000)
    golden = _tokens(ref_rs)
    events = [(t_crash, "crash", target, 0.05)]
    sigs = []
    for side in ("port", "port", "jax"):
        fe, pool, rs = _chaos_run(side, events, inventory)
        g = fe.groups["default"]
        assert all(r.done or r.shed for r in rs)
        for r in rs:
            if r.done and not r.shed:
                assert tuple(r.generated) == golden[r.rid], r.rid
        st = g.transfer_stats()
        assert st["ft_crashes"] >= 1
        assert st["scale_up_started"] >= st["scale_up_done"]
        assert st["scale_down_started"] >= st["scale_down_done"]
        led = pool.ledger()
        assert led["pool_leased"] == (led["pool_leases_total"]
                                      - led["pool_releases_total"])
        assert led["pool_free"] + led["pool_leased"] == \
            sum(inventory.values()) + led["pool_adopted"]
        assert_pools_clean(g)
        sigs.append((control_signature(fe, rs),
                     {k: v for k, v in st.items()
                      if k.startswith(("ft_", "scale_"))}))
    assert sigs[0] == sigs[1] == sigs[2]
