"""The port's decode-side prefill absorption (ServeGroup.try_absorb,
the ``absorb`` event, AbsorbJob) against the JAX package's, event for
event.

Under a DeterministicService both sides charge the same closed-form
virtual seconds, so the event log, the MetaStore audit log, the fault
log, the ``absorb_*`` counters, the scale ledger and the tokens must be
EQUAL, with no tolerance: the exhausted-pool scenario of the JAX
autoscaler tests (the burst is carried by absorption and gateway backoff
when no spare node exists), and a decode node crashing while it absorbs
(the job dies with the node and its request is re-offered).
"""
import pytest

from repro.serving.cluster import ServeRequest as JaxRequest
from repro.core.mlops import SLOSpec as JaxSLO
from repro.serving.autoscale import AutoScaler as JaxScaler
from repro.serving.autoscale import NodePool as JaxPool
from repro.serving.faults import DeterministicService as JaxService
from repro.serving.faults import FaultEvent as JaxEvent
from repro.serving.faults import FaultPlan as JaxPlan
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.core.mlops import SLOSpec
from repro_torch.serving.autoscale import AutoScaler, NodePool
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                        FaultPlan)
from repro_torch.serving import frontend
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import (assert_pools_clean, both_params,
                          control_signature, seeded_requests,
                          transfer_ledgers)

ARCH = "granite-3-8b"
SIDES = {
    "jax": dict(Frontend=JaxFrontend, Request=JaxRequest, Plan=JaxPlan,
                Event=JaxEvent, Service=JaxService, SLO=JaxSLO,
                Pool=JaxPool, Scaler=JaxScaler),
    "port": dict(Frontend=ClusterFrontend, Request=ServeRequest,
                 Plan=FaultPlan, Event=FaultEvent,
                 Service=DeterministicService, SLO=SLOSpec, Pool=NodePool,
                 Scaler=AutoScaler),
}
# the JAX autoscaler tests' slow prefill: a burst of 500 req/s is
# TTFT-bound at ~50 req/s per node
SVC = dict(prefill_base_s=0.02, prefill_per_token_s=5e-4)
ABSORB_KEYS = ("absorb_requests", "absorb_chunks", "absorb_tokens",
               "absorb_displaced")


def _frontend(side, events=(), recover_s=0.05, **kw):
    cfg, jp, pcfg, tp = both_params(ARCH)
    S = SIDES[side]
    kw.setdefault("topology", {"default": (1, 1)})
    kw.setdefault("prefill_kwargs", {"batch_size": 2})
    if events:
        kw.update(faults=S["Plan"]([S["Event"](*e) for e in events]),
                  health_timeout_s=0.05,
                  fault_kwargs={"heartbeat_s": 0.02,
                                "recover_delay_s": recover_s})
    if side == "port":
        kw["device"] = "cpu"
    return S["Frontend"](pcfg if side == "port" else cfg,
                         params=tp if side == "port" else jp,
                         service_model=S["Service"](**SVC),
                         absorb_prefill=True, **kw)


def _submit(fe, reqs, t0=0.0, dt=0.002):
    for i, r in enumerate(reqs):
        fe.submit(r, at=t0 + dt * i)
    return reqs


def _absorbs(fe):
    st = fe.groups["default"].transfer_stats()
    return {k: st[k] for k in ABSORB_KEYS}


def _exhausted(side):
    """JAX's test_exhausted_pool_degrades_gracefully: an autoscaler over
    an EMPTY node pool, three decoded requests first (the goodput model
    needs a measured decode step), then a prefill-complete burst of 60
    (max_new 0: the decode node stays idle, the only regime absorption
    may run in) and a trickle of 10."""
    S = SIDES[side]
    fe = _frontend(side)
    pool = S["Pool"]({}, provision_scale=0.002)
    S["Scaler"](fe, pool, S["SLO"](ttft_s=0.06, tpot_s=0.01), period_s=0.05,
                window_s=0.5, cooldown_s=0.1)
    R, vocab = S["Request"], fe.cfg.vocab_size
    warm = _submit(fe, seeded_requests(
        R, vocab, 3, seed=11, rid0=500, max_new=2, slo_deadline_s=4.0))
    burst = _submit(fe, seeded_requests(
        R, vocab, 60, max_new=0, slo_deadline_s=4.0))
    trickle = _submit(fe, seeded_requests(
        R, vocab, 10, seed=9, rid0=1000, max_new=0, slo_deadline_s=4.0),
        t0=1.0, dt=0.2)
    reqs = warm + burst + trickle
    fe.serve(watch=reqs, max_events=500_000)
    return fe, pool, reqs


def test_exhausted_pool_absorbs_like_jax():
    runs = {side: _exhausted(side) for side in ("port", "jax")}
    fe, pool, reqs = runs["port"]
    g = fe.groups["default"]
    assert all(r.done for r in reqs)
    assert pool.n_denied >= 1
    st = g.transfer_stats()
    assert st["scale_denied"] >= 1
    assert st["absorb_requests"] >= 1 and st["absorb_chunks"] \
        >= st["absorb_requests"]
    assert_pools_clean(g)
    assert control_signature(fe, reqs) == control_signature(
        runs["jax"][0], runs["jax"][2])
    assert _absorbs(fe) == _absorbs(runs["jax"][0])
    for sc, (mine, theirs) in transfer_ledgers(fe, runs["jax"][0]).items():
        assert mine == theirs, sc


def _crash_burst(side, events=(), recover_s=0.05):
    """1P:1D, prefill batch 1: a burst of 12 prefill-complete requests
    (two of them decoded), which the prefill node cannot take alone; the
    idle decode node absorbs some of them."""
    fe = _frontend(side, events, recover_s=recover_s,
                   prefill_kwargs={"batch_size": 1})
    R = SIDES[side]["Request"]
    reqs = seeded_requests(R, fe.cfg.vocab_size, 12, max_new=0, lo=20,
                           hi=40)
    reqs += seeded_requests(R, fe.cfg.vocab_size, 2, seed=5, rid0=100,
                            max_new=3)
    _submit(fe, reqs)
    return fe, reqs


def absorb_crash_time():
    """A virtual time inside the first absorb job's first chunk: its
    first ``absorb`` event in the port's fault-free run, plus 1 ms (a
    16-token chunk charges 28 ms here)."""
    fe, reqs = _crash_burst("port")
    fe.serve(watch=reqs, max_events=200_000)
    first = min(t for t, k in fe.groups["default"].event_log
                if k == "absorb")
    return fe, reqs, first + 0.001


def test_decode_crash_kills_absorb_job_like_jax():
    """The decode node crashes while it absorbs: the job dies with it
    (absorb_displaced 1), its request is re-offered and served; the
    event, fault and audit logs equal JAX's and every request's tokens
    equal the fault-free run's."""
    base_fe, base, t_crash = absorb_crash_time()
    assert _absorbs(base_fe)["absorb_requests"] >= 1
    ev = [(t_crash, "crash", "g0/D0", 0.05)]
    sigs = {}
    for side in ("port", "jax"):
        fe, reqs = _crash_burst(side, ev)
        fe.serve(watch=reqs, max_events=200_000)
        g = fe.groups["default"]
        assert g.ft.n_crashes == 1
        assert all(r.done and not r.shed for r in reqs)
        assert_pools_clean(g)
        sigs[side] = (control_signature(fe, reqs), _absorbs(fe))
        if side == "port":
            assert _absorbs(fe)["absorb_displaced"] == 1
            assert {r.rid: r.generated for r in reqs} == \
                {r.rid: r.generated for r in base}
            port_fe = fe
        else:
            for sc, (mine, theirs) in transfer_ledgers(port_fe,
                                                       fe).items():
                assert mine == theirs, sc
    assert sigs["port"] == sigs["jax"]


@pytest.mark.parametrize("chunk_tokens", [8, 16, 32])
def test_absorbed_tokens_equal_prefill_tokens(chunk_tokens, monkeypatch):
    """Whatever the chunk size, an absorbed request's first token (and a
    decoded one's stream) equals the same request served by prefill
    nodes only; the chunk and token counters add up."""
    monkeypatch.setattr(frontend, "ABSORB_CHUNK_TOKENS", chunk_tokens)
    fe, reqs = _crash_burst("port")
    fe.serve(watch=reqs, max_events=200_000)
    ref = ClusterFrontend(fe.cfg, params=fe.params, device="cpu",
                          topology={"default": (2, 1)},
                          prefill_kwargs={"batch_size": 1})
    want = seeded_requests(ServeRequest, fe.cfg.vocab_size, 12, max_new=0,
                           lo=20, hi=40) + seeded_requests(
        ServeRequest, fe.cfg.vocab_size, 2, seed=5, rid0=100, max_new=3)
    ref.run(want)
    assert {r.rid: r.generated for r in reqs} == \
        {r.rid: r.generated for r in want}
    ab = _absorbs(fe)
    assert ab["absorb_requests"] >= 1 and ab["absorb_displaced"] == 0
    assert ab["absorb_chunks"] >= ab["absorb_requests"]
    assert ab["absorb_requests"] <= ab["absorb_tokens"] \
        <= sum(len(r.tokens) for r in reqs)
