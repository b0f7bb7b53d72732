"""The port's fault injection and token-exact recovery
(repro_torch/serving/faults.py) against the JAX package's, event for
event.

Both sides serve the same seeded prompts on identical weights with a
DeterministicService charging the virtual time, so every number of the
control plane is a Python float computed the same way: the event log,
the MetaStore audit log, the fault controller's log and ledger, the
transfer ledger and the tokens must be EQUAL, with no tolerance. Each
chaos run is also held token-identical to the port's fault-free run,
and every pool must keep its invariants.
"""
import dataclasses
import gc
import weakref

import pytest

from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.faults import DeterministicService as JaxService
from repro.serving.faults import FaultEvent as JaxEvent
from repro.serving.faults import FaultPlan as JaxPlan
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                        FaultPlan)
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import (assert_pools_clean, both_params,
                          control_signature, moe_sorted, seeded_requests,
                          transfer_ledgers)

ARCH = "granite-3-8b"
# dense / MoE / attention-free SSM / hybrid: every payload shape the
# transfer and recovery path must survive
CHAOS_FAMILIES = [ARCH, "qwen2-moe-a2.7b", "mamba2-2.7b",
                  "jamba-1.5-large-398b"]
SIDES = {
    "jax": (JaxFrontend, JaxRequest, JaxPlan, JaxEvent, JaxService),
    "port": (ClusterFrontend, ServeRequest, FaultPlan, FaultEvent,
             DeterministicService),
}


def _frontend(side, arch, events=(), *, plan=None, topo=(1, 2),
              recover_s=0.05, heartbeat_s=0.02, timeout_s=0.05,
              overlap=True):
    """A chaos frontend of ``side`` over the shared weights: prefill
    batch size 1 (batch composition cannot move the bits), the service
    model on, a FaultPlan of ``events`` (t, kind, target, duration)."""
    cfg, jp, pcfg, tp = both_params(arch)
    Frontend, _, Plan, Event, Service = SIDES[side]
    if plan is None and events:
        plan = Plan([Event(*e) for e in events])
    kw = dict(device="cpu") if side == "port" else {}
    return Frontend(
        moe_sorted(pcfg if side == "port" else cfg),
        topology={"default": topo},
        params=tp if side == "port" else jp,
        prefill_kwargs={"batch_size": 1}, service_model=Service(),
        faults=plan, health_timeout_s=timeout_s,
        overlap_transfer=overlap,
        fault_kwargs={"heartbeat_s": heartbeat_s,
                      "recover_delay_s": recover_s}, **kw)


def _run(side, arch, n, events=(), *, t0=0.0, watch=True, req_kw=None,
         **kw):
    """Serve ``n`` seeded requests arriving 2 ms apart from ``t0``;
    returns (frontend, requests)."""
    fe = _frontend(side, arch, events, **kw)
    cfg = fe.cfg
    reqs = seeded_requests(SIDES[side][1], cfg.vocab_size, n,
                           **(req_kw or {}))
    for i, r in enumerate(reqs):
        fe.submit(r, at=t0 + 0.002 * i)
    fe.serve(watch=reqs if watch else None, max_events=200_000)
    return fe, reqs


def _both(arch, n, events=(), **kw):
    """The same run on both sides; asserts equal control-plane
    signatures and ledgers, clean pools. Returns the port's run."""
    pfe, preqs = _run("port", arch, n, events, **kw)
    jfe, jreqs = _run("jax", arch, n, events, **kw)
    assert control_signature(pfe, preqs) == control_signature(jfe, jreqs)
    for sc, (mine, theirs) in transfer_ledgers(pfe, jfe).items():
        assert mine == theirs, sc
    for g in pfe.groups.values():
        assert_pools_clean(g)
    return pfe, preqs


def _tokens(reqs):
    return {r.rid: list(r.generated) for r in reqs}


@pytest.mark.parametrize("overlap", [True, False])
def test_fault_free_event_log_matches_jax(overlap):
    """Pins the event core before any fault does: a fault-free 1P:2D run
    under the service model gives JAX's event log, audit log, ledgers
    and tokens exactly, in both transfer modes."""
    fe, reqs = _both(ARCH, 3, overlap=overlap)
    assert all(r.done and not r.shed for r in reqs)
    log = fe.groups["default"].event_log
    assert [k for _, k in log].count("step") > 0
    assert [t for t, _ in log] == sorted(t for t, _ in log)


@pytest.mark.parametrize("kind", ["decode", "prefill"])
@pytest.mark.parametrize("arch", CHAOS_FAMILIES)
def test_crash_token_identity_matches_jax(arch, kind):
    """Crash-kill a decode node mid-stream (its requests re-prefill
    prompt + emitted tokens elsewhere) or a prefill node (forming
    requests requeue, transfers it sourced die with it and re-admit):
    the port's log equals JAX's and its tokens equal its fault-free
    run's."""
    if kind == "decode":
        topo, n, ev = (1, 2), 3, (0.015, "crash", "g0/D0", 0.05)
    else:
        topo, n, ev = (2, 1), 4, (0.0045, "crash", "g0/P0", 0.05)
    _, base = _run("port", arch, n, topo=topo)
    assert all(r.done for r in base)
    fe, chaos = _both(arch, n, [ev], topo=topo)
    g = fe.groups["default"]
    assert g.ft.n_crashes == 1
    assert all(r.done and not r.shed for r in chaos)
    assert _tokens(chaos) == _tokens(base)
    if kind == "decode":
        assert g.ft.n_readmitted >= 1
        assert any(r.readmits for r in chaos)
    else:
        assert g.sched.n_src_failed >= 1
        assert g.ft.n_readmitted + g.ft.n_requeued >= 1


def test_crashed_decode_pool_is_freed_after_reboot():
    """The crashed node's pool, which took hand-offs before the crash, is
    unreachable once its substitute reboots: no completed transfer job,
    event or ledger keeps the dead node."""
    fe = _frontend("port", ARCH, [(0.015, "crash", "g0/D0", 0.05)])
    g = fe.groups["default"]
    crashed = weakref.ref(g.decodes[0].pool)
    reqs = seeded_requests(ServeRequest, fe.cfg.vocab_size, 3)
    for i, r in enumerate(reqs):
        fe.submit(r, at=0.002 * i)
    fe.serve(max_events=200_000)
    assert all(r.done for r in reqs) and g.ft.n_readmitted >= 1
    assert g.ft.n_restored == 1 and g.sched.n_admitted > len(reqs)
    assert crashed() is None


def test_crashed_absorbing_decode_pool_is_freed_after_reboot():
    """A decode node that crashes while it absorbs a chunked prefill
    frees its pool once its substitute reboots, with the cycle collector
    off, though the dead job's next chunk event is still queued: the job
    holds its node weakly (a strong back-reference keeps the pool until
    that event pops)."""
    cfg, _, pcfg, tp = both_params(ARCH)
    svc = DeterministicService(prefill_base_s=0.02, prefill_per_token_s=5e-4)

    def run(events=(), deadline=None):
        fe = ClusterFrontend(
            pcfg, params=tp, device="cpu", service_model=svc,
            absorb_prefill=True, prefill_kwargs={"batch_size": 1},
            faults=FaultPlan([FaultEvent(*e) for e in events]),
            health_timeout_s=0.05, fault_kwargs={"heartbeat_s": 0.02})
        reqs = seeded_requests(ServeRequest, cfg.vocab_size, 8, max_new=0,
                               lo=20, hi=40)
        for i, r in enumerate(reqs):
            fe.submit(r, at=0.002 * i)
        fe.serve(deadline=deadline, max_events=200_000)
        return fe, reqs

    base, _ = run()
    t0 = min(t for t, k in base.groups["default"].event_log if k == "absorb")
    t_crash, down = t0 + 0.001, 0.002       # inside a 28 ms chunk
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        fe, reqs = run([(t_crash, "crash", "g0/D0", down)],
                       deadline=t_crash)
        g = fe.groups["default"]
        node = g.decodes[0]
        assert node.crashed and node._absorb_job is None
        crashed = weakref.ref(node.pool)
        assert g.absorbs["absorb_displaced"] == 1
        del node
        fe.serve(deadline=t_crash + down + 1e-4, max_events=200_000)
        assert g.ft.n_restored == 1
        assert any(k == "absorb" and t > t_crash + down
                   for t, _, k, _ in g.events)   # the dead job's chunk
        assert crashed() is None
    finally:
        if enabled:
            gc.enable()
    fe.serve(watch=reqs, max_events=200_000)
    assert all(r.done for r in reqs)


def test_hang_ejected_at_exact_deadline_and_rejoins():
    """A node that hangs is ejected at EXACTLY its last report + the
    health timeout, its requests re-admit elsewhere, and the straggler
    rejoins with its memory when the hang ends."""
    hb, timeout = 0.02, 0.05
    _, base = _run("port", ARCH, 3)
    fe, reqs = _both(ARCH, 3, [(0.03, "hang", "g0/D0", 0.2)],
                     heartbeat_s=hb, timeout_s=timeout, watch=False)
    ft = fe.groups["default"].ft
    assert fe.meta.health_timeout_s == timeout
    ejects = [e for e in ft.log if e[1] == "eject"]
    assert len(ejects) == 1 and ejects[0][0] == pytest.approx(hb + timeout,
                                                             abs=1e-12)
    assert ft.n_restored == 1
    assert ft.recovery_walls[0] == pytest.approx(0.23 - (hb + timeout),
                                                 abs=1e-12)
    assert _tokens(reqs) == _tokens(base)


def test_short_hang_straggles_without_ejection():
    _, base = _run("port", ARCH, 2)
    fe, reqs = _both(ARCH, 2, [(0.01, "hang", "g0/D0", 0.03)],
                     timeout_s=0.5)
    ft = fe.groups["default"].ft
    assert ft.n_hangs == 1 and ft.n_ejected == 0
    assert _tokens(reqs) == _tokens(base)


def test_link_flap_retransmits():
    """A link outage in the middle of a hand-off: the in-flight stripe
    is sent again when the link returns, tokens unchanged."""
    _, base = _run("port", ARCH, 3)
    fe, reqs = _both(ARCH, 3, [(0.003, "flap", "g0/P0->g0/D0", 0.01)])
    g = fe.groups["default"]
    assert g.ft.n_flaps == 1 and g.sched.n_flaps == 1
    assert _tokens(reqs) == _tokens(base)


def test_restored_node_takes_transfers_again():
    """Crash the sole decode node before traffic: its substitute (a
    fresh node with a fresh pool) leaves the scheduler's failed set and
    lands the transfers, and the crashed node's pool is gone."""
    ev = [(0.0005, "crash", "g0/D0", 0.01)]
    _, base = _run("port", ARCH, 2, topo=(1, 1), t0=0.02)
    fe = _frontend("port", ARCH, ev, topo=(1, 1))
    crashed_pool = weakref.ref(fe.groups["default"].decodes[0].pool)
    reqs = seeded_requests(ServeRequest, fe.cfg.vocab_size, 2)
    for i, r in enumerate(reqs):
        fe.submit(r, at=0.02 + 0.002 * i)
    fe.serve(watch=reqs, max_events=200_000)
    g = fe.groups["default"]
    assert crashed_pool() is None
    assert all(r.done for r in reqs)
    assert g.sched.n_restores == 1 and not g.sched.failed_nodes
    assert g.ft.n_restored == 1 and g.ft.recovery_walls
    assert "g0/D0" in fe.meta.group_members("g0", "D")
    assert _tokens(reqs) == _tokens(base)
    _both(ARCH, 2, ev, topo=(1, 1), t0=0.02)


def test_slo_hopeless_request_is_shed():
    fe, reqs = _both(ARCH, 1, [(0.012, "crash", "g0/D0", 0.5)],
                     topo=(1, 1), recover_s=0.5,
                     req_kw={"max_new": 8, "slo_deadline_s": 0.008})
    ft = fe.groups["default"].ft
    assert reqs[0].shed and reqs[0].done and ft.n_shed == 1
    assert fe.transfer_stats()["default"]["ft_requests_shed"] == 1.0


@pytest.mark.parametrize("seed", [0, 7, 11, 12])
def test_fault_plan_random_matches_jax(seed):
    kw = dict(nodes=["b", "a", "c"], links=[("a", "b"), ("c", "a")],
              t_lo=0.0, t_hi=1.0, n_events=6, hang_s=0.2,
              crash_recover_s=0.05)
    mine = FaultPlan.random(seed, **kw)
    theirs = JaxPlan.random(seed, **kw)
    assert [dataclasses.astuple(e) for e in mine] == \
        [dataclasses.astuple(e) for e in theirs]
    assert list(mine) == sorted(mine, key=lambda e: (e.t, e.kind, e.target))
    assert mine.events != FaultPlan.random(seed + 1, **kw).events


def test_same_seed_bit_identical_logs():
    """Same FaultPlan seed: the port's two runs give identical logs and
    tokens, and both equal JAX's (the timeline drained to its end)."""
    def plan(side):
        return SIDES[side][2].random(
            7, nodes=["g0/P0", "g0/D0", "g0/D1"], t_lo=0.005, t_hi=0.05,
            n_events=3, kinds=("crash", "hang"), hang_s=0.1,
            crash_recover_s=0.05)

    sigs = []
    for side in ("port", "port", "jax"):
        fe, reqs = _run(side, ARCH, 3, plan=plan(side), watch=False)
        sigs.append(control_signature(fe, reqs))
    assert sigs[0] == sigs[1] == sigs[2]
    assert any(k in ("crash", "hang")
               for _, k, _ in sigs[0]["default"]["ft_log"])
