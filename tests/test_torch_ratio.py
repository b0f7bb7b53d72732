"""The port's runtime P/D ratio adjustment (RatioAdjuster and role flips,
repro_torch/serving/frontend.py) against the JAX package's, event for
event.

A flip drains a node (no new traffic, in-flight work completes), builds
the opposite role over the SAME params with a fresh pool and re-registers
it in the MetaStore. Under a DeterministicService both sides make the
same decisions at the same virtual times: flips, adjuster decisions,
wait votes, event and audit logs and tokens must be EQUAL.
"""
import weakref

import pytest

from repro.core.perf_model import InstanceProfile as JaxProfile
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.faults import DeterministicService as JaxService
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.core.perf_model import InstanceProfile, optimal_ratio
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.faults import DeterministicService
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import (assert_pools_clean, both_params,
                          control_signature, seeded_requests,
                          transfer_ledgers)

ARCH = "granite-3-8b"
SIDES = {
    "jax": (JaxFrontend, JaxRequest, JaxProfile, JaxService),
    "port": (ClusterFrontend, ServeRequest, InstanceProfile,
             DeterministicService),
}
# Eq. 1 optima: decode-heavy 1P:3D and prefill-heavy 3P:1D at 4 nodes;
# "at_optimum" is 2P:1D at 3 nodes, the deployed ratio of the wait-vote
# cooldown script
PROFILES = {
    "to_decode": dict(ttft_bs=0.1, b_p=4, r_pre=1.0, tpot_bs=0.05, b_d=8,
                      gen_tokens=100.0, xi=0.0),
    "to_prefill": dict(ttft_bs=1.0, b_p=1, r_pre=1.0, tpot_bs=0.001,
                       b_d=8, gen_tokens=10.0, xi=0.0),
    "at_optimum": dict(ttft_bs=0.2, b_p=4, r_pre=1.0, tpot_bs=0.01, b_d=8,
                       gen_tokens=20.0, xi=0.0),
}


def _frontend(side, topo, *, profile=None, **kw):
    cfg, jp, pcfg, tp = both_params(ARCH)
    Frontend, _, Profile, Service = SIDES[side]
    if profile is not None:
        kw.update(adjust_ratio=True,
                  profiles={"default": Profile(**PROFILES[profile])})
    if side == "port":
        kw["device"] = "cpu"
    return Frontend(pcfg if side == "port" else cfg,
                    topology={"default": topo},
                    params=tp if side == "port" else jp,
                    prefill_kwargs={"batch_size": 1},
                    service_model=Service(), **kw)


def _submit(fe, side, n, *, spacing=0.002, t0=0.0, **kw):
    reqs = seeded_requests(SIDES[side][1], fe.cfg.vocab_size, n, **kw)
    for i, r in enumerate(reqs):
        fe.submit(r, at=t0 + spacing * i)
    return reqs


def _tokens(reqs):
    return {r.rid: list(r.generated) for r in reqs}


def _roles_match_meta(fe):
    for g in fe.groups.values():
        assert sorted(fe.meta.group_members(g.gid, "P")) == \
            sorted(p.iid for p in g.prefills)
        assert sorted(fe.meta.group_members(g.gid, "D")) == \
            sorted(d.iid for d in g.decodes)


@pytest.mark.parametrize("direction", ["D->P", "P->D"])
def test_role_flip_updates_metastore_while_inflight_work_completes(
        direction):
    """A node is marked draining while it holds work: the work completes,
    then the flip swaps its role in the group and in the MetaStore, the
    new node (same params, fresh pool) serves new traffic, and both
    sides agree on every event."""
    topo = (1, 2) if direction == "D->P" else (2, 1)
    static = _frontend("port", topo)
    base = _submit(static, "port", 3)
    more_base = _submit(static, "port", 3, seed=9, rid0=50, t0=0.1)
    static.serve(watch=base + more_base)
    sigs = {}
    for side in ("port", "jax"):
        fe = _frontend(side, topo)
        g = fe.groups["default"]
        reqs = _submit(fe, side, 3)
        if direction == "D->P":
            fe.serve(deadline=0.01)
            node = next(d for d in g.decodes if d.requests)
        else:
            fe.serve(deadline=0.003)
            node = next(p for p in g.prefills if p.forming or p.waiting)
        node.draining = True
        old_iid, old_pool = node.iid, weakref.ref(node.pool)
        del node
        fe.serve(watch=reqs)
        assert all(r.done for r in reqs)
        more = _submit(fe, side, 3, seed=9, rid0=50, t0=0.1)
        fe.serve(watch=more)
        assert all(r.done for r in more)
        assert [f[1:] for f in g.flips] == [
            (old_iid, g.flips[0][2], direction)]
        assert old_iid not in fe.meta.instances
        _roles_match_meta(fe)
        if side == "port":
            new = g.find_node(g.flips[0][2])
            assert new.engine.params is fe.params
            assert old_pool() is None   # the flipped node's pool is freed
            assert _tokens(reqs + more) == _tokens(base + more_base)
            assert_pools_clean(g)
        sigs[side] = (control_signature(fe, reqs + more), fe)
    assert sigs["port"][0] == sigs["jax"][0]
    for sc, (mine, theirs) in transfer_ledgers(sigs["port"][1],
                                               sigs["jax"][1]).items():
        assert mine == theirs, sc


@pytest.mark.parametrize("case", [("to_decode", (3, 1), (1, 3), 1),
                                  ("to_prefill", (1, 3), (3, 1), 1),
                                  ("to_decode", (2, 2), (2, 2), 2),
                                  ("to_decode", (1, 1), (1, 1), 1)])
def test_adjuster_flips_toward_profile_optimum(case):
    """Eq. 1 on a profiled-in-advance InstanceProfile: the adjuster
    drains and flips one node at a time until the optimum, never below
    ``min_each`` of a role, and the port decides as JAX does."""
    profile, topo, want, min_each = case
    assert optimal_ratio(InstanceProfile(**PROFILES[profile]), sum(topo),
                         min_each=min_each) == want
    static = _frontend("port", topo)
    base = _submit(static, "port", 12, spacing=0.001)
    static.serve(watch=base)
    sigs = {}
    for side in ("port", "jax"):
        fe = _frontend(side, topo, profile=profile, adjust_interval=1,
                       adjust_period_s=0.004, min_each=min_each)
        reqs = _submit(fe, side, 12, spacing=0.001)
        fe.serve(watch=reqs)
        g = fe.groups["default"]
        assert all(r.done for r in reqs)
        assert g.ratio == want
        n_p, n_d = topo
        for _, _, _, kind in g.flips:   # every intermediate ratio
            n_p, n_d = (n_p - 1, n_d + 1) if kind == "P->D" \
                else (n_p + 1, n_d - 1)
            assert min(n_p, n_d) >= min_each
        assert (n_p, n_d) == want
        _roles_match_meta(fe)
        if side == "port":
            assert _tokens(reqs) == _tokens(base)
            assert_pools_clean(g)
        sigs[side] = control_signature(fe, reqs)
    assert sigs["port"] == sigs["jax"]


def _wait_script(side, script):
    """Drive one adjuster by hand through an admission-wait ledger
    script; returns what it decided at each step."""
    fe = _frontend(side, (2, 1),
                   profile="at_optimum" if script == "cooldown" else None,
                   adjust_ratio=True)
    g = fe.groups["default"]
    adj = fe.adjusters["default"]
    out = []

    def step(tick, waits=None, admitted=None):
        if waits is not None:
            g.sched.admission_waits = list(waits)
            g.sched.n_admitted = admitted
        out.append((tick, adj.maybe_adjust(tick), g.ratio,
                    tuple(g.draining_nodes())))

    spike = [1e-6] * 12 + [1e-3] * 4
    if script == "spike":
        step(8, [1e-6] * 16, 16)        # flat history: no vote
        step(16)
        step(24, spike, 20)             # spike arms (hysteresis)
        step(32, spike + [1e-3] * 2, 22)  # persists: P->D flip
    elif script == "expiry":
        step(8, spike, 16)              # armed on a fresh spike
        step(16)                        # no new admissions: expired
        step(24)
    else:
        step(8, spike, 16)              # Eq. 1 tie; the spike arms
        step(16, spike + [1e-3] * 2, 18)  # wait-driven P->D flip
        g._complete_flips(17.0)         # the idle node's drain completes
        for tick in (24, 32, 40, 48, 56):  # cooldown holds the revert
            step(tick)
    return out, list(adj.decisions), list(adj.wait_votes), list(g.flips)


@pytest.mark.parametrize("script", ["spike", "expiry", "cooldown"])
def test_adjuster_wait_spike_vote_expiry_and_cooldown(script):
    """The admission-wait vote: a spike over the earlier window arms and
    fires P->D; with no fresh admissions it expires; after a wait-driven
    flip the Eq. 1 revert is held for ``WAIT_COOLDOWN`` intervals."""
    assert optimal_ratio(InstanceProfile(**PROFILES["at_optimum"]),
                         3) == (2, 1)
    mine = _wait_script("port", script)
    assert mine == _wait_script("jax", script)
    steps, decisions, votes, flips = mine
    if script == "spike":
        assert [s[1] for s in steps] == [None, None, None, "P->D"]
        assert votes == [24, 32] and steps[-1][3]
    elif script == "expiry":
        assert [s[1] for s in steps] == [None] * 3
        assert votes == [8] and not steps[-1][3]
    else:
        assert [s[1] for s in steps] == \
            [None, "P->D", None, None, None, None, "D->P"]
        assert [f[3] for f in flips] == ["P->D"]
        assert [s[2] for s in steps[2:]] == [(1, 2)] * 5
