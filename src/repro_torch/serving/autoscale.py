"""SLO-goodput autoscaler over a shared heterogeneous node pool
(paper §3.2/§3.4 cluster elasticity on the REAL serving path), in
PyTorch. Counterpart of ``src/repro/serving/autoscale.py``, step for
step: a run under ``DeterministicService`` gives the JAX package's scale
ops, ledgers and MetaStore audit log exactly.

The RatioAdjuster (serving/frontend.py) rebalances P/D *inside* a fixed
group; this module grows and shrinks the groups themselves against one
shared pool of heterogeneous node classes (core.profiles.NodeClass:
prefill-heavy / decode-heavy / balanced, realized as virtual
service-time multipliers — token streams are class-invariant).

Control law (DistServe-style): per scenario, a ``GoodputModel``
(core.mlops) built from the group's own measured ``transfer_stats()``
medians converts the observed arrival rate + gateway backlog into
required prefill/decode capacity under the scenario's TTFT/TPOT SLOs.
The bottleneck side scales UP when demand overruns the SLO-feasible
capacity; a side scales DOWN when demand would still fit comfortably
without its least-loaded node (pool-leased nodes drain first, so
borrowed capacity returns to the shared pool before the base topology
shrinks).

Every transition is an event on the group's tickless heap:

  * scale-up  — lease a class from the pool (role-biased pick), pay the
    ``substitute_ready_delay`` provisioning timeline, then a ``scale``
    event lands the node in the group (one stateless container: connect
    + model load + health — the same Fig. 13 arithmetic the fault
    controller charges for substitutes);
  * scale-down — mark the victim ``draining + decommissioning`` (no new
    traffic; the flip machinery skips it) and poll drain completion via
    re-check ``scale`` events; decommission releases the lease (or
    ADOPTS a base-topology node into the pool).

One scale op is in flight per group at a time, and the RatioAdjuster
stands down while it is (``ServeGroup.scale_op``). Chaos composition
(serving/faults.py): a crashed draining node is never released to the pool — the
lease survives until its substitute reboots and actually drains, so a
dead node is never double-counted as capacity; all decisions read only
event-clock state, keeping same-seed runs bit-identical.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.mlops import (GoodputModel, SLOSpec,
                                    substitute_ready_delay)
from repro_torch.core.profiles import NODE_CLASSES, NodeClass


# scale up when demand passes UP_MARGIN x the bottleneck side's capacity;
# scale a side down when demand stays under DOWN_MARGIN x its capacity
# without its least-loaded node, keeping MIN_EACH nodes of each role;
# a draining node is re-checked every DRAIN_RECHECK_S (virtual seconds)
UP_MARGIN = 0.9
DOWN_MARGIN = 0.5
MIN_EACH = 1
DRAIN_RECHECK_S = 0.02

def _mean(xs) -> float:
    xs = list(xs)
    return sum(xs) / len(xs) if xs else 0.0


class NodePool:
    """Shared inventory of heterogeneous spare nodes.

    ``lease(role, iid)`` hands out one node, preferring the class biased
    toward ``role``, then unbiased, then off-bias classes — deterministic
    order. A lease is keyed by the instance id it provisions;
    ``release(iid)`` returns the SAME class to the free inventory and is
    idempotent (a second release, or a release of an unknown iid, is a
    no-op returning False) — the guard that keeps a crashed node from
    being double-counted as capacity. ``adopt`` grows the inventory when
    a base-topology node (never leased) drains into the pool."""

    def __init__(self, inventory: Dict[str, int], *,
                 provision_scale: float = 1.0):
        self.classes: Dict[str, NodeClass] = NODE_CLASSES
        unknown = set(inventory) - set(self.classes)
        assert not unknown, f"unknown node classes: {sorted(unknown)}"
        self.free: Dict[str, int] = {
            name: int(n) for name, n in inventory.items()}
        self.leases: Dict[str, str] = {}     # iid -> class name
        # tests/benchmarks compress the Fig. 13 provisioning timeline
        # the same way chaos runs compress heartbeat/recovery delays
        self.provision_scale = float(provision_scale)
        self.n_leased = 0
        self.n_released = 0
        self.n_adopted = 0
        self.n_denied = 0

    def total_free(self) -> int:
        return sum(self.free.values())

    def _pick(self, role: str) -> Optional[str]:
        def bias_rank(name: str) -> Tuple[int, str]:
            b = self.classes[name].role_bias
            return (0 if b == role else (1 if b == "" else 2), name)
        cands = sorted((n for n, k in self.free.items() if k > 0),
                       key=bias_rank)
        return cands[0] if cands else None

    def lease(self, role: str, iid: str) -> Optional[NodeClass]:
        name = self._pick(role)
        if name is None:
            self.n_denied += 1
            return None
        self.free[name] -= 1
        self.leases[iid] = name
        self.n_leased += 1
        return self.classes[name]

    def release(self, iid: str) -> bool:
        name = self.leases.pop(iid, None)
        if name is None:
            return False
        self.free[name] = self.free.get(name, 0) + 1
        self.n_released += 1
        return True

    def adopt(self, ncls_name: str = "balanced"):
        """A base-topology node decommissioned into the shared pool."""
        name = ncls_name if ncls_name in self.classes else "balanced"
        self.free[name] = self.free.get(name, 0) + 1
        self.n_adopted += 1

    def provision_delay(self, ncls: NodeClass) -> float:
        return self.provision_scale * substitute_ready_delay(
            ncls.provision_level)

    def ledger(self) -> Dict[str, float]:
        return {
            "pool_free": float(self.total_free()),
            "pool_leased": float(len(self.leases)),
            "pool_leases_total": float(self.n_leased),
            "pool_releases_total": float(self.n_released),
            "pool_adopted": float(self.n_adopted),
            "pool_denied": float(self.n_denied),
        }


@dataclass
class ScaleOp:
    """One provision (up) or drain+decommission (down) transition; the
    payload of the ``scale`` events on the group heap."""
    kind: str               # "up" | "down"
    role: str               # "P" | "D"
    gid: str
    iid: str
    ncls: str               # node-class name
    t_start: float
    t_ready: float          # up: provisioning completes (substitute
    #                         timeline); down: first drain re-check
    t_done: float = -1.0


class AutoScaler:
    """Goodput-maximizing group scaler on the frontend's event loop.

    ``frontend.serve()`` calls ``step(now)`` every ``period_s`` virtual
    seconds (alongside the ratio adjusters); ``on_event`` receives the
    group-heap ``scale`` events this scaler schedules. All inputs are
    event-clock state — deterministic given the arrival schedule. The
    frontend owns the scaler (``ClusterFrontend.autoscaler``), so the
    scaler holds the frontend weakly: a dropped cluster frees its params
    and pools without the cycle collector."""

    def __init__(self, frontend, pool: NodePool,
                 slos, *, period_s: float = 0.25, window_s: float = 2.0,
                 cooldown_s: float = 0.5):
        self._fe = weakref.ref(frontend)
        self.pool = pool
        if isinstance(slos, SLOSpec):
            slos = {sc: slos for sc in frontend.groups}
        self.slos: Dict[str, SLOSpec] = dict(slos)
        self.period_s = float(period_s)
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self._arrivals: Dict[str, List[float]] = {}
        self._cool: Dict[str, float] = {}
        self._wake: Dict[str, bool] = {}
        self._n_ops = 0
        self.ops: List[ScaleOp] = []
        self._led: Dict[str, Dict[str, float]] = {}
        frontend.attach_autoscaler(self)

    @property
    def fe(self):
        return self._fe()

    # ------------------------------------------------------ telemetry
    def note_arrival(self, scenario: str, t: float,
                     gen_tokens: int = -1):
        xs = self._arrivals.setdefault(scenario, [])
        xs.append((t, int(gen_tokens)))
        if len(xs) > 2048:
            del xs[:-1024]

    def _rate(self, scenario: str, t: float) -> float:
        xs = self._arrivals.get(scenario, ())
        lo = t - self.window_s
        return sum(1 for x, _ in xs if x > lo) / self.window_s

    def _gen_est(self, scenario: str, t: float) -> Optional[float]:
        """Expected output length of the CURRENT tide: the declared
        ``max_new_tokens`` of arrivals in the rate window. Finished-
        request history lags a tide change by a whole generation (a
        decode-bound burst looks prefill-bound until its first requests
        complete); the declared budget is known at submission. A
        declared 0 (prefill-complete scoring) counts — only undeclared
        (-1) arrivals are skipped. None when the window is empty."""
        lo = t - self.window_s
        gens = [g for x, g in self._arrivals.get(scenario, ())
                if x > lo and g >= 0]
        return _mean(gens) if gens else None

    def _ledger(self, gid: str) -> Dict[str, float]:
        return self._led.setdefault(gid, {
            "scale_up_started": 0.0, "scale_up_done": 0.0,
            "scale_down_started": 0.0, "scale_down_done": 0.0,
            "scale_denied": 0.0})

    def group_ledger(self, gid: str) -> Dict[str, float]:
        out = dict(self._ledger(gid))
        g = next((g for g in self.fe.groups.values() if g.gid == gid),
                 None)
        out["scale_in_flight"] = float(
            g is not None and g.scale_op is not None)
        return out

    def ledger(self) -> Dict[str, float]:
        out = self.pool.ledger()
        for led in self._led.values():
            for k, v in led.items():
                out[k] = out.get(k, 0.0) + v
        return out

    # ----------------------------------------------------- goodput law
    def _live(self, nodes):
        return [n for n in nodes
                if not (n.draining or n.crashed or n.ejected)]

    def _eff(self, nodes, role: str) -> float:
        return sum(1.0 / max(n.prefill_scale if role == "P"
                             else n.decode_scale, 1e-9)
                   for n in nodes)

    def _model(self, g, t: float) -> Optional[GoodputModel]:
        slo = self.slos.get(g.scenario)
        if slo is None:
            return None
        bs = max((p.batch_size for p in g.prefills), default=4)
        slots = max((d.engine.max_slots for d in g.decodes), default=8)
        ge = self._gen_est(g.scenario, t)
        gen = ge if ge is not None else (_mean(g.gen_tokens[-64:]) or 8.0)
        stats = dict(g.transfer_stats())
        # the control loop wants FRESH service times — a tide change
        # (long-prompt -> short-prompt traffic) must reprice capacity
        # within a few batches, not after the 32-sample median turns
        # over. Reads the raw per-group ledgers; transfer_stats() and
        # its [-32:] medians are untouched.
        pb = sorted(g.prefill_batch_s[-8:])
        ds = sorted(g.decode_step_s[-8:])
        if pb:
            stats["prefill_batch_median_s"] = pb[len(pb) // 2]
        if ds:
            stats["decode_step_median_s"] = ds[len(ds) // 2]
        return GoodputModel.from_stats(
            slo, stats, batch_size=bs, decode_slots=slots,
            gen_tokens=gen)

    # ----------------------------------------------------------- step
    def step(self, t: float):
        for g in self.fe.groups.values():
            self._step_group(t, g)
            self._arm_wake(t, g)

    def _arm_wake(self, t: float, g):
        """Self-schedule a periodic ``scale`` wake on the group heap
        while this group holds pool leases or an in-flight op: the event
        clock only advances on events, so without a wake an idle lull
        would never reach the scaler and borrowed nodes would squat on
        the pool until the next arrival. The wake chain stops as soon as
        nothing is leased, so a drained timeline still terminates."""
        if self._wake.get(g.gid):
            return
        holding = g.scale_op is not None or any(
            iid.startswith(g.gid + "/") for iid in self.pool.leases)
        if holding:
            self._wake[g.gid] = True
            g.schedule(t + self.period_s, "scale", None)

    def _step_group(self, t: float, g):
        if g.scale_op is not None:          # one transition at a time
            return
        if t < self._cool.get(g.gid, 0.0):
            return
        model = self._model(g, t)
        if model is None:                   # no SLO / no samples yet
            return
        backlog = self.fe.queued_backlog(g.scenario)
        demand = self._rate(g.scenario, t) + backlog / self.window_s
        live_p = self._live(g.prefills)
        live_d = self._live(g.decodes)
        cap_p = model.prefill_capacity(self._eff(live_p, "P"))
        cap_d = model.decode_capacity(self._eff(live_d, "D"))
        if demand > UP_MARGIN * min(cap_p, cap_d):
            role = "P" if cap_p <= cap_d else "D"
            self._scale_up(t, g, role)
            return
        if backlog > 0:
            return                          # queued work: never shrink
        for role, cap_fn, live in (("P", model.prefill_capacity, live_p),
                                   ("D", model.decode_capacity, live_d)):
            if len(live) <= MIN_EACH:
                continue
            victim = self._victim(live, role)
            v_eff = 1.0 / max(victim.prefill_scale if role == "P"
                              else victim.decode_scale, 1e-9)
            if demand < DOWN_MARGIN * cap_fn(
                    self._eff(live, role) - v_eff):
                self._scale_down(t, g, role, victim)
                return

    def _victim(self, live, role: str):
        """Least-loaded node, pool-leased nodes first (borrowed capacity
        returns to the shared pool before the base topology shrinks)."""
        def key(n):
            load = (len(n.forming) + len(n.waiting)) if role == "P" \
                else len(n.requests)
            return (0 if n.iid in self.pool.leases else 1, load, n.iid)
        return min(live, key=key)

    # ----------------------------------------------------- transitions
    def _scale_up(self, t: float, g, role: str):
        led = self._ledger(g.gid)
        iid = f"{g.gid}/S{self._n_ops}"
        ncls = self.pool.lease(role, iid)
        if ncls is None:
            # pool exhausted: degradation falls through to absorb /
            # backpressure / shed at the gateway
            led["scale_denied"] += 1
            return
        self._n_ops += 1
        delay = self.pool.provision_delay(ncls)
        op = ScaleOp("up", role, g.gid, iid, ncls.name,
                     t_start=t, t_ready=t + delay)
        self._track(op)
        g.scale_op = op
        led["scale_up_started"] += 1
        g.schedule(t + delay, "scale", op)

    def _scale_down(self, t: float, g, role: str, victim):
        self._n_ops += 1
        victim.draining = True
        victim.decommissioning = True
        op = ScaleOp("down", role, g.gid, victim.iid, victim.node_class,
                     t_start=t, t_ready=t + DRAIN_RECHECK_S)
        self._track(op)
        g.scale_op = op
        self._ledger(g.gid)["scale_down_started"] += 1
        g.schedule(t + DRAIN_RECHECK_S, "scale", op)

    def _track(self, op: ScaleOp):
        self.ops.append(op)
        if len(self.ops) > 512:
            del self.ops[:-256]

    def on_event(self, t: float, g, op: Optional[ScaleOp]):
        """A ``scale`` event fired on the group heap."""
        if op is None:                      # periodic wake (see _arm_wake)
            self._wake[g.gid] = False
            self._step_group(t, g)
            self._arm_wake(t, g)
            return
        if op.kind == "up":
            g.add_node(t, op.role, iid=op.iid,
                       ncls=self.pool.classes[op.ncls])
            op.t_done = t
            g.scale_op = None
            self._ledger(g.gid)["scale_up_done"] += 1
            self._cool[g.gid] = t + self.cooldown_s
            return
        node = g.find_node(op.iid)
        if node is not None:
            if not node.crashed and not node.draining:
                # the fault controller rebooted it mid-drain (fresh
                # flags): re-mark and keep draining toward decommission
                node.draining = True
                node.decommissioning = True
            if node.crashed or not g.node_drained(node):
                # a crashed node is NEVER released to the pool here —
                # the lease waits for its substitute to reboot and drain
                g.schedule(t + DRAIN_RECHECK_S, "scale", op)
                return
            g.remove_node(t, node)
        if not self.pool.release(op.iid):
            self.pool.adopt(op.ncls)    # base-topology node joins the pool
        op.t_done = t
        g.scale_op = None
        self._ledger(g.gid)["scale_down_done"] += 1
        self._cool[g.gid] = t + self.cooldown_s
