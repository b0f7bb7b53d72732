"""Deterministic fault injection + token-exact crash recovery on the
real event-driven data path (paper §3.3-3.5, Fig. 13 — on live engines),
in PyTorch. Counterpart of ``src/repro/serving/faults.py``: plans,
service model and controller follow it step for step, so a run under
``DeterministicService`` gives the JAX package's event log, fault log
and recovery ledger exactly.

``FaultPlan`` is a seeded schedule of (t, kind, target) chaos events —
node crash, node hang/straggle, link flap — injected through the group's
virtual-time event heap, so every chaos run is exactly reproducible:
the same seed yields a bit-identical fault schedule, and (under a
``DeterministicService`` cost model) a bit-identical group event log.

``FaultTolerance`` is the per-group controller that rides the SAME heap
(no new clocks):

  * heartbeat/health-epoch events: every live node reports into
    ``MetaStore.health_report`` on the virtual clock; a node silent past
    the store's ``health_timeout_s`` is ejected at EXACTLY
    ``last_report + timeout`` (a precisely-timestamped eject event);
  * prefill crash: forming requests requeue to healthy peers with
    capped exponential backoff (the §3.5 rejection-forwarding path — no
    scheduler timeout), in-flight transfers sourced at the dead node are
    killed (``TransferScheduler.fail_src``) and their requests re-admitted;
  * decode crash: slots are evicted and every in-flight request is
    re-admitted elsewhere by RE-PREFILLING ``prompt + tokens emitted so
    far`` — riding the prefix-cache / warm-snapshot path, so
    recovery is mostly cache hits and, under greedy decoding,
    TOKEN-IDENTICAL: the recovered stream equals the fault-free stream;
  * SLO deadlines: recovery sheds a request whose deadline already
    passed instead of burning compute on a hopeless re-admit;
  * substitute integration: a crashed node reboots (fresh pool+engine on
    the group's device — its memory is gone, and the old pool becomes
    unreachable) after the ``core.mlops`` substitute-ready timeline,
    re-registers in the MetaStore, is removed from
    ``TransferScheduler.failed_nodes`` (restore_node) and takes traffic;
    an ejected-but-alive straggler rejoins with its prefix cache intact.

``ServeGroup.transfer_stats()`` grows this controller's recovery ledger
(``ft_*`` keys): crashes seen, requests requeued / re-admitted / shed,
recovery wall medians, health-epoch lag.
"""
from __future__ import annotations

import random
import weakref
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

from repro_torch.core.mlops import substitute_ready_delay
from repro_torch.serving.cluster import (DecodeNode, PrefillNode,
                                        inherit_class)


# capped exponential backoff of a displaced request's re-offer
# (virtual seconds)
BACKOFF_BASE_S = 0.01
BACKOFF_CAP_S = 0.5


def _median(xs: Sequence[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    n = len(s)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


# --------------------------------------------------------------- plans
@dataclass(frozen=True)
class FaultEvent:
    """One scheduled chaos event.

    kind:
      * ``crash`` — the node dies; its memory (KV pools, slot state) is
        lost. ``duration`` is the substitute-ready delay; <= 0 uses the
        ``core.mlops`` node_replace timeline.
      * ``hang``  — the node straggles silently for ``duration`` virtual
        seconds (no heartbeats, compute stalled); past the health
        timeout it is ejected, with memory INTACT for a later rejoin.
      * ``flap``  — target ``"src->dst"``: the link drops for
        ``duration``; the in-flight message is retransmitted after.
    """
    t: float
    kind: str          # "crash" | "hang" | "flap"
    target: str        # instance id, or "src->dst" for flap
    duration: float = 0.0


class FaultPlan:
    """An immutable, time-sorted chaos schedule. Equality of seeds means
    equality of schedules: ``FaultPlan.random`` draws only from its own
    ``random.Random(seed)`` over sorted candidate lists."""

    def __init__(self, events: Sequence[FaultEvent] = (),
                 seed: Optional[int] = None):
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t, e.kind, e.target)))
        self.seed = seed

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, events={list(self.events)})"

    @classmethod
    def random(cls, seed: int, *, nodes: Sequence[str],
               links: Sequence[Tuple[str, str]] = (),
               t_lo: float = 0.0, t_hi: float = 1.0, n_events: int = 3,
               kinds: Sequence[str] = ("crash", "hang", "flap"),
               hang_s: float = 0.2, crash_recover_s: float = 0.0
               ) -> "FaultPlan":
        rng = random.Random(seed)
        nodes = sorted(nodes)
        links = sorted(links)
        events: List[FaultEvent] = []
        for _ in range(n_events):
            kind = rng.choice(list(kinds))
            t = rng.uniform(t_lo, t_hi)
            if kind == "flap":
                if not links:
                    continue
                src, dst = rng.choice(links)
                events.append(FaultEvent(
                    t, "flap", f"{src}->{dst}",
                    hang_s * rng.uniform(0.5, 1.5)))
            elif kind == "hang":
                events.append(FaultEvent(
                    t, "hang", rng.choice(nodes),
                    hang_s * rng.uniform(0.5, 1.5)))
            else:
                events.append(FaultEvent(
                    t, "crash", rng.choice(nodes), crash_recover_s))
        return cls(events, seed=seed)


@dataclass(frozen=True)
class DeterministicService:
    """Virtual service-time model for reproducible chaos runs: charge a
    deterministic cost per prefill batch / decode step instead of the
    measured wall time, so the whole event log (times included) is
    bit-identical across runs of the same plan. Token values are
    unaffected — the real forwards still run."""
    prefill_base_s: float = 4e-3
    prefill_per_token_s: float = 1e-4
    decode_base_s: float = 2e-3
    decode_per_slot_s: float = 2e-4

    def prefill_batch_s(self, n_tokens: int) -> float:
        return self.prefill_base_s + n_tokens * self.prefill_per_token_s

    def decode_step_s(self, n_slots: int) -> float:
        return self.decode_base_s + n_slots * self.decode_per_slot_s


# ----------------------------------------------------------- controller
class FaultTolerance:
    """Per-ServeGroup fault controller on the group's own event heap.

    Event kinds it owns (dispatched back from ``ServeGroup._dispatch``):
    ``fault`` (a FaultEvent fires), ``hb`` (heartbeat/health epoch),
    ``eject`` (exact-deadline silence check), ``requeue`` (backoff
    retry of a displaced request), ``recover`` (substitute ready /
    straggler resumes). It holds its group weakly: the group owns it
    (``ServeGroup.ft``), and a dropped cluster must not wait for the
    cycle collector to free its params and pools."""

    def __init__(self, group, plan: FaultPlan, *,
                 heartbeat_s: float = 0.05,
                 recover_delay_s: Optional[float] = None):
        self._group = weakref.ref(group)
        self.plan = plan
        self.hb_period = float(heartbeat_s)
        # the store's health timeout is the shared per-store config
        # (satellite: threaded from the frontend, virtual seconds)
        self.health_timeout = float(group.meta.health_timeout_s)
        self.recover_delay_s = substitute_ready_delay("node_replace") \
            if recover_delay_s is None else float(recover_delay_s)
        # ---------------------------------------------------- ledger
        self.n_crashes = 0
        self.n_hangs = 0
        self.n_flaps = 0
        self.n_ejected = 0
        self.n_restored = 0
        self.n_requeued = 0        # displaced with NO tokens emitted yet
        self.n_readmitted = 0      # re-prefill of prompt + emitted tokens
        self.n_shed = 0            # hopeless past-deadline requests
        self.recovery_walls: List[float] = []   # eject/crash -> rejoin
        self.hb_lags: List[float] = []          # epoch - oldest report
        self.readmit_hit_tokens = 0
        self.readmit_tokens = 0
        # deterministic chaos action log: (t, action, target)
        self.log: List[Tuple[float, str, str]] = []
        self._n_pending = 0        # outstanding fault/recover/... events
        self._hb_armed = False
        self._eject_armed: set = set()
        self._eject_t: dict = {}   # iid -> time it was ejected
        for ev in plan:
            self._sched(ev.t, "fault", ev)
        if len(plan):
            self._arm_hb(self.hb_period)

    @property
    def group(self):
        return self._group()

    # ------------------------------------------------------- plumbing
    def _sched(self, t: float, kind: str, obj=None):
        self._n_pending += 1
        self.group.schedule(t, kind, obj)

    def _arm_hb(self, t: float):
        if not self._hb_armed:
            self._hb_armed = True
            self.group.schedule(t, "hb", None)

    def _nodes(self):
        g = self.group
        return [("P", n) for n in g.prefills] + \
               [("D", n) for n in g.decodes]

    def _find(self, iid: str):
        for role, node in self._nodes():
            if node.iid == iid:
                return role, node
        return None, None

    def _active(self) -> bool:
        """Chaos still in motion: pending injected/recovery events, or a
        node currently down/straggling. Heartbeats stop when this goes
        false, so an idle timeline drains (serve() terminates)."""
        if self._n_pending > 0:
            return True
        return any(n.crashed or n.ejected
                   or n.hung_until > self.group.vclock
                   for _, n in self._nodes())

    # ------------------------------------------------------- dispatch
    def dispatch(self, kind: str, t: float, obj):
        # windowed retention for the long-run ledgers (identical trims on
        # identical runs, so bit-identical-log comparisons still hold)
        if len(self.log) > 4096:
            del self.log[:-2048]
        if len(self.recovery_walls) > 512:
            del self.recovery_walls[:-256]
        if kind == "fault":
            self._n_pending -= 1
            self._fault(t, obj)
        elif kind == "hb":
            self._hb_armed = False
            self._epoch(t)
        elif kind == "eject":
            self._n_pending -= 1
            self._eject_check(t, obj)
        elif kind == "requeue":
            self._n_pending -= 1
            req, attempt = obj
            self._reoffer(t, req, attempt)
        elif kind == "recover":
            self._n_pending -= 1
            what, iid = obj
            (self._reboot if what == "reboot" else self._unhang)(t, iid)

    # --------------------------------------------------------- faults
    def _fault(self, t: float, ev: FaultEvent):
        if ev.kind == "flap":
            self._flap(t, ev)
            return
        role, node = self._find(ev.target)
        if node is None or node.crashed:
            self.log.append((t, f"{ev.kind}-noop", ev.target))
            return
        if ev.kind == "crash":
            self._crash(t, ev, role, node)
        elif ev.kind == "hang":
            self._hang(t, ev, node)
        self._arm_hb(t + self.hb_period)

    def _crash(self, t: float, ev: FaultEvent, role: str, node):
        self.n_crashes += 1
        node.crashed = True
        self.log.append((t, "crash", node.iid))
        # the resident node monitor reports the fault level directly
        # (paper §3.4): detection is immediate, unlike a silent hang
        self.group.meta.health_report(t, node.iid, healthy=False)
        self._evacuate(t, role, node)
        delay = ev.duration if ev.duration > 0 else self.recover_delay_s
        self._sched(t + delay, "recover", ("reboot", node.iid))

    def _hang(self, t: float, ev: FaultEvent, node):
        self.n_hangs += 1
        node.hung_until = max(node.hung_until, t + ev.duration)
        node.busy_until = max(node.busy_until, node.hung_until)
        self.log.append((t, "hang", node.iid))
        self._sched(node.hung_until, "recover", ("unhang", node.iid))

    def _flap(self, t: float, ev: FaultEvent):
        self.n_flaps += 1
        self.log.append((t, "flap", ev.target))
        sched = self.group.sched
        if sched is not None and "->" in ev.target:
            src, dst = ev.target.split("->", 1)
            sched.flap_link(src, dst, t, ev.duration)

    # ------------------------------------------------------- ejection
    def _evacuate(self, t: float, role: str, node):
        """Logical removal + work displacement, shared by crash and
        health-timeout ejection. Pool accounting stays exact: every
        displaced rid releases its blocks (idempotent) before the
        request re-enters the ingress path."""
        g = self.group
        g.meta.remove_instance(t, node.iid)
        self.n_ejected += 1
        self._eject_t[node.iid] = t
        displaced = []
        if role == "P":
            if g.sched is not None:
                for job in g.sched.fail_src(node.iid):
                    displaced.append(job.req)
            displaced.extend(node.forming)
            displaced.extend(req for req, _ in node.waiting)
            node.forming = []
            node.waiting = []
            node.staged.clear()
            node.batch_meta.clear()
            node.sse_connections = 0
            for rid in list(node.pool._owned):
                node.pool.release(rid)
        else:
            if g.sched is not None:
                g.sched.fail_node(node.iid)
            # a chunked-prefill absorb job dies with the node: no token
            # streamed yet, so the request requeues from scratch (its
            # partial chunk KV lived only in the dead pool)
            job = node._absorb_job
            if job is not None:
                job.dead = True
                node._absorb_job = None
                node.pool.release(job.req.rid)
                g.absorbs["absorb_displaced"] += 1
                displaced.append(job.req)
            displaced.extend(node.requests.values())
            node.engine.evict_all()
            for rid in list(node.requests):
                node.pool.release(rid)
            node.requests.clear()
        g.event_log.append((t, "eject"))
        if g.sched is not None and not g.sched.idle():
            # jobs the dead dst stranded requeue at the next pump
            g.schedule(t, "pump", None)
        for req in displaced:
            self._reoffer(t, req, 0)

    def _epoch(self, t: float):
        """Heartbeat/health epoch: live nodes report, silent ones get an
        exact-deadline eject check scheduled at last_report + timeout."""
        g = self.group
        for _, node in self._nodes():
            if node.crashed or node.ejected:
                continue
            if node.hung_until > t:
                last = g.meta.silent_since(node.iid)
                if last is not None and node.iid not in self._eject_armed:
                    self._eject_armed.add(node.iid)
                    self._sched(max(t, last + self.health_timeout),
                                "eject", node.iid)
                continue
            g.meta.health_report(t, node.iid)
        reports = [g.meta.silent_since(iid)
                   for iid in g.meta.group_members(g.gid, "P")
                   + g.meta.group_members(g.gid, "D")]
        reports = [r for r in reports if r is not None]
        if reports:
            self.hb_lags.append(max(0.0, t - min(reports)))
            del self.hb_lags[:-512]
        if self._active():
            self._arm_hb(t + self.hb_period)

    def _eject_check(self, t: float, iid: str):
        """Fires at exactly ``last_report + health_timeout_s``; ejects
        only if the node is STILL silent (it may have resumed and
        reported since the check was armed)."""
        self._eject_armed.discard(iid)
        role, node = self._find(iid)
        if node is None or node.crashed or node.ejected:
            return
        last = self.group.meta.silent_since(iid)
        if last is None or node.hung_until <= t \
                or t < last + self.health_timeout - 1e-12:
            return
        node.ejected = True
        self.log.append((t, "eject", iid))
        self._evacuate(t, role, node)

    # ------------------------------------------------------- recovery
    def _reoffer(self, t: float, req, attempt: int):
        """Displaced-request re-entry: requeue (nothing emitted yet) or
        token-exact re-admit (re-prefill prompt + emitted tokens), with
        capped exponential backoff while no healthy peer accepts."""
        if req.done or req.shed:
            return
        if req.slo_deadline_s >= 0.0 and req.submit_t >= 0.0 \
                and t > req.submit_t + req.slo_deadline_s:
            req.shed = True
            req.done = True
            req.finish_t = t
            self.n_shed += 1
            self.log.append((t, "shed", f"rid={req.rid}"))
            return
        g = self.group
        if attempt == 0:
            if req.generated:
                # continuation prompt: the original prompt plus every
                # token emitted so far. Greedy decode makes the
                # re-prefill's next token exactly the token the dead
                # node would have produced — the recovered stream is
                # the fault-free stream
                if not hasattr(req, "_orig_tokens"):
                    req._orig_tokens = list(req.tokens)
                req.tokens = list(req._orig_tokens) + list(req.generated)
                req.readmits += 1
                self.n_readmitted += 1
                best = max((p.prefix_affinity(req) for p in g.prefills
                            if not (p.draining or p.crashed or p.ejected)),
                           default=0)
                self.readmit_hit_tokens += int(best)
                self.readmit_tokens += len(req.tokens)
                self.log.append((t, "readmit", f"rid={req.rid}"))
            else:
                self.n_requeued += 1
                self.log.append((t, "requeue", f"rid={req.rid}"))
        if g.offer(req, t=t):
            self.log.append((t, "placed", f"rid={req.rid}"))
            return
        delay = min(BACKOFF_BASE_S * (2.0 ** attempt), BACKOFF_CAP_S)
        self._sched(t + delay, "requeue", (req, attempt + 1))

    def _rejoin(self, t: float, node):
        g = self.group
        role = "P" if any(n is node for n in g.prefills) else "D"
        g.meta.gather_instance(t, node.iid, role, g.gid)
        g.meta.health_report(t, node.iid)
        if g.sched is not None:
            g.sched.restore_node(node.iid)
        self.n_restored += 1
        t0 = self._eject_t.pop(node.iid, t)
        self.recovery_walls.append(t - t0)
        g.event_log.append((t, "rejoin"))
        if g.on_capacity is not None:   # fresh capacity: retry pending
            g.on_capacity(t)

    def _reboot(self, t: float, iid: str):
        """Substitute integration for a crash: the node comes back with
        a FRESH pool and engine on the group's device (its memory died
        with it; the crashed node's pool is dropped with it),
        re-registers, and is removed from the scheduler's failed set."""
        g = self.group
        role, node = self._find(iid)
        if node is None or not node.crashed:
            return
        if role == "P":
            fresh = PrefillNode(iid, g.cfg, g.params, **g.prefill_kwargs)
            g.prefills[g.prefills.index(node)] = fresh
        else:
            fresh = DecodeNode(iid, g.cfg, g.params, **g.decode_kwargs)
            g.decodes[g.decodes.index(node)] = fresh
        # the substitute lands on the same physical iron: its node class
        # (virtual service-time multipliers, pool-lease identity) carries
        inherit_class(fresh, node)
        fresh.busy_until = t
        self.log.append((t, "reboot", iid))
        self._rejoin(t, fresh)

    def _unhang(self, t: float, iid: str):
        """A straggler resumes: if it was ejected it rejoins (prefix
        cache intact — a hang loses no memory); otherwise it simply
        reports again."""
        role, node = self._find(iid)
        if node is None or node.crashed:
            return
        node.hung_until = 0.0
        if node.ejected:
            node.ejected = False
            self.log.append((t, "resume", iid))
            self._rejoin(t, node)
        else:
            self.group.meta.health_report(t, node.iid)
            self.log.append((t, "resume", iid))

    # --------------------------------------------------------- ledger
    def ledger(self) -> dict:
        hit_rate = self.readmit_hit_tokens / self.readmit_tokens \
            if self.readmit_tokens else 0.0
        return {
            "ft_crashes": float(self.n_crashes),
            "ft_hangs": float(self.n_hangs),
            "ft_link_flaps": float(self.n_flaps),
            "ft_ejections": float(self.n_ejected),
            "ft_restores": float(self.n_restored),
            "ft_requests_requeued": float(self.n_requeued),
            "ft_requests_readmitted": float(self.n_readmitted),
            "ft_requests_shed": float(self.n_shed),
            "ft_recovery_wall_median_s": _median(self.recovery_walls),
            "ft_health_epoch_lag_median_s": _median(self.hb_lags),
            "ft_readmit_prefix_hit_rate": hit_rate,
        }
