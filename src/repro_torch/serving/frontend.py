"""Scenario-aware multi-group serving frontend on the REAL data path, in
PyTorch.

Counterpart of ``src/repro/serving/frontend.py`` (the paper's
fine-grained P/D organization, §3.2-3.5):

  ClusterFrontend (gateway)
    -> ServeGroup["svcA/chat"]: PrefillNode* -> KV transfer -> DecodeNode*
    -> ServeGroup["svcA/summ"]: PrefillNode* -> KV transfer -> DecodeNode*

Each ServeGroup binds one scenario tag to its own prefill/decode nodes
registered in the MetaStore. Ingress prefers the prefill node with the
longest cached prefix, then the fewest SSE connections, with rejection
forwarding across groups when the home group is saturated (§3.5); a
timed arrival no group takes backs off at the gateway (capped, seeded)
and sheds only past its SLO deadline.

The serving core is TICKLESS: arrivals, prefill-batch completions,
per-layer KV segment landings, decode steps, drained role flips, scale
events and fault-controller events are timestamped events drained in
nondecreasing virtual time. Each batch or step charges its MEASURED wall
time (synchronised with the card) as virtual seconds, or, with a
``service_model`` (serving/faults.py ``DeterministicService``), the
model's closed-form cost, which makes the whole event log reproducible
and equal to the JAX package's bit for bit. KV hand-off runs through the
overlapped layer-wise pipeline by default (serving/transfer_sched.py);
``overlap_transfer=False`` uses the blocking transfer on the same
timeline.

The control plane (§3.3-3.4): a RatioAdjuster flips ONE node between P
and D roles toward the Eq. 1 optimum (core/perf_model.py), on a profile
or the group's observed timings, gated by queue/TTFT pressure and the
admission-wait ledger. A flip drains the node (no new traffic, in-flight
work completes), then builds the opposite node over the SAME params with
a fresh pool and re-registers it in the MetaStore. ``faults=`` attaches a
FaultTolerance controller per group (crash, hang and link-flap
injection, heartbeat ejection, token-exact re-admission, substitute
reboot), and ``attach_autoscaler`` an SLO-goodput AutoScaler
(serving/autoscale.py) that grows and shrinks the groups from a shared
node pool. Under overload, ``absorb_prefill=True`` lets an idle decode
node absorb a request no prefill node takes as chunked prefill (its
chunks run between decode steps, its KV lands in the node's own pool),
the rung before gateway backpressure: the degradation ladder is absorb
-> scale -> backpressure -> shed. The back-references among these parts
are weak, so a dropped cluster frees its params and pools without the
cycle collector.

``spec=`` binds a speculative draft to every decode node a group builds
(one ``SpecConfig``, ``"auto"`` for the scenario-aware ``draft_for``, or
a dict per scenario). ``tickless=False`` keeps the legacy staged tick
loop as a shim over the same event handlers (``tick()``; token-identical
to the tickless core by test); fault injection needs the tickless core.
"""
from __future__ import annotations

import heapq
import itertools
import random
import time
import weakref
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.perf_model import InstanceProfile, optimal_ratio
from repro_torch.core.transfer import KVTransferEngine, LinkModel
from repro_torch.core.zookeeper import MetaStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params
from repro_torch.serving import spans
from repro_torch.serving.cluster import (DecodeNode, PrefillNode,
                                        ServeRequest, inherit_class)
from repro_torch.serving.faults import FaultTolerance
from repro_torch.serving.step_graph import prefill_compile_count
from repro_torch.serving.speculative import draft_for
from repro_torch.serving.transfer_sched import (TransferJob,
                                                TransferScheduler,
                                                state_payload_nbytes)


def _mean(xs: Sequence[float]) -> float:
    return sum(xs) / len(xs) if xs else 0.0


def _median(xs: Sequence[float]) -> float:
    if not xs:
        return 0.0
    s = sorted(xs)
    n = len(s)
    if n % 2:
        return s[n // 2]
    return 0.5 * (s[n // 2 - 1] + s[n // 2])


def _wall(device: torch.device, t0: float) -> float:
    """Seconds since ``t0`` once the card has finished the queued work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


# slot-wait poll of an absorbed prefill's final chunk (virtual seconds)
ABSORB_RETRY_S = 2e-3
# an absorbed prefill's chunk length in tokens (rounded to the engine's
# prefix alignment)
ABSORB_CHUNK_TOKENS = 16


class AbsorbJob:
    """One chunked prefill running ON a decode node (DynaServe-style
    elasticity): ``chunks`` is the absorber engine's ``iter_chunks``
    generator, stepped one chunk per ``absorb`` event so decode steps
    interleave between chunks on the virtual timeline. The node's pool
    blocks for prompt + generation are reserved at job start; the final
    chunk's stitched KV is written there and the request admits in place
    (no transfer: the KV is already home).

    The node holds its job (``DecodeNode._absorb_job``) and the job its
    node only weakly, so a crashed or dropped node with a job in flight,
    or a dead job still queued on the event heap, keeps no pool alive."""

    def __init__(self, req: ServeRequest, node: DecodeNode, chunks,
                 n_left: int):
        self.req = req
        self._node = weakref.ref(node)
        self.chunks = chunks            # PrefillEngine.iter_chunks generator
        self.n_left = n_left            # chunks not yet run
        self.out = None                 # latest (cumulative) PrefillOutput
        self.dead = False               # node crashed/ejected under the job

    @property
    def node(self) -> Optional[DecodeNode]:
        return self._node()


def weak_call(method):
    """``method`` called through a weak reference to its object, so a
    callback kept by a group's parts (the transfer scheduler, its jobs,
    the group itself) does not make a cycle: a dropped cluster frees its
    params and pools at once, without waiting for the cycle collector."""
    ref = weakref.WeakMethod(method)

    def call(*args):
        bound = ref()
        return None if bound is None else bound(*args)
    return call


class ServeGroup:
    """One scenario-bound P/D group on real engines (paper §3.2-3.3).

    Internally event-driven: ``self.events`` is a (t, seq, kind, obj)
    min-heap sharing one virtual timeline with the TransferScheduler's
    link events. Event kinds: ``batch`` (a prefill node runs its formed
    batch), ``xfer`` (hand prefilled requests to decode), ``step`` (one
    decode iteration, self-rescheduling), ``absorb`` (one chunk of a
    prefill absorbed by a decode node), ``pump`` (bare scheduler retry
    point), ``scale`` (the AutoScaler's provision, drain re-check and
    wake events) and the fault controller's ``fault``, ``hb``, ``eject``,
    ``requeue`` and ``recover``. ``segment``, ``evict``, ``flip`` and
    ``rejoin`` are ledger-only entries of ``event_log``, as are the
    ``scale`` and ``eject`` entries a node joining, leaving or being
    evacuated writes."""

    def __init__(self, gid: str, scenario: str, cfg: ModelConfig, params,
                 meta: MetaStore, xfer: KVTransferEngine, *,
                 n_prefill: int = 1, n_decode: int = 1,
                 transfer_mode: str = "block_free",
                 overlap_transfer: bool = True,
                 iid_prefix: Optional[str] = None,
                 prefill_kwargs: Optional[dict] = None,
                 decode_kwargs: Optional[dict] = None,
                 spec=None, fault_plan=None,
                 fault_kwargs: Optional[dict] = None,
                 service_model=None, absorb_prefill: bool = False):
        self.gid = gid
        self.scenario = scenario
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.meta = meta
        self.xfer = xfer
        self.transfer_mode = transfer_mode
        self.overlap_transfer = bool(overlap_transfer)
        self.sched: Optional[TransferScheduler] = TransferScheduler(
            xfer.link, seed=zlib.crc32(gid.encode()) & 0xFFFF,
            pick_dst=weak_call(self._sched_pick)) if overlap_transfer \
            else None
        self.vclock = 0.0                          # virtual seconds
        self.blocking_waits: List[float] = []      # sync-mode D2D stalls
        self.n_blocking_admits = 0
        self._blk_free_t = 0.0                     # blocking-mode link busy
        self.prefill_kwargs = dict(prefill_kwargs or {})
        self.decode_kwargs = dict(decode_kwargs or {})
        # the group's draft binding: every decode node it ever builds
        # (role flips and scale-ups included) runs the same draft
        if spec is not None:
            self.decode_kwargs.setdefault("spec", spec)
        self._prefix = f"{gid}/" if iid_prefix is None else iid_prefix
        self._n_p = itertools.count()
        self._n_d = itertools.count()
        meta.register_group(gid, scenario)
        self.prefills: List[PrefillNode] = [
            self._new_prefill(0.0) for _ in range(n_prefill)]
        self.decodes: List[DecodeNode] = [
            self._new_decode(0.0) for _ in range(n_decode)]
        self.rejections = 0            # requests no node would take (§3.5)
        self.probe_rejections = 0      # per-node placement probes that failed
        self.n_accepted = 0
        self.accepted: List[int] = []              # recent rids admitted
        # (t, old_iid, new_iid, "P->D" | "D->P") in virtual seconds; a
        # bounded window, n_flips the monotonic count
        self.flips: List[Tuple[float, str, str, str]] = []
        self.n_flips = 0
        self.scaler = None             # AutoScaler (scale events)
        self.scale_op = None           # in-flight ScaleOp (adjuster yields)
        self.absorb_prefill = bool(absorb_prefill)
        self.absorbs: Dict[str, int] = {
            "absorb_requests": 0, "absorb_chunks": 0,
            "absorb_tokens": 0, "absorb_displaced": 0}
        self.on_displaced = None       # gateway hook: crashed absorb jobs
        # observed timings, trimmed to a window by the handlers
        self.prefill_batch_s: List[float] = []     # charged s per batch
        self.decode_step_s: List[float] = []       # charged s per step
        self.gen_tokens: List[int] = []            # admitted target lengths
        self.ttft_s: List[float] = []              # submit -> first token
        self.events: List[Tuple[float, int, str, object]] = []
        self._eseq = itertools.count()
        self.event_log: List[Tuple[float, str]] = []
        self._tickless = False         # True while ClusterFrontend.serve
        self.on_capacity = None        # gateway hook: capacity may have freed
        # deterministic virtual service-time model: batch and step events
        # charge its costs instead of measured walls
        self.service_model = service_model
        self.ft: Optional[FaultTolerance] = None
        if fault_plan is not None:
            self.ft = FaultTolerance(self, fault_plan,
                                     **(fault_kwargs or {}))

    # ------------------------------------------------- node construction
    def _set_class(self, node, ncls):
        if ncls is not None:
            node.node_class = ncls.name
            node.prefill_scale = ncls.prefill_scale
            node.decode_scale = ncls.decode_scale
        return node

    def _new_prefill(self, t: float, *, iid: Optional[str] = None,
                     ncls=None) -> PrefillNode:
        iid = iid or f"{self._prefix}P{next(self._n_p)}"
        node = PrefillNode(iid, self.cfg, self.params, **self.prefill_kwargs)
        self.meta.gather_instance(t, iid, "P", self.gid)
        self.meta.health_report(t, iid)
        return self._set_class(node, ncls)

    def _new_decode(self, t: float, *, iid: Optional[str] = None,
                    ncls=None) -> DecodeNode:
        iid = iid or f"{self._prefix}D{next(self._n_d)}"
        node = DecodeNode(iid, self.cfg, self.params, **self.decode_kwargs)
        self.meta.gather_instance(t, iid, "D", self.gid)
        self.meta.health_report(t, iid)
        return self._set_class(node, ncls)

    # ---------------------------------------- autoscale node lifecycle
    def find_node(self, iid: str):
        for n in self.prefills + self.decodes:
            if n.iid == iid:
                return n
        return None

    def add_node(self, t: float, role: str, *, iid: Optional[str] = None,
                 ncls=None):
        """Provisioned capacity joins the group (the terminal event of a
        scale-up op): the node registers in the MetaStore, and fresh
        capacity retries stranded hand-offs and pending gateway work."""
        if role == "P":
            node = self._new_prefill(t, iid=iid, ncls=ncls)
            node.busy_until = t
            self.prefills.append(node)
        else:
            node = self._new_decode(t, iid=iid, ncls=ncls)
            node.busy_until = t
            self.decodes.append(node)
        self.event_log.append((t, "scale"))
        if self._tickless:
            for p in self.prefills:
                if p.waiting:
                    self.schedule(t, "xfer", p)
            if self.sched is not None and not self.sched.idle():
                self.schedule(t, "pump", None)
        if self.on_capacity is not None:
            self.on_capacity(t)
        return node

    def node_drained(self, node) -> bool:
        """No in-flight work left on a draining node (decommission can
        complete)."""
        if node in self.prefills:
            return not (node.forming or node.waiting)
        busy = bool(node.requests) or node._absorb_job is not None
        if self.sched is not None and self.sched.pending_for(node.iid):
            busy = True
        return not busy

    def remove_node(self, t: float, node):
        """Decommission a drained node out of the group (back to the
        shared pool; the AutoScaler owns the pool-side accounting)."""
        if node in self.prefills:
            self.prefills.remove(node)
        elif node in self.decodes:
            self.decodes.remove(node)
        self.meta.remove_instance(t, node.iid)
        self.event_log.append((t, "scale"))

    @property
    def ratio(self) -> Tuple[int, int]:
        return len(self.prefills), len(self.decodes)

    def load(self) -> int:
        """Requests anywhere in this group's pipeline (the gateway's
        least-loaded fallback signal for unknown scenarios)."""
        n = sum(len(p.forming) + len(p.waiting) for p in self.prefills)
        n += sum(len(d.requests) for d in self.decodes)
        n += sum(1 for d in self.decodes if d._absorb_job is not None)
        if self.sched is not None:
            n += len(self.sched.jobs) + len(self.sched.waiting)
        return n

    # ------------------------------- ingress (on-demand rejection, §3.5)
    def offer(self, req: ServeRequest, t: Optional[float] = None) -> bool:
        """Place ``req`` on a prefill node (prefix affinity first, then
        least SSE connections). ONE rejection is counted per request no
        node accepts. With ``t`` a batch event is scheduled."""
        for p in sorted(self.prefills,
                        key=lambda x: (-x.prefix_affinity(req),
                                       x.sse_connections)):
            if p.draining or p.crashed or p.ejected:
                continue   # logical removal: not a rejection
            if p.offer(req):
                self._placed(req, t)
                self.accepted.append(req.rid)
                self.n_accepted += 1
                if t is not None:
                    self._schedule_batch(p, max(t, p.busy_until))
                return True
            self.probe_rejections += 1
        self.rejections += 1
        return False

    def try_absorb(self, req: ServeRequest, t: float) -> bool:
        """Overload elasticity: when every prefill node rejected ``req``
        (and it has backed off at the gateway once, so transient bursts
        do not spill), a decode node with NO live decode work absorbs it
        as chunked prefill: the node's absorber engine (same params) runs
        ``prefix_align``-sized chunks between its decode steps, and the
        final chunk's stitched KV lands in the node's own pool."""
        if not self.absorb_prefill or req.gw_attempts < 1:
            return False
        total = len(req.tokens) + req.max_new_tokens + 1
        # a chunk's wall dwarfs co-resident decodes' TPOT budget: only an
        # idle node may start absorbing
        cands = [d for d in self.decodes
                 if not (d.draining or d.crashed or d.ejected)
                 and d._absorb_job is None
                 and not d.requests
                 and not (self.sched and self.sched.pending_for(d.iid))
                 and self._free_capacity(d) > 0]
        for d in sorted(cands, key=lambda d: (len(d.requests), d.iid)):
            eng = d.absorber()
            if d.pool.free_blocks < d.pool.blocks_for_tokens(total):
                continue
            d.pool.alloc(req.rid, total)   # reserve prompt + gen room NOW
            cuts = eng.chunk_bounds(len(req.tokens), ABSORB_CHUNK_TOKENS)
            job = AbsorbJob(
                req, d, eng.iter_chunks(
                    req.tokens, chunk_tokens=ABSORB_CHUNK_TOKENS,
                    frames=req.frames),
                n_left=len(cuts) + 1)
            d._absorb_job = job
            self._placed(req, t)
            self.accepted.append(req.rid)
            self.n_accepted += 1
            self.absorbs["absorb_requests"] += 1
            self.schedule(max(t, d.busy_until), "absorb", job)
            return True
        return False

    def _placed(self, req: ServeRequest, t: Optional[float]):
        """Stamp a request's placement on a node (``t`` None: the staged
        shim's frontier); its first ends its ``request.gateway`` span."""
        first = req.placed_t < 0.0
        req.placed_t = self.vclock if t is None else t
        if first and req.submit_t >= 0.0 and spans.on():
            spans.add("request.gateway", req.submit_t, req.placed_t,
                      (req.rid,))

    def _admitted(self, req: ServeRequest, t: float):
        """Stamp a request's admission into a decode slot at ``t``, which
        ends its ``request.handoff`` span."""
        req.admitted_t = t
        if req.prefill_t >= 0.0 and spans.on():
            spans.add("request.handoff", req.prefill_t, t, (req.rid,))

    # ------------------------------------- transfer-pipeline callbacks
    def _free_capacity(self, d: DecodeNode) -> int:
        """Decode slots not yet spoken for: free minus in-flight transfer
        jobs minus an absorbed prefill (its final chunk admits in place,
        so it claims one slot from the moment it starts)."""
        pend = self.sched.pending_for(d.iid) if self.sched else 0
        absorb = 1 if d._absorb_job is not None else 0
        return d.free_slot_count() - pend - absorb

    def _pick_decode(self, exclude: Tuple[DecodeNode, ...] = ()
                     ) -> Optional[DecodeNode]:
        cands = [d for d in self.decodes
                 if d not in exclude and d.can_admit()
                 and self._free_capacity(d) > 0
                 and not (self.sched
                          and d.iid in self.sched.failed_nodes)]
        return min(cands,
                   key=lambda d: len(d.requests)
                   + (self.sched.pending_for(d.iid) if self.sched else 0),
                   default=None)

    def _sched_pick(self, job: TransferJob) -> Optional[DecodeNode]:
        """Fallback target for a requeued job: prefer another node."""
        tgt = self._pick_decode(exclude=(job.dst,))
        return tgt if tgt is not None else self._pick_decode()

    def _on_admit(self, job: TransferJob):
        job.dst.finish_admit(job.req, job.out)
        self._admitted(job.req, job.admitted_t)
        self.gen_tokens.append(job.req.max_new_tokens)
        if self._tickless:
            self._schedule_step(job.dst,
                                max(job.admitted_t, job.dst.busy_until))

    # ------------------------------------------------------- event core
    def schedule(self, t: float, kind: str, obj: object = None):
        heapq.heappush(self.events, (t, next(self._eseq), kind, obj))

    def _schedule_batch(self, p: PrefillNode, t: float):
        if p._batch_evt:
            return
        p._batch_evt = True
        self.schedule(t, "batch", p)

    def _schedule_step(self, d: DecodeNode, t: float):
        if d._step_evt:
            return
        d._step_evt = True
        self.schedule(t, "step", d)

    def next_time(self) -> Optional[float]:
        """Earliest pending event (queued group events and link
        landings)."""
        t = self.events[0][0] if self.events else None
        if self.sched is not None and not self.sched.idle():
            ts = self.sched.next_event()
            if ts is not None and (t is None or ts < t):
                t = ts
        return t

    def advance(self, until: float):
        """Drain group events and link-segment landings in global
        nondecreasing virtual-time order, up to and including ``until``."""
        for _ in range(1_000_000):
            t_ev = self.events[0][0] if self.events else None
            t_sc = None
            if self.sched is not None and not self.sched.idle():
                t_sc = self.sched.next_event()
            if t_sc is not None and t_sc <= until \
                    and (t_ev is None or t_sc <= t_ev):
                self.vclock = max(self.vclock, t_sc)
                self.event_log.append((t_sc, "segment"))
                self.sched.pump(t_sc)
            elif t_ev is not None and t_ev <= until:
                t, _, kind, obj = heapq.heappop(self.events)
                if self.sched is not None:
                    self.sched.pump(t)
                self.vclock = max(self.vclock, t)
                self.event_log.append((t, kind))
                self._dispatch(kind, t, obj)
            else:
                return
        raise RuntimeError(f"event loop runaway in group {self.gid}")

    def _dispatch(self, kind: str, t: float, obj: object):
        if kind == "batch":
            self._ev_batch(t, obj)
        elif kind == "xfer":
            self._ev_xfer(t, obj)
        elif kind == "step":
            self._ev_step(t, obj)
        elif kind == "absorb":
            self._ev_absorb(t, obj)
        elif kind == "scale":
            if self.scaler is not None:
                self.scaler.on_event(t, self, obj)
        elif kind in ("fault", "hb", "eject", "requeue", "recover"):
            if self.ft is not None:
                self.ft.dispatch(kind, t, obj)
        # "pump": the pre-dispatch pump already retried waiting jobs

    # ------------------------------------------------------- handlers
    def _ev_batch(self, t: float, p: PrefillNode):
        """Run a prefill node's formed batch at virtual time ``t``: the
        node is busy until t + the charged seconds (the measured wall, or
        the service model's cost, times the node class's scale), TTFT
        ends at batch completion, and the transfer hand-off is
        scheduled."""
        p._batch_evt = False
        if not p.forming:
            return
        if p.busy_until > t + 1e-12:       # mid-batch: wait for the node
            self._schedule_batch(p, p.busy_until)
            return
        batch_rids = [r.rid for r in p.forming]
        batch_tokens = sum(len(r.tokens) for r in p.forming)
        on = spans.on()
        for req in p.forming:
            req.prefill_t = t
            if on and req.placed_t >= 0.0:
                spans.add("request.prefill_queue", req.placed_t, t,
                          (req.rid,))
        sp = spans.begin("prefill.batch", batch_rids, node=p.iid) \
            if on else None
        t0 = time.perf_counter()
        ready = p.run_batch(collect_layers=self.overlap_transfer)
        if sp is not None:
            spans.begin("prefill.sync")     # ends with the batch's span
        w = _wall(self.device, t0)
        if sp is not None:
            spans.finish(sp)
        if self.service_model is not None:
            w = self.service_model.prefill_batch_s(batch_tokens)
        w *= p.prefill_scale
        self.prefill_batch_s.append(w)
        done = t + w
        p.busy_until = done
        self.vclock = max(self.vclock, done)
        if self.sched is not None:
            for rid in batch_rids:
                p.batch_meta[rid] = (t, w)
        for req, _ in ready:
            # a crash-displaced re-admit keeps its ORIGINAL first-token
            # stamp: TTFT ended when the first prefill streamed it
            if req.first_token_t < 0.0:
                req.first_token_t = done
                if req.submit_t >= 0.0:
                    self.ttft_s.append(max(0.0, done - req.submit_t))
        self._note_evictions(p, t)
        # overlapped: layers stream DURING the compute window, so the
        # hand-off is stamped at batch start (Fig. 10); blocking transfer
        # moves the final KV at batch completion
        self.schedule(t if self.sched is not None else done, "xfer", p)
        if self.on_capacity is not None:   # forming slots freed
            self.on_capacity(done)
        self._trim_hists()

    def _ev_xfer(self, t: float, p: PrefillNode):
        """Hand prefilled requests to decode: pipelined transfer begin
        (overlapped) or inline blocking admission charging the D2D
        stall."""
        if not p.waiting:
            return
        for pair in [pr for pr in p.waiting
                     if len(pr[0].generated) >= pr[0].max_new_tokens + 1]:
            # budget exhausted at prefill: nothing to decode or transfer
            req, _ = pair
            p.waiting.remove(pair)
            req.done = True
            req.finish_t = max(t, req.first_token_t)
            p.pool.release(req.rid)
            p.batch_meta.pop(req.rid, None)
            p.staged.pop(req.rid, None)
            self.gen_tokens.append(req.max_new_tokens)
        remaining = []
        moved = False
        on = spans.on()
        for req, out in p.waiting:
            tgt = self._pick_decode()
            if tgt is None:
                remaining.append((req, out))
                continue
            sp = spans.begin("handoff.begin", (req.rid,), dst=tgt.iid) \
                if on else None
            if self.sched is not None:
                t0v, w = p.batch_meta.pop(req.rid, (t, 0.0))
                self.sched.begin(
                    req, out, src_iid=p.iid, dst=tgt, t_start=t0v,
                    compute_s=w, payloads=p.staged.pop(req.rid, None),
                    fracs=p.engine.layer_fractions() or None,
                    on_admit=weak_call(self._on_admit))
                p.pool.release(req.rid)
            else:
                tgt.admit(req, out, p.pool, self.xfer,
                          mode=self.transfer_mode)
                stall = self.xfer.stats[-1].time_s if out.k is not None \
                    else 0.0
                state_b = state_payload_nbytes(out)
                if state_b:
                    # the Mamba state and the cross KV cross the same
                    # link: state-only payloads pay wire time too
                    stall += self.xfer.link.time(state_b, 1)
                self.blocking_waits.append(stall)
                self.n_blocking_admits += 1
                start = max(t, self._blk_free_t)
                admitted = start + stall
                self._blk_free_t = admitted
                self.vclock = max(self.vclock, admitted)
                self._admitted(req, admitted)
                self.gen_tokens.append(req.max_new_tokens)
                if self._tickless:
                    self._schedule_step(tgt, max(admitted, tgt.busy_until))
            if sp is not None:
                spans.finish(sp)
            p.sse_connections -= 1
            moved = True
        p.waiting = remaining
        if moved and self.on_capacity is not None:
            self.on_capacity(t)

    def _ev_step(self, t: float, d: DecodeNode):
        """One decode iteration at virtual time ``t``; the node
        self-reschedules while it has requests, and completions retry the
        transfer hand-off (freed slots) at once."""
        d._step_evt = False
        if not d.requests:
            return
        if d.busy_until > t + 1e-12:
            self._schedule_step(d, d.busy_until)
            return
        n_slots = len(d.requests)
        sp = None
        if spans.on():
            eng = d.engine
            act = eng.active_slots()
            sp = spans.begin(
                "decode.step", [eng.rid[s] for s in act], node=d.iid,
                ctx=[int(eng.pos[s]) + 1 for s in act],
                blocks=sum(len(d.pool.owned(eng.rid[s])) for s in act))
        t0 = time.perf_counter()
        finished = d.step()
        w = _wall(self.device, t0)
        if sp is not None:
            spans.finish(sp)
        if self.service_model is not None:
            w = self.service_model.decode_step_s(n_slots)
        w *= d.decode_scale
        self.decode_step_s.append(w)
        done = t + w
        d.busy_until = done
        self.vclock = max(self.vclock, done)
        on = bool(finished) and spans.on()
        for req in finished:
            req.finish_t = done
            if on and req.admitted_t >= 0.0:
                spans.add("request.decode", req.admitted_t, done,
                          (req.rid,))
        if self._tickless:
            if d.requests:
                self._schedule_step(d, done)
            if finished:
                for p in self.prefills:
                    if p.waiting:
                        self.schedule(done, "xfer", p)
                if self.sched is not None and not self.sched.idle():
                    self.schedule(done, "pump", None)
        self._trim_hists()

    def _ev_absorb(self, t: float, job: AbsorbJob):
        """Run ONE chunk of an absorbed prefill on its decode node at
        virtual time ``t``: the chunk charges the node's busy window
        (scaled by its class's prefill cost), so decode steps and further
        chunks interleave on the heap. The final chunk writes the stitched
        KV into the node's own pool and admits the request in place:
        TTFT ends there."""
        if job.dead:
            return                      # crash evacuation re-offered it
        d = job.node
        req = job.req
        if d.crashed or d.ejected:
            # no fault controller claimed the job: requeue through the
            # gateway's displaced hook
            job.dead = True
            d._absorb_job = None
            d.pool.release(req.rid)
            self.absorbs["absorb_displaced"] += 1
            if self.on_displaced is not None:
                self.on_displaced(req, t)
            else:
                self.offer(req, t=t)
            return
        if d.busy_until > t + 1e-12:
            self.schedule(d.busy_until, "absorb", job)
            return
        if job.n_left == 1 and not d.engine.free_slots() \
                and req.max_new_tokens >= 1:
            # the last chunk admits in place and decode traffic took
            # every slot since the job started: poll until a step frees
            # one (the reserved blocks keep the admit itself safe)
            self.schedule(t + ABSORB_RETRY_S, "absorb", job)
            return
        t0 = time.perf_counter()
        n_chunk, out = next(job.chunks)
        w = _wall(self.device, t0)
        if self.service_model is not None:
            w = self.service_model.prefill_batch_s(n_chunk)
        w *= d.prefill_scale            # decode iron runs prefill slower
        done = t + w
        d.busy_until = done
        self.vclock = max(self.vclock, done)
        job.out = out
        job.n_left -= 1
        self.absorbs["absorb_chunks"] += 1
        self.absorbs["absorb_tokens"] += int(n_chunk)
        if job.n_left > 0:
            self.schedule(done, "absorb", job)
            return
        # final chunk: KV home, admit in place, the first token streams
        bs = d.pool.block_size
        if out.k is not None:
            d.pool.write_prefill(
                d.pool.owned(req.rid)[: (out.prompt_len + bs - 1) // bs],
                out.k, out.v)
        if req.first_token_t < 0.0:
            req.first_token_t = done
            if req.submit_t >= 0.0:
                self.ttft_s.append(max(0.0, done - req.submit_t))
        req.generated.append(out.first_token)
        if req.on_token:
            req.on_token(out.first_token)
        self.gen_tokens.append(req.max_new_tokens)
        d._absorb_job = None
        if len(req.generated) >= req.max_new_tokens + 1:
            # prefill-complete budget: nothing to decode; the reserved
            # blocks free without touching a slot
            req.done = True
            req.finish_t = done
            d.pool.release(req.rid)
            self._trim_hists()
            return
        d.finish_admit(req, out)
        self._admitted(req, done)
        if self._tickless:
            self._schedule_step(d, done)
        self._trim_hists()

    def _note_evictions(self, p: PrefillNode, t: float):
        new = p.pool.evictions - p._evictions_seen
        p._evictions_seen = p.pool.evictions
        for _ in range(int(new)):
            self.event_log.append((t, "evict"))

    def _trim_hists(self):
        for hist in (self.prefill_batch_s, self.decode_step_s,
                     self.gen_tokens, self.ttft_s, self.accepted,
                     self.blocking_waits):
            if len(hist) > 512:
                del hist[:-256]
        if len(self.event_log) > 4096:
            del self.event_log[:-2048]

    # ------------------------------------------ staged compatibility shim
    def _drain_queued(self):
        """Pop every queued group event in time order (staged shim: events
        never outrun the handlers that scheduled them), pumping the
        transfer scheduler in lockstep so segment landings and admissions
        interleave at their true times."""
        while self.events:
            t, _, kind, obj = heapq.heappop(self.events)
            if self.sched is not None:
                self.sched.pump(t)
            self.vclock = max(self.vclock, t)
            self.event_log.append((t, kind))
            self._dispatch(kind, t, obj)

    def tick(self, tick_no: int):
        """One legacy staged step over the event core: enqueue batch and
        transfer events at the current frontier, drain them (the scheduler
        pumped in lockstep), take ONE decode iteration per busy node, and
        jump the frontier to the next pending event if nothing advanced.
        Fault injection needs the tickless loop: draining pops queued
        events regardless of time, so a future-dated fault would fire
        early."""
        if self.ft is not None:
            raise RuntimeError(
                "fault injection requires the tickless event loop; the "
                "staged tick() shim cannot honor future-dated fault "
                "events")
        self._tickless = False
        vt0 = self.vclock
        for p in self.prefills:
            if p.forming:
                self._schedule_batch(p, max(self.vclock, p.busy_until))
            elif p.waiting:
                self.schedule(self.vclock, "xfer", p)
        self._drain_queued()
        # completed last layers fire decode admission
        if self.sched is not None:
            self.sched.pump(self.vclock)
        for d in self.decodes:
            if d.requests:
                self.event_log.append((self.vclock, "step"))
                self._ev_step(self.vclock, d)
        # progress guarantee: transfers in flight with the group otherwise
        # idle advance to the next link event instead of spinning ticks
        if self.vclock <= vt0:
            nxt = self.next_time()
            if nxt is not None:
                self.advance(nxt)
        self._trim_hists()
        self._complete_flips(tick_no)

    # --------------------------------- runtime role flips (§3.3 on real)
    def draining_nodes(self) -> List[str]:
        return [n.iid for n in self.prefills + self.decodes if n.draining]

    def request_flip(self, src_role: str, *, min_each: int = 1
                     ) -> Optional[str]:
        """Mark the least-loaded node of ``src_role`` as draining; the
        swap itself happens in _complete_flips once its in-flight work is
        done. Returns the draining iid, or None if the group cannot give
        up a node (min_each single-point-failure floor)."""
        if src_role == "P":
            live = [p for p in self.prefills
                    if not (p.draining or p.crashed or p.ejected)]
            if len(live) <= min_each:
                return None
            node = min(live, key=lambda p: (len(p.forming) + len(p.waiting),
                                            p.iid))
        else:
            live = [d for d in self.decodes
                    if not (d.draining or d.crashed or d.ejected)]
            if len(live) <= min_each:
                return None
            node = min(live, key=lambda d: (len(d.requests), d.iid))
        node.draining = True
        return node.iid

    def _complete_flips(self, t: float):
        """Swap every drained flipping node into the opposite role at
        ``t`` (virtual seconds under the event loop, the tick number under
        the staged shim): the old node leaves the group and the MetaStore
        (its pool goes with it), a node of the other role is built over
        the same params with a fresh pool and registered."""
        tf = float(t)
        flipped = False
        # decommissioning nodes drain OUT of the group (autoscale), not
        # into the opposite role: the scaler's re-check owns them
        for p in [x for x in self.prefills
                  if x.draining and not x.decommissioning]:
            if p.forming or p.waiting:
                continue   # in-flight prefill work must complete first
            self.prefills.remove(p)
            self.meta.remove_instance(tf, p.iid)
            d = inherit_class(self._new_decode(tf), p)  # same iron
            self.flips.append((t, p.iid, d.iid, "P->D"))
            self.n_flips += 1
            self.decodes.append(d)
            flipped = True
        for d in [x for x in self.decodes
                  if x.draining and not x.decommissioning]:
            if d.requests or d._absorb_job is not None \
                    or (self.sched is not None
                        and self.sched.pending_for(d.iid)):
                continue   # in-flight decodes/transfers must clear first
            self.decodes.remove(d)
            self.meta.remove_instance(tf, d.iid)
            p = inherit_class(self._new_prefill(tf), d)
            self.flips.append((t, d.iid, p.iid, "D->P"))
            self.n_flips += 1
            self.prefills.append(p)
            flipped = True
        if len(self.flips) > 512:
            del self.flips[:-256]
        if flipped:
            self.event_log.append((tf, "flip"))
            if self._tickless:
                # fresh capacity: retry queued hand-offs and stranded jobs
                for p in self.prefills:
                    if p.waiting:
                        self.schedule(tf, "xfer", p)
                if self.sched is not None and not self.sched.idle():
                    self.schedule(tf, "pump", None)
            if self.on_capacity is not None:
                self.on_capacity(tf)

    # ------------------------------------------------------------- stats
    def observed_profile(self, *, min_samples: int = 3
                         ) -> Optional[InstanceProfile]:
        """InstanceProfile from this group's own charged timings, for
        Eq. 1 when no profiled-in-advance numbers are supplied."""
        if (len(self.prefill_batch_s) < min_samples
                or len(self.decode_step_s) < min_samples):
            return None
        b_p = max(p.batch_size for p in self.prefills) if self.prefills \
            else 4
        b_d = max(d.engine.max_slots for d in self.decodes) if self.decodes \
            else 8
        # medians: the first samples per shape carry one-time warm-up
        # cost that would otherwise dominate the window
        return InstanceProfile(
            ttft_bs=max(_median(self.prefill_batch_s[-32:]), 1e-9), b_p=b_p,
            r_pre=1.0, tpot_bs=max(_median(self.decode_step_s[-32:]), 1e-9),
            b_d=b_d, gen_tokens=max(_mean(self.gen_tokens[-64:]), 1.0),
            xi=0.0)

    def prefix_stats(self) -> Dict[str, float]:
        """Aggregated prefix-reuse stats over this group's prefill nodes."""
        agg = {"lookups": 0.0, "hits": 0.0, "hit_tokens": 0.0,
               "evictions": 0.0, "cow_copies": 0.0,
               "compute_tokens": 0.0, "reused_tokens": 0.0,
               "snap_hits": 0.0, "snap_misses": 0.0,
               "snap_stores": 0.0, "snap_bytes": 0.0,
               "state_restores": 0.0}
        for p in self.prefills:
            for k, v in p.prefix_stats().items():
                agg[k] += v
        agg["hit_rate"] = agg["hits"] / agg["lookups"] if agg["lookups"] \
            else 0.0
        return agg

    def recent_admission_waits(self, n: int = 64) -> List[float]:
        """Tail of per-request admission waits (overlapped: scheduler
        ledger; blocking: D2D stalls), the RatioAdjuster's
        decode-pressure signal."""
        if self.sched is not None:
            return list(self.sched.admission_waits[-n:])
        return list(self.blocking_waits[-n:])

    def transfer_stats(self) -> Dict[str, float]:
        """Per-group D2D pipeline stats: the scheduler's virtual-time
        ledger (overlapped) or the blocking stalls, plus the group's
        charged engine times, prefill bucket telemetry, the absorption
        counters (``absorb_*``) and the scale (``scale_*``) and recovery
        (``ft_*``) ledgers. ``prefill_compile_count`` is the process-wide
        count of prefill graph keys (``step_graph.prefill_compile_count``,
        JAX's jit cache entries)."""
        if self.sched is not None:
            out = dict(self.sched.stats())
            out["overlapped"] = 1.0
        else:
            w = self.blocking_waits
            out = {
                "overlapped": 0.0,
                "jobs_admitted": float(self.n_blocking_admits),
                "retries": 0.0, "requeues": 0.0,
                "admission_wait_mean_s": _mean(w),
                "link_busy_s": sum(w),
                "state_segments": 0.0, "state_payload_bytes": 0.0,
            }
        out["decode_step_median_s"] = _median(self.decode_step_s[-32:])
        out["prefill_batch_median_s"] = _median(self.prefill_batch_s[-32:])
        engines = [p.engine for p in self.prefills]
        batches = sum(e.prefill_batches for e in engines)
        hits = sum(e.bucket_hits for e in engines)
        comp = sum(e.compute_tokens for e in engines)
        padt = sum(e.padded_tokens for e in engines)
        out["prefill_compile_count"] = float(prefill_compile_count())
        out["prefill_batches"] = float(batches)
        out["prefill_bucket_hit_rate"] = hits / batches if batches else 0.0
        out["prefill_pad_waste"] = padt / (comp + padt) \
            if comp + padt else 0.0
        for k, v in self.absorbs.items():   # chunked-prefill elasticity
            out[k] = float(v)
        if self.scaler is not None:         # autoscale ledger (scale_*)
            out.update(self.scaler.group_ledger(self.gid))
        if self.ft is not None:    # recovery ledger (serving/faults.py)
            out.update(self.ft.ledger())
        return out

    def stats(self) -> Dict[str, float]:
        n_p, n_d = self.ratio
        pf = self.prefix_stats()
        tf = self.transfer_stats()
        return {
            "n_p": n_p, "n_d": n_d,
            "accepted": self.n_accepted,
            "rejections": self.rejections,
            "probe_rejections": self.probe_rejections,
            "flips": self.n_flips,
            "ttft_s_mean": _mean(self.ttft_s),
            "prefix_hit_rate": pf["hit_rate"],
            "reused_tokens": pf["reused_tokens"],
            "transfer_overlapped": tf["overlapped"],
            "transfer_admission_wait_s": tf["admission_wait_mean_s"],
            "transfer_requeues": tf["requeues"],
        }


# the admission-wait vote: a spike is the last 4 waits' mean at
# WAIT_SPIKE x the earlier mean (floored at WAIT_MIN_S seconds); after a
# wait-driven flip the reverting flip waits WAIT_COOLDOWN intervals
WAIT_SPIKE = 2.0
WAIT_MIN_S = 1e-5
WAIT_COOLDOWN = 4


class RatioAdjuster:
    """Runtime P/D ratio adjustment for one ServeGroup (§3.3, Fig. 12).

    Every `interval` adjust steps: compute the Eq.1 optimum for the
    group's current node count from `profile` (profiled in advance) or
    from the group's observed timings, and flip ONE node toward it. When
    no profile is available yet, fall back to pure queue/TTFT pressure:
    gateway backlog + busy prefills + an idle decode means the prefill
    side is the bottleneck, and vice versa. A flip fires only after two
    consecutive adjust steps agree on the direction (hysteresis: noisy
    observed timings near the optimum must not ping-pong a node).
    The frontend fires an adjust step every ``adjust_period_s`` virtual
    seconds, numbered ``tick_no`` in multiples of ``interval`` (the
    numbering of the JAX package's staged ticks, which its hysteresis
    and cooldown arithmetic counts in).

    The per-group transfer pipeline's ADMISSION-WAIT ledger
    (ServeGroup.recent_admission_waits) weighs in alongside Eq.1 and the
    queue/TTFT pressure: prefilled KV waiting on a decode slot is decode
    starvation the TTFT-side signals cannot see, so a spike (recent
    waits >= WAIT_SPIKE x the earlier window) votes P->D. An
    agreeing-or-unopposed vote shifts the suggestion; a vote that
    contradicts Eq.1 cancels the step, and after a wait-driven flip the
    opposite (D->P) correction is suppressed for ``WAIT_COOLDOWN``
    adjust intervals — the relieved spike would otherwise expire
    immediately and Eq.1 would revert the flip every cycle, paying two
    node drains per round trip (conflicting evidence must not
    ping-pong nodes)."""

    def __init__(self, group: ServeGroup, *, interval: int = 8,
                 min_each: int = 1,
                 profile: Optional[InstanceProfile] = None):
        self.group = group
        self.interval = max(1, interval)
        self.min_each = min_each
        self.profile = profile
        self.decisions: List[Tuple[int, str]] = []
        self.wait_votes: List[int] = []    # ticks the wait signal fired
        self._last_want: Optional[str] = None
        self._wait_count = 0               # admissions seen at last eval
        self._wait_flip_tick: Optional[int] = None

    def _admission_wait_signal(self) -> Optional[str]:
        """P->D when the tail of admission waits spikes over the earlier
        window: segments are landing faster than decode frees slots.
        Only FRESH samples can vote — without new admissions since the
        last adjust tick the signal expires, so one historical burst
        cannot keep voting (or keep vetoing the corrective flip) on a
        quiet group."""
        g = self.group
        count = int(g.sched.n_admitted if g.sched is not None
                    else g.n_blocking_admits)
        fresh = count - self._wait_count
        self._wait_count = count
        if fresh <= 0:
            return None
        w = g.recent_admission_waits(64)
        if len(w) < 8:
            return None
        recent, base = _mean(w[-4:]), _mean(w[:-4])
        if recent >= WAIT_SPIKE * max(base, WAIT_MIN_S):
            return "P->D"
        return None

    def maybe_adjust(self, tick_no: int, backlog: int = 0) -> Optional[str]:
        """`backlog`: gateway-queued requests homed to this group."""
        if tick_no == 0 or tick_no % self.interval:
            return None
        g = self.group
        if len(self.decisions) > 512:       # windowed retention
            del self.decisions[:-256]
        if len(self.wait_votes) > 512:
            del self.wait_votes[:-256]
        if g.scale_op is not None:
            # the autoscaler has a provision/decommission in flight:
            # stand down (hysteresis too — a half-confirmed flip must
            # not fire against the post-scale capacity)
            self._last_want = None
            return None
        if g.draining_nodes():
            return None   # one flip in flight at a time
        n_p, n_d = g.ratio
        total = n_p + n_d
        if total < 2 * self.min_each + 1:
            return None   # nothing to flip without violating min_each
        wait_want = self._admission_wait_signal()
        if wait_want is not None:
            self.wait_votes.append(tick_no)
        prof = self.profile or g.observed_profile()
        if prof is not None:
            # profile leads: at the Eq.1 optimum, only the admission-wait
            # vote (decode starvation Eq.1's medians lag behind) can
            # shift the suggestion; plain pressure fall-through here
            # would oscillate
            t_p, _ = optimal_ratio(prof, total, min_each=self.min_each)
            if t_p > n_p:
                want = "D->P"
            elif t_p < n_p:
                want = "P->D"
            else:
                want = wait_want
        else:
            want = self._pressure_signal(backlog) or wait_want
        wait_driven = want is not None and want == wait_want
        if want is not None and wait_want is not None and want != wait_want:
            want = None                   # conflicting evidence: stand down
        if (want == "D->P" and self._wait_flip_tick is not None
                and tick_no - self._wait_flip_tick
                < WAIT_COOLDOWN * self.interval):
            want = None   # let the wait-driven extra decode prove itself
        if want is None:
            self._last_want = None
            return None
        if want != self._last_want:
            self._last_want = want        # needs confirmation next tick
            return None
        self._last_want = None
        if g.request_flip("D" if want == "D->P" else "P",
                          min_each=self.min_each) is None:
            return None
        if wait_driven:
            self._wait_flip_tick = tick_no
        self.decisions.append((tick_no, want))
        return want

    def _pressure_signal(self, backlog: int) -> Optional[str]:
        g = self.group
        tt = g.ttft_s
        ttft_rising = (len(tt) >= 16
                       and _mean(tt[-8:]) > 1.5 * _mean(tt[-16:-8]))
        prefill_busy = all(p.draining or not p.idle() for p in g.prefills)
        decode_idle = any(not d.draining and not d.requests
                          for d in g.decodes)
        if (backlog > 0 or ttft_rising) and prefill_busy and decode_idle:
            return "D->P"
        decode_full = all(not d.can_admit() for d in g.decodes)
        transfer_backlog = any(p.waiting for p in g.prefills)
        prefill_free = any(not p.draining and p.idle() for p in g.prefills)
        if decode_full and transfer_backlog and prefill_free:
            return "P->D"
        return None


class ClusterFrontend:
    """Gateway over N scenario groups on one shared virtual timeline
    (§3.2, §3.5).

    ``topology`` maps scenario tag -> (n_prefill, n_decode); groups are
    named g0, g1, ... in topology order. Requests route to their
    scenario's group first (unknown scenarios go to the least-loaded
    group) and forward across groups only when the home group rejects
    them everywhere. ``params`` (a port param tree) must live on
    ``device``; without them random params are drawn there from ``seed``
    (a torch generator: not the JAX package's numbers).

    Control plane: ``adjust_ratio`` gives each group a RatioAdjuster
    (``profiles`` maps a scenario to its InstanceProfile), stepped every
    ``adjust_period_s`` virtual seconds; ``faults`` (a FaultPlan, or a
    dict scenario -> FaultPlan) gives each group a FaultTolerance
    controller built with ``fault_kwargs``; ``service_model`` charges
    closed-form virtual costs in place of measured walls;
    ``health_timeout_s`` is the MetaStore's health timeout in virtual
    seconds; ``absorb_prefill`` lets idle decode nodes absorb requests no
    prefill node takes, as chunks of ``ABSORB_CHUNK_TOKENS``.

    ``tickless=True`` (default): ``run``/``serve`` drain arrivals and
    every group's events in global virtual-time order. ``tickless=False``
    keeps the legacy staged tick loop (``tick``), token-identical by test
    and refused together with ``faults``. ``spec`` binds a speculative
    draft per group (see ``_resolve_spec``)."""

    def __init__(self, cfg: ModelConfig, *,
                 topology: Optional[Dict[str, Tuple[int, int]]] = None,
                 seed: int = 0, transfer_mode: str = "block_free",
                 params=None, link: Optional[LinkModel] = None,
                 adjust_ratio: bool = False, adjust_interval: int = 8,
                 min_each: int = 1,
                 profiles: Optional[Dict[str, InstanceProfile]] = None,
                 flat_iids: bool = False,
                 prefill_kwargs: Optional[dict] = None,
                 decode_kwargs: Optional[dict] = None,
                 prefix_cache: bool = True,
                 overlap_transfer: bool = True,
                 tickless: bool = True,
                 adjust_period_s: float = 0.25,
                 spec=None, faults=None,
                 fault_kwargs: Optional[dict] = None,
                 service_model=None,
                 health_timeout_s: Optional[float] = None,
                 absorb_prefill: bool = False,
                 queue_bound: Optional[int] = None,
                 gw_backoff_base_s: float = 0.005,
                 gw_backoff_cap_s: float = 0.16,
                 gw_max_attempts: int = 8,
                 device: DeviceLike = "cuda"):
        topology = topology or {"default": (1, 1)}
        if faults is not None and not tickless:
            raise ValueError("fault injection (faults=) requires "
                             "tickless=True: the staged tick loop cannot "
                             "honor future-dated fault events")
        if flat_iids and len(topology) > 1:
            raise ValueError("flat_iids would collide instance ids across "
                             "groups; it is only for single-group shims")
        dev = resolve_device(device)
        if params is None:
            params = init_params(
                cfg, torch.Generator(device=dev).manual_seed(seed),
                device=dev)
        elif params["embed"].device.type != dev.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"not on device={str(device)!r}")
        prefill_kwargs = dict(prefill_kwargs or {})
        prefill_kwargs.setdefault("prefix_cache", prefix_cache)
        self.cfg = cfg
        self.params = params
        self.device = dev
        # per-store health timeout in VIRTUAL seconds (chaos runs use
        # sub-second timeouts; the store's default is wall-clock scale)
        self.meta = MetaStore() if health_timeout_s is None \
            else MetaStore(health_timeout_s=health_timeout_s)
        self.xfer = KVTransferEngine(link or LinkModel(), seed=seed)
        self.transfer_mode = transfer_mode
        self.tickless = bool(tickless)
        self.groups: Dict[str, ServeGroup] = {}
        self.adjusters: Dict[str, RatioAdjuster] = {}
        profiles = profiles or {}
        for i, (scenario, (n_p, n_d)) in enumerate(topology.items()):
            g = ServeGroup(
                f"g{i}", scenario, cfg, params, self.meta, self.xfer,
                n_prefill=n_p, n_decode=n_d, transfer_mode=transfer_mode,
                overlap_transfer=overlap_transfer,
                iid_prefix="" if flat_iids else None,
                prefill_kwargs=prefill_kwargs, decode_kwargs=decode_kwargs,
                spec=self._resolve_spec(spec, scenario, seed),
                fault_plan=(faults.get(scenario)
                            if isinstance(faults, dict) else faults),
                fault_kwargs=fault_kwargs, service_model=service_model,
                absorb_prefill=absorb_prefill)
            g.on_capacity = weak_call(self._note_capacity)
            g.on_displaced = weak_call(self._gw_requeue)
            self.groups[scenario] = g
            if adjust_ratio:
                self.adjusters[scenario] = RatioAdjuster(
                    g, interval=adjust_interval, min_each=min_each,
                    profile=profiles.get(scenario))
        self.pending: List[ServeRequest] = []
        self.tick_no = 0                    # staged shim's tick counter
        self.now = 0.0                      # gateway virtual-time frontier
        self.arrivals: List[Tuple[float, int, ServeRequest]] = []
        self._aseq = itertools.count()
        self._retry = False                 # capacity freed since last try
        self.adjust_period_s = float(adjust_period_s)
        self._next_adjust = self.adjust_period_s
        self._adjust_k = 0                  # adjust-step counter
        # gateway overload control: capped seeded backoff for timed
        # arrivals no group will take; ONLY past-deadline requests shed
        self.queue_bound = queue_bound
        self.gw_backoff_base_s = float(gw_backoff_base_s)
        self.gw_backoff_cap_s = float(gw_backoff_cap_s)
        self.gw_max_attempts = int(gw_max_attempts)
        self._gw_rng = random.Random((seed << 8) ^ 0x5CA1E)
        self.gw_requeues = 0
        self.gw_sheds = 0
        self.gw_backpressure = 0
        self.autoscaler = None              # attached by AutoScaler()
        self._next_autoscale = 0.0

    def attach_autoscaler(self, scaler):
        """Called by ``AutoScaler(frontend, ...)``: the frontend steps it
        every ``scaler.period_s`` virtual seconds, the groups hand it
        their ``scale`` events (it holds the frontend weakly)."""
        self.autoscaler = scaler
        for g in self.groups.values():
            g.scaler = scaler
        self._next_autoscale = scaler.period_s

    def _resolve_spec(self, spec, scenario: str, seed: int):
        """A group's draft binding from ``spec=``: None (plain greedy), a
        ``SpecConfig`` (one draft for every group), ``"auto"`` (the
        scenario-aware ``draft_for`` pick, on this frontend's device), or
        a dict {scenario: SpecConfig | "auto" | None} for mixed fleets."""
        if spec is None:
            return None
        if isinstance(spec, dict):
            spec = spec.get(scenario)
            if spec is None:
                return None
        if isinstance(spec, str):
            if spec != "auto":
                raise ValueError(f"spec={spec!r}: expected a SpecConfig, "
                                 f"'auto', a dict or None")
            return draft_for(self.cfg, scenario, seed=seed,
                             device=self.device)
        return spec

    @property
    def rejections(self) -> int:
        return sum(g.rejections for g in self.groups.values())

    def group_for(self, req: ServeRequest) -> ServeGroup:
        g = self.groups.get(getattr(req, "scenario", "default"))
        if g is not None:
            return g
        return min(self.groups.values(), key=lambda x: (x.load(), x.gid))

    # ---------------------------------------------------------- ingress
    def submit(self, req: ServeRequest, *, at: Optional[float] = None):
        """Hand a request to the gateway; ``at`` (virtual seconds)
        enqueues a timed open-loop arrival, else it arrives now (under the
        staged shim: at its home group's frontier)."""
        if at is not None:
            req.submit_t = at
            heapq.heappush(self.arrivals, (at, next(self._aseq), req))
            return
        req.submit_t = self.now if self.tickless \
            else self.group_for(req).vclock
        self.pending.append(req)

    def _try_place(self, req: ServeRequest, t: Optional[float]) -> bool:
        """Home group first, then cross-group fallback (§3.5); under
        overload, chunked-prefill absorption on an idle decode node is
        the last rung before the request waits at the gateway. The staged
        shim places with ``t=None``: no batch event, no absorption."""
        sp = spans.begin("gateway.place", (req.rid,)) if spans.on() \
            else None
        placed = self._place(req, t)
        if sp is not None:
            spans.finish(sp, outcome="placed" if placed else "rejected")
        return placed

    def _place(self, req: ServeRequest, t: Optional[float]) -> bool:
        home = self.group_for(req)
        if home.offer(req, t=t):
            return True
        for g in self.groups.values():
            if g is not home and g.offer(req, t=t):
                return True
        if t is None:
            return False
        if home.try_absorb(req, t):
            return True
        for g in self.groups.values():
            if g is not home and g.try_absorb(req, t):
                return True
        return False

    def _note_capacity(self, t: float):
        self._retry = True

    def _retry_pending(self):
        self._retry = False
        still: List[ServeRequest] = []
        for req in self.pending:
            if not self._try_place(req, self.now):
                still.append(req)
        self.pending = still

    # --------------------------------------- overload control (gateway)
    def queued_backlog(self, scenario: Optional[str] = None) -> int:
        """Requests waiting at the gateway (timed backoff requeues plus
        parked pending)."""
        n = 0
        for _, _, r in self.arrivals:
            if r.gw_attempts > 0 and (
                    scenario is None
                    or self.group_for(r).scenario == scenario):
                n += 1
        for r in self.pending:
            if scenario is None or self.group_for(r).scenario == scenario:
                n += 1
        return n

    def _gw_shed(self, req: ServeRequest, t: float):
        sp = spans.begin("gateway.place", (req.rid,)) if spans.on() \
            else None
        req.shed = True
        req.done = True
        req.finish_t = t
        self.gw_sheds += 1
        if sp is not None:
            spans.finish(sp, outcome="shed")

    def _gw_requeue(self, req: ServeRequest, t: float):
        """A timed arrival no group would take: capped, seeded
        exponential backoff. A request already past its deadline sheds
        now; past the attempt cap a deadline-less request parks in
        ``pending`` (capacity events retry it), one with a deadline
        schedules a final wake-up at the deadline."""
        if req.slo_deadline_s >= 0.0 and req.submit_t >= 0.0 \
                and t >= req.submit_t + req.slo_deadline_s:
            self._gw_shed(req, t)
            return
        sp = spans.begin("gateway.place", (req.rid,)) if spans.on() \
            else None
        outcome = self._backoff(req, t)
        if sp is not None:
            spans.finish(sp, outcome=outcome)

    def _backoff(self, req: ServeRequest, t: float) -> str:
        """Requeue ``req`` at the gateway or park it; says which."""
        if self.queue_bound is not None \
                and self.queued_backlog() >= self.queue_bound:
            self.gw_backpressure += 1
        a = req.gw_attempts
        req.gw_attempts = a + 1
        if a >= self.gw_max_attempts:
            if req.slo_deadline_s < 0.0 or req.submit_t < 0.0:
                self.pending.append(req)
                return "parked"
            t_next = max(req.submit_t + req.slo_deadline_s,
                         t + self.gw_backoff_cap_s)
        else:
            delay = min(self.gw_backoff_base_s * (2.0 ** a),
                        self.gw_backoff_cap_s)
            t_next = t + delay * (1.0 + 0.1 * self._gw_rng.random())
        heapq.heappush(self.arrivals, (t_next, next(self._aseq), req))
        self.gw_requeues += 1
        return "requeued"

    # ------------------------------------------------- tickless event loop
    def serve(self, *, deadline: Optional[float] = None,
              watch: Optional[Sequence[ServeRequest]] = None,
              max_events: int = 1_000_000):
        """Drain the shared timeline (gateway arrivals, per-group events
        and link-segment landings) in global nondecreasing virtual time,
        until ``deadline``, until the ``watch`` requests are done, or
        until the timeline is empty."""
        for g in self.groups.values():
            g._tickless = True
        sp = spans.begin("serve", deadline=deadline) if spans.on() else None
        try:
            if self.pending:
                self._retry_pending()
            for _ in range(max_events):
                t_arr = self.arrivals[0][0] if self.arrivals else None
                t_grp, g_next = None, None
                for g in self.groups.values():
                    tg = g.next_time()
                    if tg is not None and (t_grp is None or tg < t_grp):
                        t_grp, g_next = tg, g
                if t_arr is None and t_grp is None:
                    break
                if t_arr is not None and (t_grp is None or t_arr <= t_grp):
                    if deadline is not None and t_arr > deadline:
                        break
                    _, _, req = heapq.heappop(self.arrivals)
                    self.now = max(self.now, t_arr)
                    if not (req.done or req.shed):
                        if req.gw_attempts == 0 \
                                and self.autoscaler is not None:
                            self.autoscaler.note_arrival(
                                self.group_for(req).scenario, t_arr,
                                gen_tokens=req.max_new_tokens)
                        if not self._try_place(req, t_arr):
                            self._gw_requeue(req, t_arr)
                else:
                    if deadline is not None and t_grp > deadline:
                        break
                    self.now = max(self.now, t_grp)
                    g_next.advance(t_grp)
                    if g_next.draining_nodes():
                        g_next._complete_flips(g_next.vclock)
                if self._retry and self.pending:
                    self._retry_pending()
                if self.adjusters and self.now >= self._next_adjust:
                    self._run_adjusters()
                if self.autoscaler is not None \
                        and self.now >= self._next_autoscale:
                    self.autoscaler.step(self.now)
                    self._next_autoscale = \
                        self.now + self.autoscaler.period_s
                if watch is not None and all(r.done for r in watch):
                    break
        finally:
            if sp is not None:
                spans.finish(sp)
            for g in self.groups.values():
                g._tickless = False

    def _run_adjusters(self):
        """Periodic adjust step on the event timeline: every
        ``adjust_period_s`` virtual seconds, with a step counter in
        multiples of each adjuster's interval so the tick-modulo contract
        (and its hysteresis/cooldown arithmetic) carries over unchanged."""
        self._adjust_k += 1
        backlog: Dict[str, int] = {}
        for req in self.pending:
            sc = self.group_for(req).scenario
            backlog[sc] = backlog.get(sc, 0) + 1
        for sc, adj in self.adjusters.items():
            adj.maybe_adjust(self._adjust_k * adj.interval,
                             backlog.get(sc, 0))
        self._next_adjust = self.now + self.adjust_period_s

    # ----------------------------------------------- staged tick (shim)
    def tick(self):
        """One staged tick: the gateway places what it can (home group
        first, then cross-group fallback), each group ticks, then the
        adjusters step on the tick counter."""
        still: List[ServeRequest] = []
        for req in self.pending:
            if not self._try_place(req, None):
                still.append(req)
        self.pending = still
        backlog: Dict[str, int] = {}
        for req in self.pending:
            sc = self.group_for(req).scenario
            backlog[sc] = backlog.get(sc, 0) + 1
        for g in self.groups.values():
            g.tick(self.tick_no)
        for sc, adj in self.adjusters.items():
            adj.maybe_adjust(self.tick_no, backlog.get(sc, 0))
        self.tick_no += 1
        self.now = max([self.now]
                       + [g.vclock for g in self.groups.values()])

    def run(self, requests: Sequence[ServeRequest], *,
            max_ticks: int = 200) -> List[ServeRequest]:
        """Submit ``requests`` now and serve until all are done: on the
        tickless timeline, or under the staged shim for at most
        ``max_ticks`` ticks."""
        if self.tickless:
            for r in requests:
                self.submit(r, at=self.now)
            self.serve(watch=list(requests))
            return list(requests)
        for r in requests:
            self.submit(r)
        for _ in range(max_ticks):
            self.tick()
            if all(r.done for r in requests):
                break
        return list(requests)

    def stats(self) -> Dict[str, Dict[str, float]]:
        return {sc: g.stats() for sc, g in self.groups.items()}

    def transfer_stats(self) -> Dict[str, Dict[str, float]]:
        return {sc: g.transfer_stats() for sc, g in self.groups.items()}

    def gateway_stats(self) -> Dict[str, float]:
        return {
            "gw_requeues": float(self.gw_requeues),
            "gw_sheds": float(self.gw_sheds),
            "gw_backpressure": float(self.gw_backpressure),
            "gw_backlog": float(self.queued_backlog()),
        }
