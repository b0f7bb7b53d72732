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
per-layer KV segment landings and decode steps are timestamped events
drained in nondecreasing virtual time, and each batch or step charges
its MEASURED wall time (synchronised with the card) as virtual seconds.
KV hand-off runs through the overlapped layer-wise pipeline by default
(serving/transfer_sched.py); ``overlap_transfer=False`` uses the
blocking transfer on the same timeline.

Not ported yet (each raises NotImplementedError naming its ROADMAP
item): the staged tick shim (``tickless=False``), ``adjust_ratio`` with
its RatioAdjuster and role flips, an attached autoscaler, ``faults=``,
``spec=``, ``absorb_prefill=True`` and the deterministic
``service_model``.
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

from repro_torch.core.transfer import KVTransferEngine, LinkModel
from repro_torch.core.zookeeper import MetaStore
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params
from repro_torch.scope import check_served, unported
from repro_torch.serving.cluster import DecodeNode, PrefillNode, ServeRequest
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

    Internally event-driven: ``self.events`` is a (t, seq, kind, node)
    min-heap sharing one virtual timeline with the TransferScheduler's
    link events. Event kinds: ``batch`` (a prefill node runs its formed
    batch), ``xfer`` (hand prefilled requests to decode), ``step`` (one
    decode iteration, self-rescheduling), ``pump`` (bare scheduler retry
    point); ``segment`` and ``evict`` are ledger-only entries of
    ``event_log``."""

    def __init__(self, gid: str, scenario: str, cfg: ModelConfig, params,
                 meta: MetaStore, xfer: KVTransferEngine, *,
                 n_prefill: int = 1, n_decode: int = 1,
                 transfer_mode: str = "block_free",
                 overlap_transfer: bool = True,
                 iid_prefix: Optional[str] = None,
                 prefill_kwargs: Optional[dict] = None,
                 decode_kwargs: Optional[dict] = None):
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
        # observed timings, trimmed to a window by the handlers
        self.prefill_batch_s: List[float] = []     # wall time per batch
        self.decode_step_s: List[float] = []       # wall time per step
        self.gen_tokens: List[int] = []            # admitted target lengths
        self.ttft_s: List[float] = []              # submit -> first token
        self.events: List[Tuple[float, int, str, object]] = []
        self._eseq = itertools.count()
        self.event_log: List[Tuple[float, str]] = []
        self._tickless = False         # True while ClusterFrontend.serve
        self.on_capacity = None        # gateway hook: capacity may have freed

    # ------------------------------------------------- node construction
    def _new_prefill(self, t: float) -> PrefillNode:
        iid = f"{self._prefix}P{next(self._n_p)}"
        node = PrefillNode(iid, self.cfg, self.params, **self.prefill_kwargs)
        self.meta.gather_instance(t, iid, "P", self.gid)
        self.meta.health_report(t, iid)
        return node

    def _new_decode(self, t: float) -> DecodeNode:
        iid = f"{self._prefix}D{next(self._n_d)}"
        node = DecodeNode(iid, self.cfg, self.params, **self.decode_kwargs)
        self.meta.gather_instance(t, iid, "D", self.gid)
        self.meta.health_report(t, iid)
        return node

    @property
    def ratio(self) -> Tuple[int, int]:
        return len(self.prefills), len(self.decodes)

    def load(self) -> int:
        """Requests anywhere in this group's pipeline (the gateway's
        least-loaded fallback signal for unknown scenarios)."""
        n = sum(len(p.forming) + len(p.waiting) for p in self.prefills)
        n += sum(len(d.requests) for d in self.decodes)
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
                continue
            if p.offer(req):
                self.accepted.append(req.rid)
                self.n_accepted += 1
                if t is not None:
                    self._schedule_batch(p, max(t, p.busy_until))
                return True
            self.probe_rejections += 1
        self.rejections += 1
        return False

    # ------------------------------------- transfer-pipeline callbacks
    def _free_capacity(self, d: DecodeNode) -> int:
        """Decode slots not yet spoken for by in-flight transfer jobs."""
        pend = self.sched.pending_for(d.iid) if self.sched else 0
        return d.free_slot_count() - pend

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
        # "pump": the pre-dispatch pump already retried waiting jobs

    # ------------------------------------------------------- handlers
    def _ev_batch(self, t: float, p: PrefillNode):
        """Run a prefill node's formed batch at virtual time ``t``: the
        node is busy until t + measured wall seconds, TTFT ends at batch
        completion, and the transfer hand-off is scheduled."""
        p._batch_evt = False
        if not p.forming:
            return
        if p.busy_until > t + 1e-12:       # mid-batch: wait for the node
            self._schedule_batch(p, p.busy_until)
            return
        batch_rids = [r.rid for r in p.forming]
        t0 = time.perf_counter()
        ready = p.run_batch(collect_layers=self.overlap_transfer)
        w = _wall(self.device, t0) * p.prefill_scale
        self.prefill_batch_s.append(w)
        done = t + w
        p.busy_until = done
        self.vclock = max(self.vclock, done)
        if self.sched is not None:
            for rid in batch_rids:
                p.batch_meta[rid] = (t, w)
        for req, _ in ready:
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
        for req, out in p.waiting:
            tgt = self._pick_decode()
            if tgt is None:
                remaining.append((req, out))
                continue
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
                    # the Mamba state crosses the same link: state-only
                    # payloads pay wire time too
                    stall += self.xfer.link.time(state_b, 1)
                self.blocking_waits.append(stall)
                self.n_blocking_admits += 1
                start = max(t, self._blk_free_t)
                admitted = start + stall
                self._blk_free_t = admitted
                self.vclock = max(self.vclock, admitted)
                self.gen_tokens.append(req.max_new_tokens)
                if self._tickless:
                    self._schedule_step(tgt, max(admitted, tgt.busy_until))
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
        t0 = time.perf_counter()
        finished = d.step()
        w = _wall(self.device, t0) * d.decode_scale
        self.decode_step_s.append(w)
        done = t + w
        d.busy_until = done
        self.vclock = max(self.vclock, done)
        for req in finished:
            req.finish_t = done
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

    # ------------------------------------------------------------- stats
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

    def transfer_stats(self) -> Dict[str, float]:
        """Per-group D2D pipeline stats: the scheduler's virtual-time
        ledger (overlapped) or the blocking stalls, plus the group's
        measured engine wall times and prefill bucket telemetry. (There
        is no compile count: the port runs eagerly.)"""
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
        out["prefill_batches"] = float(batches)
        out["prefill_bucket_hit_rate"] = hits / batches if batches else 0.0
        out["prefill_pad_waste"] = padt / (comp + padt) \
            if comp + padt else 0.0
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
            "ttft_s_mean": _mean(self.ttft_s),
            "prefix_hit_rate": pf["hit_rate"],
            "reused_tokens": pf["reused_tokens"],
            "transfer_overlapped": tf["overlapped"],
            "transfer_admission_wait_s": tf["admission_wait_mean_s"],
            "transfer_requeues": tf["requeues"],
        }


class ClusterFrontend:
    """Gateway over N scenario groups on one shared virtual timeline
    (§3.2, §3.5).

    ``topology`` maps scenario tag -> (n_prefill, n_decode); groups are
    named g0, g1, ... in topology order. Requests route to their
    scenario's group first (unknown scenarios go to the least-loaded
    group) and forward across groups only when the home group rejects
    them everywhere. ``params`` (a port param tree) must live on
    ``device``; without them random params are drawn there from ``seed``
    (a torch generator: not the JAX package's numbers)."""

    def __init__(self, cfg: ModelConfig, *,
                 topology: Optional[Dict[str, Tuple[int, int]]] = None,
                 seed: int = 0, transfer_mode: str = "block_free",
                 params=None, link: Optional[LinkModel] = None,
                 adjust_ratio: bool = False,
                 flat_iids: bool = False,
                 prefill_kwargs: Optional[dict] = None,
                 decode_kwargs: Optional[dict] = None,
                 prefix_cache: bool = True,
                 overlap_transfer: bool = True,
                 tickless: bool = True,
                 spec=None, faults=None, service_model=None,
                 absorb_prefill: bool = False,
                 queue_bound: Optional[int] = None,
                 gw_backoff_base_s: float = 0.005,
                 gw_backoff_cap_s: float = 0.16,
                 gw_max_attempts: int = 8,
                 device: DeviceLike = "cuda"):
        check_served(cfg)
        if not tickless:
            raise unported("the staged tick shim (tickless=False)", 12)
        if adjust_ratio:
            raise unported("runtime P/D ratio adjustment (adjust_ratio)", 16)
        if faults is not None or service_model is not None:
            raise unported("fault injection (faults=, service_model=)", 15)
        if spec is not None:
            raise unported("speculative decode (spec=)", 14)
        if absorb_prefill:
            raise unported("decode-side prefill absorption", 13)
        topology = topology or {"default": (1, 1)}
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
        self.meta = MetaStore()
        self.xfer = KVTransferEngine(link or LinkModel(), seed=seed)
        self.transfer_mode = transfer_mode
        self.tickless = True
        self.groups: Dict[str, ServeGroup] = {}
        for i, (scenario, (n_p, n_d)) in enumerate(topology.items()):
            g = ServeGroup(
                f"g{i}", scenario, cfg, params, self.meta, self.xfer,
                n_prefill=n_p, n_decode=n_d, transfer_mode=transfer_mode,
                overlap_transfer=overlap_transfer,
                iid_prefix="" if flat_iids else None,
                prefill_kwargs=prefill_kwargs, decode_kwargs=decode_kwargs)
            g.on_capacity = weak_call(self._note_capacity)
            self.groups[scenario] = g
        self.pending: List[ServeRequest] = []
        self.now = 0.0                      # gateway virtual-time frontier
        self.arrivals: List[Tuple[float, int, ServeRequest]] = []
        self._aseq = itertools.count()
        self._retry = False                 # capacity freed since last try
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

    def attach_autoscaler(self, scaler):
        raise unported("autoscaling", 16)

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
        enqueues a timed open-loop arrival, else it arrives now."""
        if at is not None:
            req.submit_t = at
            heapq.heappush(self.arrivals, (at, next(self._aseq), req))
            return
        req.submit_t = self.now
        self.pending.append(req)

    def _try_place(self, req: ServeRequest, t: Optional[float]) -> bool:
        """Home group first, then cross-group fallback (§3.5)."""
        home = self.group_for(req)
        if home.offer(req, t=t):
            return True
        for g in self.groups.values():
            if g is not home and g.offer(req, t=t):
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
        req.shed = True
        req.done = True
        req.finish_t = t
        self.gw_sheds += 1

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
        if self.queue_bound is not None \
                and self.queued_backlog() >= self.queue_bound:
            self.gw_backpressure += 1
        a = req.gw_attempts
        req.gw_attempts = a + 1
        if a >= self.gw_max_attempts:
            if req.slo_deadline_s < 0.0 or req.submit_t < 0.0:
                self.pending.append(req)
                return
            t_next = max(req.submit_t + req.slo_deadline_s,
                         t + self.gw_backoff_cap_s)
        else:
            delay = min(self.gw_backoff_base_s * (2.0 ** a),
                        self.gw_backoff_cap_s)
            t_next = t + delay * (1.0 + 0.1 * self._gw_rng.random())
        heapq.heappush(self.arrivals, (t_next, next(self._aseq), req))
        self.gw_requeues += 1

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
                        if not self._try_place(req, t_arr):
                            self._gw_requeue(req, t_arr)
                else:
                    if deadline is not None and t_grp > deadline:
                        break
                    self.now = max(self.now, t_grp)
                    g_next.advance(t_grp)
                if self._retry and self.pending:
                    self._retry_pending()
                if watch is not None and all(r.done for r in watch):
                    break
        finally:
            for g in self.groups.values():
                g._tickless = False

    def run(self, requests: Sequence[ServeRequest], *,
            max_ticks: int = 200) -> List[ServeRequest]:
        """Submit ``requests`` now and serve until all are done.
        (``max_ticks`` belongs to the staged shim; it is ignored.)"""
        for r in requests:
            self.submit(r, at=self.now)
        self.serve(watch=list(requests))
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
