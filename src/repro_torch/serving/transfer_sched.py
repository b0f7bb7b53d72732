"""Asynchronous, layer-wise-triggered KV transfer pipeline (paper §3.6,
Fig. 10) on the REAL data path.

The synchronous path moves a request's whole linearized KVCache in one
blocking message inside decode admission. This scheduler instead
consumes the PrefillEngine's layer stream: layer ``i``'s stripe of the
contiguous block-free buffer becomes sendable the moment layer ``i`` is
computed (offset/length arithmetic per Fig. 10), so transfer hides
behind the remaining layers' prefill compute and decode admission fires
when the LAST layer lands — not inside the prefill tick's critical
section.

Mechanics, all in virtual (modeled link) time but with REAL byte
movement between paged pools so delivery is bit-exact testable:

  * one directional link per (src, dst) instance pair, at most ONE
    message in flight per link, FIFO contention queueing across jobs;
  * per-layer segments stamped with ready times from the engine's
    network-depth fractions x the batch's measured compute time;
  * multi-hop conflicts (LinkModel.hops > 1) fail a segment send, pay
    the conflict penalty and retry; after ``max_retries`` the job
    escalates to a different decode node;
  * a job whose target decode node drains or fails mid-transfer is
    requeued: partially-written dst blocks are released and every
    segment is re-sent (from the sender's linearized buffer) to a
    fallback node picked by the owner's ``pick_dst`` callback;
  * the mamba recurrent state / encoder-decoder cross-attention KV that
    must survive the P->D handoff travels as a final "state" payload
    segment alongside the KV stripes, so hybrid / attn-free / enc-dec
    archs ride the same pipeline.

This virtual clock is the spine of the serving loop: ``ServeGroup``
drains its own event heap (batches, hand-offs, decode steps) in lockstep
with ``next_event()``/``pump()`` here, so segment landings interleave
with compute events in global nondecreasing virtual-time order.

Counterpart of ``src/repro/serving/transfer_sched.py``: each landed
layer stripe is scattered into the destination pool by the CUDA
``kv_scatter`` kernel (single-layer form) on the card.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.transfer import LinkModel, layer_slices
from repro_torch.serving import spans


@dataclass
class Segment:
    """One message on the wire: a layer stripe of the linearized buffer,
    or the trailing state payload (layer == -1)."""
    layer: int                   # attn-layer row; -1 == state payload
    offset: int                  # byte offset in the linearized buffer
    nbytes: int
    ready_t: float               # virtual time the payload is producible
    start_t: float = -1.0
    done_t: float = -1.0
    retries: int = 0
    delivered: bool = False


class _Link:
    """Directional src->dst link: single in-flight message, FIFO queue."""

    __slots__ = ("key", "free_t", "in_flight", "queue", "history",
                 "busy_s", "n_msgs", "nbytes")

    def __init__(self, key: Tuple[str, str]):
        self.key = key
        self.free_t = 0.0
        self.in_flight: Optional[Tuple["TransferJob", Segment]] = None
        self.queue: List[Tuple["TransferJob", Segment]] = []
        self.history: List[Tuple[float, float]] = []   # (start, done) sends
        self.busy_s = 0.0
        self.n_msgs = 0
        self.nbytes = 0

    def drop_job(self, job: "TransferJob"):
        self.queue = [(j, s) for j, s in self.queue if j is not job]
        if self.in_flight is not None and self.in_flight[0] is job:
            self.in_flight = None


@dataclass
class TransferJob:
    rid: int
    req: object
    out: object                       # PrefillOutput
    src_iid: str
    dst: object                       # .iid / .pool / .draining
    dst_blocks: List[int]
    n_kv_blocks: int
    segments: List[Segment]
    buf: Dict[int, torch.Tensor]      # layer -> (padded tokens, width)
    t_start: float                    # prefill batch start (virtual)
    compute_s: float                  # measured prefill compute
    prefill_done_t: float
    on_admit: Optional[Callable[["TransferJob"], None]] = None
    admitted_t: float = -1.0
    state: str = "active"             # active | waiting_dst | admitted
    requeues: int = 0

    @property
    def admission_wait(self) -> float:
        """prefill-done -> decode-admitted (the paper's hidden latency)."""
        return max(0.0, self.admitted_t - self.prefill_done_t)

    @property
    def transfer_busy_s(self) -> float:
        return sum(s.done_t - s.start_t for s in self.segments
                   if s.delivered)


def state_payload_nbytes(out) -> int:
    """Wire bytes of the non-KV state that must survive the P->D
    handoff: mamba recurrent/conv state (hybrid & attn-free archs) and
    encoder-decoder cross-attention KV."""
    n = 0
    for st in (out.mamba_state or {}).values():
        for arr in st.values():
            n += int(np.prod(arr.shape)) * 4
    for xk, xv in (out.cross or {}).values():
        n += (int(np.prod(xk.shape)) + int(np.prod(xv.shape))) * 4
    return n


class TransferScheduler:
    """Per-layer-triggered D2D transfer scheduler over real paged pools.

    Owner wires ``pick_dst`` (fallback decode-node selection for
    mid-transfer requeues) and passes destination objects exposing
    ``iid``, ``pool`` (PagedKVPool) and optionally ``draining``.
    """

    def __init__(self, link: LinkModel = LinkModel(), *, seed: int = 0,
                 max_retries: int = 4,
                 pick_dst: Optional[Callable[["TransferJob"],
                                             Optional[object]]] = None):
        self.link = link
        self.rng = random.Random(seed)
        self.max_retries = max_retries
        self.pick_dst = pick_dst
        self.links: Dict[Tuple[str, str], _Link] = {}
        self.jobs: List[TransferJob] = []
        self.waiting: List[TransferJob] = []      # requeued, no target yet
        self.completed: List[TransferJob] = []
        self.failed_nodes: set = set()
        self.now = 0.0
        # counters (monotonic — the completed/waits lists are windowed)
        self.n_admitted = 0
        self.n_retries = 0
        self.n_requeues = 0
        self.n_restores = 0               # failed nodes brought back
        self.n_flaps = 0                  # link outage windows injected
        self.n_src_failed = 0             # jobs killed by a src crash
        self.state_segments = 0           # trailing state payloads shipped
        self.state_bytes = 0              # ... and their wire bytes
        self.admission_waits: List[float] = []

    # ------------------------------------------------------------ intake
    def _link(self, src: str, dst: str) -> _Link:
        key = (src, dst)
        if key not in self.links:
            self.links[key] = _Link(key)
        return self.links[key]

    def begin(self, req, out, *, src_iid: str, dst, t_start: float = 0.0,
              compute_s: float = 0.0,
              payloads: Optional[Dict[int, torch.Tensor]] = None,
              fracs: Optional[Sequence[float]] = None,
              on_admit: Optional[Callable[["TransferJob"], None]] = None
              ) -> TransferJob:
        """Start the pipelined transfer of one prefilled request.

        ``payloads`` maps attn-layer index -> (tokens, width) KV stripe
        as streamed by PrefillEngine's layer mode; when omitted they are
        sliced from ``out.k``/``out.v``. ``fracs`` are the engine's
        network-depth layer fractions (uniform if omitted)."""
        rid = req.rid
        pool = dst.pool
        total = out.prompt_len + getattr(req, "max_new_tokens", 0) + 1
        dst_blocks = pool.alloc(rid, total)
        n_kv = pool.blocks_for_tokens(out.prompt_len) \
            if out.k is not None else 0
        segments: List[Segment] = []
        buf: Dict[int, torch.Tensor] = {}
        prefill_done = t_start + compute_s
        if n_kv:
            L = int(out.k.shape[0])
            if fracs is None:
                fracs = [(i + 1) / L for i in range(L)]
            stripe = pool.layer_nbytes(n_kv)
            slices = layer_slices(L, L * stripe)
            pad = n_kv * pool.block_size - out.prompt_len
            for li in range(L):
                if payloads is not None and li in payloads:
                    row = payloads[li]
                    if row.shape[-1] == out.k.shape[-1]:  # split k half only
                        row = torch.cat([row, out.v[li]], dim=-1)
                else:
                    row = torch.cat([out.k[li], out.v[li]], dim=-1)
                if pad:      # zero rows up to the block multiple
                    row = F.pad(row, (0, 0, 0, pad))
                buf[li] = row
                off, ln = slices[li]
                segments.append(Segment(
                    layer=li, offset=off, nbytes=ln,
                    ready_t=t_start + fracs[li] * compute_s))
        state_bytes = state_payload_nbytes(out)
        if state_bytes:
            # the recurrent/cross state is only final once the whole
            # forward is done: it ships last, alongside the KV payload.
            # Warm (prefix-reuse) SSM admissions ship the RESTORED state
            # advanced over the suffix — out.mamba_state comes straight
            # from run_suffix's snapshot-seeded forward, never a
            # recompute of the cached prefix
            segments.append(Segment(
                layer=-1, offset=sum(s.nbytes for s in segments),
                nbytes=state_bytes, ready_t=prefill_done))
            self.state_segments += 1
            self.state_bytes += state_bytes
        job = TransferJob(
            rid=rid, req=req, out=out, src_iid=src_iid, dst=dst,
            dst_blocks=dst_blocks, n_kv_blocks=n_kv, segments=segments,
            buf=buf, t_start=t_start, compute_s=compute_s,
            prefill_done_t=prefill_done, on_admit=on_admit)
        self.jobs.append(job)
        if segments:
            link = self._link(src_iid, dst.iid)
            link.queue.extend((job, s) for s in segments)
        else:
            self._admit(job, prefill_done)
        return job

    # ---------------------------------------------------------- failures
    def fail_node(self, iid: str):
        """Mark a decode node dead: every active job targeting it is
        requeued at the next pump."""
        self.failed_nodes.add(iid)

    def restore_node(self, iid: str):
        """Inverse of fail_node: a recovered (or substituted) node may
        receive transfers again. Without this the failed set was
        one-way — a node that rejoined the group could never be a
        transfer target for the rest of the process lifetime."""
        if iid in self.failed_nodes:
            self.failed_nodes.discard(iid)
            self.n_restores += 1

    def fail_src(self, iid: str) -> List["TransferJob"]:
        """A SOURCE (prefill) node crashed: every unadmitted job it was
        feeding dies with it — unlike a dst failure there is nothing to
        re-send from, the linearized buffer lived on the dead node.
        Partially-written dst blocks are released; the caller re-admits
        the affected requests through a healthy prefill (re-prefill of
        prompt + tokens emitted so far)."""
        doomed = [j for j in self.jobs if j.src_iid == iid]
        for job in doomed:
            self._link(job.src_iid, job.dst.iid).drop_job(job)
            if job.state == "active":
                job.dst.pool.release(job.rid)
            job.dst_blocks = []
            job.state = "failed_src"
            job.buf = {}
            self.jobs.remove(job)
            if job in self.waiting:
                self.waiting.remove(job)
            self.n_src_failed += 1
        return doomed

    def flap_link(self, src: str, dst: str, t: float, duration: float):
        """Link outage window [t, t+duration): the in-flight message (if
        any) is lost and retransmitted once the link returns; queued
        segments wait it out. Deterministic — no RNG involved."""
        link = self._link(src, dst)
        link.free_t = max(link.free_t, t + duration)
        if link.in_flight is not None:
            _, seg = link.in_flight
            if seg.done_t > t - 1e-12:       # mid-wire: full retransmit
                seg.start_t = t + duration
                seg.done_t = seg.start_t + self.link.time(seg.nbytes, 1)
                if link.history:
                    link.history[-1] = (seg.start_t, seg.done_t)
                link.free_t = max(link.free_t, seg.done_t)
        self.n_flaps += 1

    def _dst_gone(self, job: TransferJob) -> bool:
        return (job.dst.iid in self.failed_nodes
                or bool(getattr(job.dst, "draining", False)))

    def _requeue(self, job: TransferJob):
        """Target drained/failed (or conflict retries exhausted):
        release partially-written dst blocks and re-send everything to a
        fallback node. Bit-exactness is free — segments re-send from the
        sender's linearized buffer, which the job owns."""
        self._link(job.src_iid, job.dst.iid).drop_job(job)
        job.dst.pool.release(job.rid)
        job.dst_blocks = []
        job.requeues += 1
        self.n_requeues += 1
        for s in job.segments:
            s.delivered = False
            s.retries = 0
            s.start_t = s.done_t = -1.0
        self._place(job)

    def _place(self, job: TransferJob):
        new_dst = self.pick_dst(job) if self.pick_dst else None
        if new_dst is None or new_dst.iid in self.failed_nodes:
            job.state = "waiting_dst"
            if job not in self.waiting:
                self.waiting.append(job)
            return
        pool = new_dst.pool
        total = job.out.prompt_len + getattr(job.req, "max_new_tokens",
                                             0) + 1
        job.dst = new_dst
        job.dst_blocks = pool.alloc(job.rid, total)
        job.state = "active"
        if job in self.waiting:
            self.waiting.remove(job)
        if job.segments:
            link = self._link(job.src_iid, new_dst.iid)
            link.queue.extend((job, s) for s in job.segments)
        else:
            self._admit(job, max(self.now, job.prefill_done_t))

    # -------------------------------------------------------------- pump
    def pump(self, until: float) -> List[TransferJob]:
        """Advance the virtual clock to ``until``: start queued sends,
        complete in-flight ones, retry conflicts, requeue orphans and
        fire admissions. Returns jobs admitted by this pump."""
        until = max(until, self.now)
        admitted: List[TransferJob] = []
        for job in [j for j in self.jobs if j.state == "active"
                    and self._dst_gone(j)]:
            self._requeue(job)
        for job in list(self.waiting):
            self._place(job)
        progressed = True
        while progressed:
            progressed = False
            # snapshot: a conflict-escalation requeue inside
            # _complete_send may create a NEW (src,dst) link mid-loop
            for link in list(self.links.values()):
                if link.in_flight is not None:
                    job, seg = link.in_flight
                    if seg.done_t <= until:
                        link.in_flight = None
                        progressed = True
                        self._complete_send(link, job, seg, admitted)
                    continue
                if not link.queue:
                    continue
                job, seg = link.queue[0]
                start = max(link.free_t, seg.ready_t)
                if start > until:
                    continue
                link.queue.pop(0)
                seg.start_t = start
                seg.done_t = start + self.link.time(seg.nbytes, 1)
                link.history.append((seg.start_t, seg.done_t))
                del link.history[:-512]
                link.free_t = seg.done_t
                link.in_flight = (job, seg)
                progressed = True
        self.now = until
        return admitted

    def _complete_send(self, link: _Link, job: TransferJob, seg: Segment,
                       admitted: List[TransferJob]):
        if self._dst_gone(job):
            self._requeue(job)
            return
        # multi-hop conflict: the send failed, pay the penalty and retry
        if self.link.hops > 1 and self.link.conflict_prob > 0 \
                and self.rng.random() < self.link.conflict_prob:
            self.n_retries += 1
            seg.retries += 1
            link.free_t = seg.done_t \
                + self.rng.uniform(0.3, 1.0) * self.link.conflict_penalty
            seg.start_t = seg.done_t = -1.0
            if seg.retries > self.max_retries:
                self._requeue(job)       # escalate off the conflicted path
            else:
                link.queue.insert(0, (job, seg))
            return
        link.busy_s += seg.done_t - seg.start_t
        link.n_msgs += 1
        link.nbytes += seg.nbytes
        seg.delivered = True
        if seg.layer >= 0:
            # RecvScatter of this layer's stripe into the dst blocks
            job.dst.pool.scatter_layer(job.buf[seg.layer],
                                       job.dst_blocks[:job.n_kv_blocks],
                                       seg.layer)
        # state payload (layer == -1) rides on job.out and is applied at
        # admission (DecodeEngine.admit): only its wire time is modeled
        if all(s.delivered for s in job.segments):
            self._admit(job, max(seg.done_t, job.prefill_done_t))
            admitted.append(job)

    def _admit(self, job: TransferJob, t: float):
        sp = spans.begin("handoff.admit", (job.rid,)) if spans.on() \
            else None
        job.admitted_t = t
        job.state = "admitted"
        if job in self.jobs:
            self.jobs.remove(job)
        self.n_admitted += 1
        self.completed.append(job)
        del self.completed[:-512]
        self.admission_waits.append(job.admission_wait)
        del self.admission_waits[:-512]
        if job.on_admit:
            job.on_admit(job)
        # everything is scattered into the dst pool (and the state
        # payload applied at admission): drop the wire buffer, the
        # PrefillOutput and the destination node, so the completed-jobs
        # window pins no KV copies and no pool of a node that later
        # crashed, flipped its role or left the group
        job.buf = {}
        job.out = None
        job.dst = None
        if sp is not None:
            spans.finish(sp)

    # ----------------------------------------------------------- queries
    def next_event(self) -> Optional[float]:
        """Earliest virtual time at which pump() can make progress."""
        best: Optional[float] = None
        for link in self.links.values():
            if link.in_flight is not None:
                cand = link.in_flight[1].done_t
            elif link.queue:
                _, seg = link.queue[0]
                cand = max(link.free_t, seg.ready_t) \
                    + self.link.time(seg.nbytes, 1)
            else:
                continue
            best = cand if best is None else min(best, cand)
        return best

    def pending_for(self, iid: str) -> int:
        return sum(1 for j in self.jobs
                   if j.state == "active" and j.dst.iid == iid)

    def idle(self) -> bool:
        return not self.jobs and not self.waiting

    def stats(self) -> Dict[str, float]:
        n = len(self.admission_waits)
        waits = self.admission_waits
        return {
            "jobs_admitted": float(self.n_admitted),
            "jobs_in_flight": float(len(self.jobs)),
            "jobs_waiting_dst": float(len(self.waiting)),
            "retries": float(self.n_retries),
            "requeues": float(self.n_requeues),
            "node_restores": float(self.n_restores),
            "link_flaps": float(self.n_flaps),
            "src_failed_jobs": float(self.n_src_failed),
            "admission_wait_mean_s": sum(waits) / n if n else 0.0,
            "link_busy_s": sum(l.busy_s for l in self.links.values()),
            "link_msgs": float(sum(l.n_msgs for l in self.links.values())),
            "link_bytes": float(sum(l.nbytes for l in self.links.values())),
            "state_segments": float(self.state_segments),
            "state_payload_bytes": float(self.state_bytes),
        }
