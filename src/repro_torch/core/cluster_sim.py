"""Discrete-event cluster simulator for paper-scale experiments.

Models the full P/D-Serve data path with the cost profiles from
`core.profiles`: gateway (on-demand rejection-based forwarding vs the
queue-status baseline), prefill instances (batching + prefix cache +
transfer-wait slots), decode instances (continuous batching + async KV
retrieval), the D2D link (block-fixed vs block-free), groups, faults.

Time is simulated seconds; the engine is a plain heapq event loop.
Copied from ``src/repro/core/cluster_sim.py``: with the same profile,
requests and seed it schedules the same events in the same order.
"""
from __future__ import annotations

import heapq
import itertools
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.profiles import ServingProfile
from repro_torch.core.requests import Request
from repro_torch.core.transfer import LinkModel


class SimClock:
    def __init__(self):
        self.t = 0.0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = itertools.count()

    def schedule(self, dt: float, fn: Callable[[], None]):
        heapq.heappush(self._heap, (self.t + max(dt, 0.0),
                                    next(self._seq), fn))

    def run_until(self, t_end: float):
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn = heapq.heappop(self._heap)
            self.t = t
            fn()
        self.t = max(self.t, t_end)

    def run_all(self, t_cap: float = float("inf")):
        self.run_until(t_cap)


# --------------------------------------------------------------------------
@dataclass
class SimConfig:
    profile: ServingProfile
    b_p: int = 4                  # prefill batch size
    b_d: int = 16                 # decode slots
    batch_window: float = 0.02    # prefill batch collect window (s)
    hbm_prefix_budget: int = 8 << 30
    transfer_mode: str = "block_free"     # | "block_fixed"
    per_layer_transfer: bool = False
    block_tokens: int = 16                # paged block size (tokens)
    layers: int = 32
    retrieval_queue: int = 2              # async-retrieval capacity (§3.6)
    link: LinkModel = field(default_factory=LinkModel)


class SimDecode:
    def __init__(self, sim: "ClusterSim", iid: str, cfg: SimConfig):
        self.sim = sim
        self.iid = iid
        self.cfg = cfg
        self.active: Dict[int, List] = {}    # rid -> [req, tokens_left]
        self.pending_retrieval: List[Request] = []
        self._iterating = False

    # admission from prefill: async retrieval with a SMALL queue
    def can_retrieve(self) -> bool:
        return (len(self.pending_retrieval) < self.cfg.retrieval_queue
                and len(self.active) + len(self.pending_retrieval)
                < self.cfg.b_d)

    def start_retrieval(self, req: Request, on_done: Callable[[], None]):
        self.pending_retrieval.append(req)
        nbytes = req.prompt_len * self.cfg.profile.kv_bytes_per_token
        block_bytes = self.cfg.block_tokens * self.cfg.profile.kv_bytes_per_token
        if self.cfg.transfer_mode == "block_free" \
                and self.cfg.per_layer_transfer:
            # per-layer triggering (Fig. 10): only the tail the prefill
            # compute could not hide is paid after prefill-done — the
            # SAME closed-form overlap model the real path's
            # TransferScheduler reports (see tests/test_transfer.py)
            t = self.cfg.link.per_layer_tail(
                nbytes, self.cfg.layers, req.t_prefill_compute)
        else:
            t = self.sim.transfer_time(nbytes, block_bytes)
        self.sim.d2d_times.append(t)

        def done():
            self.pending_retrieval.remove(req)
            req.t_transfer_done = self.sim.clock.t
            self.active[req.rid] = [req, req.output_tokens]
            self._kick()
            on_done()

        self.sim.clock.schedule(t, done)

    def _kick(self):
        if not self._iterating and self.active:
            self._iterating = True
            self.sim.clock.schedule(self._tpot(), self._iteration)

    def _tpot(self) -> float:
        return self.cfg.profile.tpot(max(len(self.active), 1))

    def _iteration(self):
        done_rids = []
        for rid, slot in self.active.items():
            slot[1] -= 1
            if slot[1] <= 0:
                done_rids.append(rid)
        for rid in done_rids:
            req = self.active.pop(rid)[0]
            req.t_done = self.sim.clock.t
            self.sim.completed.append(req)
            self.sim.on_decode_free(self)
        if self.active:
            self.sim.clock.schedule(self._tpot(), self._iteration)
        else:
            self._iterating = False


class SimPrefill:
    """No local queue (P/D-Serve): accept iff a batch seat AND a transfer
    slot are free, else reject. Baseline mode adds a FIFO local queue."""

    def __init__(self, sim: "ClusterSim", iid: str, cfg: SimConfig, *,
                 local_queue: bool = False):
        self.sim = sim
        self.iid = iid
        self.cfg = cfg
        self.local_queue = local_queue
        self.queue: List[Request] = []
        self.forming: List[Request] = []
        self.executing = False
        self.waiting_transfer = 0            # slots held for KV hand-off
        self.prefix_cache = PrefixCache(cfg.hbm_prefix_budget,
                                        cfg.profile.kv_bytes_per_token)
        self.sse_connections = 0
        self.busy_time = 0.0
        self.healthy = True
        self._window_armed = False

    # ------------------------------------------------------------ accept
    def slots_free(self) -> int:
        return self.cfg.b_p - self.waiting_transfer - len(self.forming) \
            - (self.cfg.b_p if self.executing else 0)

    def idle(self) -> bool:
        return self.healthy and not self.executing and self.slots_free() > 0

    def offer(self, req: Request) -> bool:
        """On-demand path: gateway asks; instance accepts or rejects."""
        if not self.idle():
            return False
        self._admit(req)
        return True

    def enqueue(self, req: Request):
        """Baseline path: scheduler pushes blindly into the local queue."""
        self.queue.append(req)
        self._drain_queue()

    def _drain_queue(self):
        while self.queue and self.idle():
            self._admit(self.queue.pop(0))

    def _admit(self, req: Request):
        req.t_accept = self.sim.clock.t
        self.sse_connections += 1
        self.forming.append(req)
        if len(self.forming) >= self.cfg.b_p:
            self._execute()
        elif not self._window_armed:
            self._window_armed = True
            self.sim.clock.schedule(self.cfg.batch_window, self._window_fire)

    def _window_fire(self):
        self._window_armed = False
        if self.forming and not self.executing:
            self._execute()

    # ----------------------------------------------------------- execute
    def _execute(self):
        batch = self.forming
        self.forming = []
        self.executing = True
        total_tokens = 0
        hit_tokens = 0
        for r in batch:
            cached = self.prefix_cache.lookup(r.prefix_id, r.prefix_len)
            if cached >= r.prefix_len:
                r.prefix_hit = True
                hit_tokens += cached
            else:
                self.prefix_cache.insert(r.prefix_id, r.prefix_len)
            total_tokens += r.prompt_len
        dt = self.cfg.profile.ttft(total_tokens, hit_tokens)
        for r in batch:
            r.t_prefill_compute = dt     # per-layer overlap window
        self.busy_time += dt
        self.sim.clock.schedule(dt, lambda: self._complete(batch))

    def _complete(self, batch: List[Request]):
        self.executing = False
        t = self.sim.clock.t
        for r in batch:
            # TTFT SLO check happens when prefill finishes (early
            # intervention also counts requests that exceeded it mid-run);
            # the gateway timeout watcher may have failed it already —
            # such requests consumed this batch's compute for nothing.
            r.t_prefill_done = t
            if r.timed_out:
                self.sse_connections -= 1
                continue
            if r.ttft > r.slo_ttft:
                r.timed_out = True
                self.sse_connections -= 1
                self.sim.failed.append(r)
                continue
            self.waiting_transfer += 1
            self.sim.route_to_decode(self, r)
        self._drain_queue()
        self.sim.on_prefill_idle(self)

    def transfer_started(self, req: Request):
        self.waiting_transfer -= 1
        self.sse_connections -= 1   # hand the stream over (sim simplification)
        self._drain_queue()
        self.sim.on_prefill_idle(self)


# --------------------------------------------------------------------------
class ClusterSim:
    """One P/D group (or a mixed pool) + gateway policy + link."""

    def __init__(self, cfg: SimConfig, *, n_prefill: int, n_decode: int,
                 policy: str = "ondemand", seed: int = 0,
                 retry_candidates: int = 4):
        self.cfg = cfg
        self.clock = SimClock()
        self.rng = random.Random(seed)
        self.policy = policy
        self.retry_candidates = retry_candidates
        lq = policy == "baseline"
        self.prefills = [SimPrefill(self, f"P{i}", cfg, local_queue=lq)
                         for i in range(n_prefill)]
        self.decodes = [SimDecode(self, f"D{i}", cfg)
                        for i in range(n_decode)]
        self.gateway_queue: List[Request] = []
        self.completed: List[Request] = []
        self.failed: List[Request] = []
        self.d2d_times: List[float] = []
        self.transfer_wait: List[Request] = []   # prefill-done, no decode slot

    # ------------------------------------------------------------- link
    def transfer_time(self, nbytes: int, block_bytes: int) -> float:
        if self.cfg.transfer_mode == "block_fixed":
            n_msgs = max(1, math.ceil(nbytes / block_bytes)) * self.cfg.layers
        else:
            n_msgs = self.cfg.layers if self.cfg.per_layer_transfer else 1
        return self.cfg.link.time(nbytes, n_msgs, self.rng)

    # ---------------------------------------------------------- ingress
    def submit(self, req: Request):
        if self.policy == "baseline":
            # queue-status scheduler: shortest queue by pending tokens
            tgt = min(self.prefills,
                      key=lambda p: sum(r.prompt_len for r in p.queue)
                      + sum(r.prompt_len for r in p.forming))
            tgt.enqueue(req)
            self._arm_timeout(req, where=tgt)
        else:
            self._try_assign(req)

    def _try_assign(self, req: Request):
        # least-SSE-connections ordering, retry over top candidates (§3.5)
        cands = sorted(self.prefills, key=lambda p: p.sse_connections)
        for p in cands[: self.retry_candidates]:
            if p.offer(req):
                return
            req.rejections += 1
        # all rejected: wait AT THE GATEWAY (not in a local queue)
        if req not in self.gateway_queue:
            self.gateway_queue.append(req)
            self._arm_timeout(req, where=None)

    def _arm_timeout(self, req: Request, where):
        def check():
            if req.t_prefill_done >= 0 or req.timed_out:
                return
            waited = self.clock.t - req.arrival
            if waited >= req.slo_ttft - 1e-9:
                req.timed_out = True
                if req in self.gateway_queue:
                    self.gateway_queue.remove(req)
                # NOTE: baseline keeps dead requests in the local queue —
                # "timeout intervention during prefill execution ... wastes
                # the computing power of xPU and is actually ignored"
                # (paper §4.2): they still consume batch seats when their
                # turn comes. This waste is what collapses Fig. 14a.
                self.failed.append(req)
            else:
                # min step guards against float-rounding non-progress
                self.clock.schedule(max(req.slo_ttft - waited, 1e-6), check)

        self.clock.schedule(
            max(req.slo_ttft - (self.clock.t - req.arrival), 1e-6), check)

    # ---------------------------------------------------------- routing
    def on_prefill_idle(self, p: SimPrefill):
        if self.policy != "baseline":
            pending = [r for r in self.gateway_queue if not r.timed_out]
            for r in pending:
                if not p.idle():
                    break
                if p.offer(r):
                    self.gateway_queue.remove(r)

    def route_to_decode(self, p: SimPrefill, req: Request):
        d = self._pick_decode()
        if d is None:
            self.transfer_wait.append((p, req))
            return
        d.start_retrieval(req, lambda: None)
        p.transfer_started(req)

    def _pick_decode(self) -> Optional[SimDecode]:
        free = [d for d in self.decodes if d.can_retrieve()]
        if not free:
            return None
        return min(free, key=lambda d: len(d.active)
                   + len(d.pending_retrieval))

    def on_decode_free(self, d: SimDecode):
        while self.transfer_wait and d.can_retrieve():
            p, req = self.transfer_wait.pop(0)
            d.start_retrieval(req, lambda: None)
            p.transfer_started(req)

    # ---------------------------------------------------------- metrics
    def metrics(self, horizon: float) -> Dict[str, float]:
        done = self.completed
        n_ok = len(done)
        n_fail = len(self.failed)
        tot = n_ok + n_fail
        ttfts = sorted(r.ttft for r in done if r.t_prefill_done >= 0)
        e2es = sorted(r.e2e for r in done)

        def pct(xs, p):
            return xs[min(int(p * len(xs)), len(xs) - 1)] if xs else 0.0

        n_inst = len(self.prefills) + len(self.decodes)
        return {
            "completed": n_ok,
            "failed": n_fail,
            "success_rate": n_ok / tot if tot else 1.0,
            "throughput_rps": n_ok / horizon,
            "phi": n_ok / horizon / max(n_inst, 1),
            "ttft_p50": pct(ttfts, 0.5),
            "ttft_p99": pct(ttfts, 0.99),
            "e2e_p50": pct(e2es, 0.5),
            "e2e_p99": pct(e2es, 0.99),
            "d2d_mean": (sum(self.d2d_times) / len(self.d2d_times)
                         if self.d2d_times else 0.0),
            "prefix_hit_rate": (
                sum(p.prefix_cache.hit_rate for p in self.prefills)
                / max(len(self.prefills), 1)),
        }


def run_workload(sim: ClusterSim, requests: Sequence[Request],
                 horizon: float) -> Dict[str, float]:
    for r in requests:
        sim.clock.schedule(r.arrival - sim.clock.t,
                           (lambda rr: (lambda: sim.submit(rr)))(r))
    sim.clock.run_until(horizon)
    return sim.metrics(horizon)
