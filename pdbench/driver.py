"""Drive one cell through the port's serving entry and record what it did.

``run_cell`` makes the weights from the seed, builds one
``ClusterFrontend`` with the cell's topology, pools and slots, warms it up
with the cell's own traffic (the prelude meets every prefill shape twice,
so each is captured; then the stream runs until the queue is steady),
and serves open-loop arrivals (``submit(at=)``) in short slices of virtual
time (``serve(deadline=)``), reading the real clock between slices. The
window ends when ``seconds`` of real time have passed.

With ``trace`` the harness puts spans around the program's layers from
its own files: CUDA events and a profiler range around each
``PrefillNode.run_batch`` and ``DecodeNode.step`` (wrapping the nodes'
methods), the work each prefill forward and decode step was given, and a
``torch.profiler`` trace of the window's last stretch. Without it the
program runs untouched. After the window the frontend is freed and the
served tokens are judged against the plain reference
(``pdbench/correct.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import time
import typing
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from pdbench import correct, weights
from pdbench.stats import Stamp
from pdbench.traffic import Mix, Req

SLICE_S = 0.05        # virtual seconds served between looks at the clock
BLOCK = 16            # tokens a KV block holds (the port's default)
PRELUDE_LIMIT_S = 600.0
LOOKAHEAD_S = 1.0     # virtual seconds of arrivals submitted ahead
SAMPLE_TOKENS = 2000  # served tokens the correctness sample aims at
SAMPLE_REQUESTS = 24
TRACE_S = 6.0         # real seconds of the window the profiler traces
# keys of a configuration file that the harness reads itself; every other
# key names a field of the port's ModelConfig
HARNESS_KEYS = ("source", "dtype", "tf32", "reduced", "assumed",
                "departures", "deployment", "checks", "min_tokens_compared",
                "reference")


def model_config(c: dict):
    """The port's ModelConfig of configuration file ``c``: every key but
    the harness's own (``HARNESS_KEYS``) names one of its fields, and a
    nested dataclass field (``moe``, ``ssm``, ...) is built from its dict
    by the field's declared type. Any other key raises ``KeyError``."""
    from repro_torch.models.config import ModelConfig
    return _build(ModelConfig, {k: v for k, v in c.items()
                                if k not in HARNESS_KEYS}, c.get("name"))


def _build(cls, d: dict, where):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - fields)
    if unknown:
        raise KeyError(f"configuration {where!r}: {unknown} name no field "
                       f"of {cls.__name__}")
    hints = typing.get_type_hints(cls)
    return cls(**{k: _value(hints[k], v, f"{where}.{k}")
                  for k, v in d.items()})


def _value(tp, v, where):
    """``v`` as field type ``tp`` takes it: a dict as its dataclass, a JSON
    list as its tuple (``Optional[X]`` looked through)."""
    for t in (tp, *typing.get_args(tp)):
        if dataclasses.is_dataclass(t) and isinstance(v, dict):
            return _build(t, v, where)
        if typing.get_origin(t) is tuple and isinstance(v, list):
            return tuple(v)
    return v


def pool_blocks(mix: Mix, m: dict) -> Dict[str, int]:
    """Pools sized for the worst case: every decode slot holding the
    longest request; the prefill node holding a running and a waiting
    batch of the longest prompt and one more, beside every shared
    prefix."""
    per_req = -(-mix.max_total() // BLOCK)
    per_prompt = -(-mix.max_prompt() // BLOCK)
    shared = sum(-(-len(p) // BLOCK) for p in mix.prefixes)
    return {"decode": m["decode_slots"] * per_req,
            "prefill": (2 * m["prefill_batch"] + 1) * per_prompt + shared}


class _Clock:
    """A span's start and end: CUDA events on the card, the host clock on
    the CPU (tests)."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        if cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)

    def start(self):
        if self.cuda:
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.cuda:
            self.b.record()
        else:
            self.t1 = time.perf_counter()

    def ms(self) -> float:
        return self.a.elapsed_time(self.b) if self.cuda \
            else (self.t1 - self.t0) * 1e3


@dataclass
class Span:
    clock: _Clock
    work: list            # prefill: (prefix, new) a prompt; decode: contexts
    in_stretch: bool
    table_entries: int = 0


@dataclass
class Record:
    """What one run saw; the per-layer readers read it."""
    config: dict
    setup_s: float = 0.0
    wall_s: float = 0.0            # real seconds of the window
    v_start: float = 0.0           # the window on the virtual timeline
    v_end: float = 0.0
    stamps: List[Stamp] = field(default_factory=list)
    prompt_tokens: int = 0         # of requests first served in the window
    output_tokens: int = 0         # made in the window
    first_tokens: int = 0          # of those, made by prefill
    counters: Dict[str, float] = field(default_factory=dict)  # deltas
    admission_waits: List[float] = field(default_factory=list)
    backlog: List[int] = field(default_factory=list)   # at start, at end
    memory_peak_bytes: int = 0
    captures: int = 0              # graphs captured inside the window
    sample: list = field(default_factory=list)          # judged requests
    prefill_spans: List[Span] = field(default_factory=list)
    decode_spans: List[Span] = field(default_factory=list)
    stretch: object = None     # the profiler, then a trace.Stretch
    check: Dict[str, float] = field(default_factory=dict)


def _counters(fe) -> Dict[str, float]:
    g = fe.groups["default"]
    out = {"gw_requeues": fe.gateway_stats()["gw_requeues"]}
    for k in ("compute_tokens", "padded_tokens", "reused_tokens"):
        out[k] = float(sum(getattr(p.engine, k) for p in g.prefills))
    out["fused_steps"] = float(sum(d.engine.fused_steps for d in g.decodes))
    out["admitted"] = float(g.sched.n_admitted) if g.sched is not None \
        else 0.0
    return out


def _backlog(reqs, v: float) -> int:
    """Requests due by ``v`` that have no first token yet."""
    return sum(1 for r in reqs if r.submit_t <= v and not r.generated
               and not r.shed)


class _Tracer:
    """The harness's spans around the program's layers (trace runs)."""

    def __init__(self, rec: Record, fe, cuda: bool):
        self.rec, self.cuda = rec, cuda
        self.on = False
        self.stretch = False
        self.work: list = []
        g = fe.groups["default"]
        for p in g.prefills:
            self._wrap_prefill(p)
        for d in g.decodes:
            self._wrap_decode(d)

    def _wrap_prefill(self, node):
        run_batch, eng = node.run_batch, node.engine
        run, run_suffix = eng.run, eng.run_suffix

        def traced_run(token_lists, *a, **k):
            self.work.extend((0, len(t)) for t in token_lists)
            return run(token_lists, *a, **k)

        def traced_suffix(suffix_tokens, *a, **k):
            self.work.append((int(k.get("prefix_len", 0)),
                              len(suffix_tokens)))
            return run_suffix(suffix_tokens, *a, **k)

        def traced_batch(collect_layers: bool = False):
            if not self.on:
                return run_batch(collect_layers)
            clock = _Clock(self.cuda)
            self.work = []
            with torch.profiler.record_function("pdbench.prefill_batch"):
                clock.start()
                out = run_batch(collect_layers)
                clock.stop()
            self.rec.prefill_spans.append(Span(clock, self.work,
                                               self.stretch))
            return out
        eng.run, eng.run_suffix = traced_run, traced_suffix
        node.run_batch = traced_batch

    def _wrap_decode(self, node):
        step = node.step
        bs = node.pool.block_size

        def traced_step():
            if not self.on:
                return step()
            ctx = [len(r.tokens) + len(r.generated)
                   for r in node.requests.values()]
            clock = _Clock(self.cuda)
            with torch.profiler.record_function("pdbench.decode_step"):
                clock.start()
                out = step()
                clock.stop()
            self.rec.decode_spans.append(Span(
                clock, ctx, self.stretch, sum(-(-x // bs) for x in ctx)))
            return out
        node.step = traced_step


def _sync(cuda: bool):
    if cuda:
        torch.cuda.synchronize()


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t_start: float, *, rate: Optional[float] = None,
             control: bool = False, judge: bool = True) -> Record:
    """One run of ``cell`` (see the module docstring). ``t_start`` is the
    host clock at process start (set-up is measured from it); ``rate``
    overrides the mix's arrival rate (the knee sweep); ``control`` also
    reads the TF32 control's gap on the same sample; ``judge=False`` skips
    the reference (the sweep)."""
    from repro_torch.serving import step_graph
    from repro_torch.serving.cluster import ServeRequest
    from repro_torch.serving.frontend import ClusterFrontend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"
    c, m = cell.config, dict(cell.traffic)
    if rate is not None:
        m["rate_per_s"] = rate
    rec = Record(config=c)
    w = weights.make(c, seed, device)
    mix = Mix(m, c["vocab_size"], seed)
    blocks = pool_blocks(mix, m)
    fe = ClusterFrontend(
        model_config(c), params=w, device=device, seed=seed,
        topology={"default": (m["prefill_nodes"], m["decode_nodes"])},
        prefill_kwargs={"num_blocks": blocks["prefill"],
                        "block_size": BLOCK,
                        "batch_size": m["prefill_batch"]},
        decode_kwargs={"num_blocks": blocks["decode"], "block_size": BLOCK,
                       "max_slots": m["decode_slots"]})

    def serve_req(r: Req) -> ServeRequest:
        return ServeRequest(r.rid, r.tokens, max_new_tokens=r.out_tokens - 1)

    everyone: List[ServeRequest] = []
    v = 0.0
    for group in mix.prelude():
        reqs = [serve_req(r) for r in group]
        everyone += reqs
        for r in reqs:
            fe.submit(r, at=v)
        while any(not r.generated for r in reqs):
            v += SLICE_S
            fe.serve(deadline=v)
            if v > PRELUDE_LIMIT_S:
                raise RuntimeError("the prelude did not finish")
    v0 = v
    blocks = mix.blocks()

    def submit_until(v_to: float):
        """Submit the stream's next blocks until one is due past v_to."""
        while not everyone or everyone[-1].submit_t <= v_to:
            for q in next(blocks):
                r = serve_req(q)
                everyone.append(r)
                fe.submit(r, at=v0 + q.at)

    def serve_to(v: float, until: float) -> float:
        while v < until:
            v += SLICE_S
            submit_until(v + LOOKAHEAD_S)
            fe.serve(deadline=v)
        return v
    v = serve_to(v, v0 + m["warm_virtual_s"])
    if trace:
        # the profiler's first start is slow: pay it in set-up
        _sync(cuda)
        _start_profiler(cuda).stop()

    # ---------------------------------------------------------- window
    tracer = _Tracer(rec, fe, cuda) if trace else None
    g = fe.groups["default"]
    before = _counters(fe)
    waits0 = g.sched.n_admitted if g.sched is not None else 0
    started = {r.rid for r in everyone if r.generated}
    done0 = {r.rid for r in everyone if r.done}
    out0 = sum(len(r.generated) for r in everyone)
    prof = None
    captures0 = step_graph.captures
    _sync(cuda)
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    rec.v_start = v
    rec.backlog.append(_backlog(everyone, v))
    if tracer is not None:
        tracer.on = True
    while time.perf_counter() - t0 < seconds:
        if trace and prof is None \
                and time.perf_counter() - t0 >= seconds - TRACE_S:
            _sync(cuda)
            prof = _start_profiler(cuda)
            t_prof = time.perf_counter()
            tracer.stretch = True
        v += SLICE_S
        submit_until(v + LOOKAHEAD_S)
        fe.serve(deadline=v)
    _sync(cuda)
    rec.wall_s = time.perf_counter() - t0
    if prof is not None:
        prof_wall = time.perf_counter() - t_prof
        prof.stop()
        rec.stretch = {"profile": prof, "wall_s": prof_wall}
    if tracer is not None:
        tracer.on = False
    rec.v_end = v
    rec.captures = step_graph.captures - captures0
    rec.memory_peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0

    # ------------------------------------------------------- the reading
    after = _counters(fe)
    rec.counters = {k: after[k] - before[k] for k in after}
    new_admits = int(after["admitted"]) - waits0
    if g.sched is not None and new_admits > 0:
        rec.admission_waits = list(g.sched.admission_waits[-new_admits:])
    rec.backlog.append(_backlog(everyone, v))
    last_tok = {}
    for d in g.decodes:
        for rid in d.requests:
            last_tok[rid] = d.busy_until
    for r in everyone:
        if r.rid not in started and r.generated:
            rec.prompt_tokens += len(r.tokens)
            rec.first_tokens += 1
        if rec.v_start <= r.submit_t < rec.v_end:
            last = r.finish_t if r.done else last_tok.get(r.rid, -1.0)
            rec.stamps.append(Stamp(r.submit_t, r.first_token_t, last,
                                    len(r.generated), failed=r.shed))
    rec.output_tokens = sum(len(r.generated) for r in everyone) - out0
    finished = [r for r in everyone
                if r.done and not r.shed and r.rid not in done0]
    rec.sample = [ServeRequest(r.rid, list(r.tokens),
                               max_new_tokens=r.max_new_tokens,
                               generated=list(r.generated))
                  for r in correct.sample(finished, seed, SAMPLE_TOKENS,
                                          SAMPLE_REQUESTS)]

    # the program's state is freed before the reference runs
    del fe, g, tracer, everyone, finished, last_tok
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if judge:
        rec.check = correct.gaps(c, w, rec.sample, device, control=control)
    return rec


def _start_profiler(cuda: bool):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof
