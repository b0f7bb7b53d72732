"""Spans of the serving path, kept in memory.

A span is a named interval at a layer boundary of the serving path: its
``start`` and ``end``, the ``id`` of its ``parent`` (the innermost span
open when it began; the serving loop runs on one thread), the request
ids it concerns (``rids``) and a few ``attrs``. Host spans
(``clock == "host"``) are stamped with ``time.time_ns()``: CLOCK_REALTIME
nanoseconds, the clock ``torch.profiler`` converts its own host and
device timestamps to, so a span lines up with the kernels of a profile
taken at the same time. Request spans (``clock == "virtual"``) lie on the
frontend's virtual timeline in seconds, like ``ServeRequest.submit_t``,
and are recorded whole when they close.

The recorder is on between ``start()`` and ``stop()``, and also while a
``torch.profiler`` session records, so any profile of the serving path
collects its spans with no call from the caller. Recording restarts
empty at each ``start()``, and at each new profiler session met while
``start()`` is not in effect (a session is noticed at the first span
site it reaches). ``recorded()`` returns the spans in the order they
began. At most ``LIMIT`` spans are kept; ``dropped`` counts the rest.

A span site costs one ``on()`` check while the recorder is off, and
reads no clock and allocates nothing::

    sp = spans.begin("decode.step", node=d.iid) if spans.on() else None
    ...
    if sp is not None:
        spans.finish(sp)

The recorder opens no ``torch.profiler.record_function`` range: the
profiler would mirror such ranges onto the device timeline, where they
would read as device work. Its list is its only output.

Host spans, by layer (children nest in their parents):

  serve                       ClusterFrontend.serve
    gateway.place             a placement, a gateway requeue or shed
    prefill.batch             ServeGroup._ev_batch: the batch and its sync
      prefill.lookup          the prefix store's acquires
      prefill.forward         one cold forward or one warm suffix
      prefill.store           pool writes and prefix inserts after it
      prefill.sync            the card's sync that ends the batch
    handoff.begin             one hand-off to a decode node
    handoff.admit             TransferScheduler._admit: into a slot
    decode.step               ServeGroup._ev_step: the step and its sync
      decode.prep             slot mirrors, room check, shape key
      decode.replay           the graph (or eager) step
      decode.readback         the step's one device-to-host copy
      decode.retire           appends, evictions and releases
  host.gc                     Python's garbage collector, wherever it ran

Request spans: ``request.gateway`` (due to placement on a node),
``request.prefill_queue`` (placement to the start of its prefill batch),
``request.handoff`` (batch start to admission into a decode slot) and
``request.decode`` (admission to finish).
"""
from __future__ import annotations

import gc
import time
from typing import List, Optional

import torch

LIMIT = 1 << 20       # spans kept; past it they are dropped and counted

_profiling = torch._C._autograd._profiler_enabled


class Span:
    __slots__ = ("id", "name", "start", "end", "parent", "rids", "attrs",
                 "clock")

    def __init__(self, name: str, start, end, parent, rids, attrs: dict,
                 clock: str):
        self.id = -1          # its index in recorded()
        self.name = name
        self.start = start    # host: ns (CLOCK_REALTIME); virtual: s
        self.end = end        # None while open
        self.parent = parent  # id of the enclosing span, or None
        self.rids = rids
        self.attrs = attrs
        self.clock = clock

    def __repr__(self) -> str:
        return (f"Span({self.id}, {self.name!r}, {self.start}, {self.end}, "
                f"parent={self.parent}, rids={self.rids}, {self.attrs})")


_spans: List[Span] = []
_open: List[Span] = []      # the open host spans, innermost last
dropped = 0
_started = False            # start() in effect
_in_session = False         # a profiler session was seen recording


def _reset():
    global dropped
    _spans.clear()
    _open.clear()
    dropped = 0


def start():
    """Turn the recorder on, empty."""
    global _started
    _reset()
    _started = True


def stop():
    """Turn the operator's switch off (a profiler session still records)."""
    global _started
    _started = False


def on() -> bool:
    """Whether a span site records now."""
    global _in_session
    if _profiling():
        if not _in_session:
            _in_session = True
            if not _started:
                _reset()
        return True
    _in_session = False
    return _started


def recorded() -> List[Span]:
    """The spans recorded since the recording last restarted."""
    return list(_spans)


def _keep(name, start, end, parent, rids, attrs, clock) -> Optional[Span]:
    global dropped
    if len(_spans) >= LIMIT:
        dropped += 1
        return None
    sp = Span(name, start, end, parent, rids, attrs, clock)
    # numbered once made: making it may run the collector, whose own
    # span is kept first
    sp.id = len(_spans)
    _spans.append(sp)
    return sp


def begin(name: str, rids=(), **attrs) -> Optional[Span]:
    """Open a host span now (call only when ``on()``); None if dropped."""
    parent = _open[-1].id if _open else None
    sp = _keep(name, time.time_ns(), None, parent, tuple(rids), attrs,
               "host")
    if sp is not None:
        _open.append(sp)
    return sp


def finish(sp: Span, **attrs):
    """Close ``sp`` now, with more attributes. Spans opened inside it and
    still open (a closing sync, or an exception passed through them)
    close with it."""
    t = time.time_ns()
    sp.end = t
    if attrs:
        sp.attrs.update(attrs)
    if sp in _open:
        while True:
            inner = _open.pop()
            if inner.end is None:
                inner.end = t
            if inner is sp:
                break


def then(sp: Span, name: str, rids=(), **attrs) -> Optional[Span]:
    """Close ``sp`` and open its next sibling ``name``."""
    finish(sp)
    return begin(name, rids, **attrs)


def add(name: str, start: float, end: float, rids=(), **attrs):
    """Record a closed span of the virtual timeline (call only when
    ``on()``)."""
    _keep(name, start, end, None, tuple(rids), attrs, "virtual")


_gc_span: Optional[Span] = None


def _on_gc(phase: str, info: dict):
    global _gc_span
    if phase == "start":
        _gc_span = begin("host.gc") if on() else None
    elif _gc_span is not None:
        finish(_gc_span, generation=info["generation"],
               collected=info["collected"])
        _gc_span = None


gc.callbacks.append(_on_gc)
