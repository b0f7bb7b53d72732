"""The serving path's span recorder (``repro_torch.serving.spans``) on the
CPU, through ``ClusterFrontend`` on reduced granite-3-8b: off it reads no
clock and records nothing; on, every request's virtual spans share its
rid, host spans nest, the decode step's attributes are the engine's, and
the served tokens do not change; a ``torch.profiler`` session alone turns
it on, on the profiler's clock, without adding a profiler event."""
import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.serving import spans
from repro_torch.serving.cluster import ServeRequest
from repro_torch.serving.faults import DeterministicService
from repro_torch.serving.frontend import ClusterFrontend

CFG = get_config("granite-3-8b").reduced()
N_REQ = 8
SPAN_NAMES = {"serve", "gateway.place", "prefill.batch", "prefill.lookup",
              "prefill.forward", "prefill.store", "prefill.sync",
              "handoff.begin", "handoff.admit", "decode.step",
              "decode.prep", "decode.replay", "decode.readback",
              "decode.retire", "host.gc", "request.gateway",
              "request.prefill_queue", "request.handoff", "request.decode"}


@pytest.fixture(autouse=True)
def _recorder_off():
    spans.start()
    spans.stop()
    yield
    spans.stop()


def _frontend():
    # two prefill slots, four decode slots and arrivals faster than the
    # service model's batches: requests queue at the gateway and on the
    # prefill node, at the same virtual times in every run
    return ClusterFrontend(CFG, device="cpu", seed=0,
                           service_model=DeterministicService(),
                           prefill_kwargs={"batch_size": 2},
                           decode_kwargs={"max_slots": 4})


def _requests():
    rng = np.random.default_rng(0)
    shared = [int(x) for x in rng.integers(1, CFG.vocab_size, 32)]
    return [ServeRequest(i, shared + [int(x) for x in rng.integers(
        1, CFG.vocab_size, int(rng.integers(4, 20)))],
        max_new_tokens=int(rng.integers(2, 8))) for i in range(N_REQ)]


def _serve(fe=None):
    fe = fe or _frontend()
    reqs = _requests()
    for i, r in enumerate(reqs):
        fe.submit(r, at=0.002 * i)
    fe.serve()
    assert all(r.done and not r.shed for r in reqs)
    return fe, reqs


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    calls = []
    real = time.time_ns
    monkeypatch.setattr(time, "time_ns", lambda: calls.append(1) or real())
    _serve()
    gc.collect()
    assert spans.recorded() == [] and not calls


def test_every_request_has_its_virtual_spans():
    spans.start()
    _, reqs = _serve()
    got = spans.recorded()
    assert spans.dropped == 0
    assert SPAN_NAMES - {"host.gc"} <= {s.name for s in got} <= SPAN_NAMES
    for r in reqs:
        mine = {s.name: s for s in got
                if s.clock == "virtual" and s.rids == (r.rid,)}
        assert set(mine) == {"request.gateway", "request.prefill_queue",
                             "request.handoff", "request.decode"}
        gw, pq = mine["request.gateway"], mine["request.prefill_queue"]
        ho, dec = mine["request.handoff"], mine["request.decode"]
        assert (gw.start, gw.end, pq.end, ho.end, dec.end) == (
            r.submit_t, r.placed_t, r.prefill_t, r.admitted_t, r.finish_t)
        assert gw.end == pq.start and pq.end == ho.start \
            and ho.end == dec.start
        assert r.submit_t <= r.placed_t <= r.prefill_t < r.first_token_t \
            <= r.admitted_t <= r.finish_t
    # the waits queue: some request waited at the gateway and on the node
    assert any(s.end > s.start for s in got if s.name == "request.gateway")
    assert any(s.end > s.start for s in got
               if s.name == "request.prefill_queue")


def test_children_lie_inside_their_parents():
    spans.start()
    _serve()
    got = spans.recorded()
    host = [s for s in got if s.clock == "host"]
    assert all(s.end is not None and s.start <= s.end for s in host)
    assert [s.id for s in got] == list(range(len(got)))
    parent_of = {"gateway.place": "serve", "prefill.batch": "serve",
                 "handoff.begin": "serve", "decode.step": "serve",
                 "prefill.lookup": "prefill.batch",
                 "prefill.forward": "prefill.batch",
                 "prefill.store": "prefill.batch",
                 "prefill.sync": "prefill.batch",
                 "decode.prep": "decode.step", "decode.replay": "decode.step",
                 "decode.readback": "decode.step",
                 "decode.retire": "decode.step"}
    for s in host:
        if s.parent is None:
            assert s.name in ("serve", "host.gc")
            continue
        p = got[s.parent]
        assert p.start <= s.start and s.end <= p.end, (s, p)
        if s.name in parent_of:
            assert p.name == parent_of[s.name], (s, p)
    # handoff.admit runs inside serve: in a hand-off or a decode step
    admits = [s for s in host if s.name == "handoff.admit"]
    assert len(admits) == N_REQ
    assert all(got[s.parent].name in ("serve", "handoff.begin")
               for s in admits)


def test_decode_step_attributes_are_the_engines():
    fe = _frontend()
    node = fe.groups["default"].decodes[0]
    eng = node.engine
    seen = []
    step = eng.step

    def watched():
        act = eng.active_slots()
        seen.append(([eng.rid[s] for s in act],
                     [int(eng.pos[s]) + 1 for s in act],
                     sum(len(node.pool.owned(eng.rid[s])) for s in act)))
        return step()
    eng.step = watched
    spans.start()
    _serve(fe)
    steps = [s for s in spans.recorded() if s.name == "decode.step"]
    assert seen and [(list(s.rids), s.attrs["ctx"], s.attrs["blocks"])
                     for s in steps] == seen
    assert all(s.attrs["node"] == node.iid for s in steps)
    modes = {s.attrs["mode"] for s in spans.recorded()
             if s.name == "decode.replay"}
    assert modes == {"eager"}          # no graphs on the CPU


def test_served_tokens_are_the_same_on_and_off():
    _, off = _serve()
    spans.start()
    _, on = _serve()
    assert len(spans.recorded()) > 0
    assert [r.generated for r in on] == [r.generated for r in off]
    assert [(r.submit_t, r.placed_t, r.prefill_t, r.admitted_t)
            for r in on] == [(r.submit_t, r.placed_t, r.prefill_t,
                              r.admitted_t) for r in off]


def test_a_profiler_session_alone_turns_the_recorder_on_and_off():
    fe = _frontend()
    assert not spans.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.on()
        _serve(fe)
    n = len(spans.recorded())
    assert n > 0 and not spans.on()
    _serve(fe)
    assert len(spans.recorded()) == n
    # a new session restarts the recording empty
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.on() and spans.recorded() == []


def test_spans_share_the_profilers_clock_and_add_no_event():
    fe = _frontend()
    for i, r in enumerate(_requests()):
        fe.submit(r, at=0.002 * i)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):    # a first range's set-up
            pass
        with record_function("probe"):
            fe.serve()
    probe = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "probe"]
    assert len(probe) == 1
    serve = [s for s in spans.recorded() if s.name == "serve"]
    assert len(serve) == 1
    assert abs(serve[0].start - probe[0].start_ns()) < 1_000_000
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert not names & SPAN_NAMES


def test_a_collection_inside_a_step_nests_a_gc_span():
    fe = _frontend()
    eng = fe.groups["default"].decodes[0].engine
    step = eng.step

    def collecting():
        gc.collect()
        return step()
    eng.step = collecting
    spans.start()
    _serve(fe)
    got = spans.recorded()
    gcs = [s for s in got if s.name == "host.gc"
           and s.parent is not None and got[s.parent].name == "decode.step"]
    assert gcs and all(s.attrs["generation"] == 2 for s in gcs)
    assert all(got[s.parent].start <= s.start <= s.end <= got[s.parent].end
               for s in gcs)


def test_the_recorder_is_bounded(monkeypatch):
    monkeypatch.setattr(spans, "LIMIT", 5)
    spans.start()
    _serve()
    assert len(spans.recorded()) == 5 and spans.dropped > 0
    spans.start()
    assert spans.recorded() == [] and spans.dropped == 0


def test_closing_a_span_closes_what_was_left_open_inside_it():
    spans.start()
    outer = spans.begin("serve")
    inner = spans.begin("decode.step")
    spans.finish(outer)                   # an exception skipped inner's
    after = spans.begin("serve")
    spans.finish(after)
    assert inner.end == outer.end and inner.parent == outer.id
    assert after.parent is None


@pytest.mark.parametrize("start", [True, False])
def test_a_profiler_session_under_start_keeps_the_recording(start):
    if start:
        spans.start()
    spans.add("request.gateway", 0.0, 1.0, (7,))
    assert spans.on() == start      # a span site between sessions
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.on()
    kept = [s for s in spans.recorded() if s.name == "request.gateway"]
    assert len(kept) == (1 if start else 0)
