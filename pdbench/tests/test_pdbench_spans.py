"""The readers of the program's spans (``device_idle_share.decode_step``,
``.prefill_batch``, ``.event_core``, ``gateway_wait_ms``,
``prefill_queue_ms``) on a synthetic stretch and synthetic spans."""
from types import SimpleNamespace

import pytest

from pdbench import spec
from pdbench.tests import tiny  # noqa: F401  (puts src on the path)
from pdbench.trace import Stretch
from repro_torch.serving import spans

IDLE = ("device_idle_share.decode_step", "device_idle_share.prefill_batch",
        "device_idle_share.event_core")
MS = 1_000_000          # ns


def _span(name, start, end, clock="host"):
    return spans.Span(name, start, end, None, (), {}, clock)


def _rec(kernels, wall_ns):
    return SimpleNamespace(stretch=Stretch(
        [("k", s, e) for s, e in kernels], [], wall_ns / 1e9))


def _read(name, rec, recorded, monkeypatch):
    monkeypatch.setattr(spans, "recorded", lambda: list(recorded))
    return spec.metric_reader(name)(rec)


def test_a_gap_straddling_span_boundaries_is_split_exactly(monkeypatch):
    # kernels 0-10 and 30-50 and 60-100 ms: gaps 10-30 and 50-60
    rec = _rec([(0, 10 * MS), (30 * MS, 50 * MS), (60 * MS, 100 * MS)],
               100 * MS)
    got = [_span("serve", 0, 100 * MS),
           _span("prefill.batch", 5 * MS, 14 * MS),   # 4 ms of gap 1
           _span("decode.step", 14 * MS, 22 * MS),    # 8 ms of gap 1
           _span("decode.prep", 14 * MS, 16 * MS),    # a child: counted once
           _span("decode.step", 48 * MS, 55 * MS),    # 5 ms of gap 2
           _span("decode.step", 58 * MS, 70 * MS),    # 2 ms of gap 2
           _span("request.gateway", 0.0, 0.05, clock="virtual")]
    shares = [_read(n, rec, got, monkeypatch) for n in IDLE]
    assert shares == pytest.approx([15 / 100, 4 / 100, 11 / 100])


def test_with_no_idle_edges_the_shares_sum_to_the_idle_share(monkeypatch):
    kernels = [(0, 3 * MS), (4 * MS, 9 * MS), (5 * MS, 7 * MS),
               (12 * MS, 20 * MS)]
    rec = _rec(kernels, 20 * MS)           # first kernel to last
    got = [_span("decode.step", 2 * MS, 5 * MS),
           _span("prefill.batch", 9 * MS, 11 * MS)]
    shares = [_read(n, rec, got, monkeypatch) for n in IDLE]
    idle = 1.0 - rec.stretch.busy_s() / rec.stretch.wall_s
    assert sum(shares) == pytest.approx(idle)
    assert shares == pytest.approx([1 / 20, 2 / 20, 1 / 20])


def test_gaps_are_laid_on_the_host_clock_by_the_readback_copies(
        monkeypatch):
    # the device's clock runs 2 ms behind the host's; on the host's:
    # busy 0-10, idle 10-14 (step), busy 14-39 ending with the copy of
    # the step's tokens, idle 39-40 (step) and 40-45 (batch), busy 45-60,
    # idle 60-62 (neither), busy 62-70
    lag = 2 * MS
    on_host = [(0, 10 * MS), (14 * MS, 39 * MS), (45 * MS, 60 * MS),
               (62 * MS, 70 * MS)]
    kernels = [("k", s - lag, e - lag) for s, e in on_host]
    kernels.append(("Memcpy DtoH (Device -> Pageable)", 38 * MS - lag,
                    39 * MS - lag))
    rec = SimpleNamespace(stretch=Stretch(kernels, [], 70 * MS / 1e9))
    got = [_span("decode.step", 10 * MS, 40 * MS),
           _span("decode.readback", 20 * MS, 39 * MS),
           _span("prefill.batch", 40 * MS, 60 * MS)]
    shares = [_read(n, rec, got, monkeypatch) for n in IDLE]
    assert shares == pytest.approx([5 / 70, 5 / 70, 2 / 70])
    # on the device's clock the split would read 5, 3 and 4 ms


def test_anchors_follow_a_drift_and_a_resync():
    import importlib.util
    path = spec.ROOT / "pdbench" / "metrics" / \
        "device_idle_share.decode_step.py"
    sp = importlib.util.spec_from_file_location("idle_split", path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    # readbacks every 25 ms; the device's clock drifts 0.1 ms a step
    # ahead, then snaps back to the host's at the fifth
    ends = [25 * MS * (i + 1) for i in range(8)]
    offs = [-100_000 * i for i in range(4)] + [0] * 4
    kernels = [("Memcpy DtoH (Device -> Pageable)", e - o - MS, e - o)
               for e, o in zip(ends, offs)]
    kernels.append(("Memcpy DtoH (Device -> Pageable)", 3 * MS, 4 * MS))
    host = [_span("decode.readback", e - 10 * MS, e) for e in ends]
    assert mod.anchors(kernels, host) == [
        (e - o, o) for e, o in zip(ends, offs)]


def test_no_kernels_or_no_spans_read_none(monkeypatch):
    some = [_span("decode.step", 0, MS)]
    for name in IDLE:
        assert _read(name, _rec([], MS), some, monkeypatch) is None
        assert _read(name, _rec([(0, MS)], MS), [], monkeypatch) is None
        assert _read(name, SimpleNamespace(stretch=None), some,
                     monkeypatch) is None
    for name in ("gateway_wait_ms", "prefill_queue_ms"):
        assert _read(name, None, some, monkeypatch) is None


def test_the_virtual_waits_are_means_in_ms(monkeypatch):
    got = [_span("request.gateway", 1.0, 1.0, "virtual"),
           _span("request.gateway", 2.0, 2.006, "virtual"),
           _span("request.prefill_queue", 1.0, 1.25, "virtual"),
           _span("request.prefill_queue", 2.006, 2.106, "virtual"),
           _span("request.prefill_queue", 3.0, 3.15, "virtual"),
           _span("request.handoff", 1.25, 9.0, "virtual"),
           _span("decode.step", 0, 10 * MS)]
    assert _read("gateway_wait_ms", None, got, monkeypatch) \
        == pytest.approx(3.0)
    assert _read("prefill_queue_ms", None, got, monkeypatch) \
        == pytest.approx(500 / 3)
