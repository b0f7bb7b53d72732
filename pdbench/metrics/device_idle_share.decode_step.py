"""Share of the profiled stretch's wall time in which the device was idle
while the host was inside a ``decode.step`` span of the program
(``repro_torch.serving.spans``): device-idle time between the stretch's
first and last kernel, split exactly at span boundaries, over the wall.

``split`` is shared by the other ``device_idle_share.*`` readers: the
idle nanoseconds under ``decode.step``, under ``prefill.batch``, and
outside both (the event core, the gateway, the hand-off, the collector
outside a step and the caller's loop). Their sum is the idle time
between the first and the last kernel. None without kernels or without
the program's spans (a CPU run, or a program that records none).

The spans share the profiler's host clock, but on the H100 the
profiler's device timestamps drift from it (up to tens of ms within a
stretch, then snap back). So each idle gap is laid onto the host's
timeline by the offset of the nearest anchors: a ``decode.readback``
span ends as the device-to-host copy of its step's tokens does."""
import bisect

WINDOW_NS = 3_000_000   # drift between two anchors, at most


def _merged(iv):
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_ns(a, b) -> int:
    """Summed length where two sorted lists of disjoint intervals meet."""
    tot = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def anchors(kernels, host):
    """(device ns, host minus device ns) at each ``decode.readback`` span
    whose copy is found near the last offset or near none (a resync)."""
    copies = sorted(e for n, _, e in kernels if "DtoH" in n)
    out, off = [], 0
    for sp in sorted((s for s in host if s.name == "decode.readback"),
                     key=lambda s: s.start):
        for guess in (off, 0):
            want = sp.end - guess
            lo = bisect.bisect_left(copies, want - WINDOW_NS)
            hi = bisect.bisect_right(copies, want + WINDOW_NS)
            if lo < hi:
                got = min(copies[lo:hi], key=lambda c: abs(want - c))
                off = sp.end - got
                out.append((got, off))
                break
    return out


def _offset(anc, t):
    """Host minus device ns at device time ``t``, between anchors."""
    if not anc:
        return 0
    i = bisect.bisect_right(anc, (t, float("inf")))
    if i == 0:
        return anc[0][1]
    if i == len(anc):
        return anc[-1][1]
    (d0, o0), (d1, o1) = anc[i - 1], anc[i]
    return o0 + (o1 - o0) * (t - d0) // max(d1 - d0, 1)


def split(rec):
    st = rec.stretch
    if st is None or not st.kernels:
        return None
    try:
        from repro_torch.serving import spans
    except ImportError:
        return None
    host = [s for s in spans.recorded()
            if s.clock == "host" and s.end is not None]
    if not host:
        return None
    busy = _merged((s, e) for _, s, e in st.kernels)
    anc = anchors(st.kernels, host)
    gaps = []
    for k in range(len(busy) - 1):
        a, b = busy[k][1], busy[k + 1][0]
        off = _offset(anc, a)
        gaps.append((a + off, b + off))
    gaps = _merged(gaps)        # shifted gaps that a snap made overlap
    idle = sum(b - a for a, b in gaps)
    out = {}
    for name in ("decode.step", "prefill.batch"):
        out[name] = _overlap_ns(gaps, _merged(
            (s.start, s.end) for s in host if s.name == name))
    out["event_core"] = idle - out["decode.step"] - out["prefill.batch"]
    return out


def read(rec):
    ns = split(rec)
    return None if ns is None else ns["decode.step"] / (rec.stretch.wall_s
                                                         * 1e9)
