"""Mean virtual wait between a prefill's end and its decode admission, over
the KV hand-offs admitted in the window (``admission_waits``), in ms."""


def read(rec):
    w = rec.admission_waits
    return sum(w) / len(w) * 1e3 if w else None
