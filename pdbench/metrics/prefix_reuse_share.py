"""Share of the window's prompt tokens served from the prefix store:
reused / (reused + computed), from the prefill engines' counters."""


def read(rec):
    r, c = rec.counters["reused_tokens"], rec.counters["compute_tokens"]
    return r / (r + c) if r + c else None
