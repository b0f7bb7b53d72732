"""Share of the prefill forwards' tokens that were bucket padding:
padded / (padded + computed)."""


def read(rec):
    p, c = rec.counters["padded_tokens"], rec.counters["compute_tokens"]
    return p / (p + c) if p + c else None
