"""95th percentile of time per output token (first to latest token over
the tokens after the first) of the window's requests with two or more,
on the virtual timeline, in ms."""
from pdbench.stats import percentile, tpot_samples


def read(rec):
    xs = tpot_samples(rec.stamps)
    return percentile(xs, 95.0) * 1e3 if xs else None
