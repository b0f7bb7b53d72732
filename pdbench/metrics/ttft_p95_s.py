"""95th percentile of time to first token over the requests due in the
window, on the virtual timeline; unserved ones enter with their wait.
(A per-layer reading: over a window's 140-260 requests it swings by a
fifth from seed to seed, too much for a bound.)"""
from pdbench.stats import percentile, ttft_samples


def read(rec):
    xs = ttft_samples(rec.stamps, rec.v_end)
    return percentile(xs, 95.0) if xs else None
