"""Percentiles, censoring and rates on synthetic stamps."""
import math

import pytest

from pdbench.stats import (Stamp, percentile, tokens_per_s,
                           tpot_samples, ttft_samples)


def test_nearest_rank_percentile():
    xs = list(range(1, 101))
    assert percentile(xs, 95) == 95
    assert percentile(xs, 100) == 100
    assert percentile([3.0], 95) == 3.0
    assert percentile([5, 1, 4, 2, 3], 50) == 3
    with pytest.raises(ValueError):
        percentile([], 50)


def test_ttft_censors_unserved_requests_at_the_window_end():
    stamps = [Stamp(1.0, 1.5, 2.0, 3),      # served: 0.5
              Stamp(2.0, -1.0, -1.0, 0),    # waiting since 2.0
              Stamp(9.5, -1.0, -1.0, 0)]    # due after the end: 0
    assert ttft_samples(stamps, 4.0) == [0.5, 2.0, 0.0]


def test_failed_requests_miss_every_limit():
    stamps = [Stamp(0.0, 0.1, 0.2, 2), Stamp(0.0, -1.0, -1.0, 0, True)]
    assert ttft_samples(stamps, 1.0) == [pytest.approx(0.1), math.inf]
    assert tpot_samples(stamps) == [pytest.approx(0.1)]


def test_tpot_counts_tokens_after_the_first_and_in_flight_requests():
    stamps = [Stamp(0.0, 1.0, 3.0, 5),      # done: 2 s over 4 tokens
              Stamp(0.0, 1.0, 1.6, 4),      # still decoding: 0.6 over 3
              Stamp(0.0, 1.0, -1.0, 1)]     # one token: no TPOT
    assert tpot_samples(stamps) == [pytest.approx(0.5), pytest.approx(0.2)]


def test_tokens_per_second():
    assert tokens_per_s(900, 100, 2.0) == 500.0
