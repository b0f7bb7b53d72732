"""The generator: a seed fixes the inputs, and every seed draws its own
times and lengths, with each block's count and strata fixed."""
import collections
import math
import statistics

from pdbench.tests import tiny
from pdbench.traffic import BLOCK, Mix


def _stream(mix, seed, n):
    it, out = Mix(mix, 512, seed).blocks(), []
    while len(out) < n:
        out += next(it)
    return out


def test_same_seed_same_stream():
    a = _stream(tiny.TINY_MIX, 2**31 + 3, 40)
    b = _stream(tiny.TINY_MIX, 2**31 + 3, 40)
    assert [(r.at, r.tokens, r.out_tokens) for r in a] == \
        [(r.at, r.tokens, r.out_tokens) for r in b]


def test_every_seed_draws_its_own_times_and_lengths():
    a = _stream(tiny.TINY_MIX, 1, 3 * BLOCK)
    b = _stream(tiny.TINY_MIX, 2, 3 * BLOCK)
    assert [r.at for r in a] != [r.at for r in b]
    assert [len(r.tokens) for r in a] != [len(r.tokens) for r in b]
    assert [r.out_tokens for r in a] != [r.out_tokens for r in b]


def test_each_block_holds_its_count_in_its_span_at_the_exact_rate():
    rate = tiny.TINY_MIX["rate_per_s"]
    span = BLOCK / rate
    reqs = _stream(tiny.TINY_MIX, 2**33 + 5, 20 * BLOCK)
    ats = [r.at for r in reqs]
    assert ats == sorted(ats)
    for k in range(20):
        blk = ats[k * BLOCK:(k + 1) * BLOCK]
        assert k * span <= blk[0] and blk[-1] < (k + 1) * span
    gaps = [y - x for x, y in zip(ats, ats[1:])]
    # Poisson within a block: gaps spread like the exponential's (cv 1)
    cv = statistics.pstdev(gaps) / statistics.fmean(gaps)
    assert 0.8 < cv < 1.2, cv


def test_each_block_draws_one_length_from_every_stratum():
    mix = tiny.TINY_MIX
    pfx = mix["shared_prefixes"]["tokens"]
    d = mix["prompt_tokens"]
    dist = statistics.NormalDist()
    reqs = _stream(mix, 77, 6 * BLOCK)
    for k in range(6):
        lens = sorted(len(r.tokens) - pfx
                      for r in reqs[k * BLOCK:(k + 1) * BLOCK])
        assert lens[0] == d["min"] and lens[-1] == d["max"]
        for i, n in enumerate(lens):
            if d["min"] < n < d["max"]:
                # n rounds a draw from stratum i of the lognormal
                lo = d["median"] * math.exp(
                    d["sigma"] * dist.inv_cdf(max(i / BLOCK, 1e-9)))
                hi = d["median"] * math.exp(
                    d["sigma"] * dist.inv_cdf((i + 1) / BLOCK))
                assert lo - 0.5 <= n <= hi + 0.5, (i, n, lo, hi)


def test_shared_prefixes_are_balanced_in_a_block():
    heads = collections.Counter(tuple(r.tokens[:48])
                                for r in _stream(tiny.TINY_MIX, 9, BLOCK))
    assert sorted(heads.values()) == [BLOCK // 2, BLOCK // 2]


def test_prelude_meets_both_sides_of_every_power_of_two():
    mix = Mix(tiny.TINY_UNSHARED, 512, 4)
    groups = mix.prelude()
    lens = collections.Counter(
        (len(g[0].tokens), len(g)) for g in groups if g[0].out_tokens == 4)
    lo, hi = 8, 40
    for n in (8, 9, 16, 17, 32, 33, 40):
        for b in tiny.TINY_UNSHARED["warm_batches"]:
            assert lens[(n, b)] == 2, (n, b)
    longest = [g for g in groups if g[0].out_tokens == 24]
    assert len(longest) == 1 and len(longest[0][0].tokens) == hi
    assert lo == min(n for n, _ in lens)
