"""The port's PagedKVPool: seeded alloc/release/prefix churn with its
invariants (mirroring the seeded part of tests/test_prefix_pool_props.py),
the same churn run on the JAX pool with identical bookkeeping, and the
data path (write_prefill / write_tokens / read_tokens / gather / scatter
/ COW / read_block) against the JAX pool for one operation sequence.
Pool data moves are copies, so they are compared bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kvcache import PagedKVPool as JaxPool
from repro.serving.kvcache import PoolExhausted as JaxExhausted
from repro_torch.serving.kvcache import PagedKVPool, PoolExhausted
from torch_parity import both_params

NUM_BLOCKS = 16
BS = 4
ALIGN = 2 * BS                      # snapshot stride for the churn


def _pools():
    cfg, _, pcfg, _ = both_params("granite-3-8b")
    kw = dict(num_blocks=NUM_BLOCKS, block_size=BS, enable_prefix_cache=True)
    return JaxPool(cfg, **kw), PagedKVPool(pcfg, device="cpu", **kw)


def _books(pool):
    """Everything the allocator and the trie decide, in comparable form."""
    return (list(pool._free), {r: list(b) for r, b in pool._owned.items()},
            sorted(pool._cached), dict(pool._ref), sorted(pool._snaps),
            pool.hits, pool.hit_tokens, pool.evictions, pool.cow_copies,
            pool.snap_stores)


def _snap(t):
    return {"state": np.full((3,), float(t), np.float32),
            "conv_x": np.full((2, 2), float(t), np.float32)}


@pytest.mark.parametrize("seed", range(8))
def test_seeded_churn_invariants_and_jax_bookkeeping(seed):
    """Random admit / release / pressure ops with a tiny token alphabet
    (forcing prefix collisions, COW tails and eviction): the partition
    invariant holds after every op, no live request's block is ever
    handed out, and the JAX pool makes exactly the same decisions."""
    rng = np.random.default_rng(seed)
    jpool, pool = _pools()
    live = set()
    rid_next = 0
    for _ in range(int(rng.integers(8, 30))):
        op = rng.choice(["admit", "release", "pressure"])
        if op == "release" and live:
            rid = int(rng.choice(sorted(live)))
            for p in (jpool, pool):
                p.release(rid)
            live.discard(rid)
        elif op == "pressure":
            held = {b for r in live for b in pool.owned(r)}
            rid = 9000 + rid_next
            rid_next += 1
            n = int(rng.integers(1, 24))
            try:
                got = pool.alloc(rid, n)
            except PoolExhausted:
                with pytest.raises(JaxExhausted):
                    jpool.alloc(rid, n)
            else:
                assert jpool.alloc(rid, n) == got
                assert not (set(got) & held)
                live.add(rid)
        else:
            rid = rid_next
            rid_next += 1
            toks = [int(t) for t in rng.integers(0, 4, rng.integers(2, 20))]
            states = {t: _snap(t) for t in range(ALIGN, len(toks) + 1,
                                                  ALIGN)}
            try:
                cached = pool.acquire_prefix(rid, toks)
                pool.alloc_to(rid, len(toks))
            except PoolExhausted:
                with pytest.raises(JaxExhausted):
                    jc = jpool.acquire_prefix(rid, toks)
                    jpool.alloc_to(rid, len(toks))
                for p in (jpool, pool):
                    p.release(rid)
                continue
            assert jpool.acquire_prefix(rid, toks) == cached
            jpool.alloc_to(rid, len(toks))
            assert cached < len(toks)
            for p in (jpool, pool):
                p.insert_prefix(rid, toks, states=states)
            live.add(rid)
        assert pool.invariant_ok()
        assert set(pool._snaps) <= set(pool._cached)
        assert pool.snap_bytes == sum(pool._snap_nbytes(s)
                                      for s in pool._snaps.values())
        assert _books(pool) == _books(jpool)
    for rid in sorted(live):
        pool.release(rid)
    assert pool.invariant_ok()
    assert pool.free_blocks + pool.cached_blocks == NUM_BLOCKS


def _kv(rng, L, n, kvd):
    return rng.normal(size=(L, n, kvd)).astype(np.float32)


def test_data_path_matches_jax_pool():
    """One operation sequence on both pools: every read is bit-identical
    and the storages end equal; the port's storage never moves."""
    cfg, _, pcfg, _ = both_params("granite-3-8b")
    L, kvd = cfg.num_layers, cfg.kv_dim
    rng = np.random.default_rng(5)
    jpool = JaxPool(cfg, num_blocks=12, block_size=BS,
                    enable_prefix_cache=True)
    pool = PagedKVPool(pcfg, num_blocks=12, block_size=BS,
                       enable_prefix_cache=True, device="cpu")
    ptr = pool.storage.data_ptr()

    def same():
        np.testing.assert_array_equal(pool.storage.numpy(),
                                      np.asarray(jpool.storage))

    toks = [int(t) for t in rng.integers(0, 50, 10)]
    k, v = _kv(rng, L, 10, kvd), _kv(rng, L, 10, kvd)
    for p in (jpool, pool):
        p.alloc(0, 10)
    jpool.write_prefill(jpool.owned(0), jnp.asarray(k), jnp.asarray(v))
    pool.write_prefill(pool.owned(0), torch.from_numpy(k),
                       torch.from_numpy(v))
    same()
    np.testing.assert_array_equal(
        pool.read_tokens(pool.owned(0), 10).numpy(),
        np.asarray(jpool.read_tokens(jpool.owned(0), 10)))
    for p in (jpool, pool):
        p.insert_prefix(0, toks)
    # a warm request sharing 6 tokens: one whole block + a COW tail
    toks1 = toks[:6] + [99, 98, 97]
    assert pool.acquire_prefix(1, toks1) == jpool.acquire_prefix(1, toks1) \
        == 6
    for p in (jpool, pool):
        p.alloc_to(1, len(toks1))
    same()                                           # the COW copy
    k1, v1 = _kv(rng, L, 3, kvd), _kv(rng, L, 3, kvd)
    jpool.write_tokens(jpool.owned(1), 6, jnp.asarray(k1), jnp.asarray(v1))
    pool.write_tokens(pool.owned(1), 6, torch.from_numpy(k1),
                      torch.from_numpy(v1))
    same()
    # block-free transfer halves and the per-layer stripe forms
    buf = pool.gather_contiguous(pool.owned(1))
    np.testing.assert_array_equal(
        buf.numpy(), np.asarray(jpool.gather_contiguous(jpool.owned(1))))
    dst = [int(b) for b in pool.alloc(2, 9)]
    assert jpool.alloc(2, 9) == dst
    pool.scatter_contiguous(buf, dst)
    jpool.scatter_contiguous(jnp.asarray(buf.numpy()), dst)
    same()
    stripe = pool.gather_layer(pool.owned(0), L - 1)
    np.testing.assert_array_equal(
        stripe.numpy(), np.asarray(jpool.gather_layer(jpool.owned(0),
                                                      L - 1)))
    pool.scatter_layer(stripe, dst[:3], 0)
    jpool.scatter_layer(jnp.asarray(stripe.numpy()), dst[:3], 0)
    same()
    # read_block hands out a copy: later pool writes do not reach it
    blk = pool.read_block(dst[0])
    before = blk.clone()
    pool.write_block(dst[0], torch.zeros_like(blk))
    jpool.write_block(dst[0], jnp.zeros(before.shape, jnp.float32))
    assert torch.equal(blk, before)
    same()
    assert pool.storage.data_ptr() == ptr
    assert pool.invariant_ok()


def test_pool_refuses_out_of_range_blocks():
    _, _, pcfg, _ = both_params("granite-3-8b")
    pool = PagedKVPool(pcfg, num_blocks=4, block_size=BS, device="cpu")
    with pytest.raises(IndexError):
        pool.gather_contiguous([0, 4])
