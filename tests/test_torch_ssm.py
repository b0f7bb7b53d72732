"""The port's Mamba2 (SSD) layers against the JAX package's, on mamba2
and jamba reduced (d_model 128, 16 heads of 16, d_state 16, SSD chunk
32) with identical weights, and the SSM serving pieces: the decode slot
state and the snapshot-restored warm prefill against the cold one.

Tolerance: f32 1e-4 (rtol and atol), because torch and XLA sum in
different orders; the SSD state accumulates over every chunk and layer
and is held to the same 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import caches as jc
from repro.models import modeling as jm
from repro.serving.engine import PrefillEngine as JaxPrefill
from repro_torch.models import caches as tc
from repro_torch.models import modeling as tm
from repro_torch.serving.engine import PrefillEngine
from torch_parity import assert_close, both_params, prompts

SSM_ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
LEAVES = ("conv_x", "conv_b", "conv_c", "state")


def _t(x):
    return torch.from_numpy(np.array(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def _mamba_params(arch):
    """(cfg, pcfg, jax, port) params of block 0's first Mamba sublayer."""
    cfg, jp, pcfg, tp = both_params(arch)
    sub = f"sub{cfg.layer_kinds().index('mamba')}"
    jl = {k: v[0] for k, v in jp["blocks"][sub].items()
          if not isinstance(v, dict)}
    tl = {k: v[0] for k, v in tp["blocks"][sub].items()
          if not isinstance(v, dict)}
    return cfg, pcfg, jl, tl


@pytest.mark.parametrize("with_init", [False, True])
def test_causal_conv1d_matches_jax(with_init):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 11, 24)).astype(np.float32)
    w = rng.normal(size=(24, 4)).astype(np.float32)
    init = rng.normal(size=(2, 24, 3)).astype(np.float32) if with_init \
        else None
    got = tm._causal_conv1d(_t(x), _t(w), None if init is None else _t(init))
    want = jm._causal_conv1d(_j(x), _j(w), None if init is None else _j(init))
    assert_close(got, want)


@pytest.mark.parametrize("s,with_init", [(70, False), (64, True),
                                         (9, True)])
def test_ssd_scan_matches_jax_and_ssd_step(s, with_init):
    """y, final state and per-chunk states against JAX (s not a multiple
    of the chunk pads with dt = 0); the same tokens through ssd_step one
    at a time give the scan's y and final state, on both sides."""
    rng = np.random.default_rng(s)
    b, nh, hd, n = 2, 4, 8, 16
    x = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, nh)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(nh,)) * 0.5).astype(np.float32)
    B = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    C = (rng.normal(size=(b, s, n)) * 0.5).astype(np.float32)
    S0 = (rng.normal(size=(b, nh, n, hd)) * 0.1).astype(np.float32) \
        if with_init else np.zeros((b, nh, n, hd), np.float32)
    init = S0 if with_init else None
    y, S, cs = tm.ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), 32,
                           init_state=None if init is None else _t(init),
                           return_chunk_states=True)
    jy, jS, jcs = jm.ssd_scan(_j(x), _j(dt), _j(A), _j(B), _j(C), 32,
                              init_state=None if init is None else _j(init),
                              return_chunk_states=True)
    assert_close(y, jy)
    assert_close(S, jS)
    assert_close(cs, jcs)
    st, jst = _t(S0), _j(S0)
    ys, jys = [], []
    for i in range(s):
        yi, st = tm.ssd_step(_t(x[:, i]), _t(dt[:, i]), _t(A), _t(B[:, i]),
                             _t(C[:, i]), st)
        jyi, jst = jm.ssd_step(_j(x[:, i]), _j(dt[:, i]), _j(A),
                               _j(B[:, i]), _j(C[:, i]), jst)
        ys.append(yi)
        jys.append(np.asarray(jyi))
    assert_close(torch.stack(ys, 1), np.stack(jys, 1))
    assert_close(torch.stack(ys, 1), y)
    assert_close(st, jst)
    assert_close(st, S)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_sublayer_seq_and_snapshots_match_jax(arch):
    """A right-padded batch (valid 64 and 41 of 70 tokens) with snapshot
    emission every 32 tokens, then a restore from the first row's
    boundary-32 snapshot over the next tokens: output, hand-off state
    and snapshots against JAX, and the restored run against the cold."""
    cfg, pcfg, jl, tl = _mamba_params(arch)
    rng = np.random.default_rng(3)
    h = rng.normal(size=(2, 70, cfg.d_model)).astype(np.float32)
    vl = np.array([64, 41], np.int32)
    got, gst = tm.mamba_sublayer_seq(tl, _t(h), pcfg, valid_len=_t(vl),
                                     snap_stride=32)
    want, wst = jm.mamba_sublayer_seq(jl, _j(h), cfg, return_state=True,
                                      valid_len=_j(vl), snap_stride=32)
    for r, v in enumerate(vl):
        assert_close(got[r, :v], want[r, :v])
    assert set(gst) == set(wst)
    for k in gst:
        assert tuple(gst[k].shape) == wst[k].shape, k
        assert_close(gst[k], wst[k], ctx=k)
    # restore row 0 at boundary 32 and run tokens 32..63: the state at
    # 64 is the cold run's, as in JAX
    snap = {k: gst[f"snap_{k}"][0, :1] for k in LEAVES}
    warm, wst2 = tm.mamba_sublayer_seq(tl, _t(h[:1, 32:64]), pcfg,
                                       init=snap)
    jwarm, jwst2 = jm.mamba_sublayer_seq(
        jl, _j(h[:1, 32:64]), cfg, return_state=True,
        init={k: _j(v.numpy()) for k, v in snap.items()})
    assert_close(warm, jwarm)
    assert_close(warm, got[:1, 32:64])
    for k in LEAVES:
        assert_close(wst2[k], jwst2[k], ctx=k)
        assert_close(wst2[k], gst[k][:1], ctx=k)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_mamba_sublayer_step_matches_jax(arch):
    cfg, pcfg, jl, tl = _mamba_params(arch)
    rng = np.random.default_rng(4)
    st = jc.decode_slot_state(cfg, 3)
    sub = f"sub{cfg.layer_kinds().index('mamba')}"
    cache = {k: (rng.normal(size=st[sub][k].shape[1:]) * 0.3).astype(
        np.float32) for k in LEAVES}
    h = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
    got, gc = tm.mamba_sublayer_step(
        tl, _t(h), {k: _t(v) for k, v in cache.items()}, pcfg)
    want, wc = jm.mamba_sublayer_step(
        jl, _j(h), {k: _j(v) for k, v in cache.items()}, cfg)
    assert_close(got, want)
    for k in LEAVES:
        assert_close(gc[k], wc[k], ctx=k)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_decode_slot_state_matches_jax(arch):
    cfg, _, pcfg, _ = both_params(arch)
    want = jc.decode_slot_state(cfg, 5)
    got = tc.decode_slot_state(pcfg, 5, device="cpu")
    assert set(got) == set(want)
    for sub, c in want.items():
        assert set(got[sub]) == set(c)
        for k, v in c.items():
            assert tuple(got[sub][k].shape) == v.shape
            assert str(got[sub][k].dtype).split(".")[1] == str(v.dtype)
            assert int(torch.count_nonzero(got[sub][k])) == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_warm_prefill_restores_the_cold_state(arch):
    """Engine level: a prompt of 64 + 40 tokens run cold, and run warm
    from the 64-token snapshot of another prompt sharing its first 64
    tokens (attention prefix KV gathered from the cold run for jamba):
    equal first tokens, hand-off state and KV within 1e-4 of the cold
    run and of JAX's warm run; re-emitted snapshots at absolute
    boundaries."""
    cfg, jp, pcfg, tp = both_params(arch)
    rng = np.random.default_rng(6)
    shared = prompts(cfg.vocab_size, rng, [64])[0]
    a, b = (shared + t for t in prompts(cfg.vocab_size, rng, [11, 40]))
    eng, jeng = PrefillEngine(pcfg, tp), JaxPrefill(cfg, jp)
    prime = eng.run([a], snap_stride=32)[0]
    jprime = jeng.run([a], snap_stride=32)[0]
    assert sorted(prime.snapshots) == sorted(jprime.snapshots) == [32, 64]
    cold = eng.run([b])[0]
    pkv = jpkv = None
    if prime.k is not None:
        pkv = torch.cat([prime.k, prime.v], -1)[:, :64]
        jpkv = jnp.concatenate([jprime.k, jprime.v], -1)[:, :64]
    warm = eng.run_suffix(b[64:], pkv, state=prime.snapshots[64],
                          prefix_len=64, snap_stride=32)
    jwarm = jeng.run_suffix(b[64:], jpkv, state=jprime.snapshots[64],
                            prefix_len=64, snap_stride=32)
    assert warm.first_token == cold.first_token == jwarm.first_token
    assert warm.prompt_len == cold.prompt_len == 104
    assert sorted(warm.snapshots) == sorted(jwarm.snapshots) == [96]
    for key, st in cold.mamba_state.items():
        for k in LEAVES:
            assert_close(warm.mamba_state[key][k], st[k], ctx=f"{key} {k}")
            assert_close(warm.mamba_state[key][k],
                         jwarm.mamba_state[key][k], ctx=f"{key} {k}")
    if cold.k is not None:
        assert_close(warm.k, cold.k)
        assert_close(warm.v, jwarm.v)
    for t, snap in prime.snapshots.items():
        for key, st in snap.items():
            for k in LEAVES:
                assert_close(st[k], jprime.snapshots[t][key][k],
                             ctx=f"snapshot {t} {key} {k}")


def test_attention_free_pool_moves_no_bytes():
    """mamba2's pool has width 0: gather returns an empty (1, n*BS, 0)
    buffer and scatter leaves the storage as it is, through the same
    entry points the serving path calls."""
    from repro_torch.kernels import ops
    from repro_torch.serving.kvcache import PagedKVPool
    _, _, pcfg, _ = both_params("mamba2-2.7b")
    pool = PagedKVPool(pcfg, num_blocks=8, device="cpu")
    assert tuple(pool.storage.shape) == (1, 8, 16, 0)
    assert pool.attn_layers == 0
    blocks = pool.alloc(0, 40)
    buf = pool.gather_contiguous(blocks)
    assert tuple(buf.shape) == (1, 3 * 16, 0)
    pool.scatter_contiguous(buf, blocks)
    stripe = ops.kv_gather_layer(pool.storage, pool._idx(blocks), 0)
    assert tuple(stripe.shape) == (3 * 16, 0)
    pool.scatter_layer(stripe, blocks, 0)
    assert pool.layer_nbytes(3) == 0
