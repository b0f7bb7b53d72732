#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --ab CHECKOUT

The second form only times CHECKOUT's causal flash prefill (see
``ab_causal``), for an A/B of two checkouts in turns within one call.

Phases, all of them on every run, in order (any failure exits non-zero;
nothing is swallowed):

0. device: the card's name and power limit, PyTorch's view of it, nvcc;
1. build: the four CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's full-width shapes (granite-3-8b: 40 layers, 8 kv heads
   of 128, 32 query heads, 16-token blocks) and at the MoE path's
   (qwen2-moe: 24 layers, nq = nkv = 16 of 128, pool width 4096), f32
   and bf16, plus the split and tile edges of the attention kernels (lens 0,
   1, 16, split_tokens +- 1, MAXB*BS; holes in the block table; g in
   {1, 4, 8}; hd in {32, 64, 128}; q_offset/prefix_pad across tiles),
   and flash prefill's non-causal mode at the whisper shapes (encoder
   b=2, s=sk=1500, 8/8 heads of 64; prefill cross-attention b=4, s=64,
   sk=1500) and its edges (ragged sk, GQA, q_valid),
   with device times of the kernel, the plain version and one PyTorch
   library call (CUDA-graph replay); paged attention is timed cold in
   L2, one layer of a full-size pool per launch, as the decode step
   reads it;
3. reduced paths: granite-3-8b, qwen2-moe, deepseek-moe, mamba2, jamba,
   whisper-base (with seeded stub frames) and pixtral-12b reduced, 1P:1D
   ``MiniCluster`` on the card and on the CPU with the same params,
   equal tokens per request in both transfer modes, with warm prefix
   hits (snapshot restores for mamba2 and jamba);
4. main path: full-width granite-3-8b (random f32 params from a seeded
   CUDA generator), 1P:1D, four requests of 200-480 prompt tokens and 16
   new tokens, overlapped and blocking transfer: equal tokens, and every
   kernel's launch counter grew during the run; one request's hand-off
   timed; a profiled run (``<out>/profile_main.txt``);
5. MoE path: full-width qwen2-moe-a2.7b the same way: equal tokens,
   every kernel launched, a profiled run (``<out>/profile_moe.txt``);
6. SSM path: full-width mamba2-2.7b, four requests sharing a 256-token
   prefix, prefix cache on (overlapped, blocking) and off: snapshot hits,
   warm tokens == cold tokens, a state payload per request, no KV kernel
   launch; the warm hand-off state, and a chunked prefill in 256-token
   chunks, against the cold one; a profiled run
   (``<out>/profile_ssm.txt``);
7. control plane (run right after phase 4, on its params, its launches
   counted under the path ``granite-3-8b/control``): a 2P:2D group on
   the card, fault-free under the deterministic service model, then
   twice under a FaultPlan (prefill and decode crashes, a hang past the
   health timeout): tokens equal and identical logs; the RatioAdjuster
   flipping P->D on measured walls over the same params; an AutoScaler
   scaling up and down with tokens of a static run and the card's memory
   back to params + live pools; (E, launches counted under
   ``granite-3-8b/control-absorb``) decode-side absorption with the node
   pool exhausted, twice: absorbed first tokens equal a monolithic
   prefill's, equal event logs; the cost of building a fresh decode
   node;
8. encoder-decoder path: full-width whisper-base (6 + 6 layers, d_model
   512, 1500 encoder frames), 1P:1D, four requests with seeded stub
   frames (one a warm hit: same frames and a shared 32-token prefix; one
   a miss: the same tokens with other frames), prefix cache on
   (overlapped, blocking) and off: equal tokens, flash prefill 18
   launches per forward (12 non-causal), paged attention 6 per step;
   the decode step's cross-attention timed; a profiled run
   (``<out>/profile_whisper.txt``);
9. VLM path: full-width pixtral-12b (40 layers, d_model 5120, 32/8 heads
   of 128, vocab 131072, 48.9 GB of f32 params), phase 4's prompts,
   overlapped then blocking: equal tokens, every kernel launched; a
   profiled run (``<out>/profile_pixtral.txt``).

Each path logs its prefill batch walls, decode step median, launch
counts and peak memory, beside the card's name and power limit.
Long reports go to ``--out`` (default ``build/chip_smoke``, gitignored):
the ptxas register/spill report of the build and the profile table.

The second-to-last line is ``{"kernels": [...]}`` (launches on the main
path and on each path, max |err| against the plain version, times and
bounds, and the MoE path's attention shapes and flash prefill's
non-causal shapes as "cases"); the last is
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
convolutions, so f32 stays f32 on the card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEFAULT_OUT = ROOT / "build" / "chip_smoke"

# H100 SXM published peaks (dense): HBM bytes/s and f32 / bf16 flop/s
HBM_BPS = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

ARCH = "granite-3-8b"          # the dense main path
MOE_ARCH = "qwen2-moe-a2.7b"     # the MoE path
SSM_ARCH = "mamba2-2.7b"         # the SSM path
ENCDEC_ARCH = "whisper-base"     # the encoder-decoder path
VLM_ARCH = "pixtral-12b"         # the VLM backbone path
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, repeats: int = 5) -> float:
    """Device time of one call: ``iters`` calls captured in a CUDA graph,
    the graph replayed ``repeats`` times between CUDA events, the median
    over the count. The graph takes the host's launch cost out, so a
    short kernel is timed on the card and not at the rate the host
    issues it (after warm-up calls, as torch.cuda.graphs asks)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    del graph
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_b = nbytes / HBM_BPS
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------ phase 2

def _paged_inputs(torch, randn, dev, dtype, nq, nkv, hd, lens_l, NB, BS,
                  maxb):
    """q, pages, a block table of distinct random blocks and lens for
    one paged-attention call (rows past their lens keep -1 entries)."""
    B = len(lens_l)
    bt = torch.full((B, maxb), -1, dtype=torch.int32)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(1))
    cur = 0
    for b, ln in enumerate(lens_l):
        nbk = -(-ln // BS)
        bt[b, :nbk] = perm[cur:cur + nbk].to(torch.int32)
        cur += nbk
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)
    return (randn((B, nq, hd), dtype), randn((NB, BS, 2 * nkv * hd), dtype),
            bt.to(dev), lens)


def _check_copies(torch, ref, gather, scatter, randn, gen, dtype, L, NB,
                  BS, W, n):
    """kv_gather and kv_scatter against their plain versions, bit for
    bit, on an (L, NB, BS, W) pool and ``n`` random blocks: full and
    layer forms, the storage kept in place, blocks outside ``idx`` kept,
    scatter(gather(x)) == x. Returns (storage, pool, buf, idx) for
    timing."""
    dev = gen.device
    storage = randn((L, NB, BS, W), dtype)
    perm = torch.randperm(NB, generator=gen, device=dev)
    idx = perm[:n].to(torch.int32).contiguous()
    want = ref.kv_gather(storage, idx)
    assert torch.equal(gather(storage, idx), want), \
        f"kv_gather differs from plain at L={L} W={W}"
    for layer in (0, L - 1):
        assert torch.equal(gather(storage, idx, layer=layer), want[layer]), \
            f"kv_gather layer {layer} differs at L={L} W={W}"
    buf = randn((L, n * BS, W), dtype)
    pool = storage.clone()
    ptr = pool.data_ptr()
    scatter(pool, buf, idx)
    assert pool.data_ptr() == ptr, "kv_scatter moved the storage"
    assert torch.equal(pool, ref.kv_scatter(storage.clone(), buf, idx)), \
        f"kv_scatter differs from plain at L={L} W={W}"
    untouched = perm[n:].long()
    assert torch.equal(pool[:, untouched], storage[:, untouched]), \
        "kv_scatter touched blocks outside idx"
    back = storage.clone()
    scatter(back, gather(storage, idx), idx)
    assert torch.equal(back, storage), "scatter(gather(x)) != x"
    row = randn((n * BS, W), dtype)
    for layer in (0, L - 1):
        one = storage.clone()
        scatter(one, row, idx, layer=layer)
        want = storage.clone()
        want[layer:layer + 1] = ref.kv_scatter(
            storage[layer:layer + 1].clone(), row[None], idx)
        assert torch.equal(one, want), \
            f"kv_scatter layer {layer} differs at L={L} W={W}"
    del back, one, want
    return storage, pool, buf, idx


def _check_paged(torch, ref, kernel, q, pages, bt, lens, lens_l, dn):
    """The kernel against its plain version; rows with lens 0 exactly 0.
    Returns max |err|."""
    got = kernel(q, pages, bt, lens)
    want = ref.paged_attention(q, pages, bt, lens)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dn], f"paged_attention {dn} max|err| {err}"
    for b, ln in enumerate(lens_l):
        if ln == 0:
            assert torch.count_nonzero(got[b]) == 0, "inactive row not zero"
    return err


def _time_paged(torch, ref, kernel, randn, q, bt, lens, lens_l, L, NB, BS,
                nkv, hd, maxb):
    """Device times of paged attention at one shape: cold in L2 (the
    decode step reads each layer's own pages: a full-size (L, NB, BS, W)
    f32 stack, layer i % L on launch i) and hot (one page tensor
    re-read); the plain version cold; the bound from this call's
    bytes and flops."""
    B, nq = q.shape[0], q.shape[1]
    W = 2 * nkv * hd
    live = sum(lens_l)
    nbytes = (q.numel() * 2 + live * W) * 4 + bt.numel() * 4 + B * 4
    b_ms, b_by = bound_ms(nbytes, 4 * live * nq * hd, "float32")
    store = randn((L, NB, BS, W), torch.float32)
    layers = [store[i] for i in range(L)]
    turn = itertools.count()

    def cold(fn):
        return lambda: fn(q, layers[next(turn) % L], bt, lens)
    out = dict(ms=time_ms(cold(kernel), iters=L),
               plain_ms=time_ms(cold(ref.paged_attention), iters=L),
               ms_hot=time_ms(lambda: kernel(q, layers[0], bt, lens)),
               library_ms=None, bound_ms=b_ms, bound_by=b_by,
               shape=f"B={B} lens={lens_l} nq={nq} nkv={nkv} hd={hd} "
                     f"BS={BS} MAXB={maxb} f32, cold L2 over {L} layers")
    del store, layers
    return out


def _time_flash(torch, F, ref, kernel, qq, kk, vv, qvt):
    """Device times of flash prefill (no prefix), its plain version and
    PyTorch's SDPA with the same causal and q_valid mask; the bound
    counts the causal pairs of the real rows."""
    b, s, nq, hd = qq.shape
    nkv = kk.shape[2]
    qv = qvt.tolist()
    pairs = sum(v_ * (v_ + 1) // 2 for v_ in qv)
    nbytes = (2 * qq.numel() + kk.numel() + vv.numel()) * 4
    b_ms, b_by = bound_ms(nbytes, 4 * pairs * nq * hd, "float32")
    mask = torch.ones(s, s, dtype=torch.bool, device=qq.device).tril()
    qvmask = (torch.arange(s, device=qq.device)[None]
              < qvt[:, None])[:, None, :, None]
    mask = mask[None, None] & qvmask
    qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
    return dict(
        ms=time_ms(lambda: kernel(qq, kk, vv, q_valid=qvt)),
        plain_ms=time_ms(lambda: ref.flash_prefill(qq, kk, vv, q_valid=qvt)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"b={b} s={s} nq={nq} nkv={nkv} hd={hd} q_valid={qv} f32")


def _time_flash_noncausal(torch, F, ref, kernel, qq, kk, vv):
    """Device times of non-causal flash prefill (every key live), its
    plain version and SDPA without a mask; the bound counts every
    (query, key) pair."""
    b, s, nq, hd = qq.shape
    sk, nkv = kk.shape[1], kk.shape[2]
    nbytes = (2 * qq.numel() + kk.numel() + vv.numel()) * 4
    b_ms, b_by = bound_ms(nbytes, 4 * b * s * sk * nq * hd, "float32")
    qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
    return dict(
        ms=time_ms(lambda: kernel(qq, kk, vv, causal=False)),
        plain_ms=time_ms(lambda: ref.flash_prefill(qq, kk, vv,
                                                   causal=False)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"non-causal b={b} s={s} sk={sk} nq={nq} nkv={nkv} hd={hd} "
              f"f32")


def phase_kernels(torch, results: dict) -> None:
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels import kv_gather as kv_gather_mod
    from repro_torch.kernels import kv_scatter as kv_scatter_mod
    from repro_torch.kernels.kv_gather import kv_gather_cuda
    from repro_torch.kernels.kv_scatter import kv_scatter_cuda
    from repro_torch.kernels.paged_attention import (paged_attention_cuda,
                                                     split_plan)

    cfg = get_config(ARCH)
    dev = torch.device("cuda")
    L, BS, hd = cfg.num_layers, 16, cfg.hd
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    W = 2 * cfg.kv_dim
    # the MoE path's attention shape (qwen2-moe: nq = nkv = 16, hd 128)
    mcfg = get_config(MOE_ARCH)
    MHA = (mcfg.num_heads, mcfg.num_kv_heads, mcfg.hd)
    mha_layers = mcfg.num_layers
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def entry(name):
        return results.setdefault(name, {"max_abs_err": 0.0})

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        # -------------------------------- gather / scatter, bit-exact
        # at both served pool shapes: granite's (timed) and qwen2-moe's
        for name in ("kv_gather", "kv_scatter"):
            entry(name)           # copies: max |err| stays 0
        NB, n = 256, 30                       # 30 blocks = a 480-token prompt
        for pL, pW in ((L, W), (mha_layers, 2 * MHA[1] * MHA[2])):
            storage, pool, buf, idx = _check_copies(
                torch, ref, kv_gather_cuda, kv_scatter_cuda, randn, gen,
                dtype, pL, NB, BS, pW, n)
            log(f"[kernels] kv_gather/kv_scatter {dn} L={pL} NB={NB} BS={BS} "
                f"W={pW}: bit-exact, layer forms exact, data_ptr kept, "
                f"untouched blocks kept, scatter(gather(x)) == x")
            if dtype == torch.float32 and pL == L:
                idx_l = idx.long()
                nbytes = 2 * L * n * BS * W * storage.element_size()
                b_ms, b_by = bound_ms(nbytes, 0, dn)
                results["kv_gather"].update(
                    ms=time_ms(lambda: kv_gather_cuda(storage, idx)),
                    plain_ms=time_ms(lambda: ref.kv_gather(storage, idx)),
                    library_ms=time_ms(lambda: torch.index_select(
                        storage, 1, idx_l)),
                    bound_ms=b_ms, bound_by=b_by,
                    shape=f"L={L} NB={NB} BS={BS} W={W} n={n} f32")
                view = buf.view(L, n, BS, W)
                results["kv_scatter"].update(
                    ms=time_ms(lambda: kv_scatter_cuda(pool, buf, idx)),
                    plain_ms=time_ms(lambda: ref.kv_scatter(pool, buf, idx)),
                    library_ms=time_ms(lambda: pool.index_copy_(1, idx_l,
                                                                view)),
                    bound_ms=b_ms, bound_by=b_by,
                    shape=f"L={L} NB={NB} BS={BS} W={W} n={n} f32")
            del storage, pool, buf
        # an attention-free pool (mamba2: width 0) moves no bytes: the
        # wrappers return the empty buffer and launch nothing
        empty = torch.zeros((1, NB, BS, 0), dtype=dtype, device=dev)
        before = (kv_gather_mod.launches, kv_scatter_mod.launches)
        got0 = kv_gather_cuda(empty, idx)
        assert tuple(got0.shape) == (1, n * BS, 0)
        kv_scatter_cuda(empty, got0, idx)
        kv_scatter_cuda(empty, got0[0], idx, layer=0)
        assert (kv_gather_mod.launches, kv_scatter_mod.launches) == before
        log(f"[kernels] kv_gather/kv_scatter {dn}: width 0 returns the "
            f"empty buffer with no launch")

        # -------------------------------- paged attention
        B, NB, maxb = 8, 256, 32
        lens_l = [480, 200, 1, 0, 333, 16, 17, 256]   # slot 3 inactive
        q, pages, bt, lens = _paged_inputs(torch, randn, dev, dtype, nq, nkv,
                                           hd, lens_l, NB, BS, maxb)
        err = _check_paged(torch, ref, paged_attention_cuda, q, pages, bt,
                           lens, lens_l, dn)
        e = entry("paged_attention")
        if dtype == torch.float32:
            e["max_abs_err"] = max(e["max_abs_err"], err)
        log(f"[kernels] paged_attention {dn}: max|err| {err:.3e} "
            f"(tol {TOL[dn]}), inactive row exactly 0")
        # split and tile edges: lens 0, 1, 16, split_tokens - 1, split,
        # split + 1 and MAXB*BS; a -1 entry inside a live range and one
        # past NB; g in {1, 4, 8}; hd in {64, 128}
        split = split_plan(B, nq, nkv, hd, maxb, BS).split_tokens
        edge = [0, 1, 16, split - 1, split, split + 1, maxb * BS, 250]
        for enq, enkv, ehd in ((32, 8, 128), (8, 8, 128), (64, 8, 128),
                               (32, 4, 64), (8, 8, 64), (16, 16, 128)):
            eq, ep, ebt, el = _paged_inputs(torch, randn, dev, dtype, enq,
                                            enkv, ehd, edge, NB, BS, maxb)
            ebt[6, 5] = -1                    # hole inside 512 live tokens
            ebt[7, 2] = NB + 3                # past the pool: skipped
            eerr = _check_paged(torch, ref, paged_attention_cuda, eq, ep,
                                ebt, el, edge, dn)
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], eerr)
            log(f"[kernels] paged_attention {dn} edges nq={enq} nkv={enkv} "
                f"hd={ehd} lens={edge} (hole, block >= NB): max|err| "
                f"{eerr:.3e}")
        # qwen2-moe's attention: nq = nkv = 16 (group 1), hd 128
        mq, mp, mbt, ml = _paged_inputs(torch, randn, dev, dtype, MHA[0],
                                        MHA[1], MHA[2], lens_l, NB, BS,
                                        maxb)
        merr = _check_paged(torch, ref, paged_attention_cuda, mq, mp, mbt,
                            ml, lens_l, dn)
        log(f"[kernels] paged_attention {dn} nq=nkv={MHA[0]} hd={MHA[2]} "
            f"lens={lens_l}: max|err| {merr:.3e}")
        if dtype == torch.float32:
            e["max_abs_err"] = max(e["max_abs_err"], merr)
            e.update(_time_paged(torch, ref, paged_attention_cuda, randn,
                                 q, bt, lens, lens_l, L, NB, BS, nkv, hd,
                                 maxb))
            e.setdefault("cases", []).append(dict(_time_paged(
                torch, ref, paged_attention_cuda, randn, mq, mbt, ml,
                lens_l, mha_layers, NB, BS, MHA[1], MHA[2], maxb),
                max_abs_err=merr))
            for c in [e] + e["cases"]:
                log(f"[kernels] paged_attention f32 {c['shape']}: cold L2 "
                    f"{c['ms']:.4f} ms, hot L2 (one page tensor re-read) "
                    f"{c['ms_hot']:.4f} ms")
        del mq, mp

        # -------------------------------- flash prefill
        cases = [  # (b, s, nq, nkv, hd, q_offset, prefix_pad, q_valid)
            (2, 16, nq, nkv, hd, 0, 0, [16, 9]),
            (2, 48, nq, nkv, hd, 20, 32, [48, 30]),
            (2, 512, nq, nkv, hd, 0, 0, [480, 300]),     # timed
            (1, 512, nq, nkv, hd, 37, 64, [500]),
            (2, 100, nq, nkv, hd, 0, 0, [100, 77]),      # s % 64 != 0
            (2, 90, nq, nkv, hd, 45, 70, [90, 61]),      # across tiles
            (2, 80, 8, 8, 64, 0, 0, [80, 33]),           # g = 1, hd 64
            (1, 64, 8, 8, 64, 33, 40, [64]),
            (2, 130, 64, 8, 128, 16, 16, [130, 65]),     # g = 8
            (1, 40, 4, 2, 32, 0, 0, [40]),               # hd 32
            # qwen2-moe: nq = nkv = 16, hd 128, buckets 256 and 512
            (2, 256, *MHA, 0, 0, [256, 200]),
            (2, 512, *MHA, 0, 0, [480, 300]),            # timed
            (1, 512, *MHA, 32, 32, [500]),
        ]
        for b, s, fnq, fnkv, fhd, qo, pp, qv in cases:
            sk = (pp or qo) + s
            qq = randn((b, s, fnq, fhd), dtype)
            kk = randn((b, sk, fnkv, fhd), dtype)
            vv = randn((b, sk, fnkv, fhd), dtype)
            qvt = torch.tensor(qv, dtype=torch.int32, device=dev)
            got = flash_prefill_cuda(qq, kk, vv, q_offset=qo, prefix_pad=pp,
                                     q_valid=qvt)
            want = ref.flash_prefill(qq, kk, vv, q_offset=qo, prefix_pad=pp,
                                     q_valid=qvt)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dn], \
                f"flash_prefill {dn} s={s} max|err| {err}"
            for bi, v_ in enumerate(qv):
                assert torch.count_nonzero(got[bi, v_:]) == 0, \
                    "padded query rows not zero"
            e = entry("flash_prefill")
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[kernels] flash_prefill {dn} b={b} s={s} nq={fnq} "
                f"nkv={fnkv} hd={fhd} q_offset={qo} prefix_pad={pp} "
                f"q_valid={qv}: max|err| {err:.3e} (tol {TOL[dn]}), padded "
                f"rows exactly 0")
            if dtype == torch.float32 and (b, s, qo) == (2, 512, 0):
                t = _time_flash(torch, F, ref, flash_prefill_cuda, qq, kk,
                                vv, qvt)
                if (fnq, fnkv) == (nq, nkv):
                    e.update(t)
                else:
                    e.setdefault("cases", []).append(dict(t,
                                                          max_abs_err=err))
        # the non-causal mode (JAX's attention_seq(causal=False)): the
        # whisper encoder and prefill cross-attention (timed), then a
        # ragged sk with GQA and q_valid, sk = 1, hd 32 and 128
        wcfg = get_config(ENCDEC_ARCH)
        WH = (wcfg.num_heads, wcfg.num_kv_heads, wcfg.hd)
        nc_cases = [  # (b, s, sk, nq, nkv, hd, q_valid, timed)
            (2, wcfg.encoder_seq, wcfg.encoder_seq, *WH, None, True),
            (4, 64, wcfg.encoder_seq, *WH, None, True),
            (2, 20, 77, 8, 4, 64, [20, 13], False),
            (1, 100, 33, nq, nkv, hd, [70], False),
            (2, 130, 1, 4, 2, 32, None, False),
        ]
        for b, s, sk, fnq, fnkv, fhd, qv, timed in nc_cases:
            qq = randn((b, s, fnq, fhd), dtype)
            kk = randn((b, sk, fnkv, fhd), dtype)
            vv = randn((b, sk, fnkv, fhd), dtype)
            qvt = None if qv is None else torch.tensor(
                qv, dtype=torch.int32, device=dev)
            got = flash_prefill_cuda(qq, kk, vv, q_valid=qvt, causal=False)
            want = ref.flash_prefill(qq, kk, vv, q_valid=qvt, causal=False)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dn], \
                f"flash_prefill non-causal {dn} s={s} sk={sk} max|err| {err}"
            for bi, v_ in enumerate(qv or []):
                assert torch.count_nonzero(got[bi, v_:]) == 0, \
                    "padded query rows not zero"
            e = entry("flash_prefill")
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[kernels] flash_prefill non-causal {dn} b={b} s={s} "
                f"sk={sk} nq={fnq} nkv={fnkv} hd={fhd} q_valid={qv}: "
                f"max|err| {err:.3e} (tol {TOL[dn]})")
            if dtype == torch.float32 and timed:
                e.setdefault("cases", []).append(dict(
                    _time_flash_noncausal(torch, F, ref, flash_prefill_cuda,
                                          qq, kk, vv), max_abs_err=err))
        del pages, q, qq, kk, vv
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 3, 4

def make_requests(cfg, n, lo, hi, max_new, seed):
    import numpy as np
    from repro_torch.serving.cluster import ServeRequest
    rng = np.random.default_rng(seed)
    return [ServeRequest(rid=i, tokens=[int(t) for t in rng.integers(
                0, cfg.vocab_size, int(rng.integers(lo, hi + 1)))],
                max_new_tokens=max_new) for i in range(n)]


def stub_frames(cfg, rng):
    """A seeded stub frame embedding (enc_seq, d) at scale 0.1, as the
    launcher makes them, or None for a decoder-only stack."""
    import numpy as np
    if not cfg.is_encoder_decoder:
        return None
    return (rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
            ).astype(np.float32)


REDUCED_ARCHS = (ARCH, MOE_ARCH, "deepseek-moe-16b", SSM_ARCH,
                 "jamba-1.5-large-398b", ENCDEC_ARCH, VLM_ARCH)


def phase_reduced(torch) -> None:
    """Each served family at reduced size: card tokens == CPU tokens in
    both transfer modes, with warm prefix hits in the second batch
    (window-aligned hits for capacity MoE, snapshot restores for
    SSM/hybrid, whose snapshot stride is 32 tokens here; the same frames
    for whisper)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.cluster import MiniCluster

    for arch in REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        params = {"cpu": init_params(cfg, torch.Generator().manual_seed(7),
                                     device="cpu")}
        params["cuda"] = tree_map(lambda x: x.to("cuda"), params["cpu"])
        for overlap in (True, False):
            runs = {}
            for dev, prm in params.items():
                mc = MiniCluster(cfg, params=prm, device=dev,
                                 overlap_transfer=overlap)
                reqs = make_requests(cfg, 6, 34, 40, 6, seed=3)
                rng = np.random.default_rng(5)
                for r in reqs:
                    r.frames = stub_frames(cfg, rng)
                # the second batch (requests 4, 5) reuses prefixes (and
                # frames) of the first: warm hits through run_suffix
                reqs[4].tokens = reqs[0].tokens[:32] + reqs[4].tokens[:5]
                reqs[5].tokens = reqs[1].tokens[:20] + reqs[5].tokens[:9]
                reqs[4].frames, reqs[5].frames = reqs[0].frames, \
                    reqs[1].frames
                mc.run(reqs)
                assert all(r.done for r in reqs), (arch, dev, overlap)
                st = mc.frontend.groups["default"].prefix_stats()
                if mc.prefills[0].needs_state:
                    assert st["snap_hits"] >= 1 \
                        and st["state_restores"] >= 1, (arch, dev, st)
                else:
                    assert st["hits"] >= 2, (arch, dev, overlap, st)
                runs[dev] = {r.rid: list(r.generated) for r in reqs}
            assert runs["cuda"] == runs["cpu"], (arch, overlap, runs)
            log(f"[reduced] {cfg.name} overlap={overlap}: card tokens == "
                f"CPU tokens for {len(runs['cpu'])} requests (hits "
                f"{int(st['hits'])}, snapshot hits {int(st['snap_hits'])})")
        del params


def _sync_ms(torch, fn, repeats: int = 5) -> float:
    """Median host wall of ``fn`` ending in a card synchronise."""
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _kernel_modules() -> dict:
    from repro_torch.kernels import (flash_prefill, kv_gather, kv_scatter,
                                     paged_attention)
    return {"kv_gather": kv_gather, "kv_scatter": kv_scatter,
            "paged_attention": paged_attention,
            "flash_prefill": flash_prefill}


NONCAUSAL = "flash_prefill_noncausal"   # launches in the non-causal mode


def zero_counts() -> None:
    mods = _kernel_modules()
    for m in mods.values():
        m.launches = 0
    mods["flash_prefill"].noncausal_launches = 0


def read_counts() -> dict:
    """Each kernel's launches since zero_counts, and the non-causal share
    of flash prefill's under NONCAUSAL."""
    mods = _kernel_modules()
    counts = {n: m.launches for n, m in mods.items()}
    counts[NONCAUSAL] = mods["flash_prefill"].noncausal_launches
    return counts


def unlaunched(counts: dict) -> list:
    return [n for n in REPLACES if counts[n] == 0]


def free_card(torch) -> None:
    """Return what earlier phases dropped to the card: a dropped cluster
    frees its params and pools at once (its callbacks are weak), so no
    cycle collection is needed."""
    torch.cuda.empty_cache()


def load_params(torch, arch: str):
    """Full-width random f32 params on the card, from a seeded CUDA
    generator, after freeing the card; resets the peak-memory counter."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config(arch)
    free_card(torch)
    left = torch.cuda.memory_allocated() / 2**30
    assert left < 1.0, f"{left:.1f} GiB of an earlier phase still allocated"
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[{arch}] f32 params on the card "
        f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated)")
    return cfg, params


def serve(torch, card: str, tag: str, fe, waves) -> dict:
    """Serve ``waves`` (lists of requests, one ``run`` each, so a later
    wave can hit the prefixes an earlier one stored) through the
    ClusterFrontend ``fe``; checks every request finished with its
    budget and logs the timings. Returns {rid: tokens}."""
    t0 = time.perf_counter()
    for wave in waves:
        fe.run(wave)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reqs = [r for wave in waves for r in wave]
    assert all(r.done and len(r.generated) == r.max_new_tokens + 1
               for r in reqs), tag
    g = fe.groups["default"]
    steps = g.decode_step_s
    log(f"[{tag}] {len(reqs)} requests in {len(waves)} wave(s), prompts "
        f"{[len(r.tokens) for r in reqs]}, wall {wall:.2f}s; prefill "
        f"batches {[round(x * 1e3, 1) for x in g.prefill_batch_s]} ms; "
        f"decode step median {statistics.median(steps) * 1e3:.2f} ms over "
        f"{len(steps)} steps (min {min(steps) * 1e3:.2f}, max "
        f"{max(steps) * 1e3:.2f}); "
        f"{int(g.transfer_stats()['jobs_admitted'])} transfers [{card}]")
    return {r.rid: list(r.generated) for r in reqs}


def log_peak(torch, tag: str, card: str) -> float:
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak memory allocated {peak:.2f} GiB [{card}]")
    return peak


def phase_main(torch, card: str, out: Path):
    """The dense main path: full-width granite-3-8b, overlapped then
    blocking; then one request's hand-off timed; then a profiled run;
    then phase 7 (the control plane) on the same params. Returns the
    launch counts of the main path, of the control path (A-D) and of the
    absorption run (E)."""
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.frontend import ClusterFrontend

    cfg, params = load_params(torch, ARCH)
    zero_counts()
    tokens, clusters = {}, {}
    for overlap in (True, False):
        mc = MiniCluster(cfg, params=params, device="cuda",
                         overlap_transfer=overlap)
        tokens[overlap] = serve(
            torch, card, f"main overlap={overlap}", mc.frontend,
            [make_requests(cfg, 4, 200, 480, 16, seed=11)])
        clusters[overlap] = mc
    counts = read_counts()
    assert tokens[True] == tokens[False], tokens
    log(f"[main] overlapped tokens == blocking tokens; launches {counts}")
    missing = unlaunched(counts)
    assert not missing, f"kernels never launched on the main path: {missing}"
    log_peak(torch, "main", card)
    # one request's hand-off work on the card, after the run (these
    # launches are not counted above): blocking = gather + scatter of
    # every layer, overlapped = one stripe scatter per layer
    mc = clusters[False]
    src = mc.prefills[0].pool
    dst = mc.decodes[0].pool
    n = src.blocks_for_tokens(480)
    blocks = list(range(n))
    buf = src.gather_contiguous(blocks)
    stripes = [buf[li].contiguous() for li in range(buf.shape[0])]
    blocking = _sync_ms(torch, lambda: mc.xfer.transfer_block_free(
        src, blocks, dst, blocks))
    overlapped = _sync_ms(torch, lambda: [
        dst.scatter_layer(st, blocks, li) for li, st in enumerate(stripes)])
    log(f"[main] hand-off of a {n}-block (480-token) request, host wall "
        f"with sync: blocking transfer {blocking:.3f} ms, overlapped "
        f"{len(stripes)} stripe scatters {overlapped:.3f} ms [{card}]")
    del clusters, mc, src, dst, buf, stripes
    profile(torch, card, out, "main", lambda: ClusterFrontend(
        cfg, params=params, device="cuda"),
        lambda: [make_requests(cfg, 4, 200, 480, 16, seed=11)])
    control, absorb = phase_control(torch, card, cfg, params)
    del params
    free_card(torch)
    return counts, control, absorb


# ------------------------------------------------------------ phase 7

CONTROL_PATH = f"{ARCH}/control"
ABSORB_PATH = f"{ARCH}/control-absorb"


def control_requests(cfg, n=8, seed=17, max_new=16, rid0=0):
    reqs = make_requests(cfg, n, 200, 480, max_new, seed=seed)
    for r in reqs:
        r.rid += rid0
    return reqs


def token_margin(torch, cfg, params, req, want) -> str:
    """Where ``req`` left the reference stream ``want``: the first
    differing position and the reference model's top-2 logit margin
    there (a near tie says the card's sums moved one greedy pick)."""
    from repro_torch.models.modeling import forward_seq, lm_logits
    got = req.generated
    k = next(i for i in range(min(len(got), len(want)))
             if got[i] != want[i])
    # a re-admitted request's tokens are its prompt + what it had emitted
    prompt = getattr(req, "_orig_tokens", req.tokens)
    ctx = torch.tensor([list(prompt) + want[:k]], dtype=torch.long,
                       device="cuda")
    h, _, _ = forward_seq(cfg, params, {"tokens": ctx})
    top = torch.topk(lm_logits(cfg, params, h[:, -1]).float(), 2).values[0]
    return (f"rid {req.rid}: first differing token at {k} (got {got[k]}, "
            f"want {want[k]}); top-2 logit margin there "
            f"{(top[0] - top[1]).item():.4e}")


def assert_tokens(torch, cfg, params, tag, reqs, golden) -> None:
    """Every request finished with its budget and emitted the reference
    tokens; else fail with the logit margin at the first difference."""
    for r in reqs:
        assert r.done and not r.shed \
            and len(r.generated) == r.max_new_tokens + 1, (tag, r.rid)
        if list(r.generated) != golden[r.rid]:
            raise AssertionError(f"[{tag}] tokens differ: " + token_margin(
                torch, cfg, params, r, golden[r.rid]))


def run_control(torch, card, tag, fe, reqs, *, at=None, watch=True):
    """Submit ``reqs`` at virtual times ``at`` (default 2 ms apart) and
    serve them (``watch=False``: drain the timeline, recoveries
    included); logs and returns (wall s, peak GiB)."""
    for i, r in enumerate(reqs):
        fe.submit(r, at=0.002 * i if at is None else at[i])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fe.serve(watch=reqs if watch else None, max_events=500_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    g = fe.groups["default"]
    kinds = [k for _, k in g.event_log]
    log(f"[{tag}] {len(reqs)} requests, wall {wall:.2f}s, peak "
        f"{peak:.2f} GiB, virtual end {g.vclock:.4f}s, ratio {g.ratio}, "
        f"{len(kinds)} events ({kinds.count('batch')} batch, "
        f"{kinds.count('step')} step) [{card}]")
    return wall, peak


def pool_bytes(fe) -> int:
    return sum(n.pool.storage.numel() * n.pool.storage.element_size()
               for g in fe.groups.values() for n in g.prefills + g.decodes)


def phase_control(torch, card: str, cfg, params) -> dict:
    """The P/D control plane on the main path's full-width granite-3-8b
    params (phase 4's, before they are freed), f32, one 2P:2D group on
    the card, eight 200-480-token prompts 2 ms apart, 16 new tokens,
    prefill batch size 1:

    A. fault-free under DeterministicService (the reference tokens);
    B. A plus a FaultPlan (crash of prefill P0 while its hand-off is on
       the wire, crash of decode D0 mid-steps, a hang of D1 past the
       health timeout), twice: A's tokens, equal logs both times;
    C. the RatioAdjuster on a profile whose Eq. 1 optimum is 1P:3D, on
       MEASURED card walls and blocking transfer: a P->D flip over the
       same params, and the new decode node serves;
    D. an AutoScaler over a one-prefill-heavy, one-decode-heavy NodePool,
       a burst then a trickle from 1P:1D: scale up and down, tokens of a
       static run, memory back to params + live pools;
    E. decode-side absorption: 1P:1D (prefill batch 2) with
       ``absorb_prefill=True`` and an AutoScaler over an EMPTY NodePool
       (JAX's exhausted-pool scenario at full width), three decoded
       requests, then a burst of eight prefill-complete ones: scale-up
       denied, at least one request absorbed by the idle decode node in
       16-token chunks, every first token equal to a monolithic prefill
       of its prompt, two runs with equal event logs, memory back to
       params + live pools.

    Returns the kernels' launch counts over A-D and over E."""
    from repro_torch.core.mlops import SLOSpec
    from repro_torch.core.perf_model import InstanceProfile, optimal_ratio
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.autoscale import AutoScaler, NodePool
    from repro_torch.serving.cluster import DecodeNode
    from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                            FaultPlan)
    from repro_torch.serving.frontend import ClusterFrontend

    svc = DeterministicService()
    one = dict(params=params, device="cuda", prefill_kwargs={"batch_size": 1})
    zero_counts()

    # ---- A: fault-free baseline
    fe = ClusterFrontend(cfg, topology={"default": (2, 2)},
                         service_model=svc, **one)
    reqs = control_requests(cfg)
    run_control(torch, card, "control A fault-free", fe, reqs)
    golden = {r.rid: list(r.generated) for r in reqs}
    assert_tokens(torch, cfg, params, "control A", reqs, golden)
    steps = [t for t, k in fe.groups["default"].event_log if k == "step"]
    del fe, reqs

    # ---- B: crashes and a hang, picked from A's event log
    hb, timeout, recover = 0.02, 0.05, 0.05
    t_p = 0.5 * steps[0]                 # P0's first hand-off on the wire
    t_d = steps[2 * len(steps) // 5]     # D0 in the middle of its steps
    t_h = t_d + recover + 0.01           # D1, once D0's substitute is up
    plan = [FaultEvent(t_p, "crash", "g0/P0", recover),
            FaultEvent(t_d, "crash", "g0/D0", recover),
            FaultEvent(t_h, "hang", "g0/D1", 3 * timeout)]
    log(f"[control B] faults from A's {len(steps)} decode steps "
        f"({steps[0]:.4f}-{steps[-1]:.4f} virtual s): {plan}")
    sigs, walls = [], []
    for rep in range(2):
        fe = ClusterFrontend(cfg, topology={"default": (2, 2)},
                             service_model=svc, faults=FaultPlan(plan),
                             health_timeout_s=timeout,
                             fault_kwargs={"heartbeat_s": hb,
                                           "recover_delay_s": recover}, **one)
        reqs = control_requests(cfg)
        walls.append(run_control(torch, card, f"control B run {rep + 1}",
                                 fe, reqs, watch=False))
        assert_tokens(torch, cfg, params, "control B", reqs, golden)
        g = fe.groups["default"]
        st = g.transfer_stats()
        assert st["ft_crashes"] == 2 and st["ft_ejections"] >= 3 \
            and st["ft_requests_readmitted"] >= 1, st
        assert g.sched.n_src_failed >= 1, "the prefill crash killed no hand-off"
        assert all(n.pool.invariant_ok() for n in g.prefills + g.decodes)
        sigs.append((list(g.event_log), list(g.ft.log), list(fe.meta.events)))
        if rep == 0:
            log(f"[control B] fault log {g.ft.log}")
        log(f"[control B run {rep + 1}] " + ", ".join(
            f"{k} {st[k]}" for k in sorted(st) if k.startswith("ft_"))
            + f" (virtual s) [{card}]")
        del fe, reqs, g
    assert sigs[0] == sigs[1], "the two chaos runs' logs differ"
    log(f"[control B] tokens == A's in both runs; event log "
        f"({len(sigs[0][0])} events), fault log and MetaStore audit log "
        f"({len(sigs[0][2])} entries) identical across the two runs")

    # ---- C: ratio adjustment on measured walls, blocking transfer
    prof = InstanceProfile(ttft_bs=0.1, b_p=1, r_pre=1.0, tpot_bs=0.04,
                           b_d=2, gen_tokens=16.0, xi=0.0)
    assert optimal_ratio(prof, 4) == (1, 3)
    fe = ClusterFrontend(cfg, topology={"default": (2, 2)},
                         adjust_ratio=True, adjust_interval=1,
                         adjust_period_s=0.02, profiles={"default": prof},
                         overlap_transfer=False, **one)
    reqs = control_requests(cfg)
    run_control(torch, card, "control C adjust", fe, reqs)
    assert_tokens(torch, cfg, params, "control C", reqs, golden)
    g = fe.groups["default"]
    assert [f[3] for f in g.flips] == ["P->D"] and g.ratio == (1, 3), g.flips
    for role, nodes in (("P", g.prefills), ("D", g.decodes)):
        assert sorted(fe.meta.group_members(g.gid, role)) == \
            sorted(n.iid for n in nodes), role
    new = g.find_node(g.flips[0][2])
    shared = {id(x): x.data_ptr() for x in tree_leaves(params)}
    assert [x.data_ptr() for x in tree_leaves(new.engine.params)] == \
        [shared[id(x)] for x in tree_leaves(new.engine.params)]
    assert new.engine.fused_steps > 0, "the flipped-in decode node never served"
    log(f"[control C] flips {g.flips}; adjuster decisions "
        f"{fe.adjusters['default'].decisions}; the new node {new.iid} "
        f"shares every param tensor (data_ptr) and ran "
        f"{new.engine.fused_steps} decode steps; MetaStore roles == the "
        f"group's lists; tokens == A's [{card}]")
    del fe, reqs, g, new

    # ---- D: the autoscaler, burst then trickle, from 1P:1D
    svc_d = DeterministicService(prefill_base_s=0.02,
                                 prefill_per_token_s=2e-5)
    burst = control_requests(cfg, n=10, seed=19)
    trickle = control_requests(cfg, n=3, seed=23, rid0=100)
    static = ClusterFrontend(cfg, topology={"default": (2, 1)},
                             service_model=svc_d, **one)
    ref = control_requests(cfg, n=10, seed=19) + \
        control_requests(cfg, n=3, seed=23, rid0=100)
    run_control(torch, card, "control D static 2P:1D", static, ref)
    gold_d = {r.rid: list(r.generated) for r in ref}
    del static, ref
    free_card(torch)
    base = torch.cuda.memory_allocated()
    fe = ClusterFrontend(cfg, topology={"default": (1, 1)},
                         service_model=svc_d, **one)
    pool = NodePool({"prefill-heavy": 1, "decode-heavy": 1},
                    provision_scale=0.002)
    scaler = AutoScaler(fe, pool, SLOSpec(ttft_s=0.06, tpot_s=0.01),
                        period_s=0.05, window_s=0.5, cooldown_s=0.1)
    reqs = burst + trickle
    run_control(torch, card, "control D autoscale", fe, reqs,
                at=[0.002 * i for i in range(len(burst))]
                + [1.0 + 0.2 * i for i in range(len(trickle))])
    assert_tokens(torch, cfg, params, "control D", reqs, gold_d)
    g = fe.groups["default"]
    st = g.transfer_stats()
    assert st["scale_up_done"] >= 1 and st["scale_down_done"] >= 1, st
    ops = [(o.kind, o.role, o.iid, o.ncls, round(o.t_start, 4),
            round(o.t_done, 4)) for o in scaler.ops]
    left = torch.cuda.memory_allocated() - base - pool_bytes(fe)
    block = (cfg.num_layers * 16 * 2 * cfg.kv_dim * 4)
    assert abs(left) <= block, f"{left} bytes beyond params + live pools"
    log(f"[control D] scale ops {ops}; pool {pool.ledger()}; ratio now "
        f"{g.ratio}; tokens == the static run's; allocated after the run = "
        f"before + live pools {pool_bytes(fe)} B + {left} B (one block "
        f"{block} B) [{card}]")
    counts = read_counts()
    del fe, scaler, pool, g, reqs, burst, trickle

    absorb = phase_absorb(torch, card, cfg, params)

    # ---- the card's cost of a reboot or scale-up: one fresh decode pool
    builds = []
    free_card(torch)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        node = DecodeNode("fresh", cfg, params)
        torch.cuda.synchronize()
        builds.append((time.perf_counter() - t0) * 1e3)
        nbytes = node.pool.storage.numel() * node.pool.storage.element_size()
        del node
    log(f"[control] a fresh granite decode node ({nbytes} B pool): "
        f"{builds[0]:.2f} ms after empty_cache, then "
        f"{builds[1]:.2f} / {builds[2]:.2f} ms [{card}]")
    missing = unlaunched(counts)
    assert not missing, f"kernels never launched on the control path: {missing}"
    log(f"[control] launches {counts} [{card}]")
    return counts, absorb


def absorb_run(torch, card, cfg, params, tag):
    """One run of phase 7 E; returns (frontend, requests, pool)."""
    from repro_torch.core.mlops import SLOSpec
    from repro_torch.serving.autoscale import AutoScaler, NodePool
    from repro_torch.serving.faults import DeterministicService
    from repro_torch.serving.frontend import ClusterFrontend

    fe = ClusterFrontend(cfg, params=params, device="cuda",
                         topology={"default": (1, 1)},
                         service_model=DeterministicService(
                             prefill_base_s=0.02, prefill_per_token_s=5e-4),
                         absorb_prefill=True,
                         prefill_kwargs={"batch_size": 2})
    pool = NodePool({}, provision_scale=0.002)
    AutoScaler(fe, pool, SLOSpec(ttft_s=0.06, tpot_s=0.01), period_s=0.05,
               window_s=0.5, cooldown_s=0.1)
    decoded = control_requests(cfg, n=3, seed=31, max_new=4, rid0=200)
    burst = control_requests(cfg, n=8, seed=37, max_new=0, rid0=300)
    run_control(torch, card, tag, fe, decoded + burst,
                at=[0.002 * i for i in range(3)]
                + [1.0 + 0.002 * i for i in range(8)])
    return fe, decoded + burst, pool


def phase_absorb(torch, card: str, cfg, params) -> dict:
    """Phase 7 E (see phase_control): returns its launch counts."""
    from repro_torch.serving.engine import PrefillEngine

    free_card(torch)
    base = torch.cuda.memory_allocated()
    zero_counts()
    fe, reqs, pool = absorb_run(torch, card, cfg, params,
                                "control E absorb run 1")
    counts = read_counts()
    g = fe.groups["default"]
    st = g.transfer_stats()
    ab = {k: st[k] for k in st if k.startswith("absorb_")}
    assert all(r.done and not r.shed for r in reqs), "E left requests"
    assert ab["absorb_requests"] >= 1 and pool.n_denied >= 1, (ab, st)
    left = torch.cuda.memory_allocated() - base - pool_bytes(fe)
    block = (cfg.num_layers * 16 * 2 * cfg.kv_dim * 4)
    assert abs(left) <= block, f"{left} bytes beyond params + live pools"
    log_a = list(g.event_log)
    eng = PrefillEngine(cfg, params)
    mono = {r.rid: eng.run([r.tokens])[0].first_token for r in reqs}
    for r in reqs:
        if r.generated[0] != mono[r.rid]:
            raise AssertionError(
                "[control E] first token differs from a monolithic "
                "prefill: " + token_margin(torch, cfg, params, r,
                                           [mono[r.rid]]))
    chunks = ab["absorb_chunks"] / ab["absorb_requests"]
    log(f"[control E] {ab}; {chunks:.1f} chunks per absorbed request; "
        f"scale-up denied {pool.n_denied}x; every first token == a "
        f"monolithic prefill of its prompt; allocated after the run = "
        f"before + live pools {pool_bytes(fe)} B + {left} B [{card}]")
    del fe, g, eng, pool
    fe, reqs2, pool = absorb_run(torch, card, cfg, params,
                                 "control E absorb run 2")
    assert list(fe.groups["default"].event_log) == log_a, \
        "the two absorption runs' event logs differ"
    assert [r.generated for r in reqs2] == [r.generated for r in reqs]
    log(f"[control E] run 2: the same event log ({len(log_a)} events, "
        f"{[k for _, k in log_a].count('absorb')} absorb) and tokens")
    del fe, pool, reqs2
    free_card(torch)
    return counts


def phase_path(torch, card: str, out: Path, arch: str, tag: str) -> dict:
    """A full-width decoder path through phase 4's four prompts, 1P:1D,
    overlapped then blocking: equal tokens, every kernel launched; then a
    profiled run. The MoE path (qwen2-moe-a2.7b: 60 routed experts top-4
    and 4 shared, capacity dispatch) and the VLM backbone (pixtral-12b,
    token-only as the JAX package serves it)."""
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.frontend import ClusterFrontend

    cfg, params = load_params(torch, arch)
    zero_counts()
    tokens = {}
    for overlap in (True, False):
        mc = MiniCluster(cfg, params=params, device="cuda",
                         overlap_transfer=overlap)
        tokens[overlap] = serve(
            torch, card, f"{tag} overlap={overlap}", mc.frontend,
            [make_requests(cfg, 4, 200, 480, 16, seed=11)])
        del mc
    counts = read_counts()
    assert tokens[True] == tokens[False], tokens
    log(f"[{tag}] overlapped tokens == blocking tokens; launches {counts}")
    missing = unlaunched(counts)
    assert not missing, f"kernels never launched on the {tag} path: {missing}"
    log_peak(torch, tag, card)
    profile(torch, card, out, tag, lambda: ClusterFrontend(
        cfg, params=params, device="cuda"),
        lambda: [make_requests(cfg, 4, 200, 480, 16, seed=11)])
    del params
    free_card(torch)
    return counts


def ssm_waves(cfg):
    """Four requests sharing one seeded 256-token prefix, each followed
    by 100-300 seeded suffix tokens, 16 new tokens: the first alone,
    then the other three (warm hits on the prefix it stored)."""
    import numpy as np
    from repro_torch.serving.cluster import ServeRequest
    rng = np.random.default_rng(13)
    shared = [int(t) for t in rng.integers(0, cfg.vocab_size, 256)]
    reqs = [ServeRequest(rid=i, tokens=shared + [
        int(t) for t in rng.integers(0, cfg.vocab_size,
                                     int(rng.integers(100, 301)))],
        max_new_tokens=16) for i in range(4)]
    return [reqs[:1], reqs[1:]]


# warm SSM state against cold: max |delta| over the largest |entry| (the
# SSD state sums over 64 layers of f32 matmuls whose cuBLAS algorithms
# differ by shape between the cold and the suffix-only run)
SSM_STATE_TOL = 1e-3


def phase_ssm(torch, card: str, out: Path) -> dict:
    """The SSM path: full-width mamba2-2.7b, 1P:1D, prefix cache on
    (snapshot restores at the 256-token boundary), overlapped and
    blocking, and once cold with the prefix cache off; then the warm
    hand-off state against the cold one on the engine; then a profiled
    run."""
    from repro_torch.serving.engine import PrefillEngine
    from repro_torch.serving.frontend import ClusterFrontend
    from repro_torch.serving.transfer_sched import state_payload_nbytes

    cfg, params = load_params(torch, SSM_ARCH)
    zero_counts()
    tokens = {}
    for mode, kw in (("overlapped", dict(overlap_transfer=True)),
                     ("blocking", dict(overlap_transfer=False)),
                     ("cold", dict(overlap_transfer=True,
                                   prefix_cache=False))):
        fe = ClusterFrontend(cfg, params=params, device="cuda", **kw)
        tokens[mode] = serve(torch, card, f"ssm {mode}", fe, ssm_waves(cfg))
        g = fe.groups["default"]
        st, ts = g.prefix_stats(), g.transfer_stats()
        if mode != "cold":
            assert st["snap_hits"] >= 1 and st["state_restores"] >= 1, st
        if mode == "blocking":
            # each admission's stall charges the state payload's wire time
            assert len(g.blocking_waits) == 4 \
                and min(g.blocking_waits) > 0, g.blocking_waits
        else:
            assert ts["state_segments"] == 4 \
                and ts["state_payload_bytes"] > 0, ts
        log(f"[ssm {mode}] snapshot hits {int(st['snap_hits'])}, stores "
            f"{int(st['snap_stores'])}, resident snapshot bytes "
            f"{int(st['snap_bytes'])}, reused tokens "
            f"{int(st['reused_tokens'])}, state payload bytes "
            f"{int(ts['state_payload_bytes'])} over "
            f"{int(ts['state_segments'])} segments")
        del fe, g
    counts = read_counts()
    assert tokens["overlapped"] == tokens["blocking"] == tokens["cold"], \
        tokens
    assert not any(counts.values()), f"KV kernels launched: {counts}"
    log(f"[ssm] warm tokens == cold tokens, overlapped == blocking; "
        f"launches {counts}")
    # the warm hand-off state (snapshot at 256 restored, suffix run)
    # against the cold run of the whole prompt, on one engine
    eng = PrefillEngine(cfg, params)
    first, rest = ssm_waves(cfg)
    prime = eng.run([first[0].tokens], snap_stride=256)[0]
    req = rest[0]
    cold = eng.run([req.tokens])[0]
    warm = eng.run_suffix(req.tokens[256:], None, state=prime.snapshots[256],
                          prefix_len=256)
    rel = max((w[k] - c[k]).abs().max().item()
              / c[k].abs().max().clamp_min(1e-30).item()
              for key, c in cold.mamba_state.items()
              for w in [warm.mamba_state[key]] for k in c)
    assert warm.first_token == cold.first_token, (warm.first_token,
                                                  cold.first_token)
    assert rel <= SSM_STATE_TOL, rel
    snap_b = sum(t.numel() * t.element_size()
                 for st in prime.snapshots[256].values() for t in st.values())
    log(f"[ssm] warm state vs cold over {len(cold.mamba_state)} layers: "
        f"max |delta| / max |cold| {rel:.3e} (tol {SSM_STATE_TOL}); first "
        f"tokens equal; one snapshot {snap_b} bytes, hand-off state "
        f"{state_payload_nbytes(cold)} bytes [{card}]")
    # the same prompt prefilled in 256-token chunks (one SSD chunk each,
    # the state carried across chunks) against the cold run
    chunked = eng.run_chunked(req.tokens, chunk_tokens=256)
    crel = max((w[k] - c[k]).abs().max().item()
               / c[k].abs().max().clamp_min(1e-30).item()
               for key, c in cold.mamba_state.items()
               for w in [chunked.mamba_state[key]] for k in c)
    assert chunked.first_token == cold.first_token, (chunked.first_token,
                                                     cold.first_token)
    assert crel <= SSM_STATE_TOL, crel
    log(f"[ssm] chunked prefill of a {len(req.tokens)}-token prompt in "
        f"{eng.chunked_chunks} chunks of <= 256: first token == cold, "
        f"state max |delta| / max |cold| {crel:.3e} (tol {SSM_STATE_TOL}) "
        f"[{card}]")
    del eng, prime, cold, warm, chunked
    log_peak(torch, "ssm", card)
    profile(torch, card, out, "ssm", lambda: ClusterFrontend(
        cfg, params=params, device="cuda"), lambda: ssm_waves(cfg))
    del params
    free_card(torch)
    return counts


def encdec_waves(cfg):
    """Four whisper requests of 24-64 seeded prompt tokens with seeded stub
    frames, 16 new tokens: the first alone, then three more: one with
    the first's frames and its first 32 tokens (a warm hit), one with the
    first's tokens but other frames (a miss: another namespace), one
    fresh."""
    import numpy as np
    from repro_torch.serving.cluster import ServeRequest
    rng = np.random.default_rng(29)
    fr = [stub_frames(cfg, rng) for _ in range(3)]

    def toks(n):
        return [int(t) for t in rng.integers(0, cfg.vocab_size, n)]
    a = toks(48)
    reqs = [ServeRequest(rid=0, tokens=a, max_new_tokens=16, frames=fr[0]),
            ServeRequest(rid=1, tokens=a[:32] + toks(24), max_new_tokens=16,
                         frames=fr[0]),
            ServeRequest(rid=2, tokens=list(a), max_new_tokens=16,
                         frames=fr[1]),
            ServeRequest(rid=3, tokens=toks(int(rng.integers(24, 65))),
                         max_new_tokens=16, frames=fr[2])]
    return [reqs[:1], reqs[1:]]


def phase_encdec(torch, card: str, out: Path) -> dict:
    """The encoder-decoder path: full-width whisper-base, 1P:1D, prefix
    cache on (overlapped, blocking) and off, ``encdec_waves``: equal
    tokens in all three runs (warm == cold), exactly one prefix hit per
    cached run (the same tokens under other frames miss), flash prefill
    18 launches per forward (6 encoder and 6 cross-attention, non-causal;
    6 decoder self-attention), paged attention 6 per decode step; the
    decode step's cross-attention (attention_decode, plain torch) timed
    at eight slots; then a profiled run."""
    from repro_torch.models.modeling import attention_decode
    from repro_torch.serving.frontend import ClusterFrontend

    cfg, params = load_params(torch, ENCDEC_ARCH)
    L = cfg.num_layers
    zero_counts()
    tokens, forwards, steps = {}, 0, 0
    for mode, kw in (("overlapped", dict(overlap_transfer=True)),
                     ("blocking", dict(overlap_transfer=False)),
                     ("cold", dict(overlap_transfer=True,
                                   prefix_cache=False))):
        fe = ClusterFrontend(cfg, params=params, device="cuda", **kw)
        tokens[mode] = serve(torch, card, f"whisper {mode}", fe,
                             encdec_waves(cfg))
        g = fe.groups["default"]
        st = g.prefix_stats()
        assert st["hits"] == (0 if mode == "cold" else 1), (mode, st)
        forwards += sum(p.engine.prefill_batches for p in g.prefills)
        steps += sum(d.engine.fused_steps for d in g.decodes)
        log(f"[whisper {mode}] prefix hits {int(st['hits'])}, reused "
            f"tokens {int(st['reused_tokens'])}; state payload bytes "
            f"{int(g.transfer_stats()['state_payload_bytes'])}")
        del fe, g
    counts = read_counts()
    assert tokens["overlapped"] == tokens["blocking"] == tokens["cold"], \
        tokens
    missing = unlaunched(counts)
    assert not missing, f"kernels never launched on the whisper path: " \
        f"{missing}"
    assert counts["flash_prefill"] == 3 * L * forwards \
        and counts[NONCAUSAL] == 2 * L * forwards, (counts, forwards)
    assert counts["paged_attention"] == L * steps, (counts, steps)
    log(f"[whisper] warm tokens == cold tokens, overlapped == blocking; "
        f"{forwards} forwards, {steps} decode steps; launches {counts}")
    log_peak(torch, "whisper", card)
    # the decode step's cross-attention: 8 slots x 8 heads of 64 against
    # each slot's 1500 x 512 cross KV, once per layer per step
    gen = torch.Generator(device="cuda").manual_seed(3)
    slots, S, kvd = 8, cfg.encoder_seq, cfg.kv_dim
    q = torch.randn((slots, cfg.num_heads, cfg.hd), generator=gen,
                    device="cuda")
    xk, xv = (torch.randn((slots, S, kvd), generator=gen, device="cuda")
              for _ in range(2))
    ms = time_ms(lambda: attention_decode(q, xk, xv, cfg.num_kv_heads, S))
    b_ms, b_by = bound_ms((2 * q.numel() + 2 * slots * S * kvd) * 4,
                          4 * slots * S * cfg.num_heads * cfg.hd, "float32")
    log(f"[whisper] decode-step cross-attention (attention_decode, plain "
        f"torch) at {slots} slots x {cfg.num_heads} heads of {cfg.hd} over "
        f"{S} x {kvd}: {ms:.4f} ms device time per layer ({L} per step; "
        f"bound {b_ms:.4f} ms, {b_by}) [{card}]")
    del q, xk, xv
    profile(torch, card, out, "whisper", lambda: ClusterFrontend(
        cfg, params=params, device="cuda"), lambda: encdec_waves(cfg))
    del params
    free_card(torch)
    return counts


def profile(torch, card: str, out: Path, tag: str, make_fe, make_waves
            ) -> None:
    """torch.profiler over one more overlapped run (after a warm-up run):
    device kernel time by kind and the device's busy share of the run's
    wall time. The full table goes to ``out/profile_<tag>.txt``."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    make_fe().run([r for wave in make_waves() for r in wave])  # warm-up
    fe = make_fe()
    waves = make_waves()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for wave in waves:
            fe.run(wave)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds: dict = {}
    total = 0.0
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if not dev_us or "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        name = ev.key
        low = name.lower()
        kind = ("flash_prefill" if "flash_prefill" in name else
                "paged_attention" if "paged_attention" in name else
                "kv_scatter" if "kv_scatter" in name else
                "kv_gather" if "kv_gather" in name else
                "copy" if "memcpy" in low or "memset" in low else
                "gemm/gemv" if ("gemm" in low or "gemv" in low
                                or "cutlass" in low) else "other")
        kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
        total += dev_us / 1e3
    g = fe.groups["default"]
    lines = [f"profile of one overlapped full-width run [{card}]",
             f"wall {wall * 1e3:.1f} ms; device kernel time {total:.1f} ms "
             f"(busy share {total / (wall * 1e3):.3f})",
             f"prefill batches {[round(x * 1e3, 1) for x in g.prefill_batch_s]}"
             f" ms; decode steps {len(g.decode_step_s)}, median "
             f"{statistics.median(g.decode_step_s) * 1e3:.2f} ms"]
    lines += [f"  {k}: {v:.1f} ms" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])]
    (out / f"profile_{tag}.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=30))
    for line in lines:
        log(f"[profile {tag}] {line}")
    if total == 0.0:
        log(f"[profile {tag}] the profiler recorded no device time")
    del fe, prof
    free_card(torch)


# ------------------------------------------------------------ main

REPLACES = {
    "kv_gather": "src/repro/kernels/kv_gather.py:38",
    "kv_scatter": "src/repro/kernels/kv_scatter.py:42",
    "paged_attention": "src/repro/kernels/paged_attention.py:94",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:126",
}


def ab_causal(torch, root: Path) -> int:
    """Device times of CHECKOUT ``root``'s causal flash prefill at phase
    2's two timed shapes (b=2, s=512, q_valid [480, 300], hd 128, f32;
    32/8 and 16/16 heads), three timings each, its kernels built from
    its own sources. The wrapper is called as phase 2 calls it, with no
    ``causal=``, so a checkout from before the non-causal mode is timed
    the same way. For an A/B in turns, with the parent unpacked under
    ``build/parent``:

        for t in build/parent . . build/parent; do
            python3 chip_smoke.py --ab $t; done
    """
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    qv = torch.tensor([480, 300], dtype=torch.int32, device="cuda")
    rows = []
    for nq, nkv in ((32, 8), (16, 16)):
        q, k, v = (torch.randn((2, 512, n, 128), generator=gen,
                               device="cuda") for n in (nq, nkv, nkv))
        ms = [time_ms(lambda: flash_prefill_cuda(q, k, v, q_valid=qv))
              for _ in range(3)]
        rows.append(f"{nq}/{nkv}: " + ", ".join(f"{x:.4f}" for x in ms))
    log(f"[ab] {root}: causal flash prefill ms {'; '.join(rows)} "
        f"[{smi_line()}]")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="directory for the build log and profile table")
    ap.add_argument("--ab", metavar="CHECKOUT",
                    help="only time CHECKOUT's causal flash prefill "
                         "(an A/B in turns; see ab_causal)")
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.ab:
        return ab_causal(torch, Path(a.ab))
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)

    # phase 0
    card = smi_line()
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f" cuda {torch.version.cuda}; TF32 off for matmul and cudnn")
    from repro_torch.kernels import build
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()
    log(f"[device] {nvcc[-1]}")

    # phase 1
    info = build.build()
    (out / "kernel_build.log").write_text(info.log)
    build.library()
    log(f"[build] {info.path.name} in {info.seconds:.1f}s "
        f"(ptxas report in {out / 'kernel_build.log'})")
    for line in info.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    results: dict = {}
    phase_kernels(torch, results)
    phase_reduced(torch)
    main_counts, control_counts, absorb_counts = phase_main(torch, card, out)
    paths = {ARCH: main_counts, CONTROL_PATH: control_counts,
             ABSORB_PATH: absorb_counts,
             MOE_ARCH: phase_path(torch, card, out, MOE_ARCH, "moe"),
             SSM_ARCH: phase_ssm(torch, card, out),
             ENCDEC_ARCH: phase_encdec(torch, card, out),
             VLM_ARCH: phase_path(torch, card, out, VLM_ARCH, "pixtral")}
    counts = paths[ARCH]
    assert set(results) == set(REPLACES) <= set(counts), (results, counts)

    rows = []
    for name, r in results.items():
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name],
                     "launches": counts[name],
                     "max_abs_err": r["max_abs_err"],
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "launches_by_path": {a: c[name]
                                          for a, c in paths.items()},
                     "cases": r.get("cases", [])})
        if name == "flash_prefill":
            rows[-1]["noncausal_launches_by_path"] = {
                a: c[NONCAUSAL] for a, c in paths.items()}
    for row, r in zip(rows, results.values()):
        for c in [r] + r.get("cases", []):
            log(f"[kernels] {row['name']} at {c.get('shape')}: {c['ms']} "
                f"ms, plain {c['plain_ms']} ms, library {c['library_ms']} "
                f"ms, bound {c['bound_ms']} ms ({c['bound_by']}) [{card}]")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
