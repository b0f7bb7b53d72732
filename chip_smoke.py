#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--out DIR]

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
   with device times of the kernel, the plain version and one PyTorch
   library call (CUDA-graph replay); paged attention is timed cold in
   L2, one layer of a full-size pool per launch, as the decode step
   reads it;
3. reduced paths: granite-3-8b, qwen2-moe, deepseek-moe, mamba2 and
   jamba reduced, 1P:1D ``MiniCluster`` on the card and on the CPU with
   the same params, equal tokens per request in both transfer modes,
   with warm prefix hits (snapshot restores for mamba2 and jamba);
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
   launch; the warm hand-off state against the cold one; a profiled run
   (``<out>/profile_ssm.txt``).

Each path logs its prefill batch walls, decode step median, launch
counts and peak memory, beside the card's name and power limit.
Long reports go to ``--out`` (default ``build/chip_smoke``, gitignored):
the ptxas register/spill report of the build and the profile table.

The second-to-last line is ``{"kernels": [...]}`` (launches on the main
path and on each path, max |err| against the plain version, times and
bounds, and the MoE path's attention shapes as "cases"); the last is
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


REDUCED_ARCHS = (ARCH, MOE_ARCH, "deepseek-moe-16b", SSM_ARCH,
                 "jamba-1.5-large-398b")


def phase_reduced(torch) -> None:
    """Each served family at reduced size: card tokens == CPU tokens in
    both transfer modes, with warm prefix hits in the second batch
    (window-aligned hits for capacity MoE, snapshot restores for
    SSM/hybrid, whose snapshot stride is 32 tokens here)."""
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
                # the second batch (requests 4, 5) reuses prefixes of the
                # first: warm hits through run_suffix
                reqs[4].tokens = reqs[0].tokens[:32] + reqs[4].tokens[:5]
                reqs[5].tokens = reqs[1].tokens[:20] + reqs[5].tokens[:9]
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


def zero_counts() -> None:
    for m in _kernel_modules().values():
        m.launches = 0


def read_counts() -> dict:
    return {n: m.launches for n, m in _kernel_modules().items()}


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


def phase_main(torch, card: str, out: Path) -> dict:
    """The dense main path: full-width granite-3-8b, overlapped then
    blocking; then one request's hand-off timed; then a profiled run."""
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
    missing = [n for n, c in counts.items() if c == 0]
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
    del params
    free_card(torch)
    return counts


def phase_moe(torch, card: str, out: Path) -> dict:
    """The MoE path: full-width qwen2-moe-a2.7b (60 routed experts top-4
    and 4 shared, capacity dispatch), 1P:1D, overlapped then blocking:
    equal tokens, every kernel launched; then a profiled run."""
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.frontend import ClusterFrontend

    cfg, params = load_params(torch, MOE_ARCH)
    zero_counts()
    tokens = {}
    for overlap in (True, False):
        mc = MiniCluster(cfg, params=params, device="cuda",
                         overlap_transfer=overlap)
        tokens[overlap] = serve(
            torch, card, f"moe overlap={overlap}", mc.frontend,
            [make_requests(cfg, 4, 200, 480, 16, seed=11)])
        del mc
    counts = read_counts()
    assert tokens[True] == tokens[False], tokens
    log(f"[moe] overlapped tokens == blocking tokens; launches {counts}")
    missing = [n for n, c in counts.items() if c == 0]
    assert not missing, f"kernels never launched on the MoE path: {missing}"
    log_peak(torch, "moe", card)
    profile(torch, card, out, "moe", lambda: ClusterFrontend(
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
    del eng, prime, cold, warm
    log_peak(torch, "ssm", card)
    profile(torch, card, out, "ssm", lambda: ClusterFrontend(
        cfg, params=params, device="cuda"), lambda: ssm_waves(cfg))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="directory for the build log and profile table")
    a = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
    paths = {ARCH: phase_main(torch, card, out),
             MOE_ARCH: phase_moe(torch, card, out),
             SSM_ARCH: phase_ssm(torch, card, out)}
    counts = paths[ARCH]
    assert set(results) == set(counts) == set(REPLACES), (results, counts)

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
    for row, r in zip(rows, results.values()):
        log(f"[kernels] {row['name']} at {r.get('shape')}: {row['ms']} ms, "
            f"plain {row['plain_ms']} ms, library {row['library_ms']} ms, "
            f"bound {row['bound_ms']} ms ({row['bound_by']}) [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
