#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py [--out DIR]
    python3 chip_smoke.py --ab CHECKOUT
    python3 chip_smoke.py --ab-serve CHECKOUT
    python3 chip_smoke.py --ab-train CHECKOUT
    python3 chip_smoke.py --splits

The second form only times CHECKOUT's attention kernels, the causal and
window ones with digests of their outputs (see ``ab_causal``), the third
only its served prefill batches on granite-3-8b and pixtral-12b (see
``ab_serve``), the fourth only its whisper-base training steps (see
``ab_train``), for an A/B of two checkouts in turns within one call; the
fifth only the non-causal attention kernels by forced key-range count
(see ``sweep_splits``).

Phases, all of them on every run, in order (any failure exits non-zero;
nothing is swallowed):

0. device: the card's name and power limit, PyTorch's view of it, nvcc;
1. build: the seven CUDA kernels from ``src/repro_torch/kernels/csrc``
   (six sources: grouped_mm.cu holds the grouped product and its weight
   gradient, each by a rows and a tiles path);
2. kernels: each kernel against its plain PyTorch version on the card at
   the main path's full-width shapes (granite-3-8b: 40 layers, 8 kv heads
   of 128, 32 query heads, 16-token blocks), at the MoE path's
   (qwen2-moe: 24 layers, nq = nkv = 16 of 128, pool width 4096), at
   pangu-38b's (48/8 heads of 128: 6 query heads a KV head, granite's
   pool) and deepseek-moe-16b's pool (28 layers x 4096), f32
   and bf16, plus the split and tile edges of the attention kernels (lens 0,
   1, 16, split_tokens +- 1, MAXB*BS; holes in the block table; g in
   {1, 4, 6, 8}; hd in {32, 64, 128}; q_offset/prefix_pad across tiles;
   every paged attention case called twice, bitwise equal),
   (gather and scatter also on a pool laid out with its drop block),
   and flash prefill's non-causal mode at the whisper shapes (encoder
   b=2, s=sk=1500, 8/8 heads of 64; prefill cross-attention b=4, s=64,
   sk=1500: key ranges and a merge) and its edges (ragged sk, GQA,
   q_valid; the key split's: s in SPLIT_EDGE_S x sk in SPLIT_EDGE_SK x
   g 1, 4, 6 x hd 32, 64, 128, LSE held too, two calls bitwise equal), and
   the shapes of
   speculation and the legacy baselines (paged attention at a batch of 3
   or 5 active slots with lens past MAXB*BS; causal flash prefill at s =
   1, 65, 237, 302 without q_valid and at q_offset > 0 with prefix_pad
   0), every causal and window case also with q_offset as a device
   int32 (what a prefill graph captures), bit for bit the int form and
   timed beside it at the timed shapes (with a warm suffix's shape, s =
   512 after a 37-token prefix padded to 64),
   and flash prefill's window mode (``phase_kernels_window``: at the
   long-context layer shape b=1, s=10240, W=8192, 32/8 heads of 128, f32
   and bf16, against the plain version run over 1024-row query chunks,
   timed beside SDPA with the band as a boolean mask; then W in
   ``WINDOW_EDGES`` x q_offset/prefix_pad across tiles x q_valid x g 1,
   4, 6, 8 x hd 32, 64, 128, where W >= q_offset + s equals the causal
   mode bit for bit),
   with device times of the kernel, the plain version and one PyTorch
   library call (CUDA-graph replay); paged attention is timed cold in
   L2, one layer of a full-size pool per launch, as the decode step
   reads it; then the attention backward kernel against the plain
   FlashAttention-2 backward, fed the forward's LSE (held to the plain
   LSE), at the training shape (minicpm-2b: b=4, s=1024, 36/36 heads of
   64) and granite's (b=2, s=512, 32/8 of 128), both timed beside SDPA's
   backward, and at the kernel's tile edges (s in ``BWD_EDGE_S``), g in
   {1, 4, 6, 8}, hd in {32, 64, 128}, each case called twice and equal bit
   for bit (see ``phase_kernels_bwd``); then its non-causal mode (sk
   free) the same way, fed the forward's non-causal LSE, at the whisper
   encoder's shape (b=8, s=sk=1500, 8/8 heads of 64) and the decoder
   cross-attention's (b=8, s=448, sk=1500), both timed beside SDPA's
   unmasked backward, and at edges (s, sk) apart both ways and at the
   dQ pass's key split's edges x g {1, 4} x hd {32, 64, 128} (see
   ``phase_kernels_bwd``); then the
   grouped product of
   sorted MoE dispatch (lax.ragged_dot's counterpart), its transposed
   (input-gradient) instantiation and its weight-gradient kernel against
   the per-expert plain version at qwen2-moe's decode shapes (M = 32 of
   60 experts, gate/up and down: the rows path), a 2048-token prefill
   chunk's (the tiles path: wgmma in bf16) and phase 16's training
   step's (M = 16384, gate/up and down), and the forward alone at
   deepseek-moe-16b's serving shapes (top-6 of 64 experts: M = 48 at
   decode, 12288 in a 2048-token chunk), f32 and bf16, with empty
   groups, every call twice and bitwise equal, each timed in both dtypes
   beside its bound at the dtype's rate and, in bf16, torch._grouped_mm,
   each logged with its path (the weight gradient's from ``plan_dw``);
   then the paths' edges (``GROUPED_EDGES``: one expert holding every
   row, group bounds mid-tile, M on both sides of the rows/tiles
   threshold, rows off the 16-byte runs), the forward, TRANS and the
   weight gradient (empty experts' gradient exactly zero; an Inf in one
   group's dy non-finite only in that group's gradient) (see
   ``phase_kernels_grouped``); then the skinny product of the decode
   step (``phase_kernels_skinny``): every dense product of both cells'
   decode steps that takes it (``SKINNY_SHAPES``) at M = 1, 7, 26 and 32
   against a float64 product of the same f32 inputs, within
   SKINNY_FACTOR times torch.matmul's own error, two calls bitwise
   equal, a graph replay equal to an eager call; each timed at M = 32
   over copies of its weight that pass L2, beside its bytes bound, the
   plain version and torch.matmul, and summed over one decode step of
   each cell (``--skinny`` runs this alone, with each shape also timed
   at other grid sizes);
3. reduced paths: granite-3-8b, qwen2-moe, deepseek-moe, mamba2, jamba,
   whisper-base (with seeded stub frames), pixtral-12b, mistral-nemo-12b,
   pangu-38b, qwen1.5-110b (qkv bias) and minicpm-2b reduced, and
   pangu-38b at 12/2 heads (g = 6) and deepseek-moe-16b at top-6 of 8
   experts with 2 shared (capacity and sorted) reduced, 1P:1D
   ``MiniCluster`` on the card and on the CPU with the same params,
   equal tokens per request in both transfer modes, with warm prefix
   hits (snapshot restores for mamba2 and jamba); qwen2-moe, mamba2 and
   jamba also with speculation (a seeded draft_for draft, k=3) and eager
   decode, card against CPU; then all eleven families reduced (whisper
   with seeded frames, pixtral with seeded embeddings) trained for three
   AdamW steps on the card and on the CPU: equal losses within 1e-4
   relative, the backward kernel launched (whisper's also in its
   non-causal mode) (see ``phase_reduced_train``); then
   reduced qwen2-moe with sorted dispatch served card against CPU (equal
   tokens) and one training step's gradients card against CPU, through
   the grouped product's backward kernels (``phase_reduced_sorted``);
4. main path: full-width granite-3-8b (random f32 params from a seeded
   CUDA generator), 1P:1D, four requests of 200-480 prompt tokens and 16
   new tokens, overlapped and blocking transfer: equal tokens, and every
   kernel's launch counter grew during the run; one request's hand-off
   timed; a profiled run (``<out>/profile_main.txt``). On the card every
   fused and speculative decode step and every prefill forward (bucket,
   suffix, chunk) is a replayed CUDA graph (``serving/step_graph.py``),
   whose replays add their launches to the kernels' counters;
5. MoE path: full-width qwen2-moe-a2.7b the same way: equal tokens,
   every kernel launched, a profiled run (``<out>/profile_moe.txt``);
   then on the same params with dispatch="sorted" (launches under
   ``qwen2-moe-a2.7b/sorted``): served both ways through the frontend,
   its fused step's graph against eager bit for bit, and the expert
   weight bytes a step reads (see ``phase_sorted``);
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
   back to params + live pools + live graphs; (E, launches counted under
   ``granite-3-8b/control-absorb``) decode-side absorption with the node
   pool exhausted, twice: absorbed first tokens equal a monolithic
   prefill's, equal event logs; the cost of building a fresh decode
   node; (D and E) the card's memory after a run is the params, the live
   pools and the live engines' graphs (``graph_bytes``);
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
   profiled run (``<out>/profile_pixtral.txt``);
19. the paper's serving target (run after phase 9; launches under
   ``pangu-38b``): full-width pangu-38b (40 layers, d_model 6144, 48/8
   heads of 128, so 6 query heads a KV head; d_ff 16384, vocab 100352;
   62.7 GiB of f32 params) served as phase 9: phase 4's prompts 1P:1D,
   overlapped then blocking, equal tokens, every kernel launched, peak
   memory; a profiled run (``<out>/profile_pangu.txt``), the fused
   step's graph against eager bit for bit and a replayed prefill batch
   against eager (``prefill_vs_eager``);
20. fine-grained MoE (after phase 19; launches under
   ``deepseek-moe-16b`` and ``deepseek-moe-16b/sorted``): full-width
   deepseek-moe-16b (28 layers, d_model 2048, 16/16 heads of 128, 64
   routed experts top-6 and 2 shared of 1408; 62.9 GiB) the same way
   under capacity dispatch (``<out>/profile_deepseek.txt``), then on the
   same params with dispatch="sorted" as phase 5's (``phase_sorted``):
   48 rows of the grouped product a decode step, and the expert weight
   bytes a step reads beside every expert's (what capacity reads);
10. speculation and the legacy baselines (run right after phase 7, on
   phase 4's params; launches counted under ``granite-3-8b/spec``,
   ``/eager`` and ``/exact``): self-draft and ``draft_for`` speculation,
   eager decode and exact-length prefill, each 1P:1D over phase 4's
   prompts and a warm repeat: phase 4's tokens, every kernel launched,
   committed pool rows against phase 4's; then granite reduced under the
   staged tick shim: the tickless core's tokens (see ``phase_legacy``);
14. the step graphs (run right after phase 10, before phase 11, on phase
   4's params; launches counted under ``granite-3-8b/graphs``): the
   fused step, self-draft speculation (k=4) and ``draft_for``
   speculation, each on a DecodeEngine holding phase 4's four prompts in
   4 of 8 slots: the first step (eager, then the CUDA-graph capture), one
   replay against the same step run eagerly on clones of its inputs, bit
   for bit (tokens, positions, pool blocks, slot states, the draft's pool
   and state), graph and eager step medians, the capture wall and the
   graph pool's bytes, the device busy share of profiled steps both
   ways; then JAX's capture counts (a readmission in the same table
   bucket captures nothing, a 1100-token admission across the bucket
   exactly once, a step whose slots retire 3 and 5 tokens and a slot's
   churn nothing; see ``phase_graphs``). Phases 5, 6, 8 and 9 make the
   same measurement (``graph_vs_eager``) on their own params;
17. the prefill graphs (run right after phase 14, before phase 11, on
   phase 4's params; launches counted under ``granite-3-8b/prefill-graphs``):
   phase 4's four prompts run eagerly (a key's first forward), a second
   wave of new lengths in their buckets (256, 512) captures one graph per
   bucket and a third replays them with no new key, every wave bit for
   bit a ``jit_prefill=False`` engine's first tokens and KV; warm
   suffixes after prefixes of 96, 112 and 104 tokens make one key (run
   eagerly, captured, replayed) and equal the eager suffix prefill;
   graph against eager per bucket: batch wall medians, device ms and
   busy shares, capture wall, pool bytes and the bytes the graphs keep
   against their budget (see ``phase_prefill_graphs``). Every served
   phase prefills through ``PrefillEngine``'s default (a key's first
   forward eager, a graph from its second) and logs its prefill graph
   keys, captures and replays; phase 7 holds every engine's graphs to
   their budget; phases 5 (capacity and sorted), 6, 8 and 9 also hold a
   replayed batch of their prompts to the eager prefill bit for bit and
   time it both ways (``prefill_vs_eager``); phase 11 logs the eager
   prefill walls beside the replayed ones. ``--ab-serve CHECKOUT`` times
   a checkout's served first batches alone (``ab_serve``);
11. the simulator on the card's profile (run right after phase 10, on
   phase 4's params; launches counted under ``granite-3-8b/sim``): a
   ServingProfile fitted to the engines' prefill batch walls (b = 1, 2,
   4 prompts of 512 tokens) and fused decode step walls (1, 2, 4, 8
   slots, each request admitted through a blocking transfer; the replayed
   graph, with the same step run eagerly fitted beside it), printed
   beside ``profile_for``'s analytic H100 profile; eight requests served
   by the real ClusterFrontend against ClusterSim(1P:1D) on the fitted
   profile (TTFT p50, mean TPOT); then, on the host, the paper's
   comparisons on the fitted profile (on-demand against queue-status
   forwarding, block-free against block-fixed transfer, 8P:8D against
   16 aggregated instances, per-service groups against one mixed pool),
   twice with one seed: equal metrics dicts (see ``phase_sim``);
13. the long-context window (run after phase 20, before training;
   launches counted under ``granite-3-8b/window``): full-width
   granite-3-8b, f32, W = decode_window(long_500k) = 8192; the kernel
   library precompiled into an artifact store and the steps loaded from
   it; a windowed prefill of a seeded 8192-token prompt (its cache is
   the ring), 16 ring decode steps wrapping from the first (the first is
   the store's warm-up; two more are profiled,
   ``<out>/profile_window.txt``), one windowed prefill of prompt ++ the
   first 15 decoded tokens reproducing decoded tokens 15 and 8 through
   last_index, a 4096-token prompt equal with and without the window;
   then the planner (``launch/dryrun.py``) for long_500k on one card
   against ``memory_allocated`` (2%), granite's 16x16 plans for all four
   shapes (``<out>/plans_granite_16x16.json``), the rule table on a 1x1
   NCCL DeviceMesh, and the store loaded in a process with no nvcc on
   PATH (see ``phase_window``); the ring decode steps are one CUDA graph
   (``make_serve_step``), captured in the store's warm-up and replayed,
   the first replay against the eager step on clones of the ring bit for
   bit, eager steps timed and profiled beside the replays, a replay's
   host wall beside its synchronized wall, and a second sequence of the
   same shape admitted into the ring and the first admitted back, both
   equal to eager with no second capture;
15. the examples (run after phase 13, before training; launches under
   ``examples``): the port's six examples, each ``main(["--device",
   "cuda"])`` at its default size, exit 0 and its expected line (see
   ``phase_examples``);
12. training (after phase 15; launches counted under
   ``minicpm-2b/train``): full-width minicpm-2b (2.72 B f32 params,
   AdamW state in f32) trained for 10 steps on SyntheticLM batches of 4
   x 1024 tokens with remat, through the flash prefill forward and its
   backward kernel: finite losses and grad norms, the last loss below
   the first; step wall, tokens/s, flops and MFU against the f32 peak,
   peak memory and a profiled step (``<out>/profile_train.txt``); a
   checkpoint round trip on the card, bitwise (see ``phase_train``);
18. encoder-decoder training (after phase 12; launches counted under
   ``whisper-base/train``): full-width whisper-base (6 + 6 layers,
   d_model 512, 8/8 heads of 64, vocab 51865) trained as phase 12 on 8 x
   448 decoder tokens with 1500 seeded stub frames a row: the backward
   kernel launched once per attention sublayer a step, 12 of its 18 in
   the non-causal mode (encoder, cross-attention), counted exactly;
   finite losses, the last below the first; step wall, tokens/s, MFU
   (encoder and cross-attention terms in ``train_step_flops``), a
   profiled step (``<out>/profile_encdec_train.txt``), a checkpoint round
   trip, bitwise (see ``phase_encdec_train``);
16. sorted MoE training (run last; launches counted under
   ``qwen2-moe-a2.7b/sorted-train``): full-width qwen2-moe-a2.7b with
   dispatch="sorted", its depth cut to 4 of 24 layers (f32 AdamW state
   for 24 is 229 GB), trained as phase 12 (10 steps of 4 x 1024 tokens,
   remat): every grouped call has M = 16384 rows (the tiles path), so
   the grouped product, its input gradient and its weight gradient all
   launch (the weight gradient 12 times a step); finite losses, the last
   below the first, peak memory under the card's; step wall, tokens/s
   and a profiled step (``<out>/profile_sorted_train.txt``) with the
   weight gradient's device ms and share (see ``phase_sorted_train``).

Each serving path logs its prefill batch walls, decode step median,
launch counts and peak memory, beside the card's name and power limit;
a ``[time]`` line after each phase gives the script's wall so far.
Long reports go to ``--out`` (default ``build/chip_smoke``, gitignored):
the ptxas register/spill report of the build and the profile table.

The second-to-last line is ``{"kernels": [...]}`` (launches on the main
path, the training path for the backward kernel, phase 18's for its
non-causal mode (its own row, ``flash_prefill_bwd_noncausal``), phase
5's sorted path
for the grouped product and phase 16's for its two gradients, and on
each path, max |err| against the plain version, times and bounds, and
the MoE path's attention shapes and flash prefill's
non-causal shapes as "cases"); the last is
``{"ok": true, "device": {...}}``. TF32 is switched off for matmuls and
convolutions, so f32 stays f32 on the card.
"""
from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import weakref
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEFAULT_OUT = ROOT / "build" / "chip_smoke"

ARCH = "granite-3-8b"          # the dense main path
MOE_ARCH = "qwen2-moe-a2.7b"     # the MoE path
SSM_ARCH = "mamba2-2.7b"         # the SSM path
ENCDEC_ARCH = "whisper-base"     # the encoder-decoder path
VLM_ARCH = "pixtral-12b"         # the VLM backbone path
PANGU_ARCH = "pangu-38b"         # the paper's serving target (phase 19)
DEEPSEEK_ARCH = "deepseek-moe-16b"   # fine-grained MoE (phase 20)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# the attention backward against its plain version: over the largest
# entry of each gradient (a key's dk and dv sum over every later query
# row, in another order than the plain einsum)
BWD_TOL = 1e-4

TRAIN_ARCH = "minicpm-2b"        # the training path (phase 12)
TRAIN_PATH = f"{TRAIN_ARCH}/train"
# sorted MoE dispatch (the grouped product): full width (phase 5), and
# reduced served and trained card against CPU (phase 3)
SORTED_PATH = f"{MOE_ARCH}/sorted"
DEEPSEEK_SORTED_PATH = f"{DEEPSEEK_ARCH}/sorted"
SORTED_REDUCED_PATH = f"{MOE_ARCH}-reduced/sorted"
SORTED_TRAIN_PATH = f"{MOE_ARCH}-reduced/sorted-train"
# full-width sorted training (phase 16), cut to 4 of the 24 layers
SORTED_TRAIN_FULL_PATH = f"{MOE_ARCH}/sorted-train"
SORTED_TRAIN_LAYERS = 4
EXAMPLES_PATH = "examples"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 10
ENCDEC_TRAIN_PATH = f"{ENCDEC_ARCH}/train"    # phase 18
# whisper's decoder rows: its 448-token limit (launch/dryrun.py:58)
ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ = 8, 448


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
    """The least time at the card's published rates (launch/mesh.py)."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS
    t_b = nbytes / HBM_BW
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


# ------------------------------------------------------------ phase 2

def _paged_inputs(torch, randn, dev, dtype, nq, nkv, hd, lens_l, NB, BS,
                  maxb):
    """q, pages, a block table of distinct random blocks and lens for
    one paged-attention call (rows past their lens keep -1 entries; a row
    whose lens pass MAXB*BS fills its table)."""
    B = len(lens_l)
    bt = torch.full((B, maxb), -1, dtype=torch.int32)
    perm = torch.randperm(NB, generator=torch.Generator().manual_seed(1))
    cur = 0
    for b, ln in enumerate(lens_l):
        nbk = min(-(-ln // BS), maxb)
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


def _check_drop_block(torch, ref, gather, scatter, randn, gen, dtype, L, NB,
                      BS, W, n) -> None:
    """kv_gather and kv_scatter against their plain versions, bit for bit,
    on a pool as ``PagedKVPool`` lays it out: the view of NB blocks of an
    (L, NB + 1, BS, W) tensor, its layers NB + 1 blocks apart. Full and
    layer forms; the drop block (index NB) is never touched."""
    full = randn((L, NB + 1, BS, W), dtype)
    storage = full[:, :NB]
    drop = full[:, NB].clone()
    idx = torch.randperm(NB, generator=gen, device=gen.device)[:n].to(
        torch.int32)
    want = ref.kv_gather(storage, idx)
    assert torch.equal(gather(storage, idx), want), "gather, drop block"
    assert torch.equal(gather(storage, idx, layer=L - 1), want[L - 1]), \
        "layer gather, drop block"
    buf = randn((L, n * BS, W), dtype)
    want = ref.kv_scatter(storage.clone(), buf, idx)
    scatter(storage, buf, idx)
    assert torch.equal(storage, want), "scatter, drop block"
    row = randn((n * BS, W), dtype)
    scatter(storage, row, idx, layer=L - 1)
    want[L - 1:] = ref.kv_scatter(want[L - 1:].clone(), row[None], idx)
    assert torch.equal(storage, want), "layer scatter, drop block"
    assert torch.equal(full[:, NB], drop), "the drop block was written"


def _check_paged(torch, ref, kernel, q, pages, bt, lens, lens_l, dn):
    """The kernel against its plain version, and a second call bit for
    bit; rows with lens 0 exactly 0. Returns max |err|."""
    got = kernel(q, pages, bt, lens)
    assert torch.equal(got, kernel(q, pages, bt, lens)), \
        f"paged_attention {dn} nq={q.shape[1]}: two calls differ"
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


def _time_flash_prefix(torch, F, ref, kernel, qq, kk, vv, qo, pp, qvt):
    """A warm suffix's flash prefill (q_offset real rows of a prefix padded
    to pp): device times of the int form and the device-q_offset form
    (what a prefill graph replays), the plain version and SDPA with the
    same boolean mask; the bound counts the live pairs of the real
    rows."""
    b, s, nq, hd = qq.shape
    sk, nkv = kk.shape[1], kk.shape[2]
    qv = qvt.tolist()
    pairs = sum(v_ * qo + v_ * (v_ + 1) // 2 for v_ in qv)
    nbytes = (2 * qq.numel() + kk.numel() + vv.numel()) * 4
    b_ms, b_by = bound_ms(nbytes, 4 * pairs * nq * hd, "float32")
    kj = torch.arange(sk, device=qq.device)
    kpos = torch.where(kj < pp, kj, qo + kj - pp)
    live = ((kj >= pp) | (kj < qo))[None] \
        & (kpos[None] <= qo + torch.arange(s, device=qq.device)[:, None])
    mask = live[None, None] & (torch.arange(s, device=qq.device)[None]
                               < qvt[:, None])[:, None, :, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
    qo_dev = torch.tensor(qo, dtype=torch.int32, device=qq.device)
    return dict(
        ms=time_ms(lambda: kernel(qq, kk, vv, q_offset=qo, prefix_pad=pp,
                                  q_valid=qvt)),
        ms_device_q_offset=time_ms(lambda: kernel(
            qq, kk, vv, q_offset=qo_dev, prefix_pad=pp, q_valid=qvt)),
        plain_ms=time_ms(lambda: ref.flash_prefill(
            qq, kk, vv, q_offset=qo, prefix_pad=pp, q_valid=qvt)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"suffix b={b} s={s} q_offset={qo} prefix_pad={pp} nq={nq} "
              f"nkv={nkv} hd={hd} q_valid={qv} f32")


def _time_flash_noncausal(torch, F, ref, kernel, qq, kk, vv):
    """Device times of non-causal flash prefill (every key live), its
    plain version and SDPA without a mask, and the kernel's device time
    by launch (the range kernel and, with a key split, the merge). The
    work is every (query, key) pair. Two bounds, as the backward's rows:
    ``bound_ms`` at the rate of the instructions the kernel runs, 3xTF32
    (three TF32 tensor-core products per f32 product, at 495 TFLOP/s),
    and ``bound_f32_ms`` at the 67 TFLOP/s of f32 on the CUDA cores."""
    from repro_torch.kernels.flash_prefill import split_plan
    b, s, nq, hd = qq.shape
    sk, nkv = kk.shape[1], kk.shape[2]
    nbytes = (2 * qq.numel() + kk.numel() + vv.numel()) * 4
    flops = 4 * b * s * sk * nq * hd
    b_ms, b_by = bound_ms(nbytes, 3 * flops, "tf32")
    f32_ms, f32_by = bound_ms(nbytes, flops, "float32")
    qt, kt, vt = (x.transpose(1, 2) for x in (qq, kk, vv))
    plan = split_plan(b, s, sk, nq, hd, causal=False, window=None,
                      sms=torch.cuda.get_device_properties(0)
                      .multi_processor_count)
    log(f"[kernels] flash_prefill non-causal b={b} s={s} sk={sk} nq={nq} "
        f"nkv={nkv} hd={hd}: {plan.splits} key range(s) of "
        f"{plan.keys or sk} keys; device ms a call by launch (profiler) "
        + _by_launch(torch, lambda: kernel(qq, kk, vv, causal=False)))
    return dict(
        ms=time_ms(lambda: kernel(qq, kk, vv, causal=False)),
        plain_ms=time_ms(lambda: ref.flash_prefill(qq, kk, vv,
                                                   causal=False)),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by, bound_f32_ms=f32_ms,
        bound_f32_by=f32_by, splits=plan.splits,
        shape=f"non-causal b={b} s={s} sk={sk} nq={nq} nkv={nkv} hd={hd} "
              f"f32")


def _bwd_err(got, want) -> float:
    """max |err| over max(1, the plain tensor's largest entry)."""
    return (got - want).abs().max().item() / max(
        1.0, want.abs().max().item())


def _time_flash_bwd(torch, F, ref, kernel, q, k, v, o, lse, do, want,
                    causal: bool = True):
    """Device times of the backward kernel (``kernel(q, k, v, o, lse,
    do)``, the mode bound in), its plain version and SDPA's backward
    through autograd (SDPA forward + autograd backward, less the SDPA
    forward, both replayed the same way; causal, or with no mask);
    SDPA's gradients' error against the plain ones ``want`` (the
    yardstick of the kernel's error), and the kernel's device time by
    launch (torch.profiler over three calls). The work is 2.5x the
    forward's flops on the live pairs (FlashAttention-2's count of the
    five products; causal s (s + 1) / 2, non-causal s x sk), every input
    read once and every gradient written once. Two bounds: ``bound_ms``
    at the rate of the instructions the kernel runs, 3xTF32 (three TF32
    tensor-core products per f32 product, at 495 TFLOP/s), and
    ``bound_f32_ms`` at the 67 TFLOP/s of f32 on the CUDA cores."""
    b, s, nq, hd = q.shape
    sk, nkv = k.shape[1], k.shape[2]
    pairs = b * s * (s + 1) // 2 if causal else b * s * sk
    nbytes = (4 * q.numel() + 4 * k.numel() + lse.numel()) * 4
    flops = 2.5 * 4 * pairs * nq * hd
    b_ms, b_by = bound_ms(nbytes, 3 * flops, "tf32")
    f32_ms, f32_by = bound_ms(nbytes, flops, "float32")
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              enable_gqa=nq != nkv)
    fwd_ms = time_ms(lambda: sdpa().detach())
    both_ms = time_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                  dot))
    sdpa_err = [_bwd_err(a.transpose(1, 2), w) for a, w in zip(
        torch.autograd.grad(sdpa(), (qt, kt, vt), dot), want)]
    mode = "causal" if causal else f"non-causal sk={sk}"
    log(f"[kernels] SDPA {mode} b={b} s={s} nq={nq} nkv={nkv} hd={hd}: "
        f"forward "
        f"{fwd_ms:.4f} ms, forward + backward {both_ms:.4f} ms; its "
        f"gradients over the largest entry dq {sdpa_err[0]:.2e} dk "
        f"{sdpa_err[1]:.2e} dv {sdpa_err[2]:.2e}")
    log(f"[kernels] flash_prefill_bwd {mode} b={b} s={s} nq={nq} "
        f"nkv={nkv} hd={hd}: device ms a call by launch (profiler) "
        + _by_launch(torch, lambda: kernel(q, k, v, o, lse, do)))
    return dict(
        ms=time_ms(lambda: kernel(q, k, v, o, lse, do)),
        plain_ms=time_ms(lambda: ref.flash_prefill_bwd(q, k, v, o, lse,
                                                       do, causal=causal)),
        library_ms=both_ms - fwd_ms, bound_ms=b_ms, bound_by=b_by,
        bound_f32_ms=f32_ms, bound_f32_by=f32_by,
        shape=f"{mode} b={b} s={s} nq={nq} nkv={nkv} hd={hd} f32")


# the backward kernel's tile edges: one under, at and one over its
# streamed (32, 64 rows) and resident (64, 128 rows) tiles and twice them
BWD_EDGE_S = (1, 31, 63, 64, 65, 127, 128, 129, 237, 257)
# the non-causal mode's timed shapes, whisper-base training (phase 18):
# the encoder's self-attention and the decoder's cross-attention (b, s, sk)
ENC_BWD = (ENCDEC_TRAIN_BATCH, 1500, 1500)
CROSS_BWD = (ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ, 1500)
# its edges: s and sk apart both ways, every BWD_EDGE_S value as each
BWD_EDGE_SK = tuple(zip(BWD_EDGE_S, reversed(BWD_EDGE_S)))
# the key split of the non-causal mode (forward, and the backward's dQ
# pass): sk one under, at and one over a key tile, one key, whisper's
# 1500 frames and 4097 (a last range of one key); s across a query tile
# and at whisper's 448 decoder rows
SPLIT_EDGE_SK = (1, 31, 32, 33, 1500, 4097)
SPLIT_EDGE_S = (1, 64, 65, 448)


def phase_kernels_bwd(torch, results: dict) -> None:
    """The backward kernel against the plain FlashAttention-2 backward on
    the card, in each mode fed the forward kernel's LSE in that mode
    (itself held to the plain LSE, and the forward's output with the LSE
    bit for bit its output without). Causal (row ``flash_prefill_bwd``):
    at the training shape (minicpm-2b, b=4, s=1024, 36/36 heads of 64;
    timed), granite's GQA shape (b=2, s=512, 32/8 of 128; timed), a
    multi-tile GQA case (b=2, s=300, 16/4 of 64: five key tiles, four
    head partials summed) and the edges s in BWD_EDGE_S x g in {1, 4, 6,
    8} x hd in {32, 64, 128}. Non-causal, sk free (row NONCAUSAL_BWD): at
    the whisper encoder's shape (ENC_BWD, 8/8 heads of 64; timed) and
    cross-attention's (CROSS_BWD; timed, its dQ pass split over key
    ranges), and the edges (s, sk) in BWD_EDGE_SK and in SPLIT_EDGE_S x
    SPLIT_EDGE_SK (the key split's boundaries) x g in {1, 4} x hd in {32,
    64, 128}. Every timed case
    beside SDPA's f32 backward (causal, or with no mask). dq, dk and dv
    within BWD_TOL of each plain tensor's largest entry, and a second
    call equal bit for bit (no atomics: a fixed order of every sum)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda

    tcfg, gcfg = get_config(TRAIN_ARCH), get_config(ARCH)
    wcfg = get_config(ENCDEC_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(3)
    whisper = (wcfg.num_heads, wcfg.num_kv_heads, wcfg.hd)
    modes = [  # (causal, row, its main timed case, cases (b, s, sk, nq,
        #     nkv, hd, "timed" | "shown" | "edge"))
        (True, "flash_prefill_bwd", (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ), [
            (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, tcfg.num_heads,
             tcfg.num_kv_heads, tcfg.hd, "timed"),
            (2, 512, 512, gcfg.num_heads, gcfg.num_kv_heads, gcfg.hd,
             "timed"),
            (2, 300, 300, 16, 4, 64, "shown"),
        ] + [(2, s, s, 2 * g, 2, hd, "edge") for g in (1, 4, 6, 8)
             for hd in (32, 64, 128) for s in BWD_EDGE_S]),
        (False, NONCAUSAL_BWD, ENC_BWD, [
            ENC_BWD + whisper + ("timed",), CROSS_BWD + whisper + ("timed",),
        ] + [(2, s, sk, 2 * g, 2, hd, "edge") for g in (1, 4)
             for hd in (32, 64, 128)
             for s, sk in BWD_EDGE_SK + tuple(itertools.product(
                 SPLIT_EDGE_S, SPLIT_EDGE_SK))]),
    ]
    for causal, row, main_case, cases in modes:
        e = results.setdefault(row, {"max_abs_err": 0.0})
        kernel = functools.partial(flash_prefill_bwd_cuda, causal=causal)
        mode = "" if causal else " non-causal"
        edge_err: dict = {}
        for b, s, sk, nq, nkv, hd, kind in cases:
            q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                           for shape in ((b, s, nq, hd), (b, sk, nkv, hd),
                                         (b, sk, nkv, hd), (b, s, nq, hd)))
            o, lse = flash_prefill_cuda(q, k, v, causal=causal,
                                        return_lse=True)
            assert torch.equal(o, flash_prefill_cuda(q, k, v,
                                                     causal=causal)), \
                f"the LSE output changed the{mode} forward's output"
            ro, rlse = ref.flash_prefill_fwd(q, k, v, causal=causal)
            lse_err = (lse - rlse).abs().max().item()
            o_err = (o - ro).abs().max().item()
            assert lse_err <= TOL["float32"] and o_err <= TOL["float32"], \
                f"{mode} flash_prefill LSE {lse_err} / output {o_err} at " \
                f"s={s} sk={sk}"
            where = f"flash_prefill_bwd{mode} b={b} s={s}" \
                + ("" if causal else f" sk={sk}") \
                + f" nq={nq} nkv={nkv} hd={hd}"
            got = kernel(q, k, v, o, lse, do)
            again = kernel(q, k, v, o, lse, do)
            assert all(torch.equal(a, x) for a, x in zip(got, again)), \
                f"{where}: two calls differ"
            want = ref.flash_prefill_bwd(q, k, v, o, lse, do, causal=causal)
            errs = [_bwd_err(a, w) for a, w in zip(got, want)]
            assert max(errs) <= BWD_TOL, \
                f"{where}: relative max|err| dq, dk, dv {errs}"
            abs_err = max((a - w).abs().max().item()
                          for a, w in zip(got, want))
            e["max_abs_err"] = max(e["max_abs_err"], abs_err)
            if kind == "edge":
                key = (nq // nkv, hd)
                edge_err[key] = max(edge_err.get(key, (0.0, 0, 0)),
                                    (max(errs), s, sk))
            else:
                log(f"[kernels] {where} f32: max|err| {abs_err:.3e}; over "
                    f"the largest entry dq {errs[0]:.2e} dk {errs[1]:.2e} "
                    f"dv {errs[2]:.2e} (tol {BWD_TOL}); LSE max|err| "
                    f"{lse_err:.3e}; two calls bitwise equal")
            if kind == "timed":
                tm = _time_flash_bwd(torch, F, ref, kernel, q, k, v, o, lse,
                                     do, want, causal=causal)
                if (b, s, sk) == main_case:
                    e.update(tm)
                else:
                    e.setdefault("cases", []).append(
                        dict(tm, max_abs_err=abs_err))
            del q, k, v, do, o, lse, got, again, want
        edges = BWD_EDGE_S if causal else \
            f"{BWD_EDGE_SK} and {SPLIT_EDGE_S} x {SPLIT_EDGE_SK}"
        log(f"[kernels] flash_prefill_bwd{mode} edges "
            f"{'s' if causal else '(s, sk)'} in {edges}, b=2, nkv=2: "
            f"largest relative max|err| by (g, hd) "
            + ", ".join(f"{k}: {x:.2e} at s={s}"
                        + ("" if causal else f" sk={sk}")
                        for k, (x, s, sk) in sorted(edge_err.items()))
            + f" (tol {BWD_TOL}); every case two calls bitwise equal")
        torch.cuda.empty_cache()


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
    # pangu-38b's (48/8 of 128: 6 query heads a KV head, 40 layers; its
    # pool is granite's, 40 x 2048) and deepseek-moe-16b's pool (28 layers
    # of 16/16 of 128: qwen2-moe's attention shape, deeper)
    pcfg, dcfg = get_config(PANGU_ARCH), get_config(DEEPSEEK_ARCH)
    G6 = (pcfg.num_heads, pcfg.num_kv_heads, pcfg.hd)
    assert (pcfg.num_layers, 2 * pcfg.kv_dim) == (L, W)
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
        for pL, pW in ((L, W), (mha_layers, 2 * MHA[1] * MHA[2]),
                       (dcfg.num_layers, 2 * dcfg.kv_dim)):
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
        _check_drop_block(torch, ref, kv_gather_cuda, kv_scatter_cuda, randn,
                          gen, dtype, L, NB, BS, W, n)
        log(f"[kernels] kv_gather/kv_scatter {dn} on a pool with its drop "
            f"block (L={L}, NB={NB} + 1): bit-exact, layer forms exact, the "
            f"drop block untouched")
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
        # past NB; g in {1, 4, 6, 8} (6: pangu-38b, 2 of a CTA's 8 head
        # slots idle); hd in {32, 64, 128}
        split = split_plan(B, nq, nkv, hd, maxb, BS).split_tokens
        edge = [0, 1, 16, split - 1, split, split + 1, maxb * BS, 250]
        for enq, enkv, ehd in ((32, 8, 128), (8, 8, 128), (64, 8, 128),
                               (32, 4, 64), (8, 8, 64), (16, 16, 128),
                               G6, (12, 2, 64), (6, 1, 32)):
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
        # the shapes speculation and the eager step give it: a batch of
        # the active slots only (3 and 5, not 8) and lens past MAXB*BS
        # (micro-steps beyond a slot's capacity), which must equal the
        # same rows cut at MAXB*BS
        for eb, (enq, enkv, ehd) in ((3, (nq, nkv, hd)), (5, MHA)):
            el_l = [maxb * BS + 4, maxb * BS + 1, 333, maxb * BS, 17][:eb]
            eq, ep, ebt, el = _paged_inputs(torch, randn, dev, dtype, enq,
                                            enkv, ehd, el_l, NB, BS, maxb)
            eerr = _check_paged(torch, ref, paged_attention_cuda, eq, ep,
                                ebt, el, el_l, dn)
            got = paged_attention_cuda(eq, ep, ebt, el)
            cut = paged_attention_cuda(eq, ep, ebt, el.clamp_max(maxb * BS))
            cerr = (got.float() - cut.float()).abs().max().item()
            assert cerr <= TOL[dn], f"lens past MAXB*BS differ by {cerr}"
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], eerr)
            log(f"[kernels] paged_attention {dn} B={eb} nq={enq} nkv={enkv} "
                f"hd={ehd} lens={el_l} (MAXB*BS={maxb * BS}): max|err| "
                f"{eerr:.3e}; against lens cut at MAXB*BS {cerr:.3e}")
        # qwen2-moe's attention: nq = nkv = 16 (group 1), hd 128; and
        # pangu-38b's: 48/8 (group 6)
        mq, mp, mbt, ml = _paged_inputs(torch, randn, dev, dtype, MHA[0],
                                        MHA[1], MHA[2], lens_l, NB, BS,
                                        maxb)
        merr = _check_paged(torch, ref, paged_attention_cuda, mq, mp, mbt,
                            ml, lens_l, dn)
        log(f"[kernels] paged_attention {dn} nq=nkv={MHA[0]} hd={MHA[2]} "
            f"lens={lens_l}: max|err| {merr:.3e}")
        gq, gp, gbt, gl = _paged_inputs(torch, randn, dev, dtype, *G6,
                                        lens_l, NB, BS, maxb)
        gerr = _check_paged(torch, ref, paged_attention_cuda, gq, gp, gbt,
                            gl, lens_l, dn)
        log(f"[kernels] paged_attention {dn} nq={G6[0]} nkv={G6[1]} "
            f"hd={G6[2]} lens={lens_l}: max|err| {gerr:.3e}; two calls "
            f"bitwise equal")
        if dtype == torch.float32:
            e["max_abs_err"] = max(e["max_abs_err"], merr, gerr)
            e.update(_time_paged(torch, ref, paged_attention_cuda, randn,
                                 q, bt, lens, lens_l, L, NB, BS, nkv, hd,
                                 maxb))
            e.setdefault("cases", []).append(dict(_time_paged(
                torch, ref, paged_attention_cuda, randn, mq, mbt, ml,
                lens_l, mha_layers, NB, BS, MHA[1], MHA[2], maxb),
                max_abs_err=merr))
            e["cases"].append(dict(_time_paged(
                torch, ref, paged_attention_cuda, randn, gq, gbt, gl,
                lens_l, pcfg.num_layers, NB, BS, G6[1], G6[2], maxb),
                max_abs_err=gerr))
            for c in [e] + e["cases"]:
                log(f"[kernels] paged_attention f32 {c['shape']}: cold L2 "
                    f"{c['ms']:.4f} ms, hot L2 (one page tensor re-read) "
                    f"{c['ms_hot']:.4f} ms")
        del mq, mp, gq, gp

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
            # exact-length prefill: s not a whole tile and no q_valid,
            # and a warm suffix at q_offset > 0 with prefix_pad 0
            (1, 1, nq, nkv, hd, 0, 0, None),
            (1, 65, nq, nkv, hd, 0, 0, None),
            (1, 237, nq, nkv, hd, 0, 0, None),
            (1, 302, nq, nkv, hd, 0, 0, None),
            (1, 302, *MHA, 0, 0, None),
            (1, 13, nq, nkv, hd, 224, 0, None),
            (1, 237, nq, nkv, hd, 65, 0, None),
            # pangu-38b: 48/8 of 128 (g = 6), buckets 256 and 512, a warm
            # suffix after a padded prefix, an exact-length suffix
            (2, 256, *G6, 0, 0, [256, 200]),
            (2, 512, *G6, 0, 0, [480, 300]),             # timed
            (1, 512, *G6, 37, 64, [500]),                # timed
            (1, 237, *G6, 65, 0, None),
            (2, 90, 12, 2, 64, 45, 70, [90, 61]),        # g = 6, hd 64
            (1, 40, 6, 1, 32, 0, 0, [40]),               # g = 6, hd 32
        ]
        for b, s, fnq, fnkv, fhd, qo, pp, qv in cases:
            sk = (pp or qo) + s
            qq = randn((b, s, fnq, fhd), dtype)
            kk = randn((b, sk, fnkv, fhd), dtype)
            vv = randn((b, sk, fnkv, fhd), dtype)
            qvt = None if qv is None else torch.tensor(
                qv, dtype=torch.int32, device=dev)
            got = flash_prefill_cuda(qq, kk, vv, q_offset=qo, prefix_pad=pp,
                                     q_valid=qvt)
            want = ref.flash_prefill(qq, kk, vv, q_offset=qo, prefix_pad=pp,
                                     q_valid=qvt)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= TOL[dn], \
                f"flash_prefill {dn} s={s} max|err| {err}"
            # the prefix length as a device int32 (what a prefill graph
            # captures): bit for bit the int form
            qo_dev = torch.tensor(qo, dtype=torch.int32, device=dev)
            assert torch.equal(flash_prefill_cuda(
                qq, kk, vv, q_offset=qo_dev, prefix_pad=pp, q_valid=qvt),
                got), f"flash_prefill {dn} s={s}: device q_offset != int"
            for bi, v_ in enumerate(qv or []):
                assert torch.count_nonzero(got[bi, v_:]) == 0, \
                    "padded query rows not zero"
            e = entry("flash_prefill")
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], err)
            log(f"[kernels] flash_prefill {dn} b={b} s={s} nq={fnq} "
                f"nkv={fnkv} hd={fhd} q_offset={qo} prefix_pad={pp} "
                f"q_valid={qv}: max|err| {err:.3e} (tol {TOL[dn]}), padded "
                f"rows exactly 0; q_offset on the card bitwise the int")
            if dtype == torch.float32 and (b, s, qo) == (1, 512, 37):
                e.setdefault("cases", []).append(dict(_time_flash_prefix(
                    torch, F, ref, flash_prefill_cuda, qq, kk, vv, qo, pp,
                    qvt), max_abs_err=err))
            if dtype == torch.float32 and (b, s, qo) == (2, 512, 0):
                t = _time_flash(torch, F, ref, flash_prefill_cuda, qq, kk,
                                vv, qvt)
                t["ms_device_q_offset"] = time_ms(lambda: flash_prefill_cuda(
                    qq, kk, vv, q_offset=qo_dev, q_valid=qvt))
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
        _flash_split_edges(torch, ref, flash_prefill_cuda, randn, dtype,
                           entry("flash_prefill"))
        del pages, q, qq, kk, vv
    torch.cuda.empty_cache()


def _flash_split_edges(torch, ref, kernel, randn, dtype, e) -> None:
    """Non-causal flash prefill at the key split's boundaries: s in
    SPLIT_EDGE_S x sk in SPLIT_EDGE_SK x g in {1, 4, 6} x hd in {32, 64,
    128}, b = 2 with q_valid [0, s - 1] (an empty row, and one padded
    query row when s > 1), against the plain version within TOL (f32
    also the LSE); rows past q_valid exactly 0 with LSE +inf, two calls
    equal bit for bit."""
    from repro_torch.kernels.flash_prefill import split_plan
    dn = str(dtype).split(".")[1]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst, splits = (0.0, 0, 0, 0, 0), set()
    for s, sk, g, hd in itertools.product(SPLIT_EDGE_S, SPLIT_EDGE_SK,
                                          (1, 4, 6), (32, 64, 128)):
        qq = randn((2, s, 2 * g, hd), dtype)
        kk, vv = randn((2, sk, 2, hd), dtype), randn((2, sk, 2, hd), dtype)
        qvl = [0, max(1, s - 1)]
        qvt = torch.tensor(qvl, dtype=torch.int32, device="cuda")
        got, lse = kernel(qq, kk, vv, q_valid=qvt, causal=False,
                          return_lse=True)
        again, lse2 = kernel(qq, kk, vv, q_valid=qvt, causal=False,
                             return_lse=True)
        where = f"flash_prefill non-causal {dn} s={s} sk={sk} g={g} hd={hd}"
        assert torch.equal(got, again) and torch.equal(lse, lse2), \
            f"{where}: two calls differ"
        want = ref.flash_prefill(qq, kk, vv, q_valid=qvt, causal=False)
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            _, rlse = ref.flash_prefill_fwd(qq, kk, vv, causal=False)
            err = max(err, (lse[1, :, :qvl[1]]
                            - rlse[1, :, :qvl[1]]).abs().max().item())
            e["max_abs_err"] = max(e["max_abs_err"], err)
        assert err <= TOL[dn], f"{where}: max|err| {err} (output, LSE)"
        assert torch.count_nonzero(got[0]) == 0 \
            and torch.count_nonzero(got[1, qvl[1]:]) == 0, \
            f"{where}: padded query rows not zero"
        assert bool(torch.isinf(lse[0]).all()) \
            and bool(torch.isinf(lse[1, :, qvl[1]:]).all()), \
            f"{where}: padded query rows' LSE not +inf"
        worst = max(worst, (err, s, sk, g, hd))
        splits.add(split_plan(2, s, sk, 2 * g, hd, causal=False, window=None,
                              sms=sms).splits)
    log(f"[kernels] flash_prefill non-causal {dn} split edges s in "
        f"{SPLIT_EDGE_S} x sk in {SPLIT_EDGE_SK} x g 1, 4, 6 x hd 32, 64, "
        f"128 "
        f"(q_valid [0, s - 1]; {sorted(splits)} key ranges): worst max|err| "
        f"{worst[0]:.3e} at s={worst[1]} sk={worst[2]} g={worst[3]} "
        f"hd={worst[4]} (tol {TOL[dn]}); padded rows 0, LSE +inf; every "
        f"case two calls bitwise equal")


# ------------------------------------------------------ grouped product

GROUPED = ("grouped_mm", "grouped_mm_dx", "grouped_mm_dw")
GROUPED_DECODE_T = 8     # tokens of a decode step: 8 slots
GROUPED_PREFILL_T = 2048  # tokens of a prefill chunk: 4 prompts x 512


def _routing(torch, rng, T, k, E):
    """Group offsets (E+1,) int32 on the card of T tokens routed to k
    distinct experts each, seeded; the experts none picks stay empty.
    Returns (offsets, touched experts)."""
    import numpy as np
    ids = np.stack([rng.choice(E, k, replace=False) for _ in range(T)])
    sizes = np.bincount(ids.reshape(-1), minlength=E)
    off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    return torch.from_numpy(off).cuda(), int((sizes > 0).sum())


def _library_grouped(torch, kind, x, w, dy, offsets):
    """One PyTorch call computing the same function, where this torch
    has one: ``torch._grouped_mm`` (device offsets, bf16 on sm90), or
    None with the reason."""
    if x.dtype != torch.bfloat16:
        return None, "none in f32"
    if not hasattr(torch, "_grouped_mm"):
        return None, "torch has no _grouped_mm"
    ends = offsets[1:].contiguous()
    if kind == "grouped_mm":
        fn = lambda: torch._grouped_mm(x, w, offs=ends)   # noqa: E731
    elif kind == "grouped_mm_dx":
        wt = w.transpose(-2, -1)
        fn = lambda: torch._grouped_mm(dy, wt, offs=ends)  # noqa: E731
    else:
        xt = x.t()
        fn = lambda: torch._grouped_mm(xt, dy, offs=ends)  # noqa: E731
    return fn, "torch._grouped_mm"


# the grouped product's edges (as in tests/test_torch_cuda.py): (label, E,
# group sizes: {expert: rows}, a list, or None for a seeded split that
# leaves the last two experts empty, M, K, N); M below 16E takes the rows
# path, M at 16E and above the tiles path
GROUPED_EDGES = (
    ("every row to one expert, rows path", 60, {13: 37}, 37, 256, 192),
    ("every row to one expert, tiles path", 4, {2: 300}, 300, 200, 136),
    ("bounds mid-tile, rows past the last group", 4, [0, 70, 3, 127], 210,
     200, 136),
    ("M = 16E - 1, rows path", 8, None, 127, 256, 192),
    ("M = 16E, tiles path", 8, None, 128, 256, 192),
    ("rows off 16 bytes in bf16, rows path", 6, None, 50, 100, 36),
    ("rows off 16 bytes in bf16, tiles path", 6, None, 200, 100, 36),
)


def _edge_sizes(rng, E, sizes, M):
    """The group sizes of one GROUPED_EDGES case."""
    import numpy as np
    if sizes is None:
        return np.bincount(rng.integers(0, E - 2, M), minlength=E)
    if isinstance(sizes, dict):
        out = np.zeros(E, np.int64)
        for e, n in sizes.items():
            out[e] = n
        return out
    return np.asarray(sizes)


def _grouped_edges(torch, ref, gen, rng) -> None:
    """Forward, TRANS and the weight gradient, f32 and bf16, at each
    GROUPED_EDGES case: within TOL of the plain version's largest entry,
    two calls bitwise equal, rows outside every group (the weight
    gradient: every empty expert's) exactly zero; the weight gradient
    again with an Inf in each group's first dy row, non-finite exactly
    where the plain version is."""
    import numpy as np
    from repro_torch.kernels.grouped_mm import (grouped_mm_cuda,
                                                grouped_mm_dw_cuda, plan,
                                                plan_dw)
    for label, E, sizes, M, K, N in GROUPED_EDGES:
        sz = _edge_sizes(rng, E, sizes, M)
        offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sz)])
                                   .astype(np.int32)).cuda()
        past = int(sz.sum())
        errs = []
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            for trans in (False, True):
                x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
                w = (torch.randn((E, N, K) if trans else (E, K, N),
                                 generator=gen, device="cuda")
                     / K ** 0.5).to(dtype)
                got = grouped_mm_cuda(x, w, offsets, trans=trans)
                again = grouped_mm_cuda(x, w, offsets, trans=trans)
                want = ref.grouped_mm(x, w, offsets, trans=trans)
                torch.cuda.synchronize()
                assert torch.equal(got, again), \
                    f"grouped {label} {dn} trans={trans}: two calls differ"
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1e-30, want.float().abs().max().item())
                assert err <= TOL[dn] * scale, \
                    f"grouped {label} {dn} trans={trans} max|err| {err}"
                assert int(torch.count_nonzero(got[past:])) == 0, \
                    f"grouped {label}: rows past the last group not zero"
                errs.append(f"{dn}{' trans' if trans else ''} "
                            f"{err / scale:.2e}")
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            dy = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
            got = grouped_mm_dw_cuda(x, dy, offsets, E)
            again = grouped_mm_dw_cuda(x, dy, offsets, E)
            want = ref.grouped_mm_dw(x, dy, offsets, E)
            torch.cuda.synchronize()
            assert torch.equal(got, again), \
                f"grouped {label} {dn} dw: two calls differ"
            err = (got.float() - want.float()).abs().max().item()
            scale = max(1e-30, want.float().abs().max().item())
            assert err <= TOL[dn] * scale, \
                f"grouped {label} {dn} dw max|err| {err}"
            assert int(torch.count_nonzero(got[torch.from_numpy(
                sz == 0).cuda()])) == 0, \
                f"grouped {label}: an empty expert's dw not zero"
            errs.append(f"{dn} dw {err / scale:.2e}")
            # an Inf in the first dy row of every group but the first (in
            # column e % N for expert e) stays in its own group's sum
            for e in np.flatnonzero(sz)[1:]:
                dy[int(sz[:e].sum()), int(e) % N] = float("inf")
            got = grouped_mm_dw_cuda(x, dy, offsets, E)
            want = ref.grouped_mm_dw(x, dy, offsets, E)
            fin = torch.isfinite(want)
            assert torch.equal(torch.isfinite(got), fin), \
                f"grouped {label} {dn} dw: an Inf left its group"
            err = (got.float() - want.float()).masked_fill(~fin, 0) \
                .abs().max().item()
            assert err <= TOL[dn] * scale, \
                f"grouped {label} {dn} dw with Inf max|err| {err}"
        path = ("rows", "tiles")[plan(M, K, N, E, torch.float32,
                                      False).path]
        dw_path = ("rows", "tiles")[plan_dw(M, K, N, E, torch.float32).path]
        log(f"[kernels] grouped edge: {label} (E={E}, M={M}, K={K}, N={N}, "
            f"{path} path, dw {dw_path} path): max|err| / max|want| "
            f"{', '.join(errs)}; two calls bitwise equal; rows past the "
            f"groups and empty experts' dw zero; an Inf in a group's dy "
            f"non-finite only where the plain version's is")


def phase_kernels_grouped(torch, results: dict) -> None:
    """Phase 2, the grouped product of sorted MoE dispatch (lax.ragged_
    dot's counterpart) and its two backward kernels against the plain
    version (the per-expert loop) at qwen2-moe's shapes: a decode step
    (8 tokens x top-4 of 60 experts: M = 32, d_model 2048, d_ff 1408; the
    gate/up product K = 2048, N = 1408, and the down product K = 1408, N
    = 2048: the rows path) and a prefill chunk as moe_ffn calls it (2048
    tokens, M = 8192: the tiles path), and phase 16's training step (4 x
    1024 tokens, M = 16384: every shape phase 16 launches); the forward
    also at deepseek-moe-16b's (top-6 of 64 experts: M = 48 at decode,
    12288 in a prefill chunk, gate/up and down), seeded
    routings that leave experts empty; f32 and bf16, within TOL of the
    largest entry (the weight gradient sums over a group's rows), every
    call twice and bitwise equal; then the edges (``GROUPED_EDGES``).
    Every row timed, f32 and
    bf16 (CUDA-graph replay; the plain version between CUDA events, as it
    reads the offsets on the host) beside the bound: the touched experts'
    weights (the weight gradient: every expert's gradient written) plus
    the activations over 3.35 TB/s, against 2MKN flops at the dtype's
    rate (67 TFLOP/s f32 on the CUDA cores, 989 bf16 on the tensor
    cores); and beside torch._grouped_mm in bf16."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.grouped_mm import (grouped_mm_cuda,
                                                grouped_mm_dw_cuda, plan,
                                                plan_dw)
    m = get_config(MOE_ARCH)
    E, k, d, ff = m.moe.num_experts, m.moe.top_k, m.d_model, \
        m.moe.d_ff_expert
    ds = get_config(DEEPSEEK_ARCH)
    dE, dk, dd, dff = ds.moe.num_experts, ds.moe.top_k, ds.d_model, \
        ds.moe.d_ff_expert
    gen = torch.Generator(device="cuda").manual_seed(3)
    rng = np.random.default_rng(3)
    shapes = [("decode gate/up", GROUPED_DECODE_T, d, ff, GROUPED, E, k),
              ("decode down", GROUPED_DECODE_T, ff, d, GROUPED, E, k),
              ("prefill chunk gate/up", GROUPED_PREFILL_T, d, ff, GROUPED,
               E, k),
              ("training step gate/up", TRAIN_BATCH * TRAIN_SEQ, d, ff,
               GROUPED, E, k),
              ("training step down", TRAIN_BATCH * TRAIN_SEQ, ff, d,
               GROUPED, E, k)]
    # deepseek-moe-16b's serving shapes (top-6 of 64: M = 48 at decode,
    # 12288 in a prefill chunk): the forward alone runs there
    shapes += [(f"deepseek {label}", T, K, N, ("grouped_mm",), dE, dk)
               for label, T, K, N in (
                   ("decode gate/up", GROUPED_DECODE_T, dd, dff),
                   ("decode down", GROUPED_DECODE_T, dff, dd),
                   ("prefill chunk gate/up", GROUPED_PREFILL_T, dd, dff),
                   ("prefill chunk down", GROUPED_PREFILL_T, dff, dd))]
    for name in GROUPED:
        results.setdefault(name, {"max_abs_err": 0.0})
    for label, T, K, N, kinds, E, k in shapes:
        offsets, touched = _routing(torch, rng, T, k, E)
        M = T * k
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[1]
            x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
            w = (torch.randn((E, K, N), generator=gen, device="cuda")
                 / K ** 0.5).to(dtype)
            dy = torch.randn((M, N), generator=gen, device="cuda").to(dtype)
            calls = {
                "grouped_mm": (lambda: grouped_mm_cuda(x, w, offsets),
                               lambda: ref.grouped_mm(x, w, offsets)),
                "grouped_mm_dx": (
                    lambda: grouped_mm_cuda(dy, w, offsets, trans=True),
                    lambda: ref.grouped_mm(dy, w, offsets, trans=True)),
                "grouped_mm_dw": (
                    lambda: grouped_mm_dw_cuda(x, dy, offsets, E),
                    lambda: ref.grouped_mm_dw(x, dy, offsets, E))}
            es = x.element_size()
            w_bytes = touched * K * N * es
            nbytes = {"grouped_mm": w_bytes + (M * K + M * N) * es,
                      "grouped_mm_dx": w_bytes + (M * N + M * K) * es,
                      "grouped_mm_dw": (M * K + M * N + E * K * N) * es}
            paths = {"grouped_mm": plan(M, K, N, E, dtype, False).path,
                     "grouped_mm_dx": plan(M, N, K, E, dtype, True).path,
                     "grouped_mm_dw": plan_dw(M, K, N, E, dtype).path}
            for name, (kern, plain) in calls.items():
                if name not in kinds:
                    continue
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                assert torch.equal(got, again), \
                    f"{name} {label} {dn}: two calls differ"
                err = (got.float() - want.float()).abs().max().item()
                scale = max(1e-30, want.float().abs().max().item())
                assert err <= TOL[dn] * scale, \
                    f"{name} {label} {dn} max|err| {err} (scale {scale})"
                if name == "grouped_mm_dw":
                    assert int(torch.count_nonzero(
                        got[(offsets[1:] == offsets[:-1])])) == 0, \
                        "an empty group's weight gradient is not zero"
                e = results[name]
                if dtype == torch.float32:
                    e["max_abs_err"] = max(e["max_abs_err"], err)
                path = ("rows", "tiles")[paths[name]]
                log(f"[kernels] {name} {label} {dn} M={M} E={E} K={K} "
                    f"N={N} ({touched} experts touched, {path} path): "
                    f"max|err| {err:.3e} (tol {TOL[dn]} x {scale:.2f}); two "
                    f"calls bitwise equal")
                del got, again, want
                b_ms, b_by = bound_ms(nbytes[name], 2.0 * M * K * N, dn)
                lib, why = _library_grouped(torch, name, x, w, dy, offsets)
                t = {"shape": f"{label}, M={M} E={E} K={K} N={N} "
                              f"({touched} touched) {dn}, {path} path",
                     "ms": time_ms(kern), "plain_ms": _event_ms(torch, plain),
                     "library_ms": None if lib is None else time_ms(lib),
                     "library": why, "bound_ms": b_ms, "bound_by": b_by}
                log(f"[kernels] {name} {t['shape']}: {t['ms']:.4f} ms, bound "
                    f"{b_ms:.4f} ({b_by}), plain {t['plain_ms']:.4f}, "
                    f"library {t['library_ms']} ({why})")
                if dtype == torch.float32 and label == shapes[0][0]:
                    e.update(t)
                else:
                    e.setdefault("cases", []).append(dict(t,
                                                          max_abs_err=err))
            del x, w, dy
    _grouped_edges(torch, ref, gen, rng)
    torch.cuda.empty_cache()


# the skinny launches of one decode step at its 32 rows (one a slot), as
# the benchmark's cells run them: (label, K, the products' N, trans, launches
# a step); granite-3-8b's 40 layers and tied head (embed.T),
# deepseek-moe-16b's 14 layers (pdbench's cut), its shared experts and
# untied head (its router, N = 64, is narrower than a tile: x @ w). q, k
# and v are one launch, gate and up another
SKINNY_ROWS = 32
SKINNY_M = (1, 7, 26, 32)
SKINNY_SHAPES = (
    ("granite wq|wk|wv", 4096, (4096, 1024, 1024), False, 40),
    ("granite wo", 4096, (4096,), False, 40),
    ("granite w_gate|w_up", 4096, (12800, 12800), False, 40),
    ("granite w_down", 12800, (4096,), False, 40),
    ("granite head (embed.T)", 4096, (49155,), True, 1),
    ("deepseek wq|wk|wv", 2048, (2048, 2048, 2048), False, 14),
    ("deepseek wo", 2048, (2048,), False, 14),
    ("deepseek shared gate|up", 2048, (2816, 2816), False, 14),
    ("deepseek shared down", 2816, (2048,), False, 14),
    ("deepseek head", 2048, (102400,), False, 1))
SKINNY_COLD = 256 << 20   # weight bytes cycled through a timing (> L2)
SKINNY_FACTOR = 4.0       # error vs f64 within this x torch.matmul's f32 error


def _skinny_weights(torch, gen, K, Ns, trans, copies):
    """``copies`` seeded sets of (K, N) weights in the layout of the
    shape: views of row-major (N, K) tensors for ``trans``."""
    sets = []
    for _ in range(copies):
        ws = []
        for N in Ns:
            if trans:
                ws.append((torch.randn((N, K), generator=gen, device="cuda")
                           / K ** 0.5).T)
            else:
                ws.append(torch.randn((K, N), generator=gen, device="cuda")
                          / K ** 0.5)
        sets.append(ws)
    return sets


def _rotating(sets, fn):
    """One call a set of weights, in turn: a timing over all of them reads
    each from device memory (their bytes pass L2), as the decode step
    does."""
    it = [0]

    def call():
        ws = sets[it[0] % len(sets)]
        it[0] += 1
        return fn(ws)
    return call


def phase_kernels_skinny(torch, results: dict, sweep: bool = False) -> None:
    """Phase 2, the skinny product of the decode step (``skinny_mm``) at
    every launch of the benchmark's two cells (``SKINNY_SHAPES``), at M in
    ``SKINNY_M``, each product against a float64 product of the same f32
    inputs: its largest error within SKINNY_FACTOR times torch.matmul's
    f32 error there (TF32 off), two calls bitwise equal, a call captured
    in a graph and replayed equal to an eager one. At M = 32 each launch
    timed (CUDA-graph replay over copies of the weights that pass L2, so
    every call reads its weights from device memory) beside its bound (the
    weights, x and y bytes at 3.35 TB/s against 3 x 2MKN at the TF32
    rate), the plain version (eager, between CUDA events) and
    torch.matmul on each product (the library yardstick, over the same
    copies); then the sums over one decode step of each cell. With
    ``sweep`` every launch is also timed at other grid sizes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import skinny_mm as sk
    gen = torch.Generator(device="cuda").manual_seed(32)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = results.setdefault("skinny_mm", {"max_abs_err": 0.0})
    step = {"granite": [0.0, 0.0, 0.0], "deepseek": [0.0, 0.0, 0.0]}
    for label, K, Ns, trans, calls in SKINNY_SHAPES:
        ws, = _skinny_weights(torch, gen, K, Ns, trans, 1)
        for M in SKINNY_M:
            x = torch.randn((M, K), generator=gen, device="cuda")
            got, again = sk.skinny_mm_cuda(x, *ws), sk.skinny_mm_cuda(x, *ws)
            torch.cuda.synchronize()
            for w, y, y2 in zip(ws, got, again):
                assert torch.equal(y, y2), \
                    f"skinny {label} M={M}: calls differ"
                want = x.double() @ w.double()
                err = (y.double() - want).abs().max().item()
                lib_err = ((x @ w).double() - want).abs().max().item()
                assert err <= SKINNY_FACTOR * lib_err, \
                    f"skinny {label} M={M}: max|err| {err} vs {lib_err}"
                res["max_abs_err"] = max(res["max_abs_err"], err)
                log(f"[kernels] skinny_mm {label} M={M} K={K} N={w.shape[1]} "
                    f"{'T' if trans else 'NN'}, {sk.ctas(K, Ns, sms)} CTAs: "
                    f"max|err| vs f64 {err:.3e}, torch.matmul's {lib_err:.3e} "
                    f"(ratio {err / lib_err:.2f}); two calls bitwise equal")
            del got, again
        # a replay equals an eager call
        x = torch.randn((SKINNY_ROWS, K), generator=gen, device="cuda")
        eager = sk.skinny_mm_cuda(x, *ws)
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            sk.skinny_mm_cuda(x, *ws)
        torch.cuda.current_stream().wait_stream(side)
        with torch.cuda.graph(graph):
            out = sk.skinny_mm_cuda(x, *ws)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(out, eager)), \
                f"skinny {label}: replay differs"
        del graph, out, eager
        # timing over copies that pass L2
        nbytes = K * sum(Ns) * 4
        copies = max(2, -(-SKINNY_COLD // nbytes))
        sets = [ws] + _skinny_weights(torch, gen, K, Ns, trans, copies - 1)
        kern = _rotating(sets, lambda s: sk.skinny_mm_cuda(x, *s))
        libc = _rotating(sets, lambda s: [x @ w for w in s])
        M = SKINNY_ROWS
        b_ms, b_by = bound_ms(nbytes + (M * K + M * sum(Ns)) * 4,
                              3 * 2.0 * M * K * sum(Ns), "tf32")
        t = {"shape": f"{label}: M={M} K={K} N={'+'.join(map(str, Ns))} "
                      f"{'embed.T' if trans else 'row-major'}, "
                      f"{sk.ctas(K, Ns, sms)} CTAs",
             "ms": time_ms(kern, iters=copies),
             "plain_ms": _event_ms(torch,
                                   lambda: [ref.skinny_mm(x, w) for w in ws]),
             "library_ms": time_ms(libc, iters=copies),
             "library": "torch.matmul", "bound_ms": b_ms, "bound_by": b_by}
        rate = nbytes / t["ms"] / 1e9     # TB/s (bytes / ms / 1e9)
        log(f"[kernels] skinny_mm {t['shape']}: {t['ms']:.4f} ms "
            f"({rate:.3f} TB/s of w, {rate / 3.35 * 100:.1f}% of 3.35 TB/s), "
            f"bound {b_ms:.4f} ({b_by}), plain {t['plain_ms']:.4f}, "
            f"torch.matmul {t['library_ms']:.4f}")
        acc = step[label.split()[0]]
        acc[0] += calls * t["ms"]
        acc[1] += calls * t["library_ms"]
        acc[2] += calls * b_ms
        if label == SKINNY_SHAPES[0][0]:
            res.update(t)
        else:
            res.setdefault("cases", []).append(t)
        if sweep:
            got = []
            orig = sk.ctas
            for grid in (sms // 2, sms, 2 * sms, 3 * sms):
                grid = min(grid, sk.iterations(K, Ns))
                sk.ctas = lambda *a, _g=grid: _g
                try:
                    got.append(f"{grid}: {time_ms(kern, iters=copies):.4f}")
                finally:
                    sk.ctas = orig
            log(f"[skinny sweep] {label} K={K} N={Ns} by CTAs: "
                + ", ".join(got))
        del sets, ws, kern, libc, x
        torch.cuda.empty_cache()
    for cell, (k_ms, l_ms, b) in step.items():
        log(f"[kernels] skinny_mm one {cell} decode step's dense products: "
            f"{k_ms:.3f} ms (torch.matmul {l_ms:.3f}, bound {b:.3f})")


# the window mode at the long-context layer shape: a 10240-row prompt
# (8192 + 2048) under granite's W = 8192, b = 1, 32/8 heads of 128
WINDOW_W, WINDOW_S = 8192, 10240
WINDOW_CHUNK = 1024     # query rows per call of the chunked plain version
# the window mode's edges, at s = WINDOW_EDGE_S: W of 1, one under, at
# and one over a 64-row query tile, two key tiles, s - 1, s and past it
WINDOW_EDGE_S = 300
WINDOW_EDGES = (1, 63, 64, 65, 128, WINDOW_EDGE_S - 1, WINDOW_EDGE_S, 1000)


def _plain_window_chunked(ref, q, k, v, window):
    """The plain windowed flash prefill over WINDOW_CHUNK query rows at a
    time (the q_offset form: rows [c0, c1) against key rows [0, c1)), so
    the (b, nq, s, s) scores never exist at once."""
    import torch
    s = q.shape[1]
    return torch.cat([ref.flash_prefill(q[:, c0:c0 + WINDOW_CHUNK],
                                        k[:, :c0 + WINDOW_CHUNK],
                                        v[:, :c0 + WINDOW_CHUNK],
                                        q_offset=c0, window=window)
                      for c0 in range(0, s, WINDOW_CHUNK)], dim=1)


def _event_ms(torch, fn, repeats: int = 3) -> float:
    """Median device time of one call between CUDA events (no graph: for
    the chunked plain version, whose temporaries a graph would keep)."""
    fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_kernels_window(torch, results: dict) -> None:
    """Phase 2, the window mode of flash prefill (JAX's
    ``attention_seq(window=)``): at the slice's layer shape (b = 1, s =
    WINDOW_S, W = WINDOW_W, 32/8 heads of 128) in f32 and bf16 against
    the chunked plain version within TOL, then its edges (W in
    WINDOW_EDGES; q_offset and a padded prefix across tiles; q_valid; g
    in {1, 4, 6, 8}; hd in {32, 64, 128}), where a W at or past q_offset + s
    must equal the causal mode bit for bit. The f32 layer shape is timed
    beside the plain version and SDPA with the band as a boolean mask
    (k, v expanded to the query heads outside the timing), with the
    bound of its live pairs."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.launch.cost import attention_pairs

    cfg = get_config(ARCH)
    nq, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20)
    e = results.setdefault("flash_prefill", {"max_abs_err": 0.0})

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    s, W = WINDOW_S, WINDOW_W
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        q = randn((1, s, nq, hd), dtype)
        k, v = (randn((1, s, nkv, hd), dtype) for _ in range(2))
        got = flash_prefill_cuda(q, k, v, window=W)
        want = _plain_window_chunked(ref, q, k, v, W)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= TOL[dn], f"window mode {dn} s={s} W={W} max|err| {err}"
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        assert torch.equal(flash_prefill_cuda(q, k, v, q_offset=zero,
                                              window=W), got), \
            f"window mode {dn}: device q_offset != int"
        log(f"[kernels] flash_prefill window {dn} b=1 s={s} W={W} nq={nq} "
            f"nkv={nkv} hd={hd}: max|err| {err:.3e} (tol {TOL[dn]})")
        if dtype != torch.float32:
            continue
        e["max_abs_err"] = max(e["max_abs_err"], err)
        pairs = attention_pairs(1, s, s, 0, 0, True, W)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
        b_ms, b_by = bound_ms(nbytes, 4 * pairs * nq * hd, "float32")
        pos = torch.arange(s, device=dev)
        band = (pos[None, :] <= pos[:, None]) \
            & (pos[:, None] - pos[None, :] < W)
        qt = q.transpose(1, 2)
        kt, vt = (x.repeat_interleave(nq // nkv, dim=2).transpose(1, 2)
                  for x in (k, v))
        lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)
        lib_err = (lib.transpose(1, 2) - want).abs().max().item()
        del lib, want
        t = dict(ms=time_ms(lambda: flash_prefill_cuda(q, k, v, window=W),
                            iters=3, repeats=3),
                 ms_device_q_offset=time_ms(lambda: flash_prefill_cuda(
                     q, k, v, q_offset=zero, window=W), iters=3, repeats=3),
                 plain_ms=_event_ms(torch, lambda: _plain_window_chunked(
                     ref, q, k, v, W)),
                 library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, attn_mask=band), iters=3, repeats=3),
                 bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                 shape=f"window b=1 s={s} W={W} nq={nq} nkv={nkv} hd={hd} "
                       f"f32 ({pairs} live pairs a head)")
        e.setdefault("cases", []).append(t)
        log(f"[kernels] flash_prefill window f32: {t['ms']:.4f} ms "
            f"(q_offset on the card {t['ms_device_q_offset']:.4f} ms), plain "
            f"{t['plain_ms']:.4f} ms, SDPA with the band mask "
            f"{t['library_ms']:.4f} ms (its max|err| {lib_err:.3e}), bound "
            f"{b_ms:.4f} ms ({b_by}, {pairs} live pairs a head)")
        del qt, kt, vt, band
    del q, k, v, got, zero
    torch.cuda.empty_cache()

    es = WINDOW_EDGE_S
    for (fnq, fnkv, fhd), dtype in itertools.product(
            ((32, 8, 128), (8, 8, 64), (64, 8, 128), (16, 4, 32),
             (48, 8, 128)), (torch.float32, torch.bfloat16)):
        dn = str(dtype).split(".")[1]
        for qo, pp, qv in ((0, 0, None), (45, 70, [es, 131]),
                           (37, 0, [es - 3, es])):
            sk = (pp or qo) + es
            q = randn((2, es, fnq, fhd), dtype)
            k, v = (randn((2, sk, fnkv, fhd), dtype) for _ in range(2))
            qvt = None if qv is None else torch.tensor(
                qv, dtype=torch.int32, device=dev)
            causal = flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=pp,
                                        q_valid=qvt)
            worst = 0.0
            for w in WINDOW_EDGES:
                got = flash_prefill_cuda(q, k, v, q_offset=qo, prefix_pad=pp,
                                         q_valid=qvt, window=w)
                assert torch.equal(got, flash_prefill_cuda(
                    q, k, v, q_offset=torch.tensor(qo, dtype=torch.int32,
                                                   device=dev),
                    prefix_pad=pp, q_valid=qvt, window=w)), \
                    f"window {dn} W={w} qo={qo}: device q_offset != int"
                want = ref.flash_prefill(q, k, v, q_offset=qo, prefix_pad=pp,
                                         q_valid=qvt, window=w)
                err = (got.float() - want.float()).abs().max().item()
                assert err <= TOL[dn], \
                    f"window {dn} W={w} qo={qo} pp={pp} max|err| {err}"
                for bi, v_ in enumerate(qv or []):
                    assert torch.count_nonzero(got[bi, v_:]) == 0
                if w >= qo + es:
                    assert torch.equal(got, causal), \
                        f"W={w} >= q_offset + s differs from causal"
                worst = max(worst, err)
            if dtype == torch.float32:
                e["max_abs_err"] = max(e["max_abs_err"], worst)
            log(f"[kernels] flash_prefill window {dn} edges W={WINDOW_EDGES} "
                f"s={es} nq={fnq} nkv={fnkv} hd={fhd} q_offset={qo} "
                f"prefix_pad={pp} q_valid={qv}: max|err| {worst:.3e}; W >= "
                f"q_offset + s bitwise the causal output; q_offset on the "
                f"card bitwise the int")
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
                 "jamba-1.5-large-398b", ENCDEC_ARCH, VLM_ARCH,
                 "mistral-nemo-12b", "pangu-38b", "qwen1.5-110b",
                 TRAIN_ARCH)


def phase_reduced(torch) -> None:
    """Each served family at reduced size, and the reduced variants at
    the published head and routing ratios (``configs.RATIO_VARIANTS``:
    pangu-38b at 12/2 heads, deepseek-moe-16b at top-6 of 8 + 2 shared,
    both dispatches): card tokens == CPU tokens in both transfer modes,
    with warm prefix hits in the second batch (window-aligned hits for
    capacity MoE, snapshot restores for SSM/hybrid, whose snapshot
    stride is 32 tokens here; the same frames for whisper)."""
    import numpy as np
    from repro_torch.configs import RATIO_VARIANTS, get_config, ratio_variant
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.serving.cluster import MiniCluster

    for arch in REDUCED_ARCHS + tuple(RATIO_VARIANTS):
        cfg = ratio_variant(arch) if arch in RATIO_VARIANTS \
            else get_config(arch).reduced()
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
            log(f"[reduced] {cfg.name} ({cfg.num_heads}/{cfg.num_kv_heads} "
                f"heads{_moe_note(cfg)}) overlap={overlap}: card tokens == "
                f"CPU tokens for {len(runs['cpu'])} requests (hits "
                f"{int(st['hits'])}, snapshot hits {int(st['snap_hits'])})")
        if arch in SPEC_REDUCED:
            reduced_legacy(torch, cfg, params)
        del params


def _moe_note(cfg) -> str:
    m = cfg.moe
    return "" if m is None else f", top-{m.top_k} of {m.num_experts} + " \
        f"{m.num_shared_experts} shared, {m.dispatch}"


# the families phase 3 also serves with speculation and eager decode
SPEC_REDUCED = (MOE_ARCH, SSM_ARCH, "jamba-1.5-large-398b")


def reduced_legacy(torch, cfg, params) -> None:
    """Phase 3's speculation and eager decode on one reduced family, card
    against CPU with the same target and draft params (a seeded
    ``draft_for`` draft, k=3), warm hits included: equal tokens per mode,
    and the speculative run's tokens equal the plain run's (lossless; the
    eager run's equality is logged, its batch shapes differ)."""
    import numpy as np
    from repro_torch.models.params import tree_map
    from repro_torch.serving.frontend import ClusterFrontend
    from repro_torch.serving.speculative import SpecConfig, draft_for

    d = draft_for(cfg, seed=5, device="cpu")
    drafts = {"cpu": d.draft_params,
              "cuda": tree_map(lambda x: x.to("cuda"), d.draft_params)}
    runs = {}
    for mode in ("plain", "spec", "eager"):
        for dev, prm in params.items():
            kw = {}
            if mode == "spec":
                kw["spec"] = SpecConfig(d.draft_cfg, drafts[dev], k=3)
            elif mode == "eager":
                kw["decode_kwargs"] = {"fused": False}
            fe = ClusterFrontend(cfg, params=prm, device=dev, **kw)
            reqs = make_requests(cfg, 6, 34, 40, 6, seed=3)
            reqs[4].tokens = reqs[0].tokens[:32] + reqs[4].tokens[:5]
            reqs[5].tokens = reqs[1].tokens[:20] + reqs[5].tokens[:9]
            fe.run(reqs)
            assert all(r.done for r in reqs), (cfg.name, mode, dev)
            eng = fe.groups["default"].decodes[0].engine
            steps = {"plain": eng.fused_steps, "spec": eng.spec_steps,
                     "eager": eng.eager_steps}[mode]
            assert steps > 0, (cfg.name, mode, dev)
            runs[mode, dev] = {r.rid: list(r.generated) for r in reqs}
        assert runs[mode, "cuda"] == runs[mode, "cpu"], (cfg.name, mode)
    assert runs["spec", "cuda"] == runs["plain", "cuda"], cfg.name
    log(f"[reduced] {cfg.name} spec (k=3, {d.draft_cfg.num_layers}-layer "
        f"draft) and eager: card tokens == CPU tokens; spec == plain; eager "
        f"== plain: {runs['eager', 'cuda'] == runs['plain', 'cuda']}")
    del drafts


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
    from repro_torch.kernels import (flash_prefill, flash_prefill_bwd,
                                     kv_gather, kv_scatter, paged_attention)
    return {"kv_gather": kv_gather, "kv_scatter": kv_scatter,
            "paged_attention": paged_attention,
            "flash_prefill": flash_prefill,
            "flash_prefill_bwd": flash_prefill_bwd}


# the kernels every serving path launches, and the training path's
SERVING_KERNELS = ("kv_gather", "kv_scatter", "paged_attention",
                   "flash_prefill")
TRAIN_KERNELS = ("flash_prefill", "flash_prefill_bwd")


NONCAUSAL = "flash_prefill_noncausal"   # launches in the non-causal mode
WINDOW = "flash_prefill_window"         # launches in the window mode
# the backward's launches in the non-causal mode (its own kernel row)
NONCAUSAL_BWD = "flash_prefill_bwd_noncausal"


# the grouped product's three counters: forward, input and weight gradient
GROUPED_COUNTERS = {"grouped_mm": "launches", "grouped_mm_dx": "dx_launches",
                    "grouped_mm_dw": "dw_launches"}


def zero_counts() -> None:
    from repro_torch.kernels import grouped_mm, skinny_mm
    mods = _kernel_modules()
    skinny_mm.launches = 0
    for m in mods.values():
        m.launches = 0
    mods["flash_prefill"].noncausal_launches = 0
    mods["flash_prefill"].window_launches = 0
    mods["flash_prefill_bwd"].noncausal_launches = 0
    for attr in GROUPED_COUNTERS.values():
        setattr(grouped_mm, attr, 0)


def read_counts() -> dict:
    """Each kernel's launches since zero_counts, the non-causal and
    window shares of flash prefill's under NONCAUSAL and WINDOW, the
    backward's non-causal share under NONCAUSAL_BWD, the grouped
    product's three kernels and the skinny product."""
    from repro_torch.kernels import grouped_mm, skinny_mm
    mods = _kernel_modules()
    counts = {n: m.launches for n, m in mods.items()}
    counts["skinny_mm"] = skinny_mm.launches
    counts[NONCAUSAL] = mods["flash_prefill"].noncausal_launches
    counts[WINDOW] = mods["flash_prefill"].window_launches
    counts[NONCAUSAL_BWD] = mods["flash_prefill_bwd"].noncausal_launches
    counts.update({n: getattr(grouped_mm, a)
                   for n, a in GROUPED_COUNTERS.items()})
    return counts


def unlaunched(counts: dict, kernels=SERVING_KERNELS) -> list:
    return [n for n in kernels if counts[n] == 0]


def free_card(torch) -> None:
    """Return what earlier phases dropped to the card: a dropped cluster
    frees its params and pools at once (its callbacks are weak), so no
    cycle collection is needed."""
    torch.cuda.empty_cache()


def live_tensors(torch, n: int = 6) -> list:
    """The ``n`` largest CUDA tensors the garbage collector can see, with
    the types of what refers to each (to name what an earlier phase left
    behind)."""
    import gc
    seen = {}
    for o in gc.get_objects():
        if isinstance(o, torch.Tensor) and o.is_cuda:
            st = o.untyped_storage()
            seen.setdefault(st.data_ptr(), (st.nbytes(), o))
    big = sorted(seen.values(), key=lambda x: -x[0])[:n]
    return [(nb, tuple(t.shape), sorted({type(r).__name__
                                        for r in gc.get_referrers(t)}))
            for nb, t in big]


def load_params(torch, arch):
    """Full-width random f32 params on the card of ``arch`` (a name, or a
    config), from a seeded CUDA generator, after freeing the card; resets
    the peak-memory counter."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    cfg = get_config(arch) if isinstance(arch, str) else arch
    free_card(torch)
    left = torch.cuda.memory_allocated() / 2**30
    assert left < 1.0, f"{left:.1f} GiB of an earlier phase still " \
        f"allocated: {live_tensors(torch)}"
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    log(f"[{cfg.name}] f32 params on the card "
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
        f"{int(g.transfer_stats()['jobs_admitted'])} transfers; "
        f"{prefill_graph_note(fe)} [{card}]")
    return {r.rid: list(r.generated) for r in reqs}


def log_peak(torch, tag: str, card: str) -> float:
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{tag}] peak memory allocated {peak:.2f} GiB [{card}]")
    return peak


def phase_main(torch, card: str, out: Path):
    """The dense main path: full-width granite-3-8b, overlapped then
    blocking; then one request's hand-off timed; then a profiled run;
    then phase 7 (the control plane), phase 10 (speculation and the
    legacy baselines) and phase 11 (the simulator on the card's profile)
    on the same params, then phase 14 (the step graphs), phase 17 (the
    prefill graphs) and phase 11 (the simulator on the card's profile).
    Returns the launch counts of the main path, of the control path
    (A-D), of the absorption run (E), phase 10's {path: counts}, phase
    14's, phase 17's and phase 11's counts."""
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.frontend import ClusterFrontend

    cfg, params = load_params(torch, ARCH)
    zero_counts()
    tokens, clusters, golden_rows = {}, {}, {}
    for overlap in (True, False):
        mc = MiniCluster(cfg, params=params, device="cuda",
                         overlap_transfer=overlap)
        flush = capture_rows(mc.frontend, golden_rows) if overlap else None
        tokens[overlap] = serve(
            torch, card, f"main overlap={overlap}", mc.frontend,
            [make_requests(cfg, 4, 200, 480, 16, seed=11)])
        if flush:
            flush()
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
    legacy = phase_legacy(torch, card, cfg, params, tokens[True],
                          golden_rows)
    del golden_rows
    graphs, _ = phase_graphs(torch, card, cfg, params)
    prefill_graphs = phase_prefill_graphs(torch, card, cfg, params)
    sim = phase_sim(torch, card, cfg, params)
    del params
    free_card(torch)
    return counts, control, absorb, legacy, graphs, prefill_graphs, sim


# ------------------------------------------------------------ phase 14

GRAPH_PATH = f"{ARCH}/graphs"
GRAPH_ROOM = 96      # tokens of room a request gets (a spec step retires 5)
GRAPH_TIMED = 5      # steps timed each way, then as many profiled
LONG_PROMPT = 1100   # tokens: an admission that crosses the table bucket


def admit_one(de, rid: int, out, prompt, room: int) -> int:
    """Allocate ``room`` tokens past the prompt, write the prompt's KV into
    the engine's pool and admit the request; returns its slot."""
    pool = de.pool
    pool.alloc(rid, out.prompt_len + room)
    if out.k is not None:
        pool.write_prefill(
            pool.owned(rid)[:pool.blocks_for_tokens(out.prompt_len)],
            out.k, out.v)
    return de.admit(rid, out, pool.owned(rid), prompt=prompt)


def decode_engine(torch, cfg, params, reqs, *, spec=None, extra_blocks=0):
    """A DecodeEngine on the card (8 slots) holding ``reqs`` in slots 0..,
    their prompts prefilled in one batch, GRAPH_ROOM tokens of room each.
    Returns (engine, prefill outputs)."""
    from repro_torch.serving.engine import DecodeEngine, PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    frames = [r.frames for r in reqs] if cfg.is_encoder_decoder else None
    outs = PrefillEngine(cfg, params).run([r.tokens for r in reqs],
                                          frames=frames)
    blocks = sum(-(-(o.prompt_len + GRAPH_ROOM) // 16) for o in outs)
    pool = PagedKVPool(cfg, num_blocks=blocks + extra_blocks, device="cuda")
    de = DecodeEngine(cfg, params, pool, max_slots=8, spec=spec)
    for r, o in zip(reqs, outs):
        admit_one(de, r.rid, o, r.tokens, GRAPH_ROOM)
    return de, outs


def check_twin(torch, tag: str, de, twin: dict, got: dict) -> None:
    """A replayed step (``got``, and the engine's buffers after it)
    against ``eager_twin``'s first call, bit for bit."""
    out = twin["out"].cpu()
    k = de.spec.k if de.spec is not None else None
    want = {s: [int(out[s])] if k is None else
            [int(t) for t in out[s, :int(out[s, k + 1])]]
            for s in de.active_slots()}
    pairs = [("tokens", de._tokens, twin["tokens"]),
             ("positions", de._pos, twin["pos"]),
             ("pool blocks", de.pool.storage, twin["storage"])]
    trees = [("slot state", de._slot_layers, twin["slot_layers"])]
    if k is not None:
        pairs.append(("draft pool blocks", de._d_storage[:, :-1],
                      twin["d_storage"]))
        trees.append(("draft slot state", de._d_slot_layers,
                      twin["d_slot_layers"]))
    pairs += [(f"{name} {sub}/{leaf}", a[sub][leaf], b[sub][leaf])
              for name, a, b in trees for sub in a for leaf in a[sub]]
    assert got == want, f"[{tag}] replayed tokens {got} != eager {want}"
    for name, a, b in pairs:
        assert torch.equal(a, b), f"[{tag}] replayed {name} != eager"


def busy(torch, fn, n: int):
    """torch.profiler over ``n`` calls of ``fn``: (device kernel ms, wall
    ms, {kind: device ms}) per call."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # the profiler may keep this frame alive: drop what it pins
    del fn
    kinds = {k: v / n for k, v in device_ms_by_kind(prof, kind_of).items()}
    return sum(kinds.values()), wall / n, kinds


def graph_vs_eager(torch, card: str, tag: str, de) -> dict:
    """One served decode path's step, graph against eager, on ``de``
    holding its requests: the first step (a real step run eagerly, then
    the capture), one replay against ``eager_twin`` bit for bit, then
    GRAPH_TIMED steps each way timed (host wall to a card sync; the
    eager ones on the twin's clones, the same shapes), and GRAPH_TIMED
    more of each under torch.profiler (device time per step, busy
    share). Returns the numbers."""
    from repro_torch.serving.step_graph import eager_twin
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    de.step()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    assert (de.graphs.captures, de.graphs.replays) == (1, 0), tag
    check_twin(torch, tag, de, eager_twin(de)(), de.step())
    eager = eager_twin(de)
    r = {"graph_ms": _sync_ms(torch, de.step, GRAPH_TIMED),
         "eager_ms": _sync_ms(torch, eager, GRAPH_TIMED),
         "first_ms": first, "capture_s": de.graphs.capture_s,
         "pool_mib": de.graphs.pool_bytes / 2**20}
    r["graph_dev_ms"], g_wall, kinds = busy(torch, de.step, GRAPH_TIMED)
    r["eager_dev_ms"], e_wall, _ = busy(torch, eager, GRAPH_TIMED)
    r["graph_busy"] = r["graph_dev_ms"] / g_wall
    r["eager_busy"] = r["eager_dev_ms"] / e_wall
    slots = len(de.active_slots())
    del eager, de       # the profiler may keep this frame alive
    by_kind = {k: round(v, 3) for k, v in
               sorted(kinds.items(), key=lambda kv: -kv[1])}
    log(f"[{tag}] {slots} of 8 slots: step "
        f"median graph {r['graph_ms']:.3f} ms, eager {r['eager_ms']:.3f} ms "
        f"({r['eager_ms'] / r['graph_ms']:.2f}x); device per step graph "
        f"{r['graph_dev_ms']:.3f} ms (busy {r['graph_busy']:.3f} profiled), "
        f"eager {r['eager_dev_ms']:.3f} ms (busy {r['eager_busy']:.3f}); "
        f"first step {first:.1f} ms of which capture "
        f"{r['capture_s'] * 1e3:.1f} ms, graph pool {r['pool_mib']:.1f} "
        f"MiB; a replay == the eager step bit for bit; device ms a "
        f"replayed step by kind {by_kind} [{card}]")
    return r


def phase_graphs(torch, card: str, cfg, params) -> dict:
    """Phase 14, on phase 4's params after phase 10: the step graphs at
    full width. For the fused step, self-draft speculation (k = 4) and
    ``draft_for`` speculation, phase 4's four prompts in 4 of 8 slots:
    ``graph_vs_eager`` (a replay bit for bit against the eager step,
    graph and eager medians, capture wall, graph pool, busy shares).
    Then JAX's capture counts: the fused engine readmits a request in the
    same table bucket (no new key), then a LONG_PROMPT-token request
    crosses the bucket (exactly one); the self-draft engine admits a
    request whose caps clamp its burst below k + 1 beside full bursts,
    then evicts it (no new key). Launches are counted under GRAPH_PATH.
    Returns (counts, {tag: numbers})."""
    import numpy as np
    from repro_torch.serving import step_graph
    from repro_torch.serving.engine import PrefillEngine
    from repro_torch.serving.speculative import SpecConfig, draft_for

    free_card(torch)
    zero_counts()
    reqs = make_requests(cfg, 4, 200, 480, 16, seed=11)   # phase 4's
    rng = np.random.default_rng(31)
    long = [int(t) for t in rng.integers(0, cfg.vocab_size, LONG_PROMPT)]
    res = {}
    for tag, spec in (("fused", None),
                      ("spec self-draft", SpecConfig(cfg, params, k=4)),
                      ("spec draft_for", draft_for(cfg, device="cuda"))):
        keys = (step_graph.decode_step_cache_size() if spec is None
                else step_graph.spec_decode_step_cache_size())
        de, outs = decode_engine(torch, cfg, params, reqs, spec=spec,
                                 extra_blocks=128)
        res[tag] = graph_vs_eager(torch, card, f"graphs {ARCH} {tag}",
                                  de)
        de.evict(0)
        de.pool.release(reqs[0].rid)
        if spec is None:
            admit_one(de, 10, outs[0], reqs[0].tokens, GRAPH_ROOM)
            de.step()
            assert de.graphs.captures == 1, "a readmission recaptured"
            w = de._table_w
            o, = PrefillEngine(cfg, params).run([long])
            admit_one(de, 11, o, long, 32)
            del o
            de.step()
            de.step()
            assert de._table_w > w and de.graphs.captures == 2, \
                (w, de._table_w, de.graphs.captures)
            got = step_graph.decode_step_cache_size() - keys
            assert got == 2, got
            note = (f"table bucket {w} -> {de._table_w} blocks: one more "
                    f"capture; keys +{got}")
        elif tag == "spec self-draft":
            slot = admit_one(de, 10, outs[0], reqs[0].tokens, 2)
            room = len(de.pool.owned(10)) * 16 - outs[0].prompt_len
            assert room < spec.k + 1, room
            step = de.step()
            lens = {s: len(t) for s, t in step.items()}
            assert lens[slot] == room and set(lens.values()) == \
                {room, spec.k + 1}, lens
            de.evict(slot)
            de.pool.release(10)
            de.step()
            got = step_graph.spec_decode_step_cache_size() - keys
            assert de.graphs.captures == 1 and got == 1, \
                (de.graphs.captures, got)
            note = (f"bursts {sorted(lens.values())} in one step and a "
                    f"slot churned: no new capture; keys +{got}")
        else:
            de.step()
            assert de.graphs.captures == 1
            note = "an eviction: no new capture"
        log(f"[graphs {tag}] {note}; {de.graphs.captures} capture(s), "
            f"{de.graphs.replays} replays [{card}]")
        del de, outs, spec
        free_card(torch)
    counts = read_counts()
    missing = unlaunched(counts, ("paged_attention", "flash_prefill"))
    assert not missing, f"kernels never launched in phase 14: {missing}"
    log(f"[graphs] launches on {GRAPH_PATH}: {counts} [{card}]")
    return counts, res


# ------------------------------------------------------------ phase 17

PREFILL_GRAPH_PATH = f"{ARCH}/prefill-graphs"
PREFILL_TIMED = 5      # prefill batches timed each way at each bucket
PREFILL_PROFILED = 3   # and profiled each way
SERVED_TIMED, SERVED_PROFILED = 3, 1   # the same on the other paths
SUFFIX_PROMPT = 160    # tokens: suffixes after prefixes of 96, 112, 104
SUFFIX_PREFIXES = (96, 112, 104)   # one prefix bucket (128), one suffix
                                   # (64): eager, captured, replayed


def _same_prefill(torch, tag: str, a, b) -> None:
    """Two PrefillOutputs bit for bit: first token, KV, Mamba state,
    cross KV and snapshots."""
    assert (a.first_token, a.prompt_len) == (b.first_token, b.prompt_len), \
        f"[{tag}] first token {a.first_token} != eager {b.first_token}"
    for x, y in ((a.k, b.k), (a.v, b.v)):
        assert (x is None) == (y is None) and (
            x is None or torch.equal(x, y)), f"[{tag}] KV differs"
    assert (a.snapshots or {}).keys() == (b.snapshots or {}).keys(), tag
    trees = [(a.mamba_state, b.mamba_state), (a.cross, b.cross)] + [
        (a.snapshots[t], b.snapshots[t]) for t in a.snapshots or {}]
    for ta, tb in trees:
        assert (ta is None) == (tb is None), tag
        for key in ta or {}:
            xa, xb = ta[key], tb[key]
            pairs = [(xa[k], xb[k]) for k in xa] if isinstance(xa, dict) \
                else list(zip(xa, xb))
            assert all(torch.equal(p, q) for p, q in pairs), \
                f"[{tag}] state {key} differs from the eager prefill"


def prefill_vs_eager(torch, card: str, tag: str, cfg, params, prompts, *,
                     frames=None, snap_stride: int = 0, engines=None,
                     timed: int = PREFILL_TIMED,
                     profiled: int = PREFILL_PROFILED) -> dict:
    """A served path's prefill batch, graph against eager: ``prompts``
    through a PrefillEngine (the first run is eager, the second
    captures, a replay is held bit for bit against a
    ``jit_prefill=False`` engine's outputs), then
    ``timed`` batch walls each way (host clock to a card sync) and
    ``profiled`` profiled batches each way (device ms a batch, busy
    share). ``engines`` (graphed, eager) reuses two engines. Returns the
    numbers."""
    from repro_torch.serving.engine import PrefillEngine
    t0 = time.perf_counter()
    if engines is None:
        engines = (PrefillEngine(cfg, params),
                   PrefillEngine(cfg, params, jit_prefill=False))
        # the comparison replays every key of its batch
        engines[0].graphs.budget = None
    pe, eager = engines
    kw = dict(frames=frames, snap_stride=snap_stride)
    for _ in range(2):
        pe.run(prompts, **kw)
    replays = pe.graphs.replays
    for a, b in zip(pe.run(prompts, **kw), eager.run(prompts, **kw)):
        _same_prefill(torch, f"prefill graphs {tag}", a, b)
    assert pe.graphs.replays > replays, f"[{tag}] the prefill replayed nothing"
    r = {}
    for mode, eng in (("graph", pe), ("eager", eager)):
        r[mode] = _sync_ms(torch, lambda: eng.run(prompts, **kw), timed)
        dev_ms, wall, _ = busy(torch, lambda: eng.run(prompts, **kw),
                               profiled)
        r[f"{mode}_dev"], r[f"{mode}_busy"] = dev_ms, dev_ms / wall
    log(f"[prefill graphs {tag}] b={len(prompts)}, prompts "
        f"{[len(t) for t in prompts]}: a replay == the eager prefill bit "
        f"for bit; batch wall median graph {r['graph']:.2f} ms, eager "
        f"{r['eager']:.2f} ms ({r['eager'] / r['graph']:.3f}x); device ms "
        f"a batch graph {r['graph_dev']:.2f} (busy {r['graph_busy']:.3f} "
        f"profiled), eager {r['eager_dev']:.2f} (busy "
        f"{r['eager_busy']:.3f}); medians of {timed}, {profiled} profiled; "
        f"{pe.graphs.captures} graphs, pool "
        f"{pe.graphs.pool_bytes / 2**20:.1f} MiB; the comparison took "
        f"{time.perf_counter() - t0:.1f} s [{card}]")
    del pe, eager, eng, engines   # the profiler may keep this frame alive
    return r


def phase_prefill_graphs(torch, card: str, cfg, params) -> dict:
    """Phase 17, on phase 4's params after phase 14: the prefill graphs at
    full width (granite-3-8b, f32). (a) phase 4's four prompts (237, 302,
    251, 318 tokens: buckets 256 and 512, two prompts each) run eagerly
    (a key's first forward); a second wave of new lengths in those
    buckets captures one graph per bucket and a third replays them,
    adding no key; every wave equals a ``jit_prefill=False`` engine's
    first tokens and per-request KV bit for bit. (b) Warm suffixes after
    prefixes of 96, 112 and 104 tokens (one prefix bucket, 128; one
    suffix bucket, 64) run eagerly, capture and replay one key, each
    equal to the eager suffix prefill. (c) Graph against
    eager at each bucket: the median of PREFILL_TIMED batch walls (host
    clock to a card sync), device ms and busy share of PREFILL_PROFILED
    profiled batches; the capture wall and the pool bytes per key; then
    the engines are dropped and the graphs' pools go back to the card.
    Launches are counted under PREFILL_GRAPH_PATH. Returns the counts."""
    import numpy as np
    from repro_torch.serving import step_graph
    from repro_torch.serving.engine import PrefillEngine

    free_card(torch)
    zero_counts()
    reserved0 = torch.cuda.memory_reserved()
    pe = PrefillEngine(cfg, params)
    eager = PrefillEngine(cfg, params, jit_prefill=False)
    rng = np.random.default_rng(41)
    wave1 = [r.tokens for r in make_requests(cfg, 4, 200, 480, 16, seed=11)]
    waves = [wave1] + [[[int(t) for t in rng.integers(0, cfg.vocab_size,
                                                      n)] for n in lens]
                       for lens in ((229, 350, 244, 401),
                                    (210, 290, 250, 470))]
    for w in waves:
        assert sorted(pe._bucket_len(len(t)) for t in w) == \
            [256, 256, 512, 512], [len(t) for t in w]
    keys, counts = [], []
    for i, wave in enumerate(waves):
        for a, b in zip(pe.run(wave), eager.run(wave)):
            _same_prefill(torch, f"prefill graphs wave {i + 1}", a, b)
        keys.append(step_graph.prefill_compile_count())
        counts.append((pe.graphs.captures, pe.graphs.replays))
    assert counts == [(0, 0), (2, 0), (2, 2)], counts
    assert keys[2] == keys[1] == keys[0], f"later waves added keys: {keys}"
    log(f"[prefill graphs] wave 1 {[len(t) for t in wave1]} ran eagerly, "
        f"wave 2 {[len(t) for t in waves[1]]} captured "
        f"{pe.graphs.captures} graphs (buckets 256, 512), wave 3 "
        f"{[len(t) for t in waves[2]]} replayed them, with no new key "
        f"({keys[2]} keys in the process); first tokens and KV == "
        f"jit_prefill=False bit for bit [{card}]")
    # (b) two prefix lengths in one prefix bucket: one key
    long = [int(t) for t in rng.integers(0, cfg.vocab_size, SUFFIX_PROMPT)]
    cold, = eager.run([long])
    k0 = step_graph.prefill_compile_count()
    for plen in SUFFIX_PREFIXES:
        pkv = torch.cat([cold.k[:, :plen], cold.v[:, :plen]], dim=-1)
        _same_prefill(torch, f"prefill graphs suffix after {plen}",
                      pe.run_suffix(long[plen:], pkv),
                      eager.run_suffix(long[plen:], pkv))
    assert (pe.graphs.captures, pe.graphs.replays) == (3, 3), \
        (pe.graphs.captures, pe.graphs.replays)
    assert step_graph.prefill_compile_count() - k0 <= 1
    log(f"[prefill graphs] suffixes after prefixes of {SUFFIX_PREFIXES} "
        f"tokens (prefix bucket 128, suffix bucket 64): one key, run "
        f"eagerly, captured, replayed, each == the eager suffix prefill "
        f"bit for bit [{card}]")
    # (c) graph against eager, per bucket
    for bucket in (256, 512):
        prefill_vs_eager(torch, card, f"{ARCH} bucket {bucket}", cfg,
                         params, [t for t in wave1
                                  if pe._bucket_len(len(t)) == bucket],
                         engines=(pe, eager))
    g = pe.graphs
    log(f"[prefill graphs] {g.captures} captures, {g.capture_s:.3f} s of "
        f"capture wall ({g.capture_s / g.captures * 1e3:.1f} ms each); "
        f"graph pool {g.pool_bytes / 2**20:.1f} MiB reserved "
        f"({g.pool_bytes / g.captures / 2**20:.1f} MiB a key); the "
        f"graphs keep {g.held_bytes / 2**20:.1f} MiB of outputs and "
        f"static inputs (budget {g.budget / 2**20:.0f} MiB, "
        f"{g.evictions} dropped) [{card}]")
    counts = read_counts()
    missing = unlaunched(counts, ("flash_prefill",))
    assert not missing, f"kernels never launched in phase 17: {missing}"
    del pe, eager, g, cold
    free_card(torch)
    reserved = torch.cuda.memory_reserved()
    assert reserved <= reserved0 + 2**30, \
        f"dropped prefill graphs kept {(reserved - reserved0) / 2**20} MiB"
    log(f"[prefill graphs] engines dropped: reserved "
        f"{reserved / 2**30:.2f} GiB (before the phase "
        f"{reserved0 / 2**30:.2f}); launches on "
        f"{PREFILL_GRAPH_PATH}: {counts} [{card}]")
    return counts


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
    return sum(n.pool.full_storage.numel()
               * n.pool.full_storage.element_size()
               for g in fe.groups.values() for n in g.prefills + g.decodes)


def _prefill_engines(fe) -> list:
    """Every PrefillEngine of a frontend's live nodes: the prefill nodes',
    the decode nodes' absorbers and their speculative drafts'."""
    engines = []
    for g in fe.groups.values():
        engines += [n.engine for n in g.prefills]
        for n in g.decodes:
            if n._absorber is not None:
                engines.append(n._absorber)
            if n.engine.spec is not None:
                engines.append(n.engine._d_prefill)
    return engines


def graph_bytes(fe) -> int:
    """Card memory a frontend's engines keep for their CUDA graphs: the
    prefill graphs' outputs and static inputs (each engine's within its
    budget), the decode graphs' outputs."""
    engines = _prefill_engines(fe)
    over = [(e.graph_bytes(), e.graphs.budget) for e in engines
            if e.graphs.budget is not None
            and e.graph_bytes() > e.graphs.budget]
    assert not over, f"prefill graphs over their budget: {over}"
    return sum(e.graph_bytes() for e in engines) + sum(
        n.engine.graphs.held_bytes for g in fe.groups.values()
        for n in g.decodes)


def prefill_graph_note(fe) -> str:
    """The prefill graphs of a frontend's engines, for a served phase's
    log line."""
    from repro_torch.serving.step_graph import prefill_compile_count
    engines = _prefill_engines(fe)
    return (f"prefill graphs: {prefill_compile_count()} keys in the "
            f"process, {sum(e.graphs.captures for e in engines)} captured "
            f"and {sum(e.graphs.replays for e in engines)} replayed here")


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
       MEASURED card walls and blocking transfer, arrivals 50 ms apart:
       a P->D flip over the same params, and the new decode node serves;
    D. an AutoScaler over a one-prefill-heavy, one-decode-heavy NodePool,
       a burst then a trickle from 1P:1D: scale up and down, tokens of a
       static run, memory back to params + live pools + the live
       engines' graphs (the prefill graphs keep their outputs);
    E. decode-side absorption: 1P:1D (prefill batch 2) with
       ``absorb_prefill=True`` and an AutoScaler over an EMPTY NodePool
       (JAX's exhausted-pool scenario at full width), three decoded
       requests, then a burst of eight prefill-complete ones: scale-up
       denied, at least one request absorbed by the idle decode node in
       16-token chunks, every first token equal to a monolithic prefill
       of its prompt, two runs with equal event logs, memory back to
       params + live pools + the live engines' graphs.

    Returns the kernels' launch counts over A-D and over E."""
    from repro_torch.core.mlops import SLOSpec
    from repro_torch.core.perf_model import InstanceProfile, optimal_ratio
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.autoscale import AutoScaler, NodePool
    from repro_torch.serving.cluster import DecodeNode
    from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                            FaultPlan)
    from repro_torch.serving.frontend import ClusterFrontend
    from repro_torch.serving import step_graph

    svc = DeterministicService()
    one = dict(params=params, device="cuda", prefill_kwargs={"batch_size": 1})
    zero_counts()
    graphs0 = (step_graph.captures, step_graph.capture_s)

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
    # arrivals 50 ms apart (virtual), so that prompts still arrive after
    # the flip completes whatever the decode step's wall: with 2 ms apart
    # every request can be admitted before the drained prefill node
    # rejoins as a decode node, which then has nothing to serve
    run_control(torch, card, "control C adjust", fe, reqs,
                at=[0.05 * i for i in range(len(reqs))])
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
    kept = graph_bytes(fe)
    left = torch.cuda.memory_allocated() - base - pool_bytes(fe) - kept
    block = (cfg.num_layers * 16 * 2 * cfg.kv_dim * 4)
    assert abs(left) <= block, \
        f"{left} bytes beyond params + live pools + live graphs"
    log(f"[control D] scale ops {ops}; pool {pool.ledger()}; ratio now "
        f"{g.ratio}; tokens == the static run's; allocated after the run = "
        f"before + live pools {pool_bytes(fe)} B + the live engines' "
        f"graphs {kept} B + {left} B (one block {block} B); "
        f"{prefill_graph_note(fe)} [{card}]")
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
        nbytes = node.pool.full_storage.numel() \
            * node.pool.full_storage.element_size()
        del node
    log(f"[control] a fresh granite decode node ({nbytes} B pool): "
        f"{builds[0]:.2f} ms after empty_cache, then "
        f"{builds[1]:.2f} / {builds[2]:.2f} ms [{card}]")
    missing = unlaunched(counts)
    assert not missing, f"kernels never launched on the control path: {missing}"
    n_cap = step_graph.captures - graphs0[0]
    cap_s = step_graph.capture_s - graphs0[1]
    log(f"[control] launches {counts}; {n_cap} step graphs captured by "
        f"the decode engines of A-E (each new engine's first step at a "
        f"key: after a crash, a flip, a scale-up), {cap_s:.3f} s of capture "
        f"wall, {cap_s / max(n_cap, 1) * 1e3:.1f} ms each [{card}]")
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
    kept = graph_bytes(fe)
    left = torch.cuda.memory_allocated() - base - pool_bytes(fe) - kept
    block = (cfg.num_layers * 16 * 2 * cfg.kv_dim * 4)
    assert abs(left) <= block, \
        f"{left} bytes beyond params + live pools + live graphs"
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
        f"before + live pools {pool_bytes(fe)} B + the live engines' "
        f"graphs {kept} B + {left} B; {prefill_graph_note(fe)} [{card}]")
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


# ------------------------------------------------------------ phase 10

SPEC_PATH = f"{ARCH}/spec"
EAGER_PATH = f"{ARCH}/eager"
EXACT_PATH = f"{ARCH}/exact"


def capture_rows(fe, store: dict):
    """Keep a copy of each finished request's committed KV rows (prompt +
    max_new_tokens positions) from the decode node's pool in
    ``store[rid]``. The hook on ``pool.release`` only notes the request:
    its blocks stay its own until the returned ``flush`` (called after
    the run) copies the rows and releases them, so the copy stays out of
    the timed decode steps. Plain indexing, no kernel launch: the launch
    counts stay the path's own. The hook holds the node and pool weakly,
    so a dropped cluster is freed at once, as without it."""
    import torch
    node = fe.groups["default"].decodes[0]
    node_ref, pool_ref = weakref.ref(node), weakref.ref(node.pool)
    held: dict = {}

    def hold(rid):
        node, pool = node_ref(), pool_ref()
        req = node.requests.get(rid)
        if req is not None and pool.owned(rid):
            held[rid] = len(req.tokens) + req.max_new_tokens
        else:
            type(pool).release(pool, rid)

    def flush():
        pool = pool_ref()
        st = pool.storage
        for rid, n in held.items():
            idx = torch.tensor(pool.owned(rid), dtype=torch.long,
                               device=st.device)
            store[rid] = st[:, idx].reshape(st.shape[0], -1,
                                            st.shape[-1])[:, :n].clone()
            type(pool).release(pool, rid)
        held.clear()
        del pool.release
    node.pool.release = hold
    return flush


def legacy_waves(cfg):
    """Phase 4's four requests, then a fifth with request 0's prompt (a
    warm prefix hit: the kv_gather of the cached prefix, a suffix-only
    prefill)."""
    from repro_torch.serving.cluster import ServeRequest
    reqs = make_requests(cfg, 4, 200, 480, 16, seed=11)
    return [reqs, [ServeRequest(rid=4, tokens=list(reqs[0].tokens),
                                max_new_tokens=16)]]


def phase_legacy(torch, card: str, cfg, params, golden: dict,
                 golden_rows: dict) -> dict:
    """Speculation and the legacy baselines on the main path's full-width
    granite-3-8b params, each 1P:1D overlapped over ``legacy_waves``
    (phase 4's prompts, then a warm repeat of the first), 16 new tokens:

    a. spec, self-draft: the target's own params and config as the draft,
       k=4: every proposal accepted, k+1 = 5 tokens per step until the
       budget cut;
    b. spec, ``spec="auto"``: ``draft_for``'s seeded 2-layer draft at
       granite width (acceptance near 0);
    c. eager decode (``fused=False``);
    d. exact-length prefill (``bucket_prefill=False``).

    Each returns phase 4's tokens (the warm repeat those of request 0)
    and logs its decode step median, tokens per step, spec_emitted /
    spec_steps, the draft-admission prefill walls, peak memory and the
    max |delta| of its committed pool rows against phase 4's run.
    Launches are counted under the paths granite-3-8b/spec (a and b),
    /eager and /exact; every kernel must launch on each. Then granite
    reduced under the staged tick shim: its tokens equal the tickless
    core's. Returns {path: counts}."""
    from repro_torch.serving.frontend import ClusterFrontend
    from repro_torch.serving.speculative import SpecConfig

    want = dict(golden)
    want[4] = golden[0]
    want_rows = dict(golden_rows)
    want_rows[4] = golden_rows[0]
    runs = [("spec self-draft", SPEC_PATH,
             dict(spec=SpecConfig(cfg, params, k=4))),
            ("spec draft_for", SPEC_PATH, dict(spec="auto")),
            ("eager", EAGER_PATH, dict(decode_kwargs={"fused": False})),
            ("exact", EXACT_PATH,
             dict(prefill_kwargs={"bucket_prefill": False}))]
    counts: dict = {}
    for tag, path, kw in runs:
        free_card(torch)
        fe = ClusterFrontend(cfg, params=params, device="cuda", **kw)
        g = fe.groups["default"]
        eng = g.decodes[0].engine
        rows, bursts, draft_ms = {}, [], []
        flush = capture_rows(fe, rows)
        # hooks on the engine hold it weakly: no reference cycle keeps a
        # dropped cluster (and the card memory it holds) alive
        eng_ref = weakref.ref(eng)

        def recorded_step(bursts=bursts):
            e = eng_ref()
            res = type(e).step(e)
            bursts.append({e.rid[s]: len(t) for s, t in res.items()})
            return res
        eng.step = recorded_step
        if eng.spec is not None:
            def timed(*a, draft_ms=draft_ms):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e = eng_ref()
                type(e)._admit_draft(e, *a)
                torch.cuda.synchronize()
                draft_ms.append((time.perf_counter() - t0) * 1e3)
            eng._admit_draft = timed
        waves = legacy_waves(cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        serve(torch, card, f"legacy {tag}", fe, waves)
        c = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        flush()
        acc = counts.setdefault(path, dict.fromkeys(c, 0))
        for n, v in c.items():
            acc[n] += v
        reqs = [r for wave in waves for r in wave]
        assert_tokens(torch, cfg, params, f"legacy {tag}", reqs, want)
        assert sorted(rows) == sorted(want_rows), (tag, sorted(rows))
        # requests 0-3 share phase 4's prefill batch; 4 is the warm repeat
        # (a suffix-only prefill) against request 0's cold rows
        delta = max((rows[r] - want_rows[r]).abs().max().item()
                    for r in range(4))
        same = all(torch.equal(rows[r], want_rows[r]) for r in range(4))
        warm_delta = (rows[4] - want_rows[4]).abs().max().item()
        per_rid: dict = {}
        for b in bursts:
            for rid, n in b.items():
                per_rid.setdefault(rid, []).append(n)
        emitted = sum(len(r.generated) - 1 for r in reqs)
        slot_steps = sum(len(b) for b in bursts)
        line = (f"[legacy {tag}] tokens == phase 4's (the warm repeat == "
                f"request 0's); decode step median "
                f"{statistics.median(g.decode_step_s) * 1e3:.2f} ms over "
                f"{len(g.decode_step_s)} steps, {emitted / len(bursts):.3f} "
                f"tokens retired per step ({emitted / slot_steps:.3f} per "
                f"slot and step); committed pool rows vs phase 4: requests "
                f"0-3 max |delta| {delta:.3e} (bitwise {same}), the warm "
                f"repeat {warm_delta:.3e}; peak {peak:.2f} GiB; "
                f"prefix hits {int(g.prefix_stats()['hits'])}")
        if eng.spec is not None:
            k = eng.spec.k
            line += (f"; k={k}, {eng.spec.draft_cfg.num_layers}-layer "
                     f"draft; spec_emitted / spec_steps = "
                     f"{eng.spec_emitted} / {eng.spec_steps} = "
                     f"{eng.spec_emitted / eng.spec_steps:.3f} "
                     f"({eng.spec_emitted / slot_steps:.3f} per slot and "
                     f"step); draft "
                     f"admission prefill ms "
                     f"{[round(x, 1) for x in draft_ms]}; bursts per "
                     f"request {per_rid}")
            assert eng.spec_steps > 0 and len(draft_ms) == len(reqs)
            if tag == "spec self-draft":
                assert all(n == k + 1 for b in per_rid.values()
                           for n in b[:-1]), per_rid
        elif tag == "eager":
            assert eng.eager_steps > 0 and eng.fused_steps == 0
        else:
            pe = g.prefills[0].engine
            assert not pe.bucket_prefill and pe.padded_tokens == 0
            line += f"; {pe.prefill_batches} exact-length prefills"
        log(line + f" [{card}]")
        missing = unlaunched(c)
        assert not missing, f"kernels never launched in {tag}: {missing}"
        del fe, g, eng, rows, reqs, waves
    for path, c in counts.items():
        log(f"[legacy] launches on {path}: {c} [{card}]")
    staged_vs_tickless(torch)
    return counts


def staged_vs_tickless(torch) -> None:
    """granite-3-8b reduced on the card under the staged tick shim
    (``tickless=False``) and the tickless core, warm hits included:
    equal tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving.cluster import MiniCluster
    cfg = get_config(ARCH).reduced()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         device="cuda")
    runs, ticks = {}, 0
    for tickless in (True, False):
        mc = MiniCluster(cfg, params=params, device="cuda",
                         tickless=tickless)
        reqs = make_requests(cfg, 6, 34, 40, 6, seed=3)
        reqs[4].tokens = reqs[0].tokens[:32] + reqs[4].tokens[:5]
        mc.run(reqs, max_ticks=400)
        assert all(r.done for r in reqs), tickless
        runs[tickless] = {r.rid: list(r.generated) for r in reqs}
        if not tickless:
            ticks = mc.frontend.tick_no
    assert runs[True] == runs[False], runs
    log(f"[legacy] {cfg.name} staged tick shim ({ticks} ticks) tokens == "
        f"tickless tokens for {len(runs[True])} requests")


# ------------------------------------------------------------ phase 11

SIM_PATH = f"{ARCH}/sim"
FIT_PROMPT = 512                # prefill walls at full 512-token buckets
FIT_BATCHES = (1, 2, 4)         # prompts per prefill batch
FIT_SLOTS = (1, 2, 4, 8)        # active slots per decode step
FIT_REPEATS = 5                 # timed walls per point, after a warm-up
XCHECK_GAP_S = 0.2              # mean gap of the cross-check's arrivals
XCHECK_SLO_S = 1e6              # no request of the cross-check times out
SIM_HORIZON_S = 60.0            # simulated seconds of arrivals ...
SIM_DRAIN_S = 60.0              # ... and of draining after them
SIM_SEED = 17
# offered rates of the saturation sweep (req/s), sqrt(2) apart
SIM_RATES = tuple(0.125 * 2 ** (k / 2) for k in range(16))


def _linear_fit(xs, ys):
    """Least-squares intercept and slope of ``ys`` on ``xs``, and the
    residuals."""
    import numpy as np
    slope, icept = np.polyfit(np.asarray(xs, float), np.asarray(ys, float),
                              1)
    res = [float(y - (icept + slope * x)) for x, y in zip(xs, ys)]
    return float(icept), float(slope), res


def measure_profile(torch, card: str, cfg, params):
    """Phase 11 (a): a ServingProfile fitted by least squares to the real
    engines' walls (host clock after a card sync, as ``decode_step_s``
    takes them; medians of FIT_REPEATS after a warm-up): prefill batches
    of b prompts of FIT_PROMPT tokens give ``prefill_fixed`` and
    ``prefill_tok_rate``; fused decode steps at FIT_SLOTS active slots,
    whose requests each crossed one blocking block-free transfer
    (kv_gather + kv_scatter), give ``tpot_base`` and ``tpot_per_req``;
    the KV bytes per token and the params bytes are those of the pool
    and params that ran. Returns (profile, attention layers)."""
    import math

    import numpy as np
    from repro_torch.core.profiles import (CARDS_PER_INSTANCE,
                                           ServingProfile, profile_for)
    from repro_torch.core.transfer import KVTransferEngine
    from repro_torch.models.params import tree_leaves
    from repro_torch.serving.cluster import DecodeNode, ServeRequest
    from repro_torch.serving.engine import PrefillEngine
    from repro_torch.serving.kvcache import PagedKVPool
    from repro_torch.serving.step_graph import eager_twin

    rng = np.random.default_rng(23)
    n = max(FIT_SLOTS)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size, FIT_PROMPT)]
               for _ in range(n)]
    pe = PrefillEngine(cfg, params)
    pe_eager = PrefillEngine(cfg, params, jit_prefill=False)
    pre, pre_eager = {}, {}
    for b in FIT_BATCHES:
        for _ in range(2):                # eager, then the capture
            pe.run(prompts[:b])
        pre[b] = _sync_ms(torch, lambda: pe.run(prompts[:b]),
                          FIT_REPEATS) / 1e3
        # the same batch through the eager forward
        pre_eager[b] = _sync_ms(torch, lambda: pe_eager.run(prompts[:b]),
                                FIT_REPEATS) / 1e3
    del pe_eager
    outs = pe.run(prompts[:max(FIT_BATCHES)])
    steps = (FIT_REPEATS + 1) * len(FIT_SLOTS)     # no request finishes
    dev = params["embed"].device
    src = PagedKVPool(cfg, num_blocks=FIT_PROMPT // 16, device=dev)
    dn = DecodeNode("D0", cfg, params, max_slots=n,
                    num_blocks=n * src.blocks_for_tokens(
                        FIT_PROMPT + steps + 1))
    xfer = KVTransferEngine()
    dec, dec_eager = {}, {}
    for slots in FIT_SLOTS:
        while len(dn.requests) < slots:
            rid = len(dn.requests)
            out = outs[rid % len(outs)]
            src.write_prefill(src.alloc(rid, FIT_PROMPT), out.k, out.v)
            dn.admit(ServeRequest(rid=rid, tokens=prompts[rid],
                                  max_new_tokens=steps), out, src, xfer)
        dn.step()
        dec[slots] = _sync_ms(torch, dn.step, FIT_REPEATS) / 1e3
        # the same step at the same shapes run eagerly (no graph), on
        # clones of the engine's inputs
        eager = eager_twin(dn.engine)
        eager()
        dec_eager[slots] = _sync_ms(torch, eager, FIT_REPEATS) / 1e3
        del eager
    assert dn.engine.graphs.captures == 1, dn.engine.graphs.captures
    pool = dn.pool
    p_fixed, p_slope, p_res = _linear_fit(
        [b * FIT_PROMPT for b in FIT_BATCHES], [pre[b] for b in FIT_BATCHES])
    d_base, d_slope, d_res = _linear_fit(FIT_SLOTS,
                                         [dec[s] for s in FIT_SLOTS])
    e_base, e_slope, _ = _linear_fit(FIT_SLOTS,
                                     [dec_eager[s] for s in FIT_SLOTS])
    prof = ServingProfile(
        name=f"{cfg.name} on one card, measured",
        kv_bytes_per_token=pool.width * pool.attn_layers
        * pool.storage.element_size(),
        prefill_tok_rate=1.0 / p_slope, prefill_fixed=p_fixed,
        tpot_base=d_base, tpot_per_req=d_slope,
        params_bytes=sum(t.numel() * t.element_size()
                         for t in tree_leaves(params)))
    ana = profile_for(cfg)
    per_card_rate = ana.prefill_tok_rate / CARDS_PER_INSTANCE
    per_card_floor = ana.tpot_base * CARDS_PER_INSTANCE
    log(f"[sim] prefill batch walls (b x {FIT_PROMPT} tokens: ms) "
        f"{ {b: round(w * 1e3, 2) for b, w in pre.items()} } on the "
        f"replayed prefill graphs, eager "
        f"{ {b: round(w * 1e3, 2) for b, w in pre_eager.items()} }; fit "
        f"{p_fixed * 1e3:.3f} ms + tokens / {1.0 / p_slope:.1f} tok/s, "
        f"residuals {[round(r * 1e3, 3) for r in p_res]} ms [{card}]")
    log(f"[sim] decode step walls (active slots: ms) "
        f"{ {s: round(w * 1e3, 3) for s, w in dec.items()} }; fit "
        f"{d_base * 1e3:.3f} ms + {d_slope * 1e3:.4f} ms x slots, "
        f"residuals {[round(r * 1e3, 3) for r in d_res]} ms; "
        f"{len(xfer.stats)} blocking transfers [{card}]")
    log(f"[sim] decode floor: {d_base * 1e3:.3f} ms on the replayed step "
        f"graph (the fit above) against {e_base * 1e3:.3f} ms + "
        f"{e_slope * 1e3:.4f} ms x slots on the same step run eagerly, "
        f"walls {({s: round(w * 1e3, 3) for s, w in dec_eager.items()})} "
        f"ms [{card}]")
    log(f"[sim] measured profile (one card): {prof} [{card}]")
    log(f"[sim] analytic profile_for (an instance of {CARDS_PER_INSTANCE} "
        f"cards at the published f32 and HBM rates, assumed MFU and HBM "
        f"shares): {ana}; per card {per_card_rate:.1f} tok/s, decode floor "
        f"{per_card_floor * 1e3:.3f} ms")
    log(f"[sim] measured / analytic per card: prefill rate "
        f"{prof.prefill_tok_rate / per_card_rate:.4f}, decode floor "
        f"{prof.tpot_base / per_card_floor:.3f}, KV bytes per token "
        f"{prof.kv_bytes_per_token / ana.kv_bytes_per_token:.3f}, params "
        f"bytes {prof.params_bytes / ana.params_bytes:.4f}")
    assert all(math.isfinite(x) for x in (
        prof.prefill_tok_rate, prof.prefill_fixed, prof.tpot_base,
        prof.tpot_per_req)), prof
    assert prof.prefill_tok_rate > 0 and prof.prefill_fixed > 0 \
        and prof.tpot_base > 0, prof
    return prof, pool.attn_layers


def cross_check(torch, card: str, cfg, params, prof, layers: int) -> None:
    """Phase 11 (b): eight requests of phase 4's prompt lengths, 16 new
    tokens, seeded Poisson arrivals, through the real ClusterFrontend
    (1P:1D, overlapped), and the same arrivals and lengths through
    ClusterSim(1P:1D) with the engines' batch sizes and the measured
    profile: TTFT p50 and mean TPOT (decode time per token after the
    first), real and simulated, in virtual seconds. A measurement, not a
    gate."""
    import numpy as np
    from repro_torch.core.cluster_sim import ClusterSim, SimConfig, \
        run_workload
    from repro_torch.core.requests import Request
    from repro_torch.serving.frontend import ClusterFrontend

    reqs = make_requests(cfg, 8, 200, 480, 16, seed=11)
    gaps = np.random.default_rng(29).exponential(XCHECK_GAP_S, len(reqs))
    arrivals = [float(t) for t in np.cumsum(gaps) - gaps[0]]
    fe = ClusterFrontend(cfg, params=params, device="cuda")
    for r, t in zip(reqs, arrivals):
        fe.submit(r, at=t)
    fe.serve(watch=reqs)
    torch.cuda.synchronize()
    assert all(r.done and len(r.generated) == r.max_new_tokens + 1
               for r in reqs)
    g = fe.groups["default"]
    sim = ClusterSim(SimConfig(
        profile=prof, b_p=g.prefills[0].batch_size,
        b_d=g.decodes[0].engine.max_slots, batch_window=0.0,
        per_layer_transfer=g.overlap_transfer, layers=layers,
        link=fe.xfer.link), n_prefill=1, n_decode=1)
    sreqs = [Request(rid=r.rid, scenario="default", prefix_id=f"r{r.rid}",
                     prefix_len=0, prompt_len=len(r.tokens),
                     output_tokens=r.max_new_tokens, arrival=t,
                     slo_ttft=XCHECK_SLO_S)
             for r, t in zip(reqs, arrivals)]
    m = run_workload(sim, sreqs, arrivals[-1] + SIM_DRAIN_S)
    assert m["completed"] == len(sreqs), m

    def p50(xs):
        xs = sorted(xs)
        return xs[len(xs) // 2]

    real_ttft = p50(r.first_token_t - r.submit_t for r in reqs)
    real_tpot = statistics.mean((r.finish_t - r.first_token_t)
                                / r.max_new_tokens for r in reqs)
    sim_ttft = p50(r.ttft for r in sreqs)
    sim_tpot = statistics.mean((r.t_done - r.t_prefill_done)
                               / r.output_tokens for r in sreqs)
    log(f"[sim] cross-check, {len(reqs)} requests (prompts "
        f"{[len(r.tokens) for r in reqs]}, arrivals "
        f"{[round(t, 3) for t in arrivals]} s): real prefill batches "
        f"{[round(x * 1e3, 1) for x in g.prefill_batch_s]} ms, decode "
        f"step median {statistics.median(g.decode_step_s) * 1e3:.2f} ms; "
        f"TTFT p50 real {real_ttft * 1e3:.1f} ms, sim {sim_ttft * 1e3:.1f} "
        f"ms (sim / real {sim_ttft / real_ttft:.3f}); mean TPOT real "
        f"{real_tpot * 1e3:.2f} ms, sim {sim_tpot * 1e3:.2f} ms (sim / real "
        f"{sim_tpot / real_tpot:.3f}) [{card}]")


def paper_scale(prof, layers: int) -> dict:
    """Phase 11 (c), on the host: the paper's comparisons on the measured
    profile with DEFAULT_SCENARIOS traffic (SIM_HORIZON_S of seeded
    Poisson arrivals, SIM_DRAIN_S to drain). Each offered rate is a share
    of the saturation rate of the comparison's on-demand configuration:
    the highest rate of the SIM_RATES sweep at which it still completes
    99% of the requests. Returns {name: metrics dict}."""
    from repro_torch.core.aggregated import AggregatedSim
    from repro_torch.core.cluster_sim import ClusterSim, SimConfig, \
        run_workload
    from repro_torch.core.requests import DEFAULT_SCENARIOS, \
        WorkloadGenerator

    horizon = SIM_HORIZON_S + SIM_DRAIN_S

    def workload(rate, services=None):
        reqs = WorkloadGenerator(DEFAULT_SCENARIOS, base_rps=rate,
                                 seed=SIM_SEED).arrivals(SIM_HORIZON_S)
        return [r for r in reqs if services is None
                or r.scenario.split("/")[0] in services]

    def run(rate, n_p, n_d, policy="ondemand", services=None, **kw):
        sim = ClusterSim(SimConfig(profile=prof, layers=layers, **kw),
                         n_prefill=n_p, n_decode=n_d, policy=policy,
                         seed=SIM_SEED)
        return run_workload(sim, workload(rate, services), horizon)

    def saturation(n_p, n_d):
        held = SIM_RATES[0]
        for rate in SIM_RATES:
            if run(rate, n_p, n_d)["success_rate"] < 0.99:
                break
            held = rate
        return held

    out = {}
    sat = saturation(2, 6)
    out["saturation 2P:6D"] = {"rate": sat}
    for share in (1.0, 2.0, 4.0):
        for policy in ("ondemand", "baseline"):
            out[f"forwarding {policy} 2P:6D x{share}"] = run(
                share * sat, 2, 6, policy)
    for name, kw in (("block_free", {}),
                     ("block_free per-layer", {"per_layer_transfer": True}),
                     ("block_fixed", {"transfer_mode": "block_fixed"})):
        out[f"transfer {name} 2P:6D x0.5"] = run(0.5 * sat, 2, 6, **kw)
    sat16 = saturation(8, 8)
    out["saturation 8P:8D"] = {"rate": sat16}
    for share in (1.0, 2.0):
        out[f"disaggregated 8P:8D x{share}"] = run(share * sat16, 8, 8)
        out[f"aggregated 16 x{share}"] = AggregatedSim(
            prof, n_instances=16, seed=SIM_SEED).run(
                workload(share * sat16), horizon)
    sat_mixed = saturation(6, 12)
    out["saturation mixed 6P:12D"] = {"rate": sat_mixed}
    out["mixed pool 6P:12D x1.0"] = run(sat_mixed, 6, 12)
    for svc in sorted({s.service for s in DEFAULT_SCENARIOS}):
        out[f"group {svc} 3P:6D x1.0"] = run(sat_mixed, 3, 6,
                                             services={svc})
    return out


def phase_sim(torch, card: str, cfg, params) -> dict:
    """Phase 11, on phase 4's params after phase 10: (a) the measured
    profile, (b) the real-vs-simulated cross-check, (c) the paper-scale
    runs on the measured profile, twice with the same seed (equal
    dicts). Launches are counted under SIM_PATH; (a) alone launches
    every kernel. Returns the counts."""
    free_card(torch)
    zero_counts()
    prof, layers = measure_profile(torch, card, cfg, params)
    missing = unlaunched(read_counts())
    assert not missing, f"kernels never launched by the measurement: " \
        f"{missing}"
    cross_check(torch, card, cfg, params, prof, layers)
    counts = read_counts()
    t0 = time.perf_counter()
    runs = [paper_scale(prof, layers) for _ in range(2)]
    wall = time.perf_counter() - t0
    assert runs[0] == runs[1], "the simulator is not deterministic"
    for name, m in runs[0].items():
        log(f"[sim] {name}: {json.dumps(m)}")
    log(f"[sim] paper-scale runs on the measured profile: {len(runs[0])} "
        f"results, twice, equal; {wall:.1f} s of host wall; launches on "
        f"{SIM_PATH}: {counts} [{card}]")
    free_card(torch)
    return counts


def phase_path(torch, card: str, out: Path, arch: str, tag: str,
               then=None):
    """A full-width decoder path through phase 4's four prompts, 1P:1D,
    overlapped then blocking: equal tokens, every kernel launched; then a
    profiled run, the fused step's graph against eager and a replayed
    prefill batch against eager. The MoE path (qwen2-moe-a2.7b: 60 routed
    experts top-4 and 4 shared, capacity dispatch), the VLM backbone
    (pixtral-12b, token-only as the JAX package serves it), the paper's
    serving target (pangu-38b: 48/8 heads of 128, 6 query heads a KV head)
    and the fine-grained MoE (deepseek-moe-16b: 64 routed experts top-6
    and 2 shared, capacity dispatch). ``then(torch, card, cfg, params)``
    runs last on the same params (a MoE path's sorted dispatch); returns
    (counts, what ``then`` returned or None)."""
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
    de = decode_engine(torch, cfg, params,
                       make_requests(cfg, 4, 200, 480, 16, seed=11))[0]
    graph_vs_eager(torch, card, f"graphs {arch}", de)
    del de
    prefill_vs_eager(torch, card, arch, cfg, params, [
        r.tokens for r in make_requests(cfg, 4, 200, 480, 16, seed=11)],
        timed=SERVED_TIMED, profiled=SERVED_PROFILED)
    more = None if then is None else then(torch, card, cfg, params)
    del params
    free_card(torch)
    return counts, more


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
    kv = {n: c for n, c in counts.items() if n != "skinny_mm"}
    assert not any(kv.values()), f"KV kernels launched: {counts}"
    assert counts["skinny_mm"] > 0, counts   # the decode steps' products
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
    de = decode_engine(torch, cfg, params,
                       [r for wave in ssm_waves(cfg) for r in wave])[0]
    graph_vs_eager(torch, card, f"graphs {SSM_ARCH}", de)
    del de
    # the cold prompts with the node's snapshot stride (256: the SSD
    # chunk and the block size's lcm)
    prefill_vs_eager(torch, card, SSM_ARCH, cfg, params,
                     [r.tokens for wave in ssm_waves(cfg) for r in wave],
                     snap_stride=math.lcm(cfg.ssm_cfg.chunk, 16),
                     timed=SERVED_TIMED, profiled=SERVED_PROFILED)
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
    de = decode_engine(torch, cfg, params,
                       [r for wave in encdec_waves(cfg) for r in wave])[0]
    graph_vs_eager(torch, card, f"graphs {ENCDEC_ARCH}", de)
    del de
    reqs = [r for wave in encdec_waves(cfg) for r in wave]
    prefill_vs_eager(torch, card, ENCDEC_ARCH, cfg, params,
                     [r.tokens for r in reqs],
                     frames=[r.frames for r in reqs], timed=SERVED_TIMED,
                     profiled=SERVED_PROFILED)
    del params
    free_card(torch)
    return counts


def kind_of(name: str, low: str) -> str:
    """A serving kernel's kind, by its name (``low``: lowercased)."""
    return ("flash_prefill" if "flash_prefill" in name else
            "paged_attention" if "paged_attention" in name else
            "kv_scatter" if "kv_scatter" in name else
            "kv_gather" if "kv_gather" in name else
            "grouped_mm" if any(k in name for k in GROUPED_KERNELS) else
            "copy" if "memcpy" in low or "memset" in low else
            "gemm/gemv" if ("gemm" in low or "gemv" in low
                            or "cutlass" in low) else "other")


def device_ms_by_kind(prof, kind_of) -> dict:
    """Self device ms of a profile's kernels summed by
    ``kind_of(name, name.lower())``."""
    kinds: dict = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0.0)
        if not dev_us or "CUDA" not in str(getattr(ev, "device_type", "")):
            continue
        kind = kind_of(ev.key, ev.key.lower())
        kinds[kind] = kinds.get(kind, 0.0) + dev_us / 1e3
    return kinds


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
    kinds = device_ms_by_kind(prof, kind_of)
    total = sum(kinds.values())
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


# ------------------------------------------------------------ training

# ------------------------------------------------------------ phase 13

WINDOW_PATH = f"{ARCH}/window"
WINDOW_DECODE_STEPS = 16
WINDOW_CHECK = (15, 8)      # decoded tokens the longer prefill reproduces
WITHIN_S = 4096             # a prompt inside the window
PLAN_TOL = 0.02             # planned bytes against memory_allocated


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def _rule_table_on_mesh(torch, cfg, params, ring) -> None:
    """A 1x1 NCCL DeviceMesh (world size 1): a few full-width leaves (the
    embedding, the first block's wq, a ring-shaped cache's k) distributed
    by the rule table as DTensors, their local shapes those of the rule
    table's slices; constrain() under sharding_ctx redistributes each to
    the activation rules' layout, values unchanged."""
    import torch.distributed as dist
    from repro_torch.distribution.ctx import (ACT_RULES, constrain,
                                              sharding_ctx)
    from repro_torch.distribution.sharding import (
        CACHE_RULES, PARAM_RULES_2D, distribute, local_slices, mesh_axes,
        placements, spec_from_axes)
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.caches import cache_axes
    from repro_torch.models.params import param_axes
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        mesh = make_device_mesh({"data": 1, "model": 1})
        shape = mesh_axes(mesh)
        p_axes = param_axes(cfg)
        c_axes = cache_axes(cfg, 1, WINDOW_W, window=WINDOW_W)
        leaves = [("embed", params["embed"], p_axes["embed"],
                   PARAM_RULES_2D),
                  ("blocks/sub0/wq", params["blocks"]["sub0"]["wq"],
                   p_axes["blocks"]["sub0"]["wq"], PARAM_RULES_2D),
                  ("ring k", ring["layers"]["sub0"]["k"],
                   c_axes["layers"]["sub0"]["k"], CACHE_RULES)]
        for name, leaf, axes, rules in leaves:
            spec = spec_from_axes(axes, tuple(leaf.shape), shape, rules)
            dt = distribute(leaf, spec, mesh)
            want = [sl.stop - sl.start for sl in local_slices(
                spec, tuple(leaf.shape), shape)[(0, 0)]]
            assert list(dt.to_local().shape) == want, (name, spec)
            with sharding_ctx(mesh):
                ct = constrain(dt, axes)
            want_pl = placements(spec_from_axes(
                axes, tuple(leaf.shape), shape, ACT_RULES), mesh)
            assert list(ct.placements) == want_pl, (ct.placements, want_pl)
            assert torch.equal(ct.to_local(), leaf)
            log(f"[window] mesh {shape}: {name} {tuple(leaf.shape)} spec "
                f"{spec} -> DTensor {dt.placements}, local "
                f"{tuple(dt.to_local().shape)}")
            del dt, ct
    finally:
        dist.destroy_process_group()


_STORE_PROBE = """
import shutil, sys, torch
from repro_torch.kernels import build, ref
from repro_torch.kernels import flash_prefill as fp
from repro_torch.launch.precompile import ArtifactStore
assert shutil.which("nvcc") is None, shutil.which("nvcc")
def no_build(*a, **k):
    raise AssertionError("a build was started")
build.build = no_build
build._nvcc = no_build
step, man = ArtifactStore(sys.argv[1]).load(sys.argv[2])
assert sys.argv[1] in build._lib._name, build._lib._name
g = torch.Generator(device="cuda").manual_seed(0)
q = torch.randn((1, 512, 32, 128), generator=g, device="cuda")
k, v = (torch.randn((1, 512, 8, 128), generator=g, device="cuda")
        for _ in range(2))
err = (fp.flash_prefill_cuda(q, k, v, window=100)
       - ref.flash_prefill(q, k, v, window=100)).abs().max().item()
assert err <= 1e-5, err
print(fp.launches, fp.window_launches, round(man["load_s"], 4), err)
"""


def _store_without_nvcc(torch, store, key: str) -> None:
    """Load the stored library in a fresh process whose PATH holds no
    nvcc, and launch flash prefill there once."""
    path = os.pathsep.join(p for p in os.environ["PATH"].split(os.pathsep)
                           if not (Path(p) / "nvcc").exists())
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-c", _STORE_PROBE, str(store.root), key],
        env={**os.environ, "PATH": path, "PYTHONPATH": str(SRC)},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    launches, wl, load_s, err = res.stdout.split()
    assert (launches, wl) == ("1", "1"), res.stdout
    log(f"[window] store: a process with no nvcc on PATH loaded "
        f"{key} in {load_s} s and launched flash prefill once from it "
        f"(window mode, max|err| {err}); the process took "
        f"{time.perf_counter() - t0:.1f} s")


def _profile_ring_steps(torch, card: str, out: Path, step, params, ring,
                        tok) -> float:
    """Two more ring decode steps under torch.profiler: device time by
    kind and the busy share of their wall (``<out>/profile_window.txt``).
    Returns (the busy share, the last token, the ring)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            tok, ring = step(params, ring, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kinds = device_ms_by_kind(prof, lambda name, low: (
        "gemm/gemv" if ("gemm" in low or "gemv" in low or "cutlass" in low)
        else "copy" if "memcpy" in low or "memset" in low else "other"))
    total = sum(kinds.values())
    lines = [f"profile of two ring decode steps, {WINDOW_PATH} [{card}]",
             f"wall {wall:.1f} ms; device kernel time {total:.1f} ms (busy "
             f"share {total / wall:.3f})"]
    lines += [f"  {k}: {v:.1f} ms" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])]
    (out / "profile_window.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=30))
    for line in lines:
        log(f"[profile window] {line}")
    return total / wall, tok, ring


def _ring_admission(torch, card: str, cfg, step, params, ring, tok, W):
    """The ring serve step's host share and a second sequence: the wall
    of a replay's Python call (the step returns before the card is done)
    beside its synchronized wall, GRAPH_TIMED steps each; then a clone of
    the ring, stepped once eagerly so it differs, goes through the step
    (admitted into the ring: no capture) and the first sequence after it
    (admitted back), each equal bit for bit to forward_decode run eagerly
    on a clone of its own sequence. Returns (host ms, synced ms, admission
    ms), medians and the first admission's synchronized wall."""
    from repro_torch.models.modeling import forward_decode
    from repro_torch.models.params import tree_map
    graphs, = step.graphs.values()
    host, synced = [], []
    for _ in range(GRAPH_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tok, ring = step(params, ring, tok)
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        synced.append(time.perf_counter() - t0)

    def clone(c):
        return {"layers": tree_map(lambda t: t.clone(), c["layers"]),
                "pos": c["pos"].clone()}

    def eager(c, t):
        with torch.no_grad():
            return forward_decode(cfg, params, clone(c), t.clone(),
                                  window=W)

    def same(got, want):
        return torch.equal(got[0], want[0]) \
            and torch.equal(got[1]["pos"], want[1]["pos"]) \
            and all(torch.equal(x, want[1]["layers"][sub][n])
                    for sub, c in got[1]["layers"].items()
                    for n, x in c.items())
    tok_b, other = eager(ring, tok)
    want_b, want_a = eager(other, tok_b), eager(ring, tok)
    caps, reps = graphs.captures, graphs.replays
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_b = step(params, other, tok_b)
    torch.cuda.synchronize()
    admit_ms = (time.perf_counter() - t0) * 1e3
    got_a = step(params, ring, tok)
    torch.cuda.synchronize()
    assert same(got_b, want_b) and same(got_a, want_a), \
        "an admitted sequence's step differs from the eager one"
    assert (graphs.captures, graphs.replays) == (caps, reps + 2), \
        (graphs.captures, graphs.replays)
    host_ms = statistics.median(host) * 1e3
    synced_ms = statistics.median(synced) * 1e3
    log(f"[window] ring replay: the step's call returns in {host_ms:.3f} "
        f"ms (median of {GRAPH_TIMED}; host share {host_ms / synced_ms:.3f}"
        f" of its synchronized wall {synced_ms:.2f} ms); a second "
        f"sequence of the ring's shape admitted (copied into the ring, "
        f"the first sequence copied out) and stepped in {admit_ms:.2f} ms, "
        f"the first admitted back: no capture, both == eager bit for bit "
        f"[{card}]")
    return host_ms, synced_ms, admit_ms


def phase_window(torch, card: str, out: Path) -> dict:
    """Phase 13, the long-context window (launches counted under
    WINDOW_PATH): full-width granite-3-8b, f32 seeded params, W =
    decode_window(cfg, long_500k) = 8192. The artifact store builds the
    kernel library for the key granite-3-8b/long_500k and the steps load
    from it (the first serve step is the store's warm-up). A windowed
    prefill of a seeded 8192-token prompt leaves the ring; 16 serve steps
    wrap it from the first step; one windowed prefill of prompt ++ the
    first 15 decoded tokens (8207 rows, two batch rows read at
    WINDOW_CHECK through last_index) gives the decoded tokens there; a
    4096-token prompt gives the same first token (and bitwise the same
    cache) with and without the window. The serve steps replay one CUDA
    graph; a second sequence is admitted into its ring
    (``_ring_admission``). Then, off the path: the planner
    for long_500k on a 1x1 mesh against memory_allocated (within
    PLAN_TOL), its memory term beside the decode step, the counted
    prefill flops over the prefill wall, granite's 16x16 plans for all
    four shapes (``<out>/plans_granite_16x16.json``); the rule table on a
    1x1 NCCL mesh; the store loaded with no nvcc in a subprocess.
    The windowed prefills here call ``forward_prefill(window=)`` (and the
    store's prefill step) directly, not through a PrefillEngine, so they
    run eagerly: the prefill graphs (phase 17) are the engines'."""
    from repro_torch.launch.cost import count
    from repro_torch.launch.dryrun import plan_one, summary
    from repro_torch.launch.precompile import ArtifactStore
    from repro_torch.models.caches import zeros_cache
    from repro_torch.models.config import INPUT_SHAPES
    from repro_torch.models.modeling import forward_decode, forward_prefill
    from repro_torch.models.params import abstract_params, tree_map
    from repro_torch.models.steps import decode_window, make_prefill_step

    t_phase = time.perf_counter()
    free_card(torch)
    base = torch.cuda.memory_allocated()
    cfg, params = load_params(torch, ARCH)
    shape = INPUT_SHAPES["long_500k"]
    W = decode_window(cfg, shape)
    assert W == WINDOW_W, W
    store = ArtifactStore(out / "artifacts")
    key = f"{ARCH}/long_500k"
    man = store.precompile(key, cfg, shape)
    serve_step, man = store.load(key)
    log(f"[window] store: {key} built in {man['compile_s']:.1f} s "
        f"({man['size_bytes']} bytes), loaded in {man['load_s']:.4f} s")
    prefill = make_prefill_step(cfg, window=W)
    gen = torch.Generator().manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size, (1, W), generator=gen,
                           dtype=torch.int32).cuda()

    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, ring = prefill(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    assert int(ring["pos"]) == W and ring["pos"].dtype == torch.int32 \
        and ring["layers"]["sub0"]["k"].shape[2] == W
    ring_alloc = torch.cuda.memory_allocated() - base
    toks, walls = [first], []
    for i in range(WINDOW_DECODE_STEPS):
        if i == 1:
            # the eager step on clones of the ring: the first replay's
            # reference, bit for bit (not timed)
            twin = {"layers": tree_map(lambda t: t.clone(), ring["layers"]),
                    "pos": ring["pos"].clone()}
            with torch.no_grad():
                want_tok, twin = forward_decode(cfg, params, twin,
                                                toks[-1].clone(), window=W)
        t0 = time.perf_counter()
        if i == 0:
            nxt, ring = store.warm_up(key, serve_step, params, ring,
                                      toks[-1])
        else:
            nxt, ring = serve_step(params, ring, toks[-1])
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if i == 1:
            same = torch.equal(nxt, want_tok) \
                and torch.equal(ring["pos"], twin["pos"]) \
                and all(torch.equal(x, twin["layers"][sub][n])
                        for sub, c in ring["layers"].items()
                        for n, x in c.items())
            assert same, "the replayed ring step differs from the eager one"
        toks.append(nxt)
    graphs, = serve_step.graphs.values()
    assert (graphs.captures, graphs.replays) == (1, WINDOW_DECODE_STEPS - 1)
    assert int(ring["pos"]) == W + WINDOW_DECODE_STEPS
    man = json.loads(store._paths(key)[1].read_text())
    decoded = [int(t) for t in torch.cat(toks).tolist()]
    ring_eager = {"tok": toks[-1].clone(), "cache": twin}

    def eager_step():
        with torch.no_grad():
            ring_eager["tok"], ring_eager["cache"] = forward_decode(
                cfg, params, ring_eager["cache"], ring_eager["tok"],
                window=W)
    eager_ms = _sync_ms(torch, eager_step, GRAPH_TIMED)
    eager_dev, eager_wall, _ = busy(torch, eager_step, 2)
    del twin, ring_eager, eager_step
    busy_share, tok, ring = _profile_ring_steps(torch, card, out, serve_step,
                                                params, ring, toks[-1])
    _ring_admission(torch, card, cfg, serve_step, params, ring, tok, W)
    del tok
    log(f"[window] ring step graph: captured in the store's warm-up "
        f"(warmup_s {man['warmup_s']:.3f}, capture_s "
        f"{man['capture_s']:.3f}), then {graphs.replays} replays; the first "
        f"replay == the eager step on clones of the ring bit for bit "
        f"(token, pos, every ring leaf); eager step median {eager_ms:.2f} "
        f"ms, {eager_dev:.2f} device ms a step, busy "
        f"{eager_dev / eager_wall:.3f} [{card}]")
    del ring
    free_card(torch)
    n_long = W + max(WINDOW_CHECK)
    seq = torch.cat([prompt[0], torch.cat(toks[:max(WINDOW_CHECK)])])
    ends = torch.tensor([W + j - 1 for j in WINDOW_CHECK],
                        dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        got, _ = forward_prefill(
            cfg, params, {"tokens": seq[None].expand(len(ends), -1)
                          .contiguous()}, window=W, last_index=ends)
    torch.cuda.synchronize()
    long_s = time.perf_counter() - t0
    got = got.tolist()
    want = [decoded[j] for j in WINDOW_CHECK]
    if got != want:
        for j, g in zip(WINDOW_CHECK, got):
            log(f"[window] decoded token {j}: ring {decoded[j]}, prefill "
                f"{g}")
    assert got == want, (got, want)
    log(f"[window] the {n_long}-row windowed prefill (b={len(ends)}, "
        f"{long_s:.2f} s) reproduces decoded tokens {list(WINDOW_CHECK)} of "
        f"the ring: {want}")
    within = prompt[:, :WITHIN_S].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a, ca = prefill(params, {"tokens": within})
    torch.cuda.synchronize()
    within_s = time.perf_counter() - t0
    b_, cb = make_prefill_step(cfg)(params, {"tokens": within})
    same = all(torch.equal(x, cb["layers"][sub][n])
               for sub, c in ca["layers"].items() for n, x in c.items())
    assert a.tolist() == b_.tolist() and same, (a.tolist(), b_.tolist())
    del ca, cb
    torch.cuda.synchronize()
    counts = read_counts()
    L = cfg.num_layers
    assert counts[WINDOW] == 3 * L and counts["flash_prefill"] == 4 * L, \
        counts
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = statistics.median(walls[1:]) * 1e3
    log(f"[window] {WINDOW_PATH}: W={W}; windowed prefill of {W} tokens "
        f"{prefill_s:.2f} s, of {WITHIN_S} tokens {within_s:.2f} s; "
        f"{WINDOW_DECODE_STEPS} ring decode steps (wrapping from the "
        f"first), first (the store's warm-up) {walls[0] * 1e3:.1f} ms, "
        f"median of the rest (replays) {step_ms:.2f} ms (min "
        f"{min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}; "
        f"device busy share {busy_share:.3f} of two profiled replays; "
        f"eager {eager_ms:.2f} ms in the same call); "
        f"tokens {decoded}; {WITHIN_S}-token prompt: first token "
        f"{a.tolist()} with and without the window, caches bitwise; "
        f"launches {counts}; peak memory {peak:.2f} GiB [{card}]")

    # the planner against the card
    plan = plan_one(ARCH, "long_500k", {"data": 1, "model": 1},
                    param_dtype=torch.float32)
    rl = plan["roofline"]
    planned = rl["mem_per_dev_bytes"]
    log(f"[window] planned bytes on one card {planned} (params + the "
        f"{W}-slot f32 ring + tokens) against memory_allocated {ring_alloc} "
        f"after the params and ring were built: ratio "
        f"{planned / ring_alloc:.5f}")
    assert abs(planned / ring_alloc - 1) <= PLAN_TOL, (planned, ring_alloc)
    log(f"[window] planned decode step (long_500k, 1x1, f32): memory term "
        f"{rl['memory_s'] * 1e3:.3f} ms ({rl['bytes_per_dev'] / 1e9:.2f} GB "
        f"counted), compute term {rl['compute_s'] * 1e3:.3f} ms; measured "
        f"decode step median {step_ms:.2f} ms [{card}]")
    pc = count(make_prefill_step(cfg, window=W),
               abstract_params(cfg, torch.float32),
               {"tokens": torch.empty((1, W), dtype=torch.int32,
                                      device="meta")})
    log(f"[window] counted windowed prefill ({W} tokens): "
        f"{pc.flops / 1e12:.2f} TFLOP ({pc.matmul_flops / 1e12:.2f} matmul, "
        f"{pc.kernel_flops / 1e12:.2f} attention); over the measured wall "
        f"{prefill_s:.2f} s: {pc.flops / prefill_s / 1e12:.2f} TFLOP/s "
        f"[{card}]")
    plans = [plan_one(ARCH, sh, {"data": 16, "model": 16})
             for sh in INPUT_SHAPES]
    (out / "plans_granite_16x16.json").write_text(json.dumps(plans,
                                                             indent=1))
    for p_ in plans:
        log(summary(p_))

    _rule_table_on_mesh(torch, cfg, params, zeros_cache(
        cfg, 1, W, window=W, device="cuda"))
    free_card(torch)
    _store_without_nvcc(torch, store, key)
    del params
    free_card(torch)
    log(f"[window] phase 13 wall {time.perf_counter() - t_phase:.1f} s "
        f"[{card}]")
    return counts


EXAMPLES = ("quickstart", "disaggregated_serving", "speculative_decoding",
            "train_tiny", "cluster_scale_sim", "ratio_autotuner")
# what each example's output must hold (beyond exiting 0)
EXAMPLE_MARKS = {"quickstart": "\nok\n",
                 "disaggregated_serving": "multi-group: 10/10 done",
                 "speculative_decoding": "acceptance=100.0%",
                 "train_tiny": "(improved)",
                 "cluster_scale_sim": "faults recovered:",
                 "ratio_autotuner": "served 6/6 during flips"}


def phase_examples(torch, card: str, out: Path) -> dict:
    """Phase 15: the port's six examples (``repro_torch.examples``), each
    run in this process as ``main(["--device", "cuda"])`` at its default
    (reduced) size, its output kept in ``<out>/example_<name>.txt``: exit
    0 and the line its run must print (EXAMPLE_MARKS). train_tiny writes
    its checkpoint under ``build/chip_smoke_examples/`` (deleted after).
    Launches counted under EXAMPLES_PATH."""
    import contextlib
    import importlib
    import io
    free_card(torch)
    zero_counts()
    ckpt = ROOT / "build" / "chip_smoke_examples" / "ckpt_tiny.npz"
    walls = {}
    for name in EXAMPLES:
        argv = ["--device", "cuda"]
        if name == "train_tiny":
            argv += ["--save", str(ckpt)]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(
                f"repro_torch.examples.{name}").main(argv)
        torch.cuda.synchronize()
        walls[name] = round(time.perf_counter() - t0, 1)
        text = buf.getvalue()
        (out / f"example_{name}.txt").write_text(text)
        assert rc == 0, (name, text[-2000:])
        assert EXAMPLE_MARKS[name] in text, (name, text[-2000:])
        log(f"[examples] {name} --device cuda: exit 0 in {walls[name]} s; "
            f"{text.strip().splitlines()[-1]}")
        free_card(torch)
    ckpt.unlink()
    counts = read_counts()
    log(f"[examples] all six ran on the card, walls {walls} s; launches "
        f"{counts} [{card}]")
    return counts


# every family, reduced (whisper with seeded frames, pixtral with embeds)
TRAIN_REDUCED = (TRAIN_ARCH, ARCH, MOE_ARCH, "deepseek-moe-16b", SSM_ARCH,
                 "jamba-1.5-large-398b", "mistral-nemo-12b", "pangu-38b",
                 "qwen1.5-110b", ENCDEC_ARCH, VLM_ARCH)
TRAIN_LOSS_RTOL = 1e-4   # card against CPU, relative, after 3 steps


def train_inputs(cfg, nb: dict, rng) -> dict:
    """A SyntheticLM batch (numpy) as ``cfg``'s family trains on it:
    whisper also takes seeded stub frames (b, encoder_seq, d), pixtral
    seeded embeddings (b, s, d) in place of its tokens (the VLM stub
    frontend), each at scale 0.1, as the CPU tests make them."""
    import numpy as np
    b, s = nb["labels"].shape
    if cfg.frontend == "vision":
        nb = {"embeds": (rng.normal(size=(b, s, cfg.d_model)) * 0.1
                         ).astype(np.float32), "labels": nb["labels"]}
    if cfg.is_encoder_decoder:
        nb = dict(nb, frames=(rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1
        ).astype(np.float32))
    return nb


def phase_reduced_train(torch) -> None:
    """Phase 3's training check: every family reduced (TRAIN_REDUCED),
    three AdamW steps (remat on) on the card and on the CPU from the same
    params and SyntheticLM batches (``train_inputs``): losses within
    TRAIN_LOSS_RTOL, and the card's run of a family with attention
    launched the backward kernel, whisper's also its non-causal mode (the
    encoder and cross-attention)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import flash_prefill_bwd
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.models.steps import make_train_step
    from repro_torch.training.optimizer import adamw_init

    for arch in TRAIN_REDUCED:
        cfg = get_config(arch).reduced()
        base = init_params(cfg, torch.Generator().manual_seed(7),
                           device="cpu")
        data = SyntheticLM(cfg.vocab_size, 64, 2, seed=1)
        rng = np.random.default_rng(5)
        batches = [train_inputs(cfg, data.batch(i), rng) for i in range(3)]
        losses = {}
        for dev in ("cpu", "cuda"):
            params = tree_map(lambda x: x.clone().to(dev), base)
            state, step = adamw_init(params), make_train_step(cfg)
            before = (flash_prefill_bwd.launches,
                      flash_prefill_bwd.noncausal_launches)
            losses[dev] = []
            for nb in batches:
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in nb.items()}
                params, state, m = step(params, state, batch)
                losses[dev].append(float(m["loss"]))
            if dev == "cuda":
                assert (flash_prefill_bwd.launches > before[0]) \
                    != cfg.attn_free, arch
                assert (flash_prefill_bwd.noncausal_launches > before[1]) \
                    == cfg.is_encoder_decoder, arch
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                      losses["cpu"]))
        assert rel <= TRAIN_LOSS_RTOL, (arch, losses)
        log(f"[reduced] {cfg.name} train 3 steps: card losses "
            f"{losses['cuda']} vs CPU {losses['cpu']} (max relative diff "
            f"{rel:.2e}, tol {TRAIN_LOSS_RTOL})")


def sorted_cfg(cfg):
    """``cfg`` with sorted (dropless) MoE dispatch."""
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="sorted"))


def phase_reduced_sorted(torch) -> dict:
    """Phase 3's sorted MoE dispatch: reduced qwen2-moe with
    dispatch="sorted" served 1P:1D in both transfer modes on the card and
    on the CPU with the same params (equal tokens; launches counted under
    SORTED_REDUCED_PATH), then one training step's gradients (the remat
    forward_train, every leaf) card against CPU within BWD_TOL of each
    leaf's largest entry, through the grouped product's two backward
    kernels (launches under SORTED_TRAIN_PATH). Returns {path: counts}."""
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.models.modeling import forward_train
    from repro_torch.models.params import (init_params, tree_leaves,
                                           tree_map)
    from repro_torch.serving.cluster import MiniCluster

    cfg = sorted_cfg(get_config(MOE_ARCH).reduced())
    params = {"cpu": init_params(cfg, torch.Generator().manual_seed(7),
                                 device="cpu")}
    params["cuda"] = tree_map(lambda x: x.to("cuda"), params["cpu"])
    zero_counts()
    for overlap in (True, False):
        runs = {}
        for dev, prm in params.items():
            mc = MiniCluster(cfg, params=prm, device=dev,
                             overlap_transfer=overlap)
            reqs = make_requests(cfg, 6, 34, 40, 6, seed=3)
            mc.run(reqs)
            assert all(r.done for r in reqs), (dev, overlap)
            runs[dev] = {r.rid: list(r.generated) for r in reqs}
        assert runs["cuda"] == runs["cpu"], (overlap, runs)
    serve_counts = read_counts()
    assert serve_counts["grouped_mm"] > 0, serve_counts
    log(f"[reduced] {cfg.name} sorted dispatch, both transfer modes: card "
        f"tokens == CPU tokens for {len(runs['cpu'])} requests; launches "
        f"{serve_counts}")

    zero_counts()
    batch = SyntheticLM(cfg.vocab_size, 64, 2, seed=1).batch(0)
    grads = {}
    for dev, prm in params.items():
        p = tree_map(lambda x: x.clone().requires_grad_(), prm)
        loss, _ = forward_train(cfg, p, {k: torch.from_numpy(v).to(dev)
                                         for k, v in batch.items()},
                                remat=True)
        grads[dev] = torch.autograd.grad(loss, tree_leaves(p))
    train_counts = read_counts()
    worst, smallest = 0.0, float("inf")
    for got, want in zip(grads["cuda"], grads["cpu"]):
        err = (got.cpu() - want).abs().max().item()
        scale = max(1e-30, want.abs().max().item())
        assert err <= BWD_TOL * scale, (err, scale, tuple(want.shape))
        worst, smallest = max(worst, err / scale), min(smallest, scale)
    assert train_counts["grouped_mm_dx"] > 0 \
        and train_counts["grouped_mm_dw"] > 0, train_counts
    log(f"[reduced] {cfg.name} sorted dispatch, one training step: "
        f"{len(grads['cpu'])} gradient leaves, card against CPU within "
        f"{worst:.2e} of each leaf's largest entry (tol {BWD_TOL}; the "
        f"smallest leaf's largest entry {smallest:.3e}); launches "
        f"{train_counts}")
    del params, grads
    return {SORTED_REDUCED_PATH: serve_counts,
            SORTED_TRAIN_PATH: train_counts}


def sorted_step_bytes(torch, de) -> tuple:
    """(expert weight bytes one fused step of ``de`` reads through the
    grouped product, the bytes of every expert's weights, grouped calls):
    one eager step on clones of its inputs, each grouped call's touched
    experts read from its offsets on the host (off the measured path)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.step_graph import eager_twin
    real, seen = ops.grouped_mm, []

    def watch(x, w, offsets):
        seen.append((int((offsets[1:] > offsets[:-1]).sum()), w.shape[0],
                     w[0].numel() * w.element_size()))
        return real(x, w, offsets)
    ops.grouped_mm = watch
    try:
        eager_twin(de)()
    finally:
        ops.grouped_mm = real
    return (sum(n * per for n, _, per in seen),
            sum(e * per for _, e, per in seen), len(seen))


def phase_sorted(torch, card: str, cfg, params, path: str) -> dict:
    """A MoE path's sorted dispatch, on the capacity run's params (the
    same shapes for both dispatches): ``cfg`` (full-width qwen2-moe-a2.7b
    in phase 5, deepseek-moe-16b in phase 20) with dispatch="sorted"
    serves phase 4's four prompts 1P:1D through the frontend, overlapped
    then blocking (equal tokens; launches under ``path``), then
    ``graph_vs_eager`` on its fused step (a replay against the eager step
    bit for bit, graph and eager walls, device ms, busy) and the expert
    weight bytes a step reads (``sorted_step_bytes``). Returns the launch
    counts."""
    from repro_torch.serving.cluster import MiniCluster
    scfg = sorted_cfg(cfg)
    free_card(torch)
    zero_counts()
    tokens = {}
    for overlap in (True, False):
        mc = MiniCluster(scfg, params=params, device="cuda",
                         overlap_transfer=overlap)
        tokens[overlap] = serve(
            torch, card, f"{path} overlap={overlap}", mc.frontend,
            [make_requests(scfg, 4, 200, 480, 16, seed=11)])
        del mc
    assert tokens[True] == tokens[False], tokens
    counts = read_counts()
    missing = unlaunched(counts, SERVING_KERNELS + ("grouped_mm",))
    assert not missing, f"kernels never launched on {path}: {missing}"
    log(f"[{path}] launches {counts}")
    de = decode_engine(torch, scfg, params,
                       make_requests(scfg, 4, 200, 480, 16, seed=11))[0]
    graph_vs_eager(torch, card, f"graphs {path}", de)
    touched, every, n = sorted_step_bytes(torch, de)
    log(f"[{path}] one fused step (8 slots x top-{cfg.moe.top_k} of "
        f"{cfg.moe.num_experts}) reads {touched / 1e9:.2f} GB of expert "
        f"weights over {n} grouped calls (every expert: {every / 1e9:.2f} "
        f"GB, what capacity dispatch reads) [{card}]")
    del de
    prefill_vs_eager(torch, card, path, scfg, params, [
        r.tokens for r in make_requests(scfg, 4, 200, 480, 16, seed=11)],
        timed=SERVED_TIMED, profiled=SERVED_PROFILED)
    free_card(torch)
    return counts


def train_step_flops(cfg, b: int, s: int) -> float:
    """Flops of one remat training step of a dense stack, from the
    shapes: the layer and LM-head matmuls 4x a forward (forward, backward
    2x, the remat or chunked-loss recompute 1x; a head that
    ``chunked_loss`` takes in one piece, 3x), causal attention 4.5x its
    forward (forward, remat forward, backward 2.5x).

    An encoder-decoder (whisper) adds, over its ``encoder_seq`` frames a
    row: the encoder's layers (matmuls 3x and non-causal attention 3.5x:
    the encoder is not rematerialised) and, in each remat decoder layer,
    cross-attention's projections (wq, wo on the decoder rows, wk, wv on
    the frames; 4x) and its s x encoder_seq pairs (4.5x)."""
    from repro_torch.models.modeling import LOSS_CHUNK
    assert cfg.arch_type == "dense" or cfg.is_encoder_decoder, \
        cfg.arch_type
    d, per_pair = cfg.d_model, 4 * cfg.num_heads * cfg.hd
    chunked = s % LOSS_CHUNK == 0 and s > LOSS_CHUNK
    per_layer = d * (2 * cfg.q_dim + 2 * cfg.kv_dim + 3 * cfg.d_ff)
    head = 2 * b * s * d * cfg.vocab_size
    mm = 2 * b * s * cfg.num_layers * per_layer
    attn = per_pair * (b * s * (s + 1) // 2) * cfg.num_layers
    head *= 4 if chunked else 3
    if not cfg.is_encoder_decoder:
        return 4 * mm + head + 4.5 * attn
    enc = cfg.encoder_seq
    mm += 2 * cfg.num_layers * (b * s * 2 * d * cfg.q_dim
                                + b * enc * 2 * d * cfg.kv_dim)
    attn += per_pair * b * s * enc * cfg.num_layers
    enc_mm = 2 * b * enc * cfg.encoder_layers * per_layer
    enc_attn = per_pair * b * enc * enc * cfg.encoder_layers
    return 4 * mm + head + 4.5 * attn + 3 * enc_mm + 3.5 * enc_attn


# the grouped product's kernels by name, in a profile (the weight
# gradient's first: "dw_tiles_simt_kernel" contains "tiles_simt_kernel")
DW_KERNELS = ("dw_rows_kernel", "dw_tiles_simt_kernel", "dw_wgmma_kernel")
GROUPED_KERNELS = ("rows_fwd_kernel", "rows_trans_kernel",
                   "rows_reduce_kernel", "tiles_simt_kernel",
                   "tiles_wgmma_kernel")


def train_kind(name: str, low: str) -> str:
    """A training step's kernel kind, by its name."""
    return ("grouped dw" if any(k in name for k in DW_KERNELS) else
            "grouped fwd/dx" if any(k in name for k in GROUPED_KERNELS) else
            "flash bwd" if any(x in name for x in (
                "dkdv_kernel", "dq_kernel", "rowdot_kernel",
                "sum_heads_kernel")) else
            "flash fwd" if "flash_prefill" in name else
            "gemm" if ("gemm" in low or "gemv" in low
                       or "cutlass" in low) else "other")


def profile_train(torch, card: str, out: Path, tag: str, step, params,
                  state, batch):
    """torch.profiler over one training step: device kernel time by kind
    (``train_kind``) and the device's busy share of the step's wall. The
    table goes to ``out/profile_<tag>.txt``. Returns (params, state, the
    device ms by kind)."""
    from torch.profiler import ProfilerActivity, profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, _ = step(params, state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kinds = device_ms_by_kind(prof, train_kind)
    total = sum(kinds.values())
    lines = [f"profile of one full-width {tag} step [{card}]",
             f"wall {wall * 1e3:.1f} ms; device kernel time {total:.1f} ms "
             f"(busy share {total / (wall * 1e3):.3f})"]
    lines += [f"  {k}: {v:.1f} ms" for k, v in
              sorted(kinds.items(), key=lambda kv: -kv[1])]
    (out / f"profile_{tag}.txt").write_text(
        "\n".join(lines) + "\n\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=30))
    for line in lines:
        log(f"[profile {tag}] {line}")
    assert total > 0.0, "the profiler recorded no device time"
    # torch.profiler may keep this frame alive: leave no tensor in it
    trained = [params, state]
    del prof, params, state, batch
    return trained.pop(0), trained.pop(0), kinds


def train_run(torch, card: str, cfg, params, path: str, tag: str,
              b: int = TRAIN_BATCH, s: int = TRAIN_SEQ):
    """TRAIN_STEPS AdamW steps at lr 3e-4 with remat on SyntheticLM(seed=1)
    batches of b x s (with the family's frames or embeddings from
    ``train_inputs``), launches counted under ``path``: every loss and
    grad norm finite, the last loss below the first. Logs each step, the
    step wall median over steps 1.., tokens/s and peak memory. Returns
    (params, state, step, the next batch, counts, the median wall in
    s)."""
    import numpy as np
    from repro_torch.data import SyntheticLM
    from repro_torch.models.params import param_count_actual
    from repro_torch.models.steps import make_train_step
    from repro_torch.training.optimizer import AdamWConfig, adamw_init

    state = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-4), remat=True)
    data = SyntheticLM(cfg.vocab_size, s, b, seed=1)
    rng = np.random.default_rng(5)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in train_inputs(
                    cfg, data.batch(i), rng).items()}
               for i in range(TRAIN_STEPS + 1)]
    log(f"[{tag}] {cfg.name} ({cfg.num_layers} layers): "
        f"{param_count_actual(cfg) / 1e9:.3f} B params, AdamW state "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated with "
        f"the params; batch {b} x {s}"
        + (f" (+ {cfg.encoder_seq} frames a row)"
           if cfg.is_encoder_decoder else ""))
    zero_counts()
    walls, losses, norms = [], [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batches[i])
        losses.append(float(m["loss"]))       # synchronises
        norms.append(float(m["grad_norm"]))
        walls.append(time.perf_counter() - t0)
        log(f"[{tag}] step {i}: loss {losses[-1]:.4f} grad norm "
            f"{norms[-1]:.4f} wall {walls[-1] * 1e3:.1f} ms")
    counts = read_counts()
    missing = unlaunched(counts, TRAIN_KERNELS)
    assert not missing, f"kernels never launched on {path}: {missing}"
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    assert losses[-1] < losses[0], losses
    wall = statistics.median(walls[1:])
    log(f"[{tag}] {path}: launches {counts}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step wall median {wall * 1e3:.1f} ms over "
        f"steps 1-{TRAIN_STEPS - 1} (step 0 {walls[0] * 1e3:.1f} ms); "
        f"{b * s / wall:.1f} tokens/s [{card}]")
    log_peak(torch, tag, card)
    return params, state, step, batches[TRAIN_STEPS], counts, wall


def phase_train(torch, card: str, out: Path) -> dict:
    """Phase 12: full-width minicpm-2b (40 layers, d_model 2304, 36/36
    heads of 64, d_ff 5760, vocab 122753, tied embeddings; f32 params
    from a seeded CUDA generator) trained by ``train_run`` (two 512-row
    loss chunks) through flash prefill and its backward (launches under
    TRAIN_PATH); flops and MFU against the f32 peak, a profiled step
    (``<out>/profile_train.txt``); then a checkpoint round trip on the
    card, bitwise. Frees everything before it returns the launch
    counts."""
    from repro_torch.launch.mesh import PEAK_FLOPS

    cfg, params = load_params(torch, TRAIN_ARCH)
    params, state, step, batch, counts, wall = train_run(
        torch, card, cfg, params, TRAIN_PATH, "train")
    flops = train_step_flops(cfg, TRAIN_BATCH, TRAIN_SEQ)
    log(f"[train] {flops / 1e12:.2f} TFLOP a step; MFU "
        f"{flops / wall / PEAK_FLOPS['float32']:.3f} of 67 TFLOP/s f32 "
        f"[{card}]")
    params, state, _ = profile_train(torch, card, out, "train", step,
                                     params, state, batch)
    del state, batch
    free_card(torch)
    ckpt_round_trip(torch, "train", TRAIN_ARCH, params)
    del params
    free_card(torch)
    return counts


def ckpt_round_trip(torch, tag: str, name: str, params) -> None:
    """Save ``params`` under build/chip_smoke_ckpt/``name``, read them
    back on the card, hold every leaf bit for bit, delete the files."""
    from repro_torch.checkpoint import load_params as load_ckpt
    from repro_torch.checkpoint import save_params
    from repro_torch.models.params import tree_leaves

    ckpt = ROOT / "build" / "chip_smoke_ckpt" / name
    t0 = time.perf_counter()
    save_params(str(ckpt), params, step=TRAIN_STEPS + 1)
    back = load_ckpt(str(ckpt), params, device="cuda")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                                 tree_leaves(params))), \
        "the reloaded params differ"
    log(f"[{tag}] checkpoint round trip ({len(tree_leaves(params))} "
        f"leaves) bitwise equal in {time.perf_counter() - t0:.1f} s")
    for f in ckpt.parent.iterdir():
        f.unlink()
    del back


def phase_encdec_train(torch, card: str, out: Path) -> dict:
    """Phase 18: full-width whisper-base (6 + 6 layers, d_model 512, 8/8
    heads of 64, d_ff 2048, vocab 51865; f32 params from a seeded CUDA
    generator) trained by ``train_run`` on batches of ENCDEC_TRAIN_BATCH
    x ENCDEC_TRAIN_SEQ decoder tokens with 1500 seeded stub frames a row
    (launches under ENCDEC_TRAIN_PATH): each step runs the backward
    kernel once per attention sublayer, the non-causal mode for the 6
    encoder layers (1500 x 1500) and the 6 cross-attentions (448 x 1500),
    the causal one for the 6 decoder self-attentions, counted exactly;
    flops and MFU against the f32 peak (``train_step_flops``), a profiled
    step (``<out>/profile_encdec_train.txt``, the backward under "flash
    bwd"), then a checkpoint round trip on the card, bitwise. Frees
    everything before it returns the launch counts."""
    from repro_torch.launch.mesh import PEAK_FLOPS

    cfg, params = load_params(torch, ENCDEC_ARCH)
    b, s = ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ
    params, state, step, batch, counts, wall = train_run(
        torch, card, cfg, params, ENCDEC_TRAIN_PATH, "encdec train", b, s)
    E, L = cfg.encoder_layers, cfg.num_layers
    want = ((E + 2 * L) * TRAIN_STEPS, (E + L) * TRAIN_STEPS)
    assert (counts["flash_prefill_bwd"], counts[NONCAUSAL_BWD]) == want, \
        (want, counts)
    flops = train_step_flops(cfg, b, s)
    log(f"[encdec train] backward launches {counts['flash_prefill_bwd']} "
        f"({counts[NONCAUSAL_BWD]} non-causal) over {TRAIN_STEPS} steps; "
        f"{flops / 1e12:.3f} TFLOP a step; MFU "
        f"{flops / wall / PEAK_FLOPS['float32']:.3f} of 67 TFLOP/s f32 "
        f"[{card}]")
    params, state, kinds = profile_train(torch, card, out, "encdec_train",
                                         step, params, state, batch)
    assert kinds.get("flash bwd", 0.0) > 0.0, kinds
    del state, batch, step
    free_card(torch)
    ckpt_round_trip(torch, "encdec train", ENCDEC_ARCH, params)
    del params
    free_card(torch)
    return counts


def phase_sorted_train(torch, card: str, out: Path) -> dict:
    """Phase 16: full-width qwen2-moe-a2.7b with dispatch="sorted"
    (d_model 2048, 16/16 heads of 128, 60 experts top-4 and 4 shared,
    d_ff_expert 1408, vocab 151936) cut to SORTED_TRAIN_LAYERS of its 24
    layers (f32 AdamW state for 24 is 229 GB), f32 params from a seeded
    CUDA generator, trained by ``train_run``: every grouped call takes M
    = 4 x 1024 x 4 = 16384 rows (~273 an expert: the tiles path), so the
    grouped product, its input gradient and its weight gradient all
    launch, the weight gradient 3 times a layer a step (launches under
    SORTED_TRAIN_FULL_PATH); peak memory under the card's; a profiled
    step (``<out>/profile_sorted_train.txt``) with the weight gradient's
    device ms and share. Frees everything before it returns the launch
    counts."""
    from repro_torch.configs import get_config
    cfg = sorted_cfg(get_config(MOE_ARCH)).replace(
        num_layers=SORTED_TRAIN_LAYERS)
    log(f"[sorted train] {cfg.name}: depth cut to {SORTED_TRAIN_LAYERS} of "
        f"24 layers (f32 AdamW state for 24 layers is 229 GB; the card "
        f"holds 80), full widths")
    cfg, params = load_params(torch, cfg)
    params, state, step, batch, counts, wall = train_run(
        torch, card, cfg, params, SORTED_TRAIN_FULL_PATH, "sorted train")
    want = 3 * cfg.num_layers * TRAIN_STEPS
    assert counts["grouped_mm"] > 0 and counts["grouped_mm_dx"] > 0 \
        and counts["grouped_mm_dw"] == want, (want, counts)
    peak = torch.cuda.max_memory_allocated()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    assert peak < card_bytes, (peak, card_bytes)
    params, state, kinds = profile_train(torch, card, out, "sorted_train",
                                         step, params, state, batch)
    total = sum(kinds.values())
    dw_ms = kinds.get("grouped dw", 0.0)
    assert dw_ms > 0.0, f"the profile shows no weight-gradient kernel: {kinds}"
    log(f"[sorted train] the weight gradient: {dw_ms:.2f} device ms of the "
        f"step's {total:.1f} (share {dw_ms / total:.4f}), "
        f"{dw_ms / (3 * cfg.num_layers):.3f} ms a call; grouped forward and "
        f"input gradient {kinds.get('grouped fwd/dx', 0.0):.2f} ms; step wall "
        f"median {wall * 1e3:.1f} ms, peak {peak / 2**30:.2f} GiB of "
        f"{card_bytes / 2**30:.1f} [{card}]")
    del params, state, batch, step
    free_card(torch)
    return counts


# ------------------------------------------------------------ main

REPLACES = {
    "kv_gather": "src/repro/kernels/kv_gather.py:38",
    "kv_scatter": "src/repro/kernels/kv_scatter.py:42",
    "paged_attention": "src/repro/kernels/paged_attention.py:94",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:126",
    "flash_prefill_bwd": "src/repro/models/modeling.py:80 "
                         "(jax.value_and_grad, no Pallas kernel)",
    NONCAUSAL_BWD: "src/repro/models/modeling.py:80 (jax.value_and_grad "
                   "of attention_seq(causal=False): the encoder and "
                   "cross-attention; no Pallas kernel)",
    "grouped_mm": "src/repro/models/modeling.py:412 (lax.ragged_dot, no "
                  "Pallas kernel)",
    "grouped_mm_dx": "src/repro/models/modeling.py:412 (lax.ragged_dot's "
                     "input gradient under jax.value_and_grad, no Pallas "
                     "kernel)",
    "grouped_mm_dw": "src/repro/models/modeling.py:412 (lax.ragged_dot's "
                     "weight gradient under jax.value_and_grad, no Pallas "
                     "kernel)",
    "skinny_mm": "none: the dense products of the decode step "
                 "(src/repro/models/modeling.py _mm and lm_logits, left to "
                 "XLA, no Pallas kernel)",
}
# the path whose launches each kernel's row reports
ROW_PATH = {**{n: ARCH for n in SERVING_KERNELS},
            "flash_prefill_bwd": TRAIN_PATH,
            NONCAUSAL_BWD: ENCDEC_TRAIN_PATH, "grouped_mm": SORTED_PATH,
            "grouped_mm_dx": SORTED_TRAIN_FULL_PATH,
            "grouped_mm_dw": SORTED_TRAIN_FULL_PATH, "skinny_mm": ARCH}
# each kernel's source file
SOURCE = {**{n: f"src/repro_torch/kernels/csrc/{n}.cu" for n in REPLACES},
          **{n: "src/repro_torch/kernels/csrc/grouped_mm.cu"
             for n in GROUPED},
          NONCAUSAL_BWD: "src/repro_torch/kernels/csrc/flash_prefill_bwd.cu"}


def _digest(*ts) -> str:
    """The first 16 hex digits of the SHA-256 of tensors' bytes."""
    import hashlib
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _by_launch(torch, fn) -> str:
    """Device ms of each kernel one call of ``fn`` launches (torch.profiler
    over three calls)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    names = [(m[0] if (m := re.search(r"\w+_kernel(<[^>]*>)?", ev.key))
              else ev.key[:40], ev.device_time_total / 3e3)
             for ev in prof.key_averages() if ev.device_time_total > 0]
    return ", ".join(f"{n} {t:.4f}" for n, t in names)


def _forced_split(n: int, tile: int):
    """A split plan that cuts the keys into n ranges of whole tiles (fewer
    where the tiles run out), whatever the shapes."""
    from repro_torch.kernels.flash_prefill import KeySplit

    def plan(b, s, sk, *args, **kw):
        tiles = -(-sk // tile)
        per = -(-tiles // n)
        m = -(-tiles // per)
        return KeySplit(m, per * tile) if m > 1 else KeySplit(1, 0)
    return plan


def sweep_splits(torch) -> int:
    """Device times of the non-causal attention kernels at whisper-base's
    shapes (8/8 heads of 64) with the keys forced into n ranges, beside
    the range count the plan picks there: the forward at the served
    encoder (b=2, s=sk=1500), prefill cross-attention (b=4, s=64,
    sk=1500), training's encoder (b=8) and cross-attention (b=8, s=448);
    the backward, its dQ pass split, at training's two. The evidence for
    the plans' constants (``kernels/flash_prefill.py``); the plans are
    replaced while the sweep runs."""
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_prefill as fpm
    from repro_torch.kernels import flash_prefill_bwd as fbm
    build.library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    plans = (fpm.split_plan, fbm.dq_split)
    for b, s, sk in ((2, 1500, 1500), (4, 64, 1500), ENC_BWD, CROSS_BWD):
        q, k, v = rn(b, s, 8, 64), rn(b, sk, 8, 64), rn(b, sk, 8, 64)
        fn = functools.partial(fpm.flash_prefill_cuda, q, k, v, causal=False)
        got = []
        for n in (1, 2, 3, 4, 5, 6, 8, 12, 16):
            fpm.split_plan = _forced_split(n, fpm.KEY_TILE)
            got.append(f"{n}: {time_ms(fn):.4f}")
        fpm.split_plan = plans[0]
        plan = plans[0](b, s, sk, 8, 64, causal=False, window=None, sms=sms)
        log(f"[splits] forward b={b} s={s} sk={sk}: plan {plan.splits}; "
            f"ms by ranges {', '.join(got)} [{smi_line()}]")
    for b, s, sk in (ENC_BWD, CROSS_BWD):
        q, do = rn(b, s, 8, 64), rn(b, s, 8, 64)
        k, v = rn(b, sk, 8, 64), rn(b, sk, 8, 64)
        o, lse = fpm.flash_prefill_cuda(q, k, v, causal=False,
                                        return_lse=True)
        fn = functools.partial(fbm.flash_prefill_bwd_cuda, q, k, v, o, lse,
                               do, causal=False)
        got = []
        for n in (1, 2, 3, 4, 5, 6, 8):
            fbm.dq_split = _forced_split(n, 32)
            got.append(f"{n}: {time_ms(fn):.4f}")
        fbm.dq_split = plans[1]
        plan = plans[1](b, s, sk, 8, 64, causal=False, sms=sms)
        log(f"[splits] backward b={b} s={s} sk={sk}: dQ plan {plan.splits}; "
            f"ms by dQ ranges {', '.join(got)} [{smi_line()}]")
    return 0


def ab_causal(torch, root: Path) -> int:
    """Device times of CHECKOUT ``root``'s attention kernels, three timings
    each, its kernels built from its own sources: flash prefill causal at
    phase 2's two timed shapes (b=2, s=512, q_valid [480, 300], hd 128,
    f32; 32/8 and 16/16 heads) and in the window mode at phase 2's
    (b=1, s=10240, W=8192, 32/8 of 128), its attention backward at phase
    2's two causal timed shapes (minicpm-2b training, b=4, s=1024, 36/36
    of 64; granite, b=2, s=512, 32/8 of 128), each with a digest of its
    outputs (equal digests: equal bits on the same seeded inputs), then
    the non-causal mode at whisper's shapes (8/8 heads of 64): the
    forward at the served encoder (b=2, s=sk=1500) and prefill
    cross-attention (b=4, s=64, sk=1500), the backward at training's
    encoder (b=8, 1500 x 1500) and cross-attention (b=8, s=448, sk=1500).
    The wrappers are called as phase 2 calls them, so a checkout with
    the same wrapper signatures is timed the same way. For an A/B in
    turns, with the parent unpacked under ``build/parent``:

        for t in build/parent . . build/parent; do
            python3 chip_smoke.py --ab $t; done
    """
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.flash_prefill_bwd import flash_prefill_bwd_cuda
    build.library()
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def times(fn, iters=10):
        return ", ".join(f"{time_ms(fn, iters=iters):.4f}" for _ in range(3))
    qv = torch.tensor([480, 300], dtype=torch.int32, device="cuda")
    rows = []
    for nq, nkv in ((32, 8), (16, 16)):
        q, k, v = rn(2, 512, nq, 128), rn(2, 512, nkv, 128), \
            rn(2, 512, nkv, 128)
        fn = functools.partial(flash_prefill_cuda, q, k, v, q_valid=qv)
        rows.append(f"{nq}/{nkv}: {times(fn)} [{_digest(fn())}]")
    q, k, v = rn(1, 10240, 32, 128), rn(1, 10240, 8, 128), \
        rn(1, 10240, 8, 128)
    fn = functools.partial(flash_prefill_cuda, q, k, v, window=8192)
    rows.append(f"window W=8192 s=10240 32/8: {times(fn, iters=2)} "
                f"[{_digest(fn())}]")
    del q, k, v
    bwd = []
    for b, s, nq, nkv, hd in ((TRAIN_BATCH, TRAIN_SEQ, 36, 36, 64),
                              (2, 512, 32, 8, 128)):
        q, do = rn(b, s, nq, hd), rn(b, s, nq, hd)
        k, v = rn(b, s, nkv, hd), rn(b, s, nkv, hd)
        o, lse = flash_prefill_cuda(q, k, v, return_lse=True)
        fn = functools.partial(flash_prefill_bwd_cuda, q, k, v, o, lse, do)
        bwd.append(f"b={b} s={s} {nq}/{nkv} hd {hd}: {times(fn)} "
                   f"[{_digest(o, lse, *fn())}]")
        del q, k, v, do, o, lse
    nc = []
    for b, s, sk in ((2, 1500, 1500), (4, 64, 1500)):
        q, k, v = rn(b, s, 8, 64), rn(b, sk, 8, 64), rn(b, sk, 8, 64)
        fn = functools.partial(flash_prefill_cuda, q, k, v, causal=False)
        nc.append(f"forward b={b} s={s} sk={sk}: {times(fn)} "
                  f"({_by_launch(torch, fn)})")
    for b, s, sk in (ENC_BWD, CROSS_BWD):
        q, do = rn(b, s, 8, 64), rn(b, s, 8, 64)
        k, v = rn(b, sk, 8, 64), rn(b, sk, 8, 64)
        o, lse = flash_prefill_cuda(q, k, v, causal=False, return_lse=True)
        fn = functools.partial(flash_prefill_bwd_cuda, q, k, v, o, lse, do,
                               causal=False)
        nc.append(f"backward b={b} s={s} sk={sk}: {times(fn)} "
                  f"({_by_launch(torch, fn)})")
        del q, k, v, do, o, lse
    log(f"[ab] {root}: causal flash prefill ms [output digest] "
        f"{'; '.join(rows)}; backward ms [o, lse, dq, dk, dv digest] "
        f"{'; '.join(bwd)}; non-causal (8/8 of 64) ms {'; '.join(nc)} "
        f"[{smi_line()}]")
    return 0


def ab_train(torch, root: Path) -> int:
    """Phase 18's whisper-base training for CHECKOUT ``root``, its kernels
    built from its own sources: TRAIN_STEPS steps of ENCDEC_TRAIN_BATCH x
    ENCDEC_TRAIN_SEQ decoder tokens (1500 seeded frames a row), the step
    wall median, and one profiled step's device ms by kind. For an A/B
    in turns, with the parent unpacked under ``build/parent``:

        for t in build/parent . . build/parent; do
            python3 chip_smoke.py --ab-train $t; done
    """
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels import build
    build.library()
    card = smi_line()
    DEFAULT_OUT.mkdir(parents=True, exist_ok=True)
    cfg, params = load_params(torch, ENCDEC_ARCH)
    params, state, step, batch, _, wall = train_run(
        torch, card, cfg, params, ENCDEC_TRAIN_PATH, "ab-train",
        ENCDEC_TRAIN_BATCH, ENCDEC_TRAIN_SEQ)
    _, _, kinds = profile_train(torch, card, DEFAULT_OUT, "ab_train", step,
                                params, state, batch)
    log(f"[ab-train] {root}: whisper-base step wall median "
        f"{wall * 1e3:.1f} ms; one profiled step's device ms by kind "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(kinds.items()))
        + f" [{card}]")
    return 0


AB_SERVES = 3        # fresh clusters a checkout serves each way


def ab_serve(torch, root: Path) -> int:
    """Served prefill batch walls of CHECKOUT ``root``: phase 4's traffic
    (four requests of 200-480 tokens, seed 11, 16 new tokens each)
    through fresh 1P:1D MiniClusters, overlapped then blocking,
    AB_SERVES times each way, on full-width granite-3-8b and then
    pixtral-12b (f32, the seeded params of phases 4 and 9), with its
    kernels built from its own sources. Every serve is a fresh engine's
    first batch at each of its keys, the batches phases 4 and 9 log.
    For an A/B in turns, with the parent unpacked under
    ``build/parent``:

        for t in build/parent . . build/parent; do
            python3 chip_smoke.py --ab-serve $t; done
    """
    sys.path.insert(0, str(root.resolve() / "src"))
    from repro_torch.kernels import build
    from repro_torch.serving.cluster import MiniCluster
    build.library()
    for arch in (ARCH, VLM_ARCH):
        cfg, params = load_params(torch, arch)
        walls = {True: [], False: []}
        for _ in range(AB_SERVES):
            for overlap in (True, False):
                mc = MiniCluster(cfg, params=params, device="cuda",
                                 overlap_transfer=overlap)
                mc.frontend.run(make_requests(cfg, 4, 200, 480, 16,
                                              seed=11))
                torch.cuda.synchronize()
                walls[overlap].append(
                    [round(x * 1e3, 2) for x in
                     mc.frontend.groups["default"].prefill_batch_s])
                del mc
        log(f"[ab-serve] {root}: {arch} served prefill batch walls ms, "
            f"overlapped {walls[True]}, blocking {walls[False]} "
            f"[{smi_line()}]")
        del params
        free_card(torch)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="directory for the build log and profile table")
    ap.add_argument("--ab", metavar="CHECKOUT",
                    help="only time CHECKOUT's attention kernels (causal "
                         "and window with output digests, non-causal at "
                         "whisper's shapes; an A/B in turns; see "
                         "ab_causal)")
    ap.add_argument("--ab-train", metavar="CHECKOUT",
                    help="only time CHECKOUT's whisper-base training steps "
                         "(phase 18; an A/B in turns; see ab_train)")
    ap.add_argument("--splits", action="store_true",
                    help="only time the non-causal attention kernels at "
                         "whisper's shapes by forced key-range count (see "
                         "sweep_splits)")
    ap.add_argument("--skinny", action="store_true",
                    help="only check and time the skinny product at the "
                         "decode step's shapes, with every plan it could "
                         "take (see phase_kernels_skinny)")
    ap.add_argument("--ab-serve", metavar="CHECKOUT",
                    help="only time CHECKOUT's served prefill batches on "
                         "granite-3-8b and pixtral-12b (an A/B in turns; "
                         "see ab_serve)")
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
    if a.ab_serve:
        return ab_serve(torch, Path(a.ab_serve))
    if a.ab_train:
        return ab_train(torch, Path(a.ab_train))
    if a.splits:
        return sweep_splits(torch)
    if a.skinny:
        sys.path.insert(0, str(SRC))
        from repro_torch.kernels import build
        info = build.build()
        for part in info.log.split("== ")[1:]:
            if part.startswith("skinny_mm.cu"):
                for line in part.splitlines():
                    if "registers" in line or "spill" in line \
                            or "entry" in line:
                        log(f"[build] {line.strip()}")
        log(f"[build] {info.path.name} in {info.seconds:.1f}s")
        build.library()
        phase_kernels_skinny(torch, {}, sweep=True)
        return 0
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"[time] {what} done at {time.perf_counter() - t_start:.1f} s "
            f"of the script")

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

    stamp("phases 0-1 (device, build)")
    results: dict = {}
    phase_kernels(torch, results)
    phase_kernels_window(torch, results)
    phase_kernels_bwd(torch, results)
    phase_kernels_grouped(torch, results)
    phase_kernels_skinny(torch, results)
    stamp("phase 2 (kernels)")
    phase_reduced(torch)
    phase_reduced_train(torch)
    sorted_reduced = phase_reduced_sorted(torch)
    stamp("phase 3 (reduced paths)")
    main_counts, control_counts, absorb_counts, legacy_counts, \
        graph_counts, prefill_graph_counts, sim_counts = phase_main(
            torch, card, out)
    stamp("phases 4, 7, 10, 14, 17, 11 (granite-3-8b)")
    moe_counts, sorted_counts = phase_path(
        torch, card, out, MOE_ARCH, "moe",
        then=functools.partial(phase_sorted, path=SORTED_PATH))
    stamp("phase 5 (qwen2-moe-a2.7b, capacity and sorted)")
    paths = {ARCH: main_counts, CONTROL_PATH: control_counts,
             ABSORB_PATH: absorb_counts, **legacy_counts,
             GRAPH_PATH: graph_counts,
             PREFILL_GRAPH_PATH: prefill_graph_counts, SIM_PATH: sim_counts,
             **sorted_reduced, MOE_ARCH: moe_counts,
             SORTED_PATH: sorted_counts}
    paths[SSM_ARCH] = phase_ssm(torch, card, out)
    stamp("phase 6 (mamba2-2.7b)")
    paths[ENCDEC_ARCH] = phase_encdec(torch, card, out)
    stamp("phase 8 (whisper-base)")
    paths[VLM_ARCH] = phase_path(torch, card, out, VLM_ARCH, "pixtral")[0]
    stamp("phase 9 (pixtral-12b)")
    paths[PANGU_ARCH] = phase_path(torch, card, out, PANGU_ARCH, "pangu")[0]
    stamp("phase 19 (pangu-38b)")
    paths[DEEPSEEK_ARCH], paths[DEEPSEEK_SORTED_PATH] = phase_path(
        torch, card, out, DEEPSEEK_ARCH, "deepseek",
        then=functools.partial(phase_sorted, path=DEEPSEEK_SORTED_PATH))
    stamp("phase 20 (deepseek-moe-16b, capacity and sorted)")
    paths[WINDOW_PATH] = phase_window(torch, card, out)
    stamp("phase 13 (window)")
    paths[EXAMPLES_PATH] = phase_examples(torch, card, out)
    stamp("phase 15 (examples)")
    paths[TRAIN_PATH] = phase_train(torch, card, out)
    stamp("phase 12 (minicpm-2b training)")
    paths[ENCDEC_TRAIN_PATH] = phase_encdec_train(torch, card, out)
    stamp("phase 18 (whisper-base training)")
    paths[SORTED_TRAIN_FULL_PATH] = phase_sorted_train(torch, card, out)
    stamp("phase 16 (sorted qwen2-moe training)")
    assert set(results) == set(REPLACES) == set(ROW_PATH) \
        <= set(paths[ARCH]), (results, paths[ARCH])

    rows = []
    for name, r in results.items():
        rows.append({"name": name, "route": "cuda",
                     "source": SOURCE[name],
                     "replaces": REPLACES[name],
                     "launches": paths[ROW_PATH[name]][name],
                     "max_abs_err": r["max_abs_err"],
                     "ms": r.get("ms"), "plain_ms": r.get("plain_ms"),
                     "bound_ms": r.get("bound_ms"),
                     "bound_by": r.get("bound_by"),
                     "library_ms": r.get("library_ms"),
                     "launches_by_path": {a: c[name]
                                          for a, c in paths.items()},
                     "cases": r.get("cases", [])})
        assert rows[-1]["launches"] > 0, \
            f"{name} launched no time on {ROW_PATH[name]}"
        if name == "flash_prefill":
            rows[-1]["noncausal_launches_by_path"] = {
                a: c[NONCAUSAL] for a, c in paths.items()}
            rows[-1]["window_launches_by_path"] = {
                a: c[WINDOW] for a, c in paths.items()}
        if name == "flash_prefill_bwd":
            rows[-1]["noncausal_launches_by_path"] = {
                a: c[NONCAUSAL_BWD] for a, c in paths.items()}
        if "bound_f32_ms" in r:
            rows[-1]["bound_f32_ms"] = r["bound_f32_ms"]
        if "ms_device_q_offset" in r:
            rows[-1]["ms_device_q_offset"] = r["ms_device_q_offset"]
    for row, r in zip(rows, results.values()):
        for c in [r] + r.get("cases", []):
            log(f"[kernels] {row['name']} at {c.get('shape')}: {c['ms']} "
                f"ms, plain {c['plain_ms']} ms, library {c['library_ms']} "
                f"ms, bound {c['bound_ms']} ms ({c['bound_by']})"
                + (f", f32 bound {c['bound_f32_ms']} ms"
                   if "bound_f32_ms" in c else "")
                + (f", q_offset on the card {c['ms_device_q_offset']} ms"
                   if "ms_device_q_offset" in c else "") + f" [{card}]")
    log(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
