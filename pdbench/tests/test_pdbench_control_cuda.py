"""The control on the card: the plain reference with TF32 matmuls, put in
the program's place, reads a wider logit gap than the program does on the
same served tokens, at the published widths (depth cut so that a test run
holds it). ``python3 -m pdbench.control`` reads both at each cell's own
size; PERF.md gives those readings and the limits set from them."""
import json

import pytest

from pdbench.tests import tiny

WIDE = {"granite": {"num_layers": 4, "d_model": 4096, "num_heads": 32,
                    "num_kv_heads": 8, "head_dim": 128, "d_ff": 12800,
                    "vocab_size": 49155, "tie_embeddings": True},
        "deepseek": {"num_layers": 2, "d_model": 2048, "num_heads": 16,
                     "num_kv_heads": 16, "head_dim": 128, "d_ff": 10944,
                     "vocab_size": 102400, "tie_embeddings": False,
                     "norm_eps": 1e-6,
                     "moe": {"num_experts": 64, "top_k": 6,
                             "num_shared_experts": 2, "d_ff_expert": 1408,
                             "layout": "all", "dispatch": "sorted"}}}


@pytest.mark.cuda
@pytest.mark.parametrize("family", sorted(WIDE))
def test_control_reads_wider_than_the_program(tmp_path, family):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import time
    from pdbench import driver, spec
    root = tiny.make_root(tmp_path)
    cfg = dict(tiny.TINY_CONFIG, name="wide", min_tokens_compared=200,
               **WIDE[family])
    (root / "pdbench" / "configs" / "wide.json").write_text(json.dumps(cfg))
    mix = dict(tiny.TINY_UNSHARED, decode_slots=16, warm_batches=[1],
               prompt_tokens={"median": 256, "sigma": 0.5, "min": 128,
                              "max": 512},
               output_tokens={"median": 64, "sigma": 0.5, "min": 32,
                              "max": 128}, rate_per_s=20.0)
    (root / "pdbench" / "traffic" / "wide-chat.json").write_text(
        json.dumps(mix))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "wide", "source": "test",
                             "file": "pdbench/configs/wide.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "wide.wide-chat", "config": "wide",
                               "traffic": "wide-chat", "chips": 1,
                               "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("wide.wide-chat", root)
    for seed in (1, 2, 3):
        rec = driver.run_cell(cell, seed, 8.0, False, "cuda",
                              time.perf_counter(), control=True)
        ck = rec.check
        assert ck["tokens_compared"] >= 200, ck
        assert ck["control_gap_max"] > 3 * ck["logit_gap_max"], ck
