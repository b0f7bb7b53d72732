"""A tiny cell for the CPU tests: a reduced granite-like model and a short
shared-prefix mix, written into a temporary copy of the benchmark."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SRC = str(ROOT / "src")
if SRC not in sys.path:
    sys.path.insert(0, SRC)

TINY_CONFIG = {
    "name": "tiny", "source": "test", "arch_type": "dense",
    "num_layers": 4, "d_model": 256, "num_heads": 8, "num_kv_heads": 2,
    "head_dim": 32, "d_ff": 512, "vocab_size": 512, "rope_theta": 10000.0,
    "norm_eps": 1e-05, "tie_embeddings": True, "max_seq_len": 4096,
    "dtype": "float32", "tf32": False, "reduced": {},
    "checks": {"logit_gap_max": 1e-3}, "min_tokens_compared": 16,
}
TINY_MOE = dict(TINY_CONFIG, name="tiny-moe", arch_type="moe",
                tie_embeddings=False,
                moe={"num_experts": 8, "top_k": 3, "num_shared_experts": 1,
                     "d_ff_expert": 64, "layout": "all",
                     "dispatch": "sorted"})
TINY_MIX = {
    "why": "test", "rate_per_s": 8.0,
    "shared_prefixes": {"count": 2, "tokens": 48},
    "prompt_tokens": {"median": 16, "sigma": 0.8, "min": 8, "max": 40},
    "output_tokens": {"median": 8, "sigma": 0.8, "min": 4, "max": 24},
    "prefill_nodes": 1, "decode_nodes": 1, "prefill_batch": 2,
    "decode_slots": 4, "warm_batches": [1], "warm_virtual_s": 0.5,
}
TINY_UNSHARED = {k: v for k, v in TINY_MIX.items()
                 if k != "shared_prefixes"}
TINY_UNSHARED["warm_batches"] = [1, 2]


def make_root(tmp: Path) -> Path:
    """A copy of the benchmark under ``tmp`` whose BENCHMARK.json holds the
    tiny cells beside the real ones."""
    root = tmp / "checkout"
    shutil.copytree(ROOT / "pdbench", root / "pdbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cfg in (TINY_CONFIG, TINY_MOE):
        (root / "pdbench" / "configs" / f"{cfg['name']}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "test",
                                 "file": f"pdbench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "test"})
    for name, mix in (("tiny-chat", TINY_MIX),
                      ("tiny-unshared", TINY_UNSHARED)):
        (root / "pdbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    cells = {"tiny.tiny-chat": ("tiny", "tiny-chat"),
             "tiny-moe.tiny-unshared": ("tiny-moe", "tiny-unshared")}
    for name, (cfg, mix) in cells.items():
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, workload: str, seed: int = 1, seconds: float = 3.0,
        trace: bool = False):
    """(cell, record, result) of one CPU run of ``workload``."""
    import torch
    from pdbench import driver, run as bench_run, spec
    torch.set_num_threads(1)     # several test workers share the cores
    cell = spec.load_cell(workload, root)
    rec = driver.run_cell(cell, seed, seconds, trace, "cpu",
                          time.perf_counter())
    return cell, rec, bench_run.result(cell, rec, trace, root)
