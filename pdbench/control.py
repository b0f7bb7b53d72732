"""The control at a cell's own size and load: the readings that set its
limits, and the proof that the control comes out not correct.

    python3 -m pdbench.control --workload <name> --seeds 1,2,3 --seconds 20

For each seed one run of the cell as the benchmark makes it (its own load,
a window of ``--seconds``), then the served tokens against the float32
reference (the program's readings) and, at the same positions of the same
sample, the tokens that the reference computed with TF32 matmuls puts
first (the control's readings). Both sets of readings go through the
harness's own judgement (``run.result`` with the cell's ``checks``). One
JSON line a seed, then the largest program reading and the smallest
control reading of each number. Exits 1 unless every program run is
correct and every control run is not (PERF.md gives the readings).
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from pdbench import run as bench_run

KEYS = ("logit_gap_max", "mismatch_share")


def as_control(rec):
    """A copy of ``rec`` whose readings are the control's."""
    ctl = copy.copy(rec)
    ck = rec.check
    ctl.check = {"logit_gap_max": ck["control_gap_max"],
                 "mismatch_share": ck["control_mismatch_share"],
                 "tokens_compared": ck["tokens_compared"]}
    return ctl


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    bench_run._setup_env()
    import torch
    from pdbench import driver, spec

    if not torch.cuda.is_available():
        print("pdbench.control: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    prog = {k: [] for k in KEYS}
    ctl = {k: [] for k in KEYS}
    sound = True
    for seed in (int(x) for x in args.seeds.split(",")):
        rec = driver.run_cell(cell, seed, args.seconds, False, "cuda",
                              time.perf_counter(), control=True)
        p_ok = bench_run.result(cell, rec, False)["correct"]
        c_ok = bench_run.result(cell, as_control(rec), False)["correct"]
        sound = sound and p_ok and not c_ok
        print(json.dumps(dict(seed=seed, program_correct=p_ok,
                              control_correct=c_ok, **rec.check)),
              flush=True)
        for k in KEYS:
            prog[k].append(rec.check[k])
            ctl[k].append(as_control(rec).check[k])
        del rec
        torch.cuda.empty_cache()
    print(json.dumps({k: {"program_max": max(prog[k]),
                          "control_min": min(ctl[k]),
                          "limit": cell.config["checks"].get(k)}
                      for k in KEYS}), flush=True)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
