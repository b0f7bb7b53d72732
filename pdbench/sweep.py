"""The knee sweep: one cell at a list of arrival rates, one process.

    python3 -m pdbench.sweep --workload <name> --rates 4,5,6 --seconds 20 --seed <n>

Each rate gets a fresh frontend on the same seed's weights and traffic
(the mix's rate replaced), the cell's prelude and warm-up, then a window
of ``--seconds`` real seconds. One line a rate: the virtual seconds the
window covered, the requests due in it, the backlog (requests due without
a first token) at the window's start and end, the gateway requeues a
request, TTFT and TPOT p95 and the tokens a card-second. A rate is
sustained while the backlog ends the window no larger than it started and
the gateway turns back fewer than one request in five; the knee is the
highest sustained rate, and a cell's rate is fixed at 4/5 of it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from pdbench import run as bench_run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    bench_run._setup_env()
    import torch
    from pdbench import driver, spec
    from pdbench.stats import percentile, tpot_samples, ttft_samples

    if not torch.cuda.is_available():
        print("pdbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    for rate in (float(x) for x in args.rates.split(",")):
        rec = driver.run_cell(cell, args.seed, args.seconds, False, "cuda",
                              time.perf_counter(), rate=rate, judge=False)
        tt = percentile(ttft_samples(rec.stamps, rec.v_end), 95.0)
        tp = percentile(tpot_samples(rec.stamps), 95.0)
        print(json.dumps({
            "rate": rate, "virtual_s": rec.v_end - rec.v_start,
            "real_s": rec.wall_s, "due": len(rec.stamps),
            "backlog_start": rec.backlog[0], "backlog_end": rec.backlog[-1],
            "captures_in_window": rec.captures,
            "gw_requeues_per_req": rec.counters["gw_requeues"]
            / max(1, len(rec.stamps)),
            "ttft_p95_s": tt, "tpot_p95_ms": tp * 1e3,
            "tokens_per_card_s": (rec.prompt_tokens + rec.output_tokens)
            / rec.wall_s,
            "decode_batch_mean": (rec.output_tokens - rec.first_tokens)
            / max(1.0, rec.counters["fused_steps"])}), flush=True)
        del rec
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
