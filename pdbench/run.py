"""Run one cell of the benchmark once and print its result line.

    python3 -m pdbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Needs the card(s) the cell asks for and
exits non-zero without them. With ``--trace 0`` the result's metrics are
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
(and ``device.busy_s``, ``device.window_s`` and a ``breakdown``). The last
line of standard output is the result's JSON object; the numbers compared
to decide ``correct`` are the last lines of standard error and the last
key of the result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_env():
    """Kernel caches at fixed paths inside the checkout; the port's nvcc
    build already lands in ``build/repro_torch_kernels``."""
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build"
                                             / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules() -> list:
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def result(cell, rec, trace: bool, root: Path = ROOT) -> dict:
    """The result object of a run (without the device description)."""
    from pdbench import spec, trace as tr
    if rec.stretch is not None and not isinstance(rec.stretch, tr.Stretch):
        rec.stretch = tr.reduce(rec.stretch["profile"],
                                rec.stretch["wall_s"])
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.metric_reader(m["name"], root)(rec)
        if v is not None and math.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    limits = cell.config["checks"]
    min_tokens = int(cell.config["min_tokens_compared"])
    ck = rec.check
    correct = all(ck[k] <= v for k, v in limits.items()) \
        and ck["tokens_compared"] >= min_tokens
    out = {"correct": bool(correct), "attempted": len(rec.stamps),
           "failed": sum(1 for s in rec.stamps if s.failed),
           "metrics": metrics}
    if trace and rec.stretch is not None:
        out["breakdown"] = {"device_ops": rec.stretch.top_ops(),
                            "idle_gaps": rec.stretch.idle_gaps()}
    out["check"] = {k: {"value": ck[k], "limit": v} for k, v in limits.items()}
    out["check"]["tokens_compared"] = {"value": ck["tokens_compared"],
                                       "limit": min_tokens}
    return out


def device_info(rec, trace: bool) -> dict:
    import torch
    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": 1, "memory_peak_bytes": int(rec.memory_peak_bytes)}
    if trace and rec.stretch is not None:
        d["busy_s"] = rec.stretch.busy_s()
        d["window_s"] = rec.stretch.wall_s
    return d


def emit(out: dict, device: dict) -> None:
    check = out.pop("check")
    out["device"] = device
    out["check"] = check
    for name, c in check.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_env()
    import torch
    from pdbench import driver, roofline, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"pdbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    rec = driver.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"pdbench: the run loaded {bad}; the benchmark runs the port "
              f"alone", file=sys.stderr)
        return 3
    print(f"pdbench: {args.workload} seed {args.seed}: set-up "
          f"{rec.setup_s:.2f} s; window {rec.wall_s:.2f} real s, "
          f"{rec.v_end - rec.v_start:.2f} virtual s; {len(rec.stamps)} due, "
          f"backlog {rec.backlog[0]} -> {rec.backlog[-1]}; "
          f"{rec.captures} graphs captured in the window; "
          f"{rec.prompt_tokens} prompt + {rec.output_tokens} output tokens; "
          f"peak {rec.memory_peak_bytes / 2**30:.2f} GiB; card "
          f"{roofline.power_limit()}", file=sys.stderr)
    from pdbench.stats import percentile, tpot_samples, ttft_samples
    for name, xs, unit in (
            ("ttft", ttft_samples(rec.stamps, rec.v_end), 1.0),
            ("tpot_ms", tpot_samples(rec.stamps), 1e3)):
        if xs:
            print(f"pdbench: {name} p50/p90/p95/p99 " + " ".join(
                f"{percentile(xs, q) * unit:.4f}" for q in (50, 90, 95, 99))
                + f" over {len(xs)}", file=sys.stderr)
    out = result(cell, rec, bool(args.trace))
    emit(out, device_info(rec, bool(args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
