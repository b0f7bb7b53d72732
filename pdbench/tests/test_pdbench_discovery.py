"""A traffic mix and a per-layer metric added as files are found by their
names in BENCHMARK.json, with no file of the harness edited."""
import json

from pdbench import spec
from pdbench.tests import tiny


def test_new_mix_and_metric_are_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "pdbench").rglob("*.py")}
    mix = dict(tiny.TINY_MIX, rate_per_s=6.0)
    (root / "pdbench" / "traffic" / "throwaway-mix.json").write_text(
        json.dumps(mix))
    (root / "pdbench" / "metrics" / "throwaway_metric.py").write_text(
        "def read(rec):\n    return 42.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.throwaway-mix",
                               "config": "tiny", "traffic": "throwaway-mix",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway_metric", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "setup_s",
                               "workloads": ["tiny.throwaway-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell("tiny.throwaway-mix", root)
    assert cell.traffic["rate_per_s"] == 6.0
    assert "throwaway_metric" in {m["name"] for m in cell.per_layer}
    assert spec.metric_reader("throwaway_metric", root)(None) == 42.0
    cell, rec, out = tiny.run(root, "tiny.throwaway-mix", trace=True)
    assert out["metrics"]["throwaway_metric"]["value"] == 42.0
    assert out["correct"] is True
    assert before == {p: p.read_bytes() for p in before}
