"""Each configuration names its reference module, and the harness takes
the weight layout, the model's counts and the reference logits from that
module: the two accepted configurations read exactly what they read when
the harness knew one kind of model, and a new architecture joins the
benchmark as new files only."""
import json
import math

import pytest

from pdbench import driver, roofline, spec, weights
from pdbench.tests import tiny
from repro_torch.models.config import ModelConfig, MoEConfig

B = ("blocks", "sub0")
FROZEN = {
    "granite-3-8b.chat-shared": {
        "params": 8_170_516_480,
        "prompt_flops": 2_182_962_216_960,
        "decode_flops": 17_193_000_960,
        "normal": 8_170_516_480,
        "model": ModelConfig(
            name="granite-3-8b", arch_type="dense", num_layers=40,
            d_model=4096, num_heads=32, num_kv_heads=8, d_ff=12800,
            vocab_size=49155, head_dim=128, rope_theta=10000.0,
            norm_eps=1e-05, tie_embeddings=True, max_seq_len=4096),
        "layout": [
            (("embed",), (49155, 4096), "normal"),
            (("final_norm",), (4096,), "ones"),
            (B + ("norm",), (40, 4096), "ones"),
            (B + ("wq",), (40, 4096, 4096), "normal"),
            (B + ("wk",), (40, 4096, 1024), "normal"),
            (B + ("wv",), (40, 4096, 1024), "normal"),
            (B + ("wo",), (40, 4096, 4096), "normal"),
            (B + ("norm2",), (40, 4096), "ones"),
            (B + ("mlp", "w_gate"), (40, 4096, 12800), "normal"),
            (B + ("mlp", "w_up"), (40, 4096, 12800), "normal"),
            (B + ("mlp", "w_down"), (40, 12800, 4096), "normal")],
    },
    "deepseek-moe-16b.chat": {
        "params": 1_415_315_456,
        "prompt_flops": 378_300_006_400,
        "decode_flops": 2_979_725_312,
        "normal": 8_649_441_280,
        "model": ModelConfig(
            name="deepseek-moe-16b", arch_type="moe", num_layers=14,
            d_model=2048, num_heads=16, num_kv_heads=16, d_ff=10944,
            vocab_size=102400, head_dim=128, rope_theta=10000.0,
            norm_eps=1e-06, tie_embeddings=False, max_seq_len=4096,
            moe=MoEConfig(num_experts=64, top_k=6, num_shared_experts=2,
                          d_ff_expert=1408, layout="all",
                          dispatch="sorted")),
        "layout": [
            (("embed",), (102400, 2048), "normal"),
            (("final_norm",), (2048,), "ones"),
            (B + ("norm",), (14, 2048), "ones"),
            (B + ("wq",), (14, 2048, 2048), "normal"),
            (B + ("wk",), (14, 2048, 2048), "normal"),
            (B + ("wv",), (14, 2048, 2048), "normal"),
            (B + ("wo",), (14, 2048, 2048), "normal"),
            (B + ("norm2",), (14, 2048), "ones"),
            (B + ("moe", "router"), (14, 2048, 64), "normal"),
            (B + ("moe", "w_gate"), (14, 64, 2048, 1408), "normal"),
            (B + ("moe", "w_up"), (14, 64, 2048, 1408), "normal"),
            (B + ("moe", "w_down"), (14, 64, 1408, 2048), "normal"),
            (B + ("moe", "shared", "w_gate"), (14, 2048, 2816), "normal"),
            (B + ("moe", "shared", "w_up"), (14, 2048, 2816), "normal"),
            (B + ("moe", "shared", "w_down"), (14, 2816, 2048), "normal"),
            (("lm_head",), (2048, 102400), "normal")],
    },
}


@pytest.mark.parametrize("cell", sorted(FROZEN))
def test_the_accepted_configurations_read_what_they_read(cell):
    want = FROZEN[cell]
    c = spec.load_cell(cell).config
    assert "reference" not in c
    assert spec.reference(c).__file__.endswith("reference/model.py")
    assert roofline.matmul_params_per_token(c) == want["params"]
    assert roofline.forward_flops(c, 1024, 128) == want["prompt_flops"]
    assert roofline.forward_flops(c, 1299, 1) == want["decode_flops"]
    layout = weights.layout(c)
    assert len(layout) == len(want["layout"])
    for got, leaf in zip(layout, want["layout"]):
        assert got == leaf
    assert sum(math.prod(shape) for _, shape, init in layout
               if init == "normal") == want["normal"]
    assert driver.model_config(c) == want["model"]


# today's equations, with a count of the logits calls and a distinct
# count of the weights a token multiplies through
PROBE = '''

CALLS = 0
_model_logits = logits
_model_params = matmul_params_per_token


def logits(c, w, tokens, first):
    global CALLS
    CALLS += 1
    return _model_logits(c, w, tokens, first)


def matmul_params_per_token(c):
    return 3 * _model_params(c)
'''


def _add_cell(root, cfg: dict, traffic: str) -> str:
    """A configuration file and its cell, as a new architecture adds them:
    new files, new entries, and the cell appended to the metrics'
    ``workloads`` lists."""
    (root / "pdbench" / "configs" / f"{cfg['name']}.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": cfg["name"], "source": "test",
                             "file": f"pdbench/configs/{cfg['name']}.json",
                             "reduced": [], "why": "test"})
    name = f"{cfg['name']}.{traffic}"
    bench["workloads"].append({"name": name, "config": cfg["name"],
                               "traffic": traffic, "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return name


def test_a_new_architecture_joins_as_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    before = {p: p.read_bytes() for p in (root / "pdbench").rglob("*")
              if p.is_file()}
    ref = root / "pdbench" / "reference"
    (ref / "tiny_probe.py").write_text((ref / "model.py").read_text()
                                       + PROBE)
    cfg = dict(tiny.TINY_CONFIG, name="tiny-probe", reference="tiny_probe")
    name = _add_cell(root, cfg, "tiny-chat")

    cell, rec, out = tiny.run(root, name, seed=2**31 + 17, trace=True)
    assert out["correct"] is True, out["check"]
    probe = spec.reference(cell.config)
    assert probe.__file__ == str(ref / "tiny_probe.py")
    assert probe.CALLS >= len(rec.sample) > 0

    c = cell.config
    model = spec.reference(tiny.TINY_CONFIG)
    assert probe.matmul_params_per_token(c) \
        == 3 * model.matmul_params_per_token(c)

    def mfu(params):
        def flops(p, n):
            return 2.0 * n * params + probe.attention_flops(
                c, roofline.attention_pairs(p, n))
        total = sum(flops(p, n) for s in rec.prefill_spans for p, n in s.work)
        total += sum(flops(x - 1, 1) for s in rec.decode_spans
                     for x in s.work)
        return 100.0 * total / rec.wall_s / roofline.PEAK_FLOPS
    got = out["metrics"]["mfu"]["value"]
    assert got == pytest.approx(mfu(probe.matmul_params_per_token(c)),
                                rel=1e-12)
    assert got != pytest.approx(mfu(model.matmul_params_per_token(c)),
                                rel=0.1)
    assert before == {p: p.read_bytes() for p in before}


@pytest.mark.parametrize("base, key", [(tiny.TINY_CONFIG, "num_kv_head"),
                                       (tiny.TINY_MOE, "moe.top_K")])
def test_an_unknown_key_is_refused_by_name(tmp_path, base, key):
    root = tiny.make_root(tmp_path)
    cfg = json.loads(json.dumps(base))
    node, *path = key.split(".")
    if path:
        cfg[node][path[0]] = 2
    else:
        cfg[node] = 2
    cfg["name"] = "tiny-typo"
    name = _add_cell(root, cfg, "tiny-chat")
    with pytest.raises(KeyError, match=key.split(".")[-1]):
        tiny.run(root, name)
