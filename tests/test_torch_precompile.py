"""The port's artifact store (launch/precompile.py, paper §3.2): keys,
manifests with the JAX store's fields, load without a build, warm-up.

On the CPU the build step is a test double: ``build.build`` writes a
stand-in file where nvcc would link the library, and
``build.load_library`` records the path it is asked to load instead of
opening it with ctypes (there is no nvcc and no card here). The real
build, a load with no nvcc on PATH and a launch from the loaded library
run on the card (tests/test_torch_cuda.py and chip_smoke.py phase 13).
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.launch.precompile import ArtifactStore
from repro_torch.models import caches
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import init_params
from repro_torch.models.steps import make_serve_step

JAX_FIELDS = {"key", "arch", "kind", "seq_len", "global_batch",
              "compile_s", "size_bytes"}


@pytest.fixture
def fake_build(monkeypatch):
    loaded = []

    def fake(out_dir=None):
        out_dir.mkdir(parents=True, exist_ok=True)
        lib = out_dir / build.LIB_NAME
        lib.write_bytes(b"\0" * 1234)
        return build.BuildInfo(lib, 0.5, "stand-in")

    monkeypatch.setattr(build, "build", fake)
    monkeypatch.setattr(build, "load_library", loaded.append)
    return loaded


def test_store_round_trip_and_manifest(tmp_path, fake_build):
    store = ArtifactStore(tmp_path / "store")
    keys = {"granite-3-8b/long_500k": "long_500k",
            "granite-3-8b/prefill_32k": "prefill_32k",
            "qwen1.5-110b/decode_32k": "decode_32k"}
    for key, shape in keys.items():
        man = store.precompile(key, get_config(key.split("/")[0]),
                               INPUT_SHAPES[shape])
        assert JAX_FIELDS <= set(man)
        assert man["key"] == key and man["arch"] == key.split("/")[0]
        assert man["kind"] == INPUT_SHAPES[shape].kind
        assert man["size_bytes"] == 1234
        assert man["source_hash"] == build.source_hash()
    assert store.available() == sorted(keys)
    step, man = store.load("granite-3-8b/long_500k")
    assert callable(step) and man["load_s"] >= 0
    assert [p.name for p in fake_build] == ["granite-3-8b_long_500k.so"]
    on_disk = json.loads((tmp_path / "store" /
                          "granite-3-8b_long_500k.manifest.json").read_text())
    assert "load_s" not in on_disk and on_disk["seq_len"] == 524288


def test_store_refuses_other_sources(tmp_path, fake_build, monkeypatch):
    store = ArtifactStore(tmp_path)
    store.precompile("k", get_config("granite-3-8b"),
                     INPUT_SHAPES["decode_32k"])
    monkeypatch.setattr(build, "source_hash", lambda: "0" * 16)
    with pytest.raises(RuntimeError, match="other kernel sources"):
        store.load("k")
    assert fake_build == []


def test_store_warm_up_records_its_wall(tmp_path, fake_build):
    """A first run of a serve step on real inputs (reduced granite, a
    windowed cache on the CPU) records ``warmup_s``."""
    store = ArtifactStore(tmp_path)
    cfg = get_config("granite-3-8b").reduced()
    store.precompile("g", cfg, INPUT_SHAPES["long_500k"])
    params = init_params(cfg, device="cpu")
    cache = caches.zeros_cache(cfg, 1, 64, window=8, device="cpu")
    tok = torch.from_numpy(np.array([3], np.int32))
    nxt, cache = store.warm_up("g", make_serve_step(cfg, window=8), params,
                               cache, tok)
    assert nxt.shape == (1,) and cache["pos"] == 1
    man = json.loads((tmp_path / "g.manifest.json").read_text())
    assert man["warmup_s"] > 0
