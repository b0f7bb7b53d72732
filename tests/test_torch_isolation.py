"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to fall back to the CPU when the card is asked
for and missing."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError("jax is blocked in this process")
        return None

sys.meta_path.insert(0, _Block())
import repro_torch
names = ["repro_torch"]
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
    names.append(mod.name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro."))
             or m == "repro")
print(len(names), bad)
"""


def test_port_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(count) >= 30          # every module of the port was loaded


def test_no_source_file_names_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|repro)\b|from\s+(jax|repro)\b"
                     r"[\s.])", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert files
    for f in files:
        text = f.read_text()
        assert not pat.search(text), f
        # no TPU rate of the simulator's serving profiles rides along
        assert "197e12" not in text and "819e9" not in text, f


def test_default_device_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.serving.cluster import MiniCluster
    cfg = get_config("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniCluster(cfg)


def test_out_of_scope_features_raise_not_implemented():
    """Nothing of the JAX package is left out of the port: no
    NotImplementedError names a ROADMAP item, and the calls that raised
    for the last one (sliding-window attention, item 18) now equal the
    JAX package's."""
    import jax.numpy as jnp
    import numpy as np
    from repro.models import modeling as jm
    from repro_torch.configs import get_config
    from repro_torch.models.modeling import attention_decode, attention_seq
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.faults import (DeterministicService,
                                            FaultEvent, FaultPlan)
    from repro_torch.serving.frontend import ClusterFrontend
    from repro_torch.serving.speculative import SpecConfig
    for f in PORT.rglob("*.py"):
        assert "ROADMAP.md queue A item" not in f.read_text(), f
    assert not (PORT / "scope.py").exists()
    q = np.random.default_rng(0).normal(size=(1, 4, 2, 32)).astype(
        np.float32)
    got = attention_seq(torch.from_numpy(q), torch.from_numpy(q),
                        torch.from_numpy(q), 2, causal=True, window=2)
    want = jm.attention_seq(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                            2, causal=True, window=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    kc = q[:, :, 0].reshape(1, 2, 64)
    got = attention_decode(torch.from_numpy(q[:, 0]), torch.from_numpy(kc),
                           torch.from_numpy(kc), 2, 1, window=2)
    want = jm.attention_decode(jnp.asarray(q[:, 0]), jnp.asarray(kc),
                               jnp.asarray(kc), 2, jnp.asarray(1), window=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    dense = get_config("granite-3-8b").reduced()
    # items 12 and 14 are served: the legacy baselines and speculation
    # build a cluster on the CPU
    for kw in ({"tickless": False}, {"spec": "auto"},
               {"decode_kwargs": {"fused": False}},
               {"prefill_kwargs": {"bucket_prefill": False}}):
        fe = ClusterFrontend(dense, device="cpu", **kw)
        g = fe.groups["default"]
        eng, pre = g.decodes[0].engine, g.prefills[0].engine
        assert fe.tickless == kw.get("tickless", True)
        assert (eng.spec is not None) == ("spec" in kw)
        assert eng.fused == ("decode_kwargs" not in kw)
        assert pre.bucket_prefill == ("prefill_kwargs" not in kw)
    mc = MiniCluster(dense, device="cpu", tickless=False)
    assert not mc.frontend.tickless
    fe = ClusterFrontend(dense, device="cpu", spec=SpecConfig(
        dense, mc.params, k=2))
    assert fe.groups["default"].decodes[0].engine.spec.k == 2
    # item 11 is served: the encoder-decoder and the VLM backbone build
    # a cluster on the CPU (with the cross-attention slot state)
    for arch in ("whisper-base", "pixtral-12b"):
        cfg = get_config(arch).reduced()
        mc = MiniCluster(cfg, device="cpu")
        slots = mc.decodes[0].engine._slot_layers["sub0"]
        assert ("xk" in slots) == cfg.is_encoder_decoder
    # items 13, 15 and 16 are served: absorption and the control plane
    # build on the CPU
    fe = ClusterFrontend(
        dense, device="cpu", adjust_ratio=True, absorb_prefill=True,
        faults=FaultPlan([FaultEvent(0.5, "crash", "g0/D0")]),
        service_model=DeterministicService())
    g = fe.groups["default"]
    assert fe.adjusters["default"].group is g and g.ft.group is g
    assert g.absorb_prefill and g.absorbs["absorb_requests"] == 0


_CUDA_PROBE = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "jaxlib", "repro", "torch_parity", "conftest") \
                or name.startswith(("jax.", "jaxlib.", "repro.")):
            raise ImportError(f"{name} is blocked in this process")
        return None

sys.meta_path.insert(0, _Block())
import importlib.util
spec = importlib.util.spec_from_file_location("torch_cuda_tests", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
tests = sorted(n for n in dir(mod) if n.startswith("test_"))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "torch_parity",
                                    "conftest"))
print(len(tests), bad)
"""


def test_cuda_test_file_imports_no_jax():
    """tests/test_torch_cuda.py runs where the card is and JAX is not:
    it names no jax, repro, torch_parity or conftest import, and loads
    with those blocked."""
    path = ROOT / "tests" / "test_torch_cuda.py"
    text = path.read_text()
    pat = re.compile(r"^\s*(import\s+(jax|repro|torch_parity|conftest)\b|"
                     r"from\s+(jax|repro|torch_parity|conftest)\b[\s.])",
                     re.M)
    assert not pat.search(text)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _CUDA_PROBE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.strip().split(" ", 1)
    assert bad == "[]", bad
    assert int(count) >= 4          # the card-side cases are all there
