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
        assert not pat.search(f.read_text()), f


def test_default_device_refuses_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.serving.cluster import MiniCluster
    cfg = get_config("granite-3-8b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MiniCluster(cfg)


def test_out_of_scope_features_raise_not_implemented():
    from repro_torch.configs import get_config
    from repro_torch.serving.cluster import MiniCluster
    from repro_torch.serving.frontend import ClusterFrontend
    dense = get_config("granite-3-8b").reduced()
    for arch in ("whisper-base", "pixtral-12b"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP.md queue A item 11"):
            MiniCluster(get_config(arch).reduced(), device="cpu")
    for kw in ({"tickless": False}, {"adjust_ratio": True},
               {"faults": object()}, {"spec": object()},
               {"absorb_prefill": True},
               {"decode_kwargs": {"fused": False}},
               {"prefill_kwargs": {"bucket_prefill": False}}):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            ClusterFrontend(dense, device="cpu", **kw)
