"""The port's training I/O against the JAX package's: SyntheticLM and
text_to_tokens byte for byte, checkpoints in either direction (leaves
equal, manifests equal), the decode window policy, and the port's
training launcher on the CPU. No tolerance anywhere: these are copies.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_params as jax_load
from repro.checkpoint import save_params as jax_save
from repro.configs import get_config as jax_config
from repro.data import SyntheticLM as JaxLM
from repro.data import text_to_tokens as jax_text_to_tokens
from repro.models.config import INPUT_SHAPES as JAX_SHAPES
from repro.models.steps import decode_window as jax_decode_window
from repro_torch.checkpoint import load_params, save_params
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM, text_to_tokens
from repro_torch.launch import train
from repro_torch.models.config import INPUT_SHAPES
from repro_torch.models.params import (params_from_numpy, params_to_numpy,
                                       tree_leaves)
from repro_torch.models.steps import decode_window
from torch_parity import ALL_ARCHS, both_params


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (0, 512, 64, 2), (1, 122753, 33, 3), (7, 50, 128, 1)])
def test_synthetic_lm_batches_are_byte_equal(seed, vocab, seq, batch):
    ours, theirs = SyntheticLM(vocab, seq, batch, seed=seed), \
        JaxLM(vocab, seq, batch, seed=seed)
    for step in (0, 1, 5):
        a, b = ours.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes(), (k, step)
    text = "P/D-Serve: disaggregated serving at scale"
    assert text_to_tokens(text, vocab).tobytes() == \
        jax_text_to_tokens(text, vocab).tobytes()


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "mamba2-2.7b"])
def test_checkpoints_load_across_packages(arch, tmp_path):
    cfg, jp, pcfg, tp = both_params(arch)
    # JAX saves, the port loads
    jax_save(str(tmp_path / "jax"), jp, step=3, meta={"from": "jax"})
    got = load_params(str(tmp_path / "jax"), tp, device="cpu")
    for a, w in zip(tree_leaves(got), jax.tree.leaves(jp)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
    # the port saves, JAX loads
    save_params(str(tmp_path / "port"), tp, step=3, meta={"from": "jax"})
    back = jax_load(str(tmp_path / "port"), jp)
    for a, w in zip(jax.tree.leaves(back), tree_leaves(tp)):
        np.testing.assert_array_equal(np.asarray(a), w.numpy())
    manifests = [json.loads((tmp_path / f"{w}.manifest.json").read_text())
                 for w in ("jax", "port")]
    assert manifests[0] == manifests[1]
    # params_to_numpy reverses params_from_numpy
    again = params_from_numpy(pcfg, params_to_numpy(tp), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again),
                                                 tree_leaves(tp)))


def test_decode_window_equals_jax():
    for arch in ALL_ARCHS:
        pcfg, jcfg = get_config(arch), jax_config(arch)
        for name in INPUT_SHAPES:
            assert decode_window(pcfg, INPUT_SHAPES[name]) == \
                jax_decode_window(jcfg, JAX_SHAPES[name]), (arch, name)


def test_launcher_trains_reduced_on_cpu(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    rc = train.main(["--reduced", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--seq", "32", "--save", ckpt])
    out = capsys.readouterr().out
    assert "minicpm-2b-reduced" in out and "saved ->" in out
    assert rc == (0 if "(improved)" in out else 1)
    saved = json.loads(open(ckpt + ".manifest.json").read())
    assert saved["step"] == 2
    params = load_params(ckpt, both_params("minicpm-2b")[3], device="cpu")
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
