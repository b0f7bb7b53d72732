"""The port's six examples (``repro_torch.examples``) on ``--device cpu``,
against the JAX package's scripts in ``examples/`` where those are cheap
and deterministic, each run in-process with its stdout captured:

* ``quickstart``: the whole output equal to the JAX script's (the same
  streamed and final tokens), the port's cluster given the JAX script's
  params (``init_params(cfg, PRNGKey(0))``) through numpy;
* ``cluster_scale_sim``: the whole output equal (the simulator is a copy
  held to JAX with ``==``);
* ``ratio_autotuner``: the simulated part's three lines equal, both
  priced by JAX's ``profile_for(pangu-38b)`` (the port's own prices an
  H100 instance); the live part on the CPU converges and serves all;
* ``speculative_decoding``: both drafts emit the target's greedy tokens
  (forward_prefill + forward_decode on the same seeded params), the
  self-draft accepts every proposal;
* ``disaggregated_serving``: every request of every run done, and the
  prefix-reuse counts of four requests sharing a 16-token prefix;
* ``train_tiny``: the launcher gets the JAX script's argv; cut to 2
  layers x d64, the loss falls and the checkpoint is written.

And every example asks for the card by default: without one it raises.
"""
import contextlib
import dataclasses
import functools
import importlib
import importlib.util
import io
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.params import init_params as jax_init_params
from repro_torch.configs import get_config
from repro_torch.models.params import params_from_numpy

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ["quickstart", "disaggregated_serving", "speculative_decoding",
            "train_tiny", "cluster_scale_sim", "ratio_autotuner"]


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port_example(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def _jax_stdout(mod, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__])
    return _stdout(mod.main)[1]


def test_quickstart_equals_jax(monkeypatch):
    jmod, pmod = _jax_example("quickstart"), _port_example("quickstart")
    cfg = jax_config("granite-3-8b").reduced()
    pcfg = get_config("granite-3-8b").reduced()
    tp = params_from_numpy(pcfg, jax.tree.map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0))),
        device="cpu")
    want = _jax_stdout(jmod, monkeypatch)
    monkeypatch.setattr(pmod, "MiniCluster",
                        functools.partial(pmod.MiniCluster, params=tp))
    rc, got = _stdout(pmod.main, ["--device", "cpu"])
    assert rc == 0
    assert got == want
    assert got.count("[sse rid=") == 3 * 9 and got.endswith("ok\n")


def test_cluster_scale_sim_equals_jax(monkeypatch):
    want = _jax_stdout(_jax_example("cluster_scale_sim"), monkeypatch)
    rc, got = _stdout(_port_example("cluster_scale_sim").main,
                      ["--device", "cpu"])
    assert rc == 0 and got == want
    assert "faults recovered:" in got


def test_ratio_autotuner_simulated_part_equals_jax(monkeypatch):
    from repro.core.profiles import profile_for as jax_profile_for
    from repro_torch.core.profiles import ServingProfile
    jmod, pmod = (_jax_example("ratio_autotuner"),
                  _port_example("ratio_autotuner"))
    jprof = jax_profile_for(jax_config("pangu-38b"))
    monkeypatch.setattr(jmod, "live_adjustment", lambda: None)
    want = _jax_stdout(jmod, monkeypatch).splitlines()
    monkeypatch.setattr(pmod, "profile_for", lambda cfg: ServingProfile(
        **dataclasses.asdict(jprof)))
    rc, got = _stdout(pmod.main, ["--device", "cpu"])
    got = got.splitlines()
    assert rc == 0 and len(want) == 3
    assert got[:3] == want
    assert got[3] == "live: deployed 3P:1D, Eq.1 wants 1P:3D"
    assert re.fullmatch(r"live: final ratio \dP:\dD, served 6/6 during "
                        r"flips", got[-1]), got[-1]
    assert any("P->D" in line for line in got[4:-1])


def test_speculative_decoding_emits_target_greedy():
    from repro_torch.models.modeling import forward_decode, forward_prefill
    from repro_torch.models.params import init_params
    rc, out = _stdout(_port_example("speculative_decoding").main,
                      ["--device", "cpu"])
    assert rc == 0
    lines = out.splitlines()
    assert len(lines) == 2
    toks = [re.search(r"tokens=(\[[^\]]*\])", line).group(1)
            for line in lines]
    assert "acceptance=100.0%" in lines[0]
    cfg = get_config("granite-3-8b").reduced()
    params = init_params(cfg, torch.Generator().manual_seed(7),
                         device="cpu")
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, 12)
    with torch.no_grad():
        tok, cache = forward_prefill(cfg, params, {"tokens": torch.tensor(
            [prompt.tolist()], dtype=torch.int32)})
        cache = {"layers": {s: {n: torch.nn.functional.pad(x, (0, 0, 0, 8))
                                for n, x in c.items()}
                            for s, c in cache["layers"].items()},
                 "pos": cache["pos"]}
        greedy = [int(tok[0])]
        for _ in range(7):
            tok, cache = forward_decode(cfg, params, cache, tok)
            greedy.append(int(tok[0]))
    assert toks[0] == toks[1] == str(greedy)


def test_disaggregated_serving_serves_every_request():
    rc, out = _stdout(_port_example("disaggregated_serving").main,
                      ["--device", "cpu"])
    assert rc == 0
    assert "multi-group: 10/10 done" in out
    assert "prefix reuse: hit_rate=75% reused=48tok computed=36tok" in out
    for label in ("overlapped", "block_free", "block_fixed"):
        assert re.search(rf"  {label} *: 10/10 done", out), label
    assert "first instance RoCE IPs:" in out


def _flags(argv):
    """{flag: value, or None for a bare flag} of a launcher argv."""
    out = {}
    for i, t in enumerate(argv):
        if t.startswith("--"):
            nxt = argv[i + 1] if i + 1 < len(argv) else "--"
            out[t] = None if nxt.startswith("--") else nxt
    return out


def _argv(flags):
    return [t for f, v in flags.items() for t in (f, v) if t is not None]


def test_train_tiny_loss_falls(tmp_path, monkeypatch):
    """The port's train_tiny hands the launcher the JAX script's argv
    (plus ``--device`` and ``--save``); run here with the sizes cut to 2
    layers x d64, batch 2 x 32, the loss falls and the checkpoint is
    written."""
    jmod, pmod = _jax_example("train_tiny"), _port_example("train_tiny")
    seen = {}

    def jax_train(argv):
        seen["jax"] = argv
        return 0
    monkeypatch.setattr(jmod, "train_main", jax_train)
    monkeypatch.setattr(sys, "argv", [jmod.__file__, "--steps", "8"])
    with pytest.raises(SystemExit):
        jmod.main()
    train = pmod.train_main

    def cut_train(argv):
        seen["port"] = argv
        return train(_argv(dict(_flags(argv), **{
            "--d-model": "64", "--layers": "2", "--batch": "2",
            "--seq": "32"})))
    monkeypatch.setattr(pmod, "train_main", cut_train)
    ckpt = tmp_path / "ckpt_tiny.npz"
    rc, out = _stdout(pmod.main, ["--device", "cpu", "--steps", "8",
                                  "--save", str(ckpt)])
    assert _flags(seen["port"]) == dict(
        _flags(seen["jax"]), **{"--device": "cpu", "--save": str(ckpt)})
    assert rc == 0, out
    assert "(improved)" in out and ckpt.exists()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_asks_for_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="asks for a CUDA card"):
        _port_example(name).main([])
