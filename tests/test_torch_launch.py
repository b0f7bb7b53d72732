"""The port's launch and distribution layer against the JAX package:
dense-cache shapes and bytes, the rule tables' specs for every leaf,
mesh and mode, each mesh coordinate's slice against JAX's
``devices_indices_map``, the meta-device input specs, the planner's
formulas, and the flop counter against JAX's HLO cost model.

Tolerances, each stated where it is checked: shapes, specs, slices and
the copied formulas exactly; the counted matmul flops within 2% of the
dot flops of JAX's lowering; the dense family's counted train-step flops
within 1% of ``model_flops_total`` plus the attention kernels' own
count.
"""
import itertools
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ALIASES, get_config as jax_config
from repro.distribution import sharding as jsh
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.launch.hlo_cost import HloCostModel, analyze_text
from repro.launch.mesh import make_test_mesh
from repro.models import caches as jcaches
from repro.models import params as jparams
from repro.models import steps as jsteps
from repro.models.config import INPUT_SHAPES
from repro_torch.configs import get_config
from repro_torch.distribution import sharding as tsh
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.cost import attention_pairs, count
from repro_torch.launch.specs import input_specs
from repro_torch.models import caches as tcaches
from repro_torch.models import steps as tsteps
from repro_torch.models.params import abstract_params
from torch_parity import both_params

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(ALIASES)
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 1, "model": 1}]
MODES = ["train", "prefill", "decode", "decode_opt", "prefill_ep",
         "decode_opt2", "decode_opt3"]


def _flat(tree, path=()):
    """{key path: leaf} of a nested dict (JAX's trees are dicts too)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _jax_specs(axes, shapes, mesh_shape, rules):
    fake = types.SimpleNamespace(shape=mesh_shape)
    return jax.tree.map(
        lambda a, sds: tuple(jsh.spec_from_axes(a, sds.shape, fake, rules)),
        axes, shapes, is_leaf=_is_axes)


def _dt(x) -> str:
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shapes_bytes_and_zeros_match_jax(arch):
    cfg, pcfg = jax_config(arch), get_config(arch)
    for b, s, w in ((2, 64, None), (1, 524288, 8192), (3, 48, 16)):
        assert tcaches.cache_shapes(pcfg, b, s, window=w) == \
            jcaches.cache_shapes(cfg, b, s, window=w)
        for bpe in (2, 4):
            assert tcaches.cache_num_bytes(pcfg, b, s, window=w,
                                           bytes_per_el=bpe) == \
                jcaches.cache_num_bytes(cfg, b, s, window=w,
                                        bytes_per_el=bpe)
    rcfg, rpcfg = cfg.reduced(), pcfg.reduced()
    for dtype, jdt in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
        got = tcaches.zeros_cache(rpcfg, 2, 24, window=8, dtype=dtype,
                                  pos=5, device="cpu")
        want = jcaches.zeros_cache(rcfg, 2, 24, window=8, dtype=jdt, pos=5)
        assert got["pos"] == int(want["pos"]) == 5
        g, w_ = _flat(got["layers"]), _flat(want["layers"])
        assert g.keys() == w_.keys()
        for k in g:
            assert tuple(g[k].shape) == w_[k].shape, k
            assert _dt(g[k]) == str(w_[k].dtype), k
            assert not g[k].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_from_axes_matches_jax_on_every_leaf(arch):
    """Every param, cache and batch leaf of the family, every shape,
    every mode of ShardingRules.for_mode, on the 16x16, 2x16x16 and 1x1
    meshes: the port's specs equal JAX's ``spec_from_axes`` (which reads
    only ``mesh.shape``)."""
    cfg, pcfg = jax_config(arch), get_config(arch)
    p_abs, p_axes = jparams.abstract_params(cfg), jparams.param_axes(cfg)
    n = 0
    for mesh_shape, mode, shape in itertools.product(
            MESHES, MODES, INPUT_SHAPES.values()):
        if shape.kind == "train" and mode != "train":
            continue
        rules = jsh.ShardingRules.for_mode(mode)
        want = {"params": _jax_specs(p_axes, p_abs, mesh_shape,
                                     rules.params)}
        if shape.kind == "decode":
            w = jsteps.decode_window(cfg, shape)
            b, s = shape.global_batch, shape.seq_len
            want["cache"] = _jax_specs(
                jcaches.cache_axes(cfg, b, s, window=w),
                jcaches.abstract_cache(cfg, b, s, window=w), mesh_shape,
                rules.cache)
            tok = jax.ShapeDtypeStruct((b,), jnp.int32)
            want["tok"] = tuple(jsh.spec_from_axes(
                ("batch",), tok.shape, types.SimpleNamespace(
                    shape=mesh_shape), rules.batch))
        else:
            batch = jspecs.batch_specs(cfg, shape)
            want["batch"] = _jax_specs(jsh.batch_axes_for(batch), batch,
                                       mesh_shape, rules.batch)
        _, specs = input_specs(pcfg, shape, mesh_shape, mode=mode)
        got = {"params": specs[0]}
        if shape.kind == "decode":
            got["cache"], got["tok"] = specs[1], specs[2]
        else:
            got["batch"] = specs[-1]
            if shape.kind == "train":
                assert specs[1]["mu"] == specs[1]["nu"] == specs[0]
        g, w_ = _flat(got), _flat(want)
        assert g == w_, (arch, mesh_shape, mode, shape.name)
        n += len(g)
    assert n > 0


def _leaves(tree, specs=False):
    """Leaves in insertion order (spec tuples are leaves of a spec
    tree)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v, specs)]
    if isinstance(tree, (list, tuple)) and not (specs and _is_axes_spec(
            tree)):
        return [x for v in tree for x in _leaves(v, specs)]
    return [tree]


def _is_axes_spec(t):
    return all(e is None or isinstance(e, (str, tuple)) for e in t) and \
        not any(isinstance(e, dict) for e in t)


_JAX_SIDE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
import numpy as np
assert len(jax.devices()) == 8
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.stdin.read())
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
pos = {d.id: idx for idx, d in np.ndenumerate(mesh.devices)}
out = []
for shape, spec in cases:
    spec = [tuple(e) if isinstance(e, list) else e for e in spec]
    m = NamedSharding(mesh, P(*spec)).devices_indices_map(tuple(shape))
    got = {}
    for dev, idx in m.items():
        got[str(list(pos[dev.id]))] = [
            list(sl.indices(n)[:2]) for sl, n in zip(idx, shape)]
    out.append(got)
# the dry-run module sets a 512-device XLA_FLAGS when imported: import it
# after the backend is up
from repro.configs import ALIASES, get_config
from repro.launch import dryrun
from repro.models.config import INPUT_SHAPES
flops = {f"{a}|{s}": dryrun.model_flops_total(get_config(a), sh)
         for a in ALIASES for s, sh in INPUT_SHAPES.items()}
skips = {f"{a}|{s}": dryrun.skip_reason(a, s)
         for a in ALIASES for s in INPUT_SHAPES}
print(json.dumps({"maps": out, "flops": flops, "skips": skips}))
"""


def test_slices_match_devices_indices_map_and_dtensor():
    """On a (pod, data, model) = (2, 2, 2) mesh of 8 CPU devices (a
    subprocess: the device count is fixed when JAX starts), every
    coordinate's slice of every leaf of four families equals JAX's
    ``devices_indices_map``; where DTensor's Shard placements can state
    the layout they give the same local shape and offset, and where a
    dim names mesh axes against the mesh's order ``placements`` refuses.
    The same process gives JAX's ``model_flops_total`` and
    ``skip_reason`` for every family and shape, which the port's equal
    exactly."""
    from torch.distributed.tensor._utils import \
        _compute_local_shape_and_global_offset as dtensor_local
    mesh_shape = {"pod": 2, "data": 2, "model": 2}
    cases = set()
    for arch in ("granite-3-8b", "deepseek-moe-16b", "jamba-1.5-large-398b",
                 "whisper-base"):
        for mode, shape in (("train", "train_4k"), ("decode", "long_500k"),
                            ("decode_opt2", "decode_32k"),
                            ("prefill_ep", "prefill_32k")):
            args, specs = input_specs(get_config(arch), INPUT_SHAPES[shape],
                                      mesh_shape, mode=mode)
            for leaf, spec in zip(_leaves(args), _leaves(specs, True)):
                cases.add((tuple(leaf.shape), spec))
    cases = sorted(cases, key=repr)
    payload = [[list(sh), [list(e) if isinstance(e, tuple) else e
                           for e in sp]] for sh, sp in cases]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE],
                         input=json.dumps(payload), env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    got_jax = json.loads(res.stdout)
    refused = 0
    for (shape, spec), want in zip(cases, got_jax["maps"]):
        mine = tsh.local_slices(spec, shape, mesh_shape)
        assert {str(list(c)): [[sl.start, sl.stop] for sl in sls]
                for c, sls in mine.items()} == want, (shape, spec)
        try:
            pl = tsh.placements(spec, mesh_shape)
        except ValueError:
            refused += 1
            continue
        for c, sls in mine.items():
            lshape, off = dtensor_local(shape, (2, 2, 2), list(c), pl)
            assert list(lshape) == [sl.stop - sl.start for sl in sls]
            assert list(off) == [sl.start for sl in sls], (shape, spec, c)
    assert refused > 0        # deepseek's 64 experts over ("data", "pod")
    for key, flops in got_jax["flops"].items():
        arch, shape = key.split("|")
        assert dryrun.model_flops_total(get_config(arch),
                                        INPUT_SHAPES[shape]) == flops, key
        assert dryrun.skip_reason(arch, shape) == got_jax["skips"][key]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_shapes_and_dtypes_match_jax(arch):
    cfg, pcfg = jax_config(arch), get_config(arch)
    mesh = make_test_mesh()
    for shape in INPUT_SHAPES.values():
        want, _ = jspecs.input_specs(cfg, shape, mesh)
        got, _ = input_specs(pcfg, shape, {"data": 1, "model": 1})
        w = _flat({str(i): t for i, t in enumerate(want)})
        g = _flat({str(i): t for i, t in enumerate(got)})
        assert g.keys() == w.keys(), (arch, shape.name)
        for k in g:
            assert g[k].device.type == "meta"
            assert tuple(g[k].shape) == w[k].shape, (arch, shape.name, k)
            assert _dt(g[k]) == str(w[k].dtype), (arch, shape.name, k)


def test_analytic_bytes_floor_matches_jax():
    for kind in ("train", "prefill", "decode"):
        for args in ((1e9, 3e8, 4096.0, 4096, 40),
                     (2.5e7, 0.0, 1.0, 512, 6)):
            kw = dict(zip(("params_bytes_dev", "cache_bytes_dev",
                           "tokens_dev", "d_model", "num_layers"), args),
                      kind=kind)
            assert roofline.analytic_bytes_floor(**kw) == \
                jroof.analytic_bytes_floor(**kw)


def _dot_flops(model: HloCostModel, comp: str, memo=None) -> float:
    """The dot flops alone of ``analyze_text``'s walk (loops multiplied
    by their trip counts, fusions and calls entered)."""
    memo = {} if memo is None else memo
    if comp in memo:
        return memo[comp]
    memo[comp] = 0.0
    total = 0.0
    for inst in model.computations.get(comp, []):
        called = [m for m in re.findall(
            r"(?:calls|to_apply|body|condition)=%?([\w\.\-]+)", inst.rest)
            if m in model.computations]
        mult = model._trip_count(inst) if inst.opcode == "while" else 1
        total += mult * sum(_dot_flops(model, c, memo) for c in called)
        if inst.opcode in ("dot", "dot_general"):
            total += model._dot_flops(inst)
    memo[comp] = total
    return total


def _jax_dots(fn, *args):
    text = jax.jit(fn).lower(*args).compile().as_text()
    m = HloCostModel(text)
    return _dot_flops(m, m.entry), analyze_text(text).flops


def test_cost_matmul_flops_match_jax_hlo_dots():
    """Reduced granite: the prefill step (2 x 16 tokens) and the windowed
    serve step (W = 8 over a 64-token cache) traced on meta. Counted
    matmul flops within 2% of the dot flops of JAX's CPU lowering of the
    same step; the prefill adds the dense attention einsums JAX's jnp
    attention computes (4 * b * s * s * nq * hd a layer), which the port's
    kernel replaces. The ratio to analyze_text's total (which also counts
    elementwise ops by another convention) is printed, not held."""
    cfg, jp, pcfg, _ = both_params("granite-3-8b")
    b, s, W = 2, 16, 8
    p_meta = abstract_params(pcfg, torch.float32)
    toks = jnp.zeros((b, s), jnp.int32)
    jd, jtot = _jax_dots(jsteps.make_prefill_step(cfg), jp,
                         {"tokens": toks})
    c = count(tsteps.make_prefill_step(pcfg), p_meta,
              {"tokens": torch.empty((b, s), dtype=torch.int32,
                                     device="meta")})
    dense_attn = cfg.num_layers * 4 * b * s * s * cfg.num_heads * cfg.hd
    got = c.matmul_flops + dense_attn
    assert abs(got / jd - 1) < 0.02, (got, jd)
    print(f"prefill: counted {got:.4g} vs JAX dots {jd:.4g}; "
          f"analyze_text total {jtot:.4g} (ratio {c.flops / jtot:.3f})")
    assert c.kernels["flash_prefill"]["calls"] == cfg.num_layers
    assert c.kernel_flops == cfg.num_layers * 4 * cfg.num_heads * cfg.hd \
        * attention_pairs(b, s, s, 0, 0, True, None)

    jcache = jcaches.zeros_cache(cfg, b, 64, window=W, pos=40)
    jd, jtot = _jax_dots(jsteps.make_serve_step(cfg, window=W), jp, jcache,
                         jnp.zeros((b,), jnp.int32))
    tcache = tcaches.abstract_cache(pcfg, b, 64, window=W,
                                    dtype=torch.float32)
    tcache["pos"] = 40
    c = count(tsteps.make_serve_step(pcfg, window=W), p_meta, tcache,
              torch.empty((b,), dtype=torch.int32, device="meta"))
    assert abs(c.matmul_flops / jd - 1) < 0.02, (c.matmul_flops, jd)
    print(f"windowed decode: counted {c.flops:.4g} vs JAX dots {jd:.4g}; "
          f"analyze_text total {jtot:.4g} (ratio {c.flops / jtot:.3f})")


@pytest.mark.parametrize("arch", ["granite-3-8b", "minicpm-2b"])
def test_cost_dense_train_flops_match_model_flops(arch):
    """A dense family's train step (no remat) counted on meta: within 1%
    of model_flops_total (6 N D) plus the attention kernels' own count
    (forward and backward)."""
    pcfg = get_config(arch).reduced()
    shape = INPUT_SHAPES["train_4k"].__class__("t", 64, 4, "train")
    args, _ = input_specs(pcfg, shape, {"data": 1, "model": 1},
                          param_dtype=torch.float32)
    c = count(tsteps.make_train_step(pcfg, remat=False), *args)
    want = dryrun.model_flops_total(pcfg, shape) + c.kernel_flops
    assert abs(c.flops / want - 1) < 0.01, (c.flops, want)
    assert set(c.kernels) == {"flash_prefill", "flash_prefill_bwd"}


def test_meta_tensors_run_nothing_outside_the_counter():
    q = torch.empty((1, 8, 2, 32), device="meta")
    from repro_torch.kernels import ops
    with pytest.raises(ValueError, match="meta tensors only count"):
        ops.flash_prefill(q, q, q)


def test_dryrun_cli_plans_on_meta(tmp_path, capsys):
    out = tmp_path / "plan.json"
    assert dryrun.main(["--arch", "granite-3-8b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("[dryrun] granite-3-8b x long_500k x 16x16")
    r = json.loads(out.read_text())
    assert r["roofline"]["dominant"] == "memory"
    assert r["roofline"]["collective_s"] is None
    assert dryrun.main(["--arch", "whisper-base", "--shape",
                        "long_500k"]) == 0
    assert capsys.readouterr().out.startswith("skip:")


@pytest.mark.parametrize("causal,s,sk", [(True, 24, 24), (False, 24, 40),
                                         (False, 40, 24)])
def test_cost_flash_prefill_bwd_charges_its_mode(causal, s, sk):
    """The backward's meta charge: 2.5 x the forward's 4 flops a pair,
    per query head and head dim, on the mode's live pairs (causal s (s +
    1) / 2, non-causal s x sk), and q, o, do, dq at s, k, v, dk, dv at
    sk and the LSE, each moved once."""
    from repro_torch.kernels import ops
    b, nq, nkv, hd = 2, 8, 2, 64

    def step(q, k, v):
        leaves = [x.requires_grad_() for x in (q, k, v)]
        out = ops.flash_prefill(*leaves, causal=causal)
        return torch.autograd.grad(out, leaves, torch.ones_like(out))
    c = count(step, *(torch.empty(shape, device="meta") for shape in (
        (b, s, nq, hd), (b, sk, nkv, hd), (b, sk, nkv, hd))))
    pairs = b * (s * (s + 1) // 2 if causal else s * sk)
    bwd = c.kernels["flash_prefill_bwd"]
    assert bwd["calls"] == 1
    assert bwd["flops"] == 2.5 * 4 * pairs * nq * hd
    assert bwd["bytes"] == 4 * (4 * b * s * nq * hd + 4 * b * sk * nkv * hd
                                + b * nq * s)
    assert c.kernels["flash_prefill"]["flops"] == 4 * pairs * nq * hd


def test_cost_whisper_train_step_charges_each_attention():
    """Reduced whisper's train step (no remat) on meta: the backward is
    charged once per attention sublayer, the encoder's non-causal
    enc x enc pairs, the decoder's causal s x s and cross-attention's s x
    enc, each at 2.5 x 4 flops a pair per head and head dim."""
    pcfg = get_config("whisper-base").reduced()
    shape = INPUT_SHAPES["train_4k"].__class__("t", 24, 2, "train")
    b, s, enc = shape.global_batch, shape.seq_len, pcfg.encoder_seq
    args, _ = input_specs(pcfg, shape, {"data": 1, "model": 1},
                          param_dtype=torch.float32)
    assert args[2]["frames"].shape == (b, enc, pcfg.d_model)
    c = count(tsteps.make_train_step(pcfg, remat=False), *args)
    L, E = pcfg.num_layers, pcfg.encoder_layers
    per_pair = 2.5 * 4 * pcfg.num_heads * pcfg.hd
    bwd = c.kernels["flash_prefill_bwd"]
    assert bwd["calls"] == E + 2 * L
    assert bwd["flops"] == per_pair * b * (
        E * enc * enc + L * s * (s + 1) // 2 + L * s * enc)
