"""A tiny cell end to end on the CPU: the harness drives the port's real
serving path (plain kernels on the CPU) and prints a well-formed result
line with ``correct`` true."""
import json

import pytest
import torch

from pdbench import run as bench_run
from pdbench import weights
from pdbench.tests import tiny

CPU_DEVICE = {"platform": "cpu", "kind": "cpu", "count": 1,
              "memory_peak_bytes": 0}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("pdbench"))


@pytest.mark.parametrize("workload", ["tiny.tiny-chat",
                                      "tiny-moe.tiny-unshared"])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_prints_a_correct_line(root, workload, trace, capsys):
    cell, rec, out = tiny.run(root, workload, seed=2**31 + 11,
                              trace=trace)
    bench_run.emit(out, CPU_DEVICE)
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True, line["check"]
    assert line["attempted"] > 0 and line["failed"] == 0
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        # no device trace on the CPU: only host-side layers read
        assert {"prefix_reuse_share", "decode_step_ms",
                "mfu"} <= set(line["metrics"])
    err = captured.err.strip().splitlines()
    assert err[-1].startswith("check tokens_compared")
    assert err[-2].startswith("check logit_gap_max")
    assert set(line["check"]) == {"logit_gap_max", "tokens_compared"}


def test_the_control_is_judged_by_the_cells_own_limits(root):
    from pdbench.control import as_control
    cell, rec, out = tiny.run(root, "tiny.tiny-chat", seed=2**31 + 13)
    assert out["correct"] is True
    limit = cell.config["checks"]["logit_gap_max"]
    rec.check.update(control_gap_max=limit / 2, control_mismatch_share=0.0)
    assert bench_run.result(cell, as_control(rec), False)["correct"]
    rec.check["control_gap_max"] = 2 * limit
    ctl = bench_run.result(cell, as_control(rec), False)
    assert ctl["correct"] is False
    assert ctl["check"]["logit_gap_max"] == {"value": 2 * limit,
                                             "limit": limit}


def test_same_seed_same_weights():
    a = weights.make(tiny.TINY_MOE, 2**31 + 7, "cpu")
    b = weights.make(tiny.TINY_MOE, 2**31 + 7, "cpu")
    c = weights.make(tiny.TINY_MOE, 8, "cpu")
    la = weights.layout(tiny.TINY_MOE)
    for path, shape, _ in la:
        x, y, z = a, b, c
        for k in path:
            x, y, z = x[k], y[k], z[k]
        assert x.shape == shape and torch.equal(x, y)
    assert not torch.equal(a["embed"], c["embed"])
    assert {p for p, _ in _leaves(a)} == {p for p, _, _ in la}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v
