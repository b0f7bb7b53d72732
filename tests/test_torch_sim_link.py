"""The port's link model against the JAX package's, and the overlap
model shared by the simulator and the real path: the port's
TransferScheduler reports ``LinkModel.per_layer_completion`` and
``per_layer_tail`` for an uncontended single transfer (the counterpart
of tests/test_transfer.py's reconciliation)."""
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core.transfer import KVTransferEngine as JaxEngine
from repro.core.transfer import LinkModel as JaxLink
from repro_torch.configs import get_config
from repro_torch.core.transfer import KVTransferEngine, LinkModel
from repro_torch.serving.kvcache import PagedKVPool
from repro_torch.serving.transfer_sched import TransferScheduler

LINKS = [dict(), dict(bandwidth=10e9, c_ctrl=80e-6),
         dict(hops=2, conflict_prob=0.3, conflict_penalty=0.2)]


@pytest.mark.parametrize("kw", LINKS)
def test_link_model_methods_equal(kw):
    """time (with the conflict draws of a seeded rng), utilization,
    per_layer_completion, per_layer_tail and the engine's time_only in
    every mode: equal to JAX's."""
    j, p = JaxLink(**kw), LinkModel(**kw)
    rj, rp = random.Random(3), random.Random(3)
    ej, ep = JaxEngine(j, seed=5), KVTransferEngine(p, seed=5)
    for nbytes in (0, 4096, 13 << 20, 5e9):
        for n in (1, 7, 40, 1280):
            assert j.time(nbytes, n, rj) == p.time(nbytes, n, rp)
            for mode, pl in (("block_fixed", False), ("block_free", False),
                             ("block_free", True)):
                assert ej.time_only(nbytes, block_bytes=65536, layers=n,
                                    mode=mode, per_layer=pl) \
                    == ep.time_only(nbytes, block_bytes=65536, layers=n,
                                    mode=mode, per_layer=pl)
            assert j.time(nbytes, n) == p.time(nbytes, n)
            if nbytes:
                assert j.utilization(nbytes, n) == p.utilization(nbytes, n)
            for compute in (0.0, 1e-3, 0.25, 10.0):
                assert j.per_layer_completion(nbytes, n, compute) \
                    == p.per_layer_completion(nbytes, n, compute)
                assert j.per_layer_tail(nbytes, n, compute) \
                    == p.per_layer_tail(nbytes, n, compute)
    assert p.per_layer_completion(4096, 0, 1.0) \
        == p.per_layer_completion(4096, 1, 1.0)


@pytest.mark.parametrize("compute_s", [0.0, 0.004, 10.0])
def test_scheduler_reports_link_model_per_layer_timing(compute_s):
    """An uncontended per-layer transfer through the port's scheduler is
    admitted at ``per_layer_completion`` after its prefill start, and
    waits ``per_layer_tail`` after prefill-done, within 1e-12; with no
    compute to hide behind, its busy time is one message per layer."""
    cfg = get_config("granite-3-8b").reduced()
    link = LinkModel()
    tokens = 13
    pool = PagedKVPool(cfg, num_blocks=32, block_size=4, device="cpu")
    dst = SimpleNamespace(iid="D0", pool=pool, draining=False)
    sched = TransferScheduler(link)
    rng = np.random.default_rng(0)
    L = pool.attn_layers
    k, v = (torch.from_numpy(rng.normal(size=(L, tokens, cfg.kv_dim))
                             .astype(np.float32)) for _ in range(2))
    out = SimpleNamespace(k=k, v=v, prompt_len=tokens, mamba_state={},
                          cross=None)
    req = SimpleNamespace(rid=1, max_new_tokens=0)
    job = sched.begin(req, out, src_iid="P0", dst=dst, t_start=0.0,
                      compute_s=compute_s)
    while not sched.idle():
        sched.pump(sched.next_event())
    nbytes = L * pool.layer_nbytes(pool.blocks_for_tokens(tokens))
    assert abs(job.admitted_t
               - link.per_layer_completion(nbytes, L, compute_s)) < 1e-12
    assert abs(job.admission_wait
               - link.per_layer_tail(nbytes, L, compute_s)) < 1e-12
    # the JAX link model gives the same closed form
    assert link.per_layer_tail(nbytes, L, compute_s) \
        == JaxLink().per_layer_tail(nbytes, L, compute_s)
    if compute_s == 0.0:
        t_pl = KVTransferEngine(link).time_only(
            nbytes, block_bytes=4 * pool.width * 4, layers=L,
            mode="block_free", per_layer=True)
        assert abs(job.admitted_t - t_pl) < 1e-12
        assert abs(job.transfer_busy_s - t_pl) < 1e-12
    # the bytes landed: the destination holds the request's K ++ V rows
    blocks = pool.owned(1)
    got = pool.gather_contiguous(blocks)[:, :tokens]
    assert torch.equal(got, torch.cat([k, v], dim=-1))
