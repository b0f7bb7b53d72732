"""The port's staged tick shim (ClusterFrontend(tickless=False):
ServeGroup.tick over the event handlers, ClusterFrontend.tick/run with
max_ticks, the staged form of _complete_flips) against the tickless core
and the JAX package's shim.

Greedy tokens must be equal (staged == tickless == JAX staged) on the
dense, MoE, hybrid and encoder-decoder families in both transfer modes'
default (overlapped). Under DeterministicService every virtual time is
a closed-form cost, so the staged event logs, MetaStore audit logs and
flips (stamped with tick numbers) equal JAX's exactly. Fault injection
needs the tickless core on both stacks.
"""
import numpy as np
import pytest

from repro.core.perf_model import InstanceProfile as JaxProfile
from repro.serving.cluster import MiniCluster as JaxMiniCluster
from repro.serving.cluster import ServeRequest as JaxRequest
from repro.serving.faults import DeterministicService as JaxService
from repro.serving.frontend import ClusterFrontend as JaxFrontend
from repro_torch.core.perf_model import InstanceProfile
from repro_torch.serving.cluster import MiniCluster, ServeRequest
from repro_torch.serving.faults import (DeterministicService, FaultEvent,
                                        FaultPlan)
from repro_torch.serving.frontend import ClusterFrontend
from torch_parity import both_params, moe_sorted, prompts, seeded_requests

# dense / MoE / hybrid SSM+attention / encoder-decoder
FAMILIES = ["granite-3-8b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b",
            "whisper-base"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_staged_equals_tickless_and_jax_staged(arch):
    """Three sequential requests (the third a warm prefix hit of the
    first) through 1P:2D: the port's staged shim emits its tickless
    core's tokens and JAX's staged shim's."""
    cfg, jp, pcfg, tp = both_params(arch)
    cfg, pcfg = moe_sorted(cfg), moe_sorted(pcfg)
    rng = np.random.default_rng(11)
    frames = None
    if cfg.is_encoder_decoder:
        frames = (rng.normal(size=(cfg.encoder_seq, cfg.d_model)) * 0.1
                  ).astype(np.float32)
    base, other, tail = prompts(cfg.vocab_size, rng, [11, 7, 4])
    toks = [base, other, base + tail]
    gens = {}
    for name, tickless in (("tickless", True), ("staged", False),
                           ("jax", False)):
        if name == "jax":
            mc = JaxMiniCluster(cfg, n_decode=2, params=jp,
                                tickless=tickless)
            cls = JaxRequest
        else:
            mc = MiniCluster(pcfg, n_decode=2, params=tp, device="cpu",
                             tickless=tickless)
            cls = ServeRequest
        out = []
        for i, t in enumerate(toks):
            req = cls(rid=i, tokens=list(t), max_new_tokens=3,
                      frames=frames)
            mc.run([req], max_ticks=80)
            assert req.done, (arch, name, i)
            out.append(list(req.generated))
        gens[name] = out
    assert gens["staged"] == gens["tickless"] == gens["jax"], arch


@pytest.mark.parametrize("overlap", [True, False])
def test_staged_logs_equal_jax_under_service_model(overlap):
    """2P:2D, eight requests, the RatioAdjuster on a profile whose Eq. 1
    optimum is 1P:3D: the staged shim flips P->D at the same tick as
    JAX's, and the event log, MetaStore audit log, flips and tokens are
    equal."""
    cfg, jp, pcfg, tp = both_params("granite-3-8b")
    prof = dict(ttft_bs=0.1, b_p=1, r_pre=1.0, tpot_bs=0.04, b_d=2,
                gen_tokens=16.0, xi=0.0)
    sides = {}
    for name in ("jax", "port"):
        kw = dict(topology={"default": (2, 2)}, adjust_ratio=True,
                  adjust_interval=1, overlap_transfer=overlap,
                  tickless=False, prefill_kwargs={"batch_size": 1})
        if name == "jax":
            fe = JaxFrontend(cfg, params=jp, service_model=JaxService(),
                             profiles={"default": JaxProfile(**prof)}, **kw)
            cls = JaxRequest
        else:
            fe = ClusterFrontend(pcfg, params=tp, device="cpu",
                                 service_model=DeterministicService(),
                                 profiles={"default": InstanceProfile(**prof)},
                                 **kw)
            cls = ServeRequest
        reqs = seeded_requests(cls, cfg.vocab_size, 8, max_new=5)
        fe.run(reqs, max_ticks=200)
        assert all(r.done for r in reqs), name
        g = fe.groups["default"]
        sides[name] = ({r.rid: list(r.generated) for r in reqs},
                       list(g.event_log), list(fe.meta.events), list(g.flips),
                       g.ratio, fe.tick_no, list(fe.adjusters["default"]
                                                 .decisions))
    assert sides["port"] == sides["jax"]
    assert [f[3] for f in sides["port"][3]] == ["P->D"]


def test_staged_shim_refuses_faults():
    _, _, pcfg, tp = both_params("granite-3-8b")
    plan = FaultPlan([FaultEvent(0.5, "crash", "g0/D0")])
    with pytest.raises(ValueError, match="tickless=True"):
        ClusterFrontend(pcfg, params=tp, device="cpu", faults=plan,
                        tickless=False)
    fe = ClusterFrontend(pcfg, params=tp, device="cpu", faults=plan)
    with pytest.raises(RuntimeError, match="tickless event loop"):
        fe.tick()
