"""Fine-grained P/D organization on the RoCE map (paper §3.2-3.3).

A PDGroup binds a scenario to a set of prefill/decode instances via the
MetaStore, runs the setup workflow (gather IPs -> init order -> connect ->
load pre-compiled model -> health reports), and supports dynamic RoCE
(re)construction for ratio adjustment, group scaling and rolling upgrade —
all without service interruption (one group at a time). Copied from
``src/repro/core/group.py``.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.zookeeper import MetaStore

# The paper's container-workflow timeline (Fig. 13; model loads take
# minutes), in VIRTUAL seconds: gather RoCE IPs, connect, pre-compiled
# model load from SFS or SSD, health check. The serving path's crash
# recovery and scale-up provisioning charge it too (core/mlops.py).
# Nothing here was measured on a card.
T_GATHER = 2.0
T_CONNECT = 5.0
T_LOAD_SFS = 180.0
T_LOAD_SSD = 75.0
T_HEALTH = 1.0

_iid = itertools.count()


@dataclass
class WorkflowEvent:
    t: float
    step: str
    detail: str = ""


class PDGroup:
    def __init__(self, gid: str, scenario: Optional[str], meta: MetaStore,
                 *, storage: str = "ssd"):
        self.gid = gid
        self.scenario = scenario
        self.meta = meta
        self.storage = storage
        self.timeline: List[WorkflowEvent] = []
        meta.register_group(gid, scenario)

    # ------------------------------------------------------- setup (§3.2)
    def setup(self, t: float, n_prefill: int, n_decode: int) -> float:
        """Runs the 6-step workflow; returns completion time."""
        tl = self.timeline
        # 1: gather RoCE IPs per instance, report to zookeeper
        for i in range(n_prefill):
            self.meta.gather_instance(t, f"{self.gid}/P{next(_iid)}", "P",
                                      self.gid)
        for i in range(n_decode):
            self.meta.gather_instance(t, f"{self.gid}/D{next(_iid)}", "D",
                                      self.gid)
        t += T_GATHER
        tl.append(WorkflowEvent(t, "gathered",
                                f"{n_prefill}P+{n_decode}D"))
        assert self.meta.collection_complete(self.gid,
                                             n_prefill + n_decode)
        # 2: init order  3: establish connections (with verification)
        t += T_CONNECT
        tl.append(WorkflowEvent(t, "connected"))
        # 4: load pre-compiled models (role-specific)
        t += T_LOAD_SSD if self.storage == "ssd" else T_LOAD_SFS
        tl.append(WorkflowEvent(t, "model_loaded", self.storage))
        # 5: first health reports  6: zookeeper confirms, label entrances
        for iid in self.members("P") + self.members("D"):
            self.meta.health_report(t, iid)
        t += T_HEALTH
        tl.append(WorkflowEvent(t, "serving", "prefills labeled entrance"))
        return t

    def members(self, role: str) -> List[str]:
        return self.meta.group_members(self.gid, role)

    @property
    def ratio(self) -> Tuple[int, int]:
        return len(self.members("P")), len(self.members("D"))

    # -------------------------------------- dynamic RoCE adjustment (§3.3)
    def adjust_ratio(self, t: float, n_p: int, n_d: int) -> float:
        """Dynamic RoCE construction: stateless containers join / leave;
        running instances are never interrupted."""
        cur_p, cur_d = self.ratio
        # removals: logical removal first (no new traffic), then erase
        for iid in self.members("P")[n_p:]:
            self.meta.remove_instance(t, iid)
        for iid in self.members("D")[n_d:]:
            self.meta.remove_instance(t, iid)
        added = max(0, n_p - cur_p) + max(0, n_d - cur_d)
        for _ in range(max(0, n_p - cur_p)):
            self.meta.gather_instance(t, f"{self.gid}/P{next(_iid)}", "P",
                                      self.gid)
        for _ in range(max(0, n_d - cur_d)):
            self.meta.gather_instance(t, f"{self.gid}/D{next(_iid)}", "D",
                                      self.gid)
        if added:
            # new connections + model load for the added containers only
            t += T_CONNECT + (T_LOAD_SSD if self.storage == "ssd"
                              else T_LOAD_SFS)
        t += T_HEALTH  # zookeeper pushes updated decode meta to prefills
        self.timeline.append(WorkflowEvent(t, "ratio_adjusted",
                                           f"{n_p}:{n_d}"))
        return t

    # ----------------------------------------------- rolling upgrade (§3.3)
    def rolling_upgrade(self, t: float, groups: List["PDGroup"]) -> float:
        """Upgrade one group after another; each group keeps its P/D ratio
        so the service is never interrupted (traffic shifts to peers)."""
        for g in groups:
            n_p, n_d = g.ratio
            t = g.adjust_ratio(t, n_p, n_d)  # reload with new artifacts
            g.timeline.append(WorkflowEvent(t, "upgraded"))
        return t
