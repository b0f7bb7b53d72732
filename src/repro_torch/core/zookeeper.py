"""Metadata store (the paper's Zookeeper role, §3.2), copied from
``src/repro/core/zookeeper.py`` (no tensors in it).

Holds the service -> scenario -> group -> instance -> RoCE-IP map, health
reports, and decode metadata pushed to prefills. Logical (pod, chip)
coordinates stand in for RoCE IPs (DESIGN.md §3).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass
class InstanceMeta:
    iid: str
    role: str                     # "P" | "D" | "" (stateless container)
    group: str
    roce_ips: Tuple[str, ...]     # one per device
    healthy: bool = True
    last_report: float = 0.0


class MetaStore:
    def __init__(self, health_timeout_s: float = 60.0):
        # per-store health timeout: a node silent for longer than this is
        # reported unhealthy. The serving frontend threads its EVENT
        # clock's timeout here (virtual seconds), so ejection math and
        # heartbeats share one timescale — the old hard-coded wall-clock
        # 60.0 was disconnected from the virtual timeline.
        self.health_timeout_s = float(health_timeout_s)
        self.instances: Dict[str, InstanceMeta] = {}
        self.groups: Dict[str, Dict[str, List[str]]] = {}   # gid -> {"P": [...], "D": [...]}
        self.group_scenario: Dict[str, Optional[str]] = {}  # gid -> scenario
        self._ip_counter = itertools.count()
        self.events: List[Tuple[float, str]] = []   # audit log (windowed)
        self.n_events = 0                           # monotonic count

    def _audit(self, t: float, msg: str):
        self.events.append((t, msg))
        self.n_events += 1
        if len(self.events) > 4096:                 # long-run retention
            del self.events[:-2048]

    # ------------------------------------------------------------ RoCE
    def assign_ips(self, n_devices: int) -> Tuple[str, ...]:
        base = next(self._ip_counter)
        return tuple(f"10.{base // 250}.{base % 250}.{d}"
                     for d in range(n_devices))

    # ----------------------------------------------------------- groups
    def register_group(self, gid: str, scenario: Optional[str]):
        self.groups.setdefault(gid, {"P": [], "D": []})
        self.group_scenario[gid] = scenario

    def gather_instance(self, t: float, iid: str, role: str, gid: str,
                        n_devices: int = 8) -> InstanceMeta:
        """Step 1 of the setup workflow: collect RoCE IPs in device order."""
        meta = InstanceMeta(iid, role, gid, self.assign_ips(n_devices),
                            last_report=t)
        self.instances[iid] = meta
        self.groups.setdefault(gid, {"P": [], "D": []})
        if role in ("P", "D"):
            self.groups[gid][role].append(iid)
        self._audit(t, f"gather {iid} role={role} group={gid}")
        return meta

    def collection_complete(self, gid: str, expected: int) -> bool:
        g = self.groups.get(gid, {"P": [], "D": []})
        return len(g["P"]) + len(g["D"]) >= expected

    def remove_instance(self, t: float, iid: str):
        """Logical removal — no further requests are forwarded (§3.4)."""
        meta = self.instances.pop(iid, None)
        if meta and meta.group in self.groups and meta.role in ("P", "D"):
            lst = self.groups[meta.group][meta.role]
            if iid in lst:
                lst.remove(iid)
        self._audit(t, f"remove {iid}")

    def group_members(self, gid: str, role: str) -> List[str]:
        return list(self.groups.get(gid, {}).get(role, []))

    # ----------------------------------------------------------- health
    def health_report(self, t: float, iid: str, healthy: bool = True):
        m = self.instances.get(iid)
        if m is not None:
            m.healthy = healthy
            m.last_report = t

    def unhealthy(self, t: float, timeout: Optional[float] = None
                  ) -> List[str]:
        """Instances flagged unhealthy or silent past the store's
        timeout (override per call with ``timeout``)."""
        if timeout is None:
            timeout = self.health_timeout_s
        return [iid for iid, m in self.instances.items()
                if not m.healthy or t - m.last_report > timeout]

    def silent_since(self, iid: str) -> Optional[float]:
        """Last report time for ``iid``, or None if unregistered — the
        fault controller's input for exact-deadline ejection
        (eject at last_report + health_timeout_s)."""
        m = self.instances.get(iid)
        return None if m is None else m.last_report
