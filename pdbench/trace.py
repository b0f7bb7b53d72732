"""The profiler's trace of the window's last stretch, reduced to what the
per-layer readers and the result's ``device`` and ``breakdown`` need."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

# the grouped product's kernels (csrc/grouped_mm.cu), as chip_smoke.py
# names them
GROUPED = ("rows_fwd_kernel", "rows_trans_kernel", "rows_reduce_kernel",
           "tiles_simt_kernel", "tiles_wgmma_kernel")


@dataclass
class Stretch:
    kernels: List[Tuple[str, int, int]]    # (name, start ns, end ns)
    host: List[Tuple[str, int, int]]       # the harness's ranges
    wall_s: float

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union
        of the kernel and copy intervals)."""
        return _union_ns(self.kernels) / 1e9

    def device_s(self, match) -> float:
        """Summed device seconds of the operations whose name ``match``
        accepts."""
        return sum(e - s for n, s, e in self.kernels if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, int] = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:160], v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps between device operations, each named by
        the harness range the host was in at its middle."""
        ks = sorted((s, e) for _, s, e in self.kernels)
        gaps, end = [], None
        for s, e in ks:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for d, a, b in gaps[:k]:
            mid = (a + b) // 2
            name = next((n for n, s, e in self.host if s <= mid <= e),
                        "pdbench.serve_loop")
            out.append([name, d / 1e9])
        return out


def _union_ns(iv) -> int:
    tot, cur_s, cur_e = 0, None, None
    for _, s, e in sorted(iv, key=lambda x: x[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                tot += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        tot += cur_e - cur_s
    return tot


def reduce(prof, wall_s: float) -> Stretch:
    kernels, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        name = ev.name()
        if name.startswith("pdbench."):
            # the harness's ranges, on the host and mirrored onto the
            # device's timeline as annotations: not device operations
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                host.append((name, s, e))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            kernels.append((name, s, e))
    return Stretch(kernels, host, wall_s)


def is_grouped(name: str) -> bool:
    return any(k in name for k in GROUPED)
