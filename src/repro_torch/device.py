"""Device placement for the port's entry points.

Entry points take ``device=`` and default to the card. Asking for the
card on a machine without one raises at once instead of quietly running
on the CPU: a CPU run must be asked for (``device="cpu"``), as the tests
do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} asks for a CUDA card but none is "
            f"available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
