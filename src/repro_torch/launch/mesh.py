"""Mesh shapes, the torch DeviceMesh, and the card's published rates.

Counterpart of ``src/repro/launch/mesh.py``. A mesh is planned by its
shape, ``{axis name: size}`` in mesh order; a ``DeviceMesh`` over the
visible cards is built only by ``make_device_mesh``, never at import.

The rates are the one home of the card's numbers in the port (the
simulator's profiles, the planner's roofline and ``chip_smoke.py``'s
kernel bounds read them here): NVIDIA's published dense peaks of one
NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit. A card set to a
lower limit runs slower under load.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

# flop/s: f32 on the CUDA cores, bf16 and TF32 on the tensor cores
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12, "tf32": 495e12}
HBM_BW = 3.35e12              # bytes/s of device memory
NVLINK_BW = 450e9             # bytes/s to the other cards, each direction
HBM_PER_CARD = 80e9           # bytes, the data sheet's 80 GB


def production_mesh_shape(multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def card_memory_bytes() -> int:
    """Device memory of card 0 as the CUDA runtime reports it, or the data
    sheet's 80 GB where no card is visible (planning on the host)."""
    if torch.cuda.is_available():
        return int(torch.cuda.get_device_properties(0).total_memory)
    return int(HBM_PER_CARD)


def make_device_mesh(shape: Mapping[str, int], device_type: str = "cuda"):
    """A torch DeviceMesh of ``shape`` with named dims, one rank per card.
    Raises when fewer cards are visible than the mesh needs, or when the
    process group (which the caller initialises, with its address, world
    size and rank) has another size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = math.prod(shape.values())
    if device_type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"mesh {dict(shape)} needs {n} cards but only "
            f"{torch.cuda.device_count()} are visible")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(
            f"mesh {dict(shape)} needs a process group of {n} ranks: call "
            f"torch.distributed.init_process_group with its address, world "
            f"size and rank first")
    return init_device_mesh(device_type, tuple(shape.values()),
                            mesh_dim_names=tuple(shape))
