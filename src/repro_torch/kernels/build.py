"""Build the hand-written CUDA kernels and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process for
``sm_90a`` (all started together), and the objects are linked into one
shared library with a plain C interface. The library lands in
``<checkout>/build/repro_torch_kernels/<hash>/`` where the hash covers the
sources and the flags, so a changed source rebuilds and an unchanged one
loads at once. Nothing is built when this module is imported: the first
call to ``library()`` builds, and only a process that launches a kernel
(on a machine with ``nvcc`` and a card) ever gets there.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("kv_gather.cu", "kv_scatter.cu", "paged_attention.cu",
           "flash_prefill.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LIB_NAME = "librepro_torch_kernels.so"

_vp = ctypes.c_void_p
_i64 = ctypes.c_int64
_i32 = ctypes.c_int
SIGNATURES = {
    # name: argtypes (every pointer and the stream as c_void_p)
    "kv_gather": [_vp, _vp, _vp, _i64, _i64, _i64, _i64, _i64, _vp],
    "kv_scatter": [_vp, _vp, _vp, _i64, _i64, _i64, _i64, _i64, _vp],
    "paged_attention": [_vp] * 8 + [_i32] * 10 + [_vp],
    "flash_prefill": [_vp] * 5 + [_i32] * 10 + [_vp],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float        # wall time of this process's build (0 if cached)
    log: str              # nvcc output (ptxas register/spill report)


_lib: Optional[ctypes.CDLL] = None


def build_root() -> Path:
    """``<checkout>/build/repro_torch_kernels`` (this file sits at
    ``<checkout>/src/repro_torch/kernels/build.py``)."""
    return Path(__file__).resolve().parents[3] / "build" \
        / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> BuildInfo:
    """Compile the sources in parallel and link them (no-op if a library
    for these exact sources exists)."""
    out_dir = build_root() / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return BuildInfo(lib, 0.0, "cached")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for name, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"linking {LIB_NAME} failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)      # atomic: never a half-written .so
    return BuildInfo(lib, time.perf_counter() - t0, "\n".join(logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry reported a launch error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
