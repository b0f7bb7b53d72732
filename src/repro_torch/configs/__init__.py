"""Architecture registry: one module per assigned architecture.

Each module exposes CONFIG (full-size, dry-run only) — reduced smoke
variants come from ``CONFIG.reduced()``.
"""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "qwen2_moe_a2_7b",
    "qwen1_5_110b",
    "pixtral_12b",
    "whisper_base",
    "deepseek_moe_16b",
    "mistral_nemo_12b",
    "jamba_1_5_large",
    "mamba2_2_7b",
    "granite_3_8b",
    "minicpm_2b",
    "pangu_38b",  # paper's own model family (Pangu-like dense)
]

# public --arch ids (dashed) -> module names
ALIASES = {
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen1.5-110b": "qwen1_5_110b",
    "pixtral-12b": "pixtral_12b",
    "whisper-base": "whisper_base",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "mamba2-2.7b": "mamba2_2_7b",
    "granite-3-8b": "granite_3_8b",
    "minicpm-2b": "minicpm_2b",
    "pangu-38b": "pangu_38b",
}

ASSIGNED = [a for a in ALIASES if a != "pangu-38b"]


def get_config(arch: str) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ALIASES}
