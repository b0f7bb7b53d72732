"""Architecture registry: one module per assigned architecture.

Each module exposes CONFIG (full-size, dry-run only) — reduced smoke
variants come from ``CONFIG.reduced()``, and ``ratio_variant`` keeps the
published head and routing ratios that ``reduced()`` cuts.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict

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


# reduced variants at the published head and routing ratios, which
# ``reduced()`` cuts to 4/2 heads and top-2 of 4 experts: {name: (arch,
# fields replaced on the reduced config, MoE fields replaced)}
RATIO_VARIANTS = {
    # pangu-38b's 48/8 heads: 6 query heads a KV head
    "pangu-38b-g6": ("pangu-38b",
                     dict(num_heads=12, num_kv_heads=2, head_dim=32), {}),
    # deepseek-moe-16b's routing: top-6 with 2 shared experts, of 8
    "deepseek-moe-16b-top6": ("deepseek-moe-16b", {},
                              dict(num_experts=8, top_k=6,
                                   num_shared_experts=2)),
    # the same under sorted (dropless) dispatch
    "deepseek-moe-16b-top6-sorted": ("deepseek-moe-16b", {},
                                     dict(num_experts=8, top_k=6,
                                          num_shared_experts=2,
                                          dispatch="sorted")),
}


def ratio_variant(name: str,
                  get: Callable[[str], ModelConfig] = get_config):
    """The RATIO_VARIANTS entry ``name``: ``get(arch).reduced()``, then
    ``.replace(...)``. ``get`` may be another package's ``get_config``
    whose configs have the same fields (the parity tests build the JAX
    package's twin this way)."""
    arch, kw, moe_kw = RATIO_VARIANTS[name]
    cfg = get(arch).reduced()
    if moe_kw:
        kw = dict(kw, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg.replace(name=name, **kw)
