"""Config registry: ``--arch <id>`` -> ModelConfig.

Every assigned architecture is a selectable config; ``get_config`` is the one
entry point used by the launcher, the dry-run and the tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (ModelConfig, ShapeSpec, SHAPES,
                                reduce_for_smoke, shape_applicable)

# arch id -> module under repro_torch.configs
ARCH_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "qwen3-32b": "qwen3_32b",
    "starcoder2-3b": "starcoder2_3b",
    "phi3-mini-3.8b": "phi3_mini",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v2-236b": "deepseek_v2",
    "xlstm-125m": "xlstm_125m",
    "whisper-small": "whisper_small",
    "internvl2-1b": "internvl2_1b",
}

ARCHS = list(ARCH_MODULES)

# configs of the port alone: the reference has no counterpart, so they stay
# out of ``ARCHS`` (which the reference's registry, generator and dry-run
# cells mirror) and are reached by name
PORT_ONLY = {
    "deepseek-v2-lite": "deepseek_v2_lite",
}


def get_config(arch: str) -> ModelConfig:
    mod = ARCH_MODULES.get(arch) or PORT_ONLY.get(arch)
    if mod is None:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{ARCHS + list(PORT_ONLY)}")
    return importlib.import_module(f"repro_torch.configs.{mod}").config()


__all__ = ["ModelConfig", "ShapeSpec", "SHAPES", "ARCHS", "ARCH_MODULES",
           "PORT_ONLY", "get_config", "reduce_for_smoke", "shape_applicable"]
