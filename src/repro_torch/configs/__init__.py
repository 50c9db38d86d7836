"""Experiment configurations (port of `repro.configs`): the `--arch <id>`
registry. The language-model configs are shapes only (no weights), copied
from the JAX package so that an arch resolves the same in both packages;
`omniglot-conv4` and `cub-resnet12` are the paper's few-shot setups."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (SHAPES, ModelConfig,  # noqa: F401
                                      ShapeConfig, TrainConfig)

ARCHS = [
    "xlstm-350m",
    "llama3-405b",
    "starcoder2-3b",
    "qwen1.5-110b",
    "command-r-plus-104b",
    "deepseek-moe-16b",
    "deepseek-v3-671b",
    "musicgen-medium",
    "hymba-1.5b",
    "qwen2-vl-7b",
    # paper-faithful FSL controllers
    "omniglot-conv4",
    "cub-resnet12",
]


def _module(arch: str):
    return importlib.import_module(
        "repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def load_config(arch: str, smoke: bool = False) -> ModelConfig:
    m = _module(arch)
    return m.get_smoke_config() if smoke else m.get_config()



def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether a (arch, shape) dry-run cell is runnable: a full-attention
    arch does not run at 500k positions."""
    if shape.name == "long_500k":
        sub_quadratic = cfg.family in ("ssm", "hybrid")
        if not sub_quadratic:
            return False, "skipped(full-attention arch at 500k context)"
    return True, ""
