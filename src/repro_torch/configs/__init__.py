"""Architecture registry of the port: ``get_config("<arch-id>")``.

Every architecture of the reference's registry; ``"<arch>-smoke"`` returns
the mechanically reduced variant.  ``shape_applicable`` is the reference's
skip rule over ``INPUT_SHAPES``.
"""
from __future__ import annotations

from repro_torch.configs.base import (INPUT_SHAPES, EncDecConfig, ExitConfig,
                                      GroupedSSMConfig, InputShape,
                                      ModelConfig, SiteConfig, SSMConfig)
from repro_torch.configs.deepseek_v3_671b import CONFIG as _dsv3
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.mistral_nemo_12b import CONFIG as _nemo
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwen2_vl
from repro_torch.configs.starcoder2_3b import CONFIG as _starcoder2
from repro_torch.configs.whisper_base import CONFIG as _whisper
from repro_torch.configs.xlstm_350m import CONFIG as _xlstm
from repro_torch.configs.yi_6b import CONFIG as _yi
from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2

ARCHS = {c.name: c for c in (_granite, _dsv3, _yi, _starcoder2, _nemo,
                             _zamba2, _xlstm, _qwen2_vl, _whisper, _llama4)}


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return ARCHS[name[: -len("-smoke")]].reduced()
    return ARCHS[name]


def resolve_config(arch) -> ModelConfig:
    """A ``ModelConfig`` as it is, or the registered config of an arch
    name (entry points take either)."""
    return arch if isinstance(arch, ModelConfig) else get_config(arch)


def shape_applicable(config: ModelConfig, shape_name: str) -> bool:
    """Whether an (arch, input-shape) pair is runnable: long_500k only on
    an arch with sub-quadratic long decode."""
    shape = INPUT_SHAPES[shape_name]
    if shape.name == "long_500k" and not config.supports_long_context:
        return False
    return True


__all__ = ["ARCHS", "EncDecConfig", "ExitConfig", "GroupedSSMConfig",
           "INPUT_SHAPES", "InputShape", "ModelConfig", "SSMConfig",
           "SiteConfig", "get_config",
           "resolve_config", "shape_applicable"]
