"""Registry: ``--arch`` id -> ModelConfig (exact assigned shapes).

A copy of ``repro.configs`` so the port needs nothing of the JAX
package.  Every arch is registered; the port serves the ``dense``
family only for now (``repro_torch.models.lm.segments`` refuses the
others).
"""
from repro_torch.configs.base import (
    SHAPES,
    ModelConfig,
    MoESpec,
    ShapeSpec,
    shape_applicable,
    smoke_config,
)
from repro_torch.configs.internvl2_26b import CONFIG as _internvl2_26b
from repro_torch.configs.llama4_maverick_400b import CONFIG as _llama4
from repro_torch.configs.nemotron_4_340b import CONFIG as _nemotron
from repro_torch.configs.phi35_moe import CONFIG as _phi35
from repro_torch.configs.qwen3_0_6b import CONFIG as _qwen3_06b
from repro_torch.configs.qwen3_32b import CONFIG as _qwen3_32b
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rgemma
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv6
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless
from repro_torch.configs.starcoder2_7b import CONFIG as _starcoder2

__all__ = ["ARCHS", "SHAPES", "ModelConfig", "MoESpec", "ShapeSpec",
           "get_config", "shape_applicable", "smoke_config"]

ARCHS = {
    "qwen3-32b": _qwen3_32b,
    "nemotron-4-340b": _nemotron,
    "starcoder2-7b": _starcoder2,
    "qwen3-0.6b": _qwen3_06b,
    "internvl2-26b": _internvl2_26b,
    "llama4-maverick-400b-a17b": _llama4,
    "phi3.5-moe-42b-a6.6b": _phi35,
    "rwkv6-7b": _rwkv6,
    "seamless-m4t-large-v2": _seamless,
    "recurrentgemma-2b": _rgemma,
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
