"""Architecture registry: HF config -> (ModelConfig, converter).
Counterpart of mixq_tensorrt_llm_tpu/models/registry.py.

The Llama lineage (``llama``, ``mistral``, ``mixtral``, ``qwen2``,
``aquila``) goes through models/llama.py, every other family (the expert
models DBRX, Qwen2-MoE and Qwen3-MoE among them) through
models/families.py, which maps each onto the one config-driven decoder of
models/common.py (its MLP models/moe.py where the config has experts). The
recurrent-state models have modules of their own: ``mamba`` goes through
models/mamba.py, ``recurrent_gemma`` through models/recurrentgemma.py.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike
from ..quant.config import QuantConfig
from . import families, llama, mamba, recurrentgemma

_LLAMA_ARCHS = ("llama", "mistral", "mixtral", "qwen2")

# model_type -> converter module key, as in the JAX package
SUPPORTED_ARCHS = {
    "llama": "llama",
    "mistral": "llama",
    "mixtral": "llama",
    "qwen2": "llama",
    "aquila": "llama",
    "opt": "families",
    "gpt2": "families",
    "gptj": "families",
    "gpt_neox": "families",
    "falcon": "families",
    "refinedweb": "families",
    "refinedwebmodel": "families",
    "bloom": "families",
    "mpt": "families",
    "phi": "families",
    "phi3": "families",
    "dbrx": "families",
    "gemma": "families",
    "gemma2": "families",
    "qwen3": "families",
    "qwen2_moe": "families",
    "qwen3_moe": "families",
    "glm": "families",
    "glm4": "families",
    "olmo2": "families",
    "cohere": "families",
    "granite": "families",
    "baichuan": "families",
    "gpt_bigcode": "families",
    "starcoder2": "families",
    "stablelm": "families",
    "mamba": "mamba",
    "recurrent_gemma": "recurrentgemma",
}


def _module(arch: str):
    """The module that builds a model of ``arch`` (or of a
    ``SUPPORTED_ARCHS`` converter key)."""
    if arch in _LLAMA_ARCHS:
        return llama
    return {"mamba": mamba,
            "recurrentgemma": recurrentgemma}.get(arch, families)


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()):
    mt = hf_config.model_type.lower()
    kind = SUPPORTED_ARCHS.get(mt)
    if kind is None:
        raise ValueError(f"unsupported model_type {mt!r}; supported: "
                         f"{sorted(SUPPORTED_ARCHS)}")
    return _module(kind).config_from_hf(hf_config, quant)


def params_from_hf(cfg, hf_state, act_scales=None,
                   device: DeviceLike = "cuda"):
    """HF state dict -> quantized params on ``device``, by ``cfg.arch``."""
    return _module(cfg.arch).params_from_hf(cfg, hf_state, act_scales,
                                            device=device)


def init_random_params(cfg, seed: int = 0, device: DeviceLike = "cuda",
                       act_scales=None,
                       generator: Optional[torch.Generator] = None):
    """Random-weight params honouring every config axis, by ``cfg.arch``
    (each module's init_random_params)."""
    return _module(cfg.arch).init_random_params(
        cfg, seed=seed, device=device, act_scales=act_scales,
        generator=generator)
