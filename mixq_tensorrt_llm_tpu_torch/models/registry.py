"""Architecture registry: HF config -> (ModelConfig, converter).
Counterpart of mixq_tensorrt_llm_tpu/models/registry.py.

The Llama lineage (``llama``, ``mistral``, ``mixtral``, ``qwen2``,
``aquila``) goes through models/llama.py, every other family (the expert
models DBRX, Qwen2-MoE and Qwen3-MoE among them) through
models/families.py, which maps each onto the one config-driven decoder of
models/common.py (its MLP models/moe.py where the config has experts). The
state-space model types raise naming the module whose port brings them.
"""

from __future__ import annotations

from ..device import DeviceLike
from ..quant.config import QuantConfig
from . import families, llama

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
# model types listed above that the port does not serve yet -> the module
# whose port brings them
_LATER = {
    "mamba": "models/mamba.py",
    "recurrent_gemma": "models/recurrentgemma.py",
}


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()):
    mt = hf_config.model_type.lower()
    kind = SUPPORTED_ARCHS.get(mt)
    if kind is None:
        raise ValueError(f"unsupported model_type {mt!r}; supported: "
                         f"{sorted(SUPPORTED_ARCHS)}")
    if mt in _LATER:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet: it comes with "
            f"{_LATER[mt]}")
    if kind == "llama":
        return llama.config_from_hf(hf_config, quant)
    return families.config_from_hf(hf_config, quant)


def params_from_hf(cfg, hf_state, act_scales=None,
                   device: DeviceLike = "cuda"):
    """HF state dict -> quantized params on ``device``, by ``cfg.arch``."""
    if cfg.arch in ("llama", "mistral", "mixtral", "qwen2"):
        return llama.params_from_hf(cfg, hf_state, act_scales, device=device)
    return families.params_from_hf(cfg, hf_state, act_scales, device=device)
