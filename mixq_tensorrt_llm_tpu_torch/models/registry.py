"""Architecture registry: HF config -> (ModelConfig, converter).
Counterpart of mixq_tensorrt_llm_tpu/models/registry.py.

The port serves the Llama lineage (``llama``, ``mistral``, ``qwen2``)
through models/llama.py. Every other model type the JAX package lists
raises naming the module whose port brings it.
"""

from __future__ import annotations

from ..device import DeviceLike
from ..quant.config import QuantConfig
from . import llama

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
PORTED_ARCHS = ("llama", "mistral", "qwen2")
# model types listed above that the port does not serve yet -> the module
# whose port brings them
_LATER = {
    "mixtral": "models/moe.py",
    # a remote-code config class: convert/hf.py's reader knows no defaults
    # for it
    "aquila": "models/registry.py (the aquila config's defaults)",
    "families": "models/families.py",
    "mamba": "models/mamba.py",
    "recurrentgemma": "models/recurrentgemma.py",
}


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()):
    mt = hf_config.model_type.lower()
    kind = SUPPORTED_ARCHS.get(mt)
    if kind is None:
        raise ValueError(f"unsupported model_type {mt!r}; supported: "
                         f"{sorted(SUPPORTED_ARCHS)}")
    if mt not in PORTED_ARCHS:
        raise NotImplementedError(
            f"model_type {mt!r} is not ported yet: it comes with "
            f"{_LATER.get(mt, _LATER.get(kind))}")
    return llama.config_from_hf(hf_config, quant)


def params_from_hf(cfg, hf_state, act_scales=None,
                   device: DeviceLike = "cuda"):
    """HF state dict -> quantized params on ``device`` (Llama lineage)."""
    if cfg.arch not in PORTED_ARCHS:
        kind = SUPPORTED_ARCHS.get(cfg.arch, "families")
        raise NotImplementedError(
            f"arch {cfg.arch!r} is not ported yet: it comes with "
            f"{_LATER.get(cfg.arch, _LATER.get(kind))}")
    return llama.params_from_hf(cfg, hf_state, act_scales, device=device)
