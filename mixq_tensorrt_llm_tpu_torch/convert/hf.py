"""HF model directory -> quantized checkpoint (the `quantize` pipeline).
Counterpart of mixq_tensorrt_llm_tpu/convert/hf.py.

Read the HF config and weights, optionally calibrate act_scales on the
float model, quantize under the QuantConfig routing, save the checkpoint
format both packages read. Neither ``transformers`` nor ``safetensors`` is
needed: ``config.json`` is read with ``json`` (``load_hf_config`` gives what
``AutoConfig`` gives for every field the converter reads) and the weights
with the port's own safetensors reader, memory-mapped in their file dtype;
``models/llama.params_from_hf`` brings one layer at a time to the device.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import types
from typing import Dict, Iterable, Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import registry
from ..models.common import ModelConfig
from ..quant.config import QuantConfig
from ..utils.logger import logger
from . import calibrate as calib
from .checkpoint import read_safetensors, save_checkpoint

# The class defaults of transformers' LlamaConfig, MistralConfig and
# Qwen2Config for every field models/llama.config_from_hf reads: what
# AutoConfig gives where config.json leaves a key out.
_COMMON = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=None,
               rope_theta=10000.0, rms_norm_eps=1e-6, rope_scaling=None,
               tie_word_embeddings=False)
_CONFIG_DEFAULTS = {
    "llama": dict(_COMMON, intermediate_size=11008, head_dim=None,
                  max_position_embeddings=2048),
    "mistral": dict(_COMMON, intermediate_size=14336, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=4096 * 32,
                    sliding_window=4096),
    "qwen2": dict(_COMMON, vocab_size=151936, intermediate_size=22016,
                  max_position_embeddings=32768, use_sliding_window=False,
                  sliding_window=4096),
}
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model", "special_tokens_map.json",
                    "vocab.json", "merges.txt", "added_tokens.json",
                    "chat_template.jinja")


def load_hf_config(hf_dir: str) -> types.SimpleNamespace:
    """config.json as an attribute object, with the defaults and
    normalisation ``AutoConfig`` applies for the Llama lineage: absent keys
    take their class default, ``num_key_value_heads`` falls back to the
    head count, Llama's ``head_dim`` to hidden / heads, Qwen2's
    ``sliding_window`` is None unless ``use_sliding_window``, and a
    rope_scaling ``type`` is also given as ``rope_type``. Other model types
    get the file's keys alone (the registry refuses them)."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type", "")
    d = {**_CONFIG_DEFAULTS.get(mt, {}), **d}
    if mt in _CONFIG_DEFAULTS:
        if d["num_key_value_heads"] is None:
            d["num_key_value_heads"] = d["num_attention_heads"]
        if mt == "llama" and d["head_dim"] is None:
            d["head_dim"] = d["hidden_size"] // d["num_attention_heads"]
        if mt == "qwen2" and not d["use_sliding_window"]:
            d["sliding_window"] = None
        rs = d.get("rope_scaling")
        if mt != "mistral" and rs and "type" in rs:
            d["rope_scaling"] = {**rs, "rope_type": rs["type"]}
    return types.SimpleNamespace(**d)


def load_hf_state_dict(hf_dir: str) -> Dict[str, torch.Tensor]:
    """Every tensor of an HF model directory, on the CPU in its file dtype
    and memory-mapped: all ``*.safetensors`` shards (the port's reader), or
    else ``pytorch_model*.bin`` (``torch.load(weights_only=True,
    mmap=True)``)."""
    sd: Dict[str, torch.Tensor] = {}
    st_files = sorted(glob.glob(os.path.join(hf_dir, "*.safetensors")))
    for f in st_files:
        sd.update(read_safetensors(f))
    if st_files:
        return sd
    bin_files = sorted(glob.glob(os.path.join(hf_dir, "pytorch_model*.bin")))
    for f in bin_files:
        sd.update(torch.load(f, map_location="cpu", weights_only=True,
                             mmap=True))
    if bin_files:
        return sd
    raise FileNotFoundError(f"no model weights found in {hf_dir}")


def quantize_hf_model(
    hf_dir: str,
    output_dir: str,
    quant: QuantConfig,
    act_scales: Optional[Mapping] = None,
    act_scales_path: Optional[str] = None,
    calib_batches: Optional[Iterable] = None,
    dtype: Optional[torch.dtype] = None,
    lora_dir: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> ModelConfig:
    """HF dir -> (calibration) -> quantize -> checkpoint dir, on ``device``.

    For mix algos the outlier ranking comes from, in this order: explicit
    act_scales > act_scales_path (.pt/.npz artifact) > calibration over
    calib_batches on the float model > none, which falls back to ones
    (channels 0..k-1, with a warning), as in the JAX package. Writes
    act_scales.npz beside the checkpoint when there are scales, and copies
    the tokenizer files. ``lora_dir``: a PEFT adapter merged into the float
    weights first (convert/lora.merge_lora_into_state_dict)."""
    dev = resolve_device(device)
    cfg = registry.config_from_hf(load_hf_config(hf_dir), quant)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    sd = load_hf_state_dict(hf_dir)
    if lora_dir:
        from .lora import merge_lora_into_state_dict
        sd = merge_lora_into_state_dict(sd, lora_dir)

    if act_scales is None and act_scales_path:
        act_scales = calib.load_act_scales(act_scales_path)
    if act_scales is None and calib_batches is not None and quant.algo.is_mix:
        float_cfg = dataclasses.replace(cfg, quant=QuantConfig())
        float_params = registry.params_from_hf(float_cfg, sd, device=dev)
        act_scales = calib.calibrate_act_scales(float_params, float_cfg,
                                                calib_batches)
        del float_params
    if act_scales is None and quant.algo.is_mix:
        logger.warning(
            "%s: no act_scales for %s; the outliers fall back to channels "
            "0..%d (give act_scales_path or calib_batches)", hf_dir,
            quant.algo.value, quant.num_outliers - 1)

    params = registry.params_from_hf(cfg, sd, act_scales, device=dev)
    save_checkpoint(output_dir, params, cfg)
    del params
    if act_scales is not None:
        calib.save_act_scales(act_scales,
                              os.path.join(output_dir, "act_scales.npz"))
    _copy_tokenizer_files(hf_dir, output_dir)
    return cfg


def _copy_tokenizer_files(hf_dir: str, output_dir: str) -> None:
    """Carry the tokenizer files into the checkpoint, so that it is usable
    on its own."""
    for name in _TOKENIZER_FILES:
        src = os.path.join(hf_dir, name)
        if os.path.exists(src):
            shutil.copy(src, os.path.join(output_dir, name))
