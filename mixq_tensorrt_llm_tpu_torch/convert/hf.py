"""HF model directory -> quantized checkpoint (the `quantize` pipeline).
Counterpart of mixq_tensorrt_llm_tpu/convert/hf.py.

Read the HF config and weights, optionally calibrate act_scales on the
float model, quantize under the QuantConfig routing, save the checkpoint
format both packages read. Neither ``transformers`` nor ``safetensors`` is
needed: ``config.json`` is read with ``json`` (``load_hf_config`` gives what
``AutoConfig`` gives for every field the converters read, for every dense
family) and the weights
with the port's own safetensors reader, memory-mapped in their file dtype;
``models/registry.params_from_hf`` brings one layer at a time to the
device.
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

# The class defaults of transformers' config classes (transformers 4.57)
# for every field the converters' config_from_hf read (models/llama.py,
# models/families.py, models/mamba.py, models/recurrentgemma.py): what
# AutoConfig gives where a (diff-only) config.json leaves a key out. A
# None stands for a default the class computes from other fields.
_COMMON = dict(vocab_size=32000, hidden_size=4096, num_hidden_layers=32,
               num_attention_heads=32, num_key_value_heads=None,
               rope_theta=10000.0, rms_norm_eps=1e-6, rope_scaling=None,
               tie_word_embeddings=False)
_GPT2 = dict(vocab_size=50257, n_embd=768, n_layer=12, n_head=12,
             n_positions=1024, n_inner=None, layer_norm_epsilon=1e-5,
             tie_word_embeddings=True)
_CONFIG_DEFAULTS = {
    "llama": dict(_COMMON, intermediate_size=11008, head_dim=None,
                  max_position_embeddings=2048),
    "mistral": dict(_COMMON, intermediate_size=14336, num_key_value_heads=8,
                    head_dim=None, max_position_embeddings=4096 * 32,
                    sliding_window=4096),
    "qwen2": dict(_COMMON, vocab_size=151936, intermediate_size=22016,
                  max_position_embeddings=32768, use_sliding_window=False,
                  sliding_window=4096),
    # Aquila's remote-code config is Llama's
    "aquila": dict(_COMMON, intermediate_size=11008, head_dim=None,
                   max_position_embeddings=2048),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12,
                num_attention_heads=12, max_position_embeddings=2048,
                tie_word_embeddings=True, ffn_dim=3072,
                do_layer_norm_before=True, word_embed_proj_dim=None,
                activation_function="relu"),
    "gpt2": dict(_GPT2, activation_function="gelu_new"),
    "gptj": dict(_GPT2, vocab_size=50400, n_embd=4096, n_layer=28,
                 n_head=16, n_positions=2048, rotary_dim=64,
                 activation_function="gelu_new", tie_word_embeddings=False),
    "gpt_bigcode": dict(_GPT2, activation_function="gelu_pytorch_tanh",
                        multi_query=True),
    "gpt_neox": dict(vocab_size=50432, hidden_size=6144,
                     intermediate_size=24576, num_hidden_layers=44,
                     num_attention_heads=64, max_position_embeddings=2048,
                     rotary_emb_base=10000, rotary_pct=0.25,
                     layer_norm_eps=1e-5, use_parallel_residual=True,
                     hidden_act="gelu", tie_word_embeddings=False),
    "falcon": dict(vocab_size=65024, hidden_size=4544, num_hidden_layers=32,
                   num_attention_heads=71, max_position_embeddings=2048,
                   rope_theta=10000.0, layer_norm_epsilon=1e-5,
                   new_decoder_architecture=False, num_kv_heads=None,
                   multi_query=True, parallel_attn=True,
                   ffn_hidden_size=None, alibi=False, activation="gelu",
                   bias=False, tie_word_embeddings=True),
    "bloom": dict(vocab_size=250880, hidden_size=64, n_layer=2, n_head=8,
                  layer_norm_epsilon=1e-5, tie_word_embeddings=True),
    "mpt": dict(vocab_size=50368, d_model=2048, n_layers=24, n_heads=16,
                expansion_ratio=4, max_seq_len=2048, no_bias=True,
                layer_norm_epsilon=1e-5, attn_config=None,
                tie_word_embeddings=True),
    "phi": dict(_COMMON, vocab_size=51200, hidden_size=2048,
                intermediate_size=8192, num_hidden_layers=24,
                max_position_embeddings=2048, layer_norm_eps=1e-5,
                hidden_act="gelu_new", partial_rotary_factor=0.5),
    "phi3": dict(_COMMON, vocab_size=32064, hidden_size=3072,
                 intermediate_size=8192, max_position_embeddings=4096,
                 original_max_position_embeddings=4096, rms_norm_eps=1e-5,
                 sliding_window=None, partial_rotary_factor=1.0),
    "gemma": dict(_COMMON, vocab_size=256000, hidden_size=3072,
                  intermediate_size=24576, num_hidden_layers=28,
                  num_attention_heads=16, num_key_value_heads=16,
                  head_dim=256, max_position_embeddings=8192,
                  hidden_act="gelu_pytorch_tanh", hidden_activation=None,
                  tie_word_embeddings=True),
    "gemma2": dict(_COMMON, vocab_size=256000, hidden_size=2304,
                   intermediate_size=9216, num_hidden_layers=26,
                   num_attention_heads=8, num_key_value_heads=4,
                   head_dim=256, max_position_embeddings=8192,
                   hidden_activation="gelu_pytorch_tanh",
                   query_pre_attn_scalar=256, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, sliding_window=4096,
                   tie_word_embeddings=True),
    "qwen3": dict(_COMMON, vocab_size=151936, intermediate_size=22016,
                  head_dim=128, max_position_embeddings=32768,
                  sliding_window=4096, use_sliding_window=False),
    "glm": dict(_COMMON, vocab_size=151552, intermediate_size=13696,
                num_hidden_layers=40, num_key_value_heads=2, head_dim=128,
                max_position_embeddings=131072, rms_norm_eps=1.5625e-07,
                partial_rotary_factor=0.5, attention_bias=True),
    "olmo2": dict(_COMMON, vocab_size=50304, intermediate_size=11008,
                  max_position_embeddings=2048, rms_norm_eps=1e-5),
    "cohere": dict(_COMMON, vocab_size=256000, hidden_size=8192,
                   intermediate_size=22528, num_hidden_layers=40,
                   num_attention_heads=64, max_position_embeddings=8192,
                   layer_norm_eps=1e-5, attention_bias=False,
                   logit_scale=0.0625, tie_word_embeddings=True),
    "granite": dict(_COMMON, intermediate_size=11008,
                    max_position_embeddings=2048, attention_bias=False,
                    mlp_bias=False, embedding_multiplier=1.0,
                    residual_multiplier=1.0, attention_multiplier=1.0,
                    logits_scaling=1.0),
    "starcoder2": dict(_COMMON, vocab_size=49152, hidden_size=3072,
                       intermediate_size=12288, num_hidden_layers=30,
                       num_attention_heads=24, num_key_value_heads=2,
                       max_position_embeddings=4096, norm_epsilon=1e-5,
                       hidden_act="gelu_pytorch_tanh", use_bias=True,
                       tie_word_embeddings=True),
    "stablelm": dict(_COMMON, vocab_size=50304, hidden_size=2560,
                     intermediate_size=6912, max_position_embeddings=4096,
                     layer_norm_eps=1e-5, hidden_act="silu",
                     partial_rotary_factor=0.25, use_qkv_bias=False),
    "mixtral": dict(_COMMON, intermediate_size=14336,
                    num_key_value_heads=8, head_dim=None,
                    max_position_embeddings=4096 * 32, rope_theta=1e6,
                    rms_norm_eps=1e-5, sliding_window=None,
                    num_local_experts=8, num_experts_per_tok=2),
    "dbrx": dict(vocab_size=32000, d_model=2048, n_heads=16, n_layers=24,
                 max_seq_len=2048, attn_config=None, ffn_config=None,
                 tie_word_embeddings=False),
    "qwen2_moe": dict(_COMMON, vocab_size=151936, hidden_size=2048,
                      intermediate_size=5632, num_hidden_layers=24,
                      num_attention_heads=16, num_key_value_heads=16,
                      max_position_embeddings=32768,
                      use_sliding_window=False, sliding_window=4096,
                      num_experts=60, num_experts_per_tok=4,
                      norm_topk_prob=False, moe_intermediate_size=1408,
                      shared_expert_intermediate_size=5632,
                      decoder_sparse_step=1, mlp_only_layers=[]),
    "qwen3_moe": dict(_COMMON, vocab_size=151936, hidden_size=2048,
                      intermediate_size=6144, num_hidden_layers=24,
                      num_attention_heads=32, num_key_value_heads=4,
                      max_position_embeddings=32768,
                      use_sliding_window=False, sliding_window=4096,
                      num_experts=128, num_experts_per_tok=8,
                      norm_topk_prob=False, moe_intermediate_size=768,
                      decoder_sparse_step=1, mlp_only_layers=[]),
    # MambaConfig: intermediate_size = expand x hidden, time_step_rank
    # "auto" = ceil(hidden / 16)
    "mamba": dict(vocab_size=50280, hidden_size=768, state_size=16,
                  num_hidden_layers=32, layer_norm_epsilon=1e-5,
                  conv_kernel=4, expand=2, intermediate_size=None,
                  use_bias=False, use_conv_bias=True,
                  time_step_rank="auto", tie_word_embeddings=True),
    # RecurrentGemmaConfig: head_dim = hidden / heads, lru_width = hidden;
    # its num_key_value_heads falls back to the head count (10), where
    # google/recurrentgemma-2b's config.json says 1
    "recurrent_gemma": dict(
        num_hidden_layers=26, vocab_size=256000, hidden_size=2560,
        intermediate_size=7680, num_attention_heads=10, lru_width=None,
        attention_window_size=2048, conv1d_width=4, logits_soft_cap=30.0,
        rms_norm_eps=1e-6, rope_theta=10000.0, partial_rotary_factor=0.5,
        block_types=["recurrent", "recurrent", "attention"],
        hidden_activation="gelu_pytorch_tanh", head_dim=None,
        num_key_value_heads=None, attention_bias=False,
        tie_word_embeddings=True),
}
# DBRX's nested configs (DbrxAttentionConfig, DbrxFFNConfig)
_DBRX_ATTN = dict(clip_qkv=None, kv_n_heads=1, rope_theta=10000.0)
_DBRX_FFN = dict(ffn_act_fn={"name": "silu"}, ffn_hidden_size=3584,
                 moe_num_experts=4, moe_top_k=1,
                 moe_normalize_expert_weights=1.0)
_CONFIG_DEFAULTS["glm4"] = _CONFIG_DEFAULTS["glm"]
for _alias in ("refinedweb", "refinedwebmodel"):
    _CONFIG_DEFAULTS[_alias] = _CONFIG_DEFAULTS["falcon"]
# the class attribute maps (standard name -> the family's own)
_ATTRIBUTE_MAPS = {
    "gpt2": dict(hidden_size="n_embd", max_position_embeddings="n_positions",
                 num_attention_heads="n_head", num_hidden_layers="n_layer"),
    "bloom": dict(num_hidden_layers="n_layer", num_attention_heads="n_head"),
    "mpt": dict(hidden_size="d_model", num_attention_heads="n_heads",
                num_hidden_layers="n_layers"),
    "dbrx": dict(hidden_size="d_model", num_attention_heads="n_heads",
                 num_hidden_layers="n_layers",
                 max_position_embeddings="max_seq_len"),
}
_ATTRIBUTE_MAPS["gptj"] = _ATTRIBUTE_MAPS["gpt_bigcode"] = \
    _ATTRIBUTE_MAPS["gpt2"]
_TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                    "tokenizer.model", "special_tokens_map.json",
                    "vocab.json", "merges.txt", "added_tokens.json",
                    "chat_template.jinja")


def load_hf_config(hf_dir: str) -> types.SimpleNamespace:
    """config.json as an attribute object, with the defaults and
    normalisation ``AutoConfig`` applies for the dense families and the
    expert models: absent keys take their class default
    (``_CONFIG_DEFAULTS``), the class's
    attribute map gives its standard names, ``num_key_value_heads`` falls
    back to the head count (GPT-BigCode: 1 under multi_query), Llama's
    ``head_dim`` to hidden / heads, Falcon's ``num_kv_heads`` to the head
    count and ``ffn_hidden_size`` to 4 x hidden, OPT's
    ``word_embed_proj_dim`` to hidden, Qwen2's and Qwen3's
    ``sliding_window`` is None unless ``use_sliding_window`` (and their
    expert models' too), DBRX's nested ``attn_config`` / ``ffn_config``
    take their classes' defaults key by key, GPT-NeoX's
    ``rotary_emb_base`` is its ``rope_theta``, MPT's ``attn_config``
    keeps alibi on unless it says otherwise, a rope_scaling ``type``
    is also given as ``rope_type``, Mamba's ``intermediate_size`` is
    expand x hidden and its ``time_step_rank`` "auto" ceil(hidden / 16),
    RecurrentGemma's ``head_dim`` hidden / heads and ``lru_width`` hidden.
    Other model types get the file's keys alone (the registry refuses
    them)."""
    with open(os.path.join(hf_dir, "config.json")) as f:
        d = json.load(f)
    mt = d.get("model_type", "")
    d = {**_CONFIG_DEFAULTS.get(mt, {}), **d}
    if mt in _CONFIG_DEFAULTS:
        heads = d.get("num_attention_heads")
        if "num_key_value_heads" in d and d["num_key_value_heads"] is None:
            d["num_key_value_heads"] = heads
        if mt in ("llama", "aquila") and d["head_dim"] is None:
            d["head_dim"] = d["hidden_size"] // heads
        if mt in ("qwen2", "qwen3", "qwen2_moe", "qwen3_moe") \
                and not d["use_sliding_window"]:
            d["sliding_window"] = None
        if mt == "dbrx":
            d["attn_config"] = {**_DBRX_ATTN, **(d["attn_config"] or {})}
            d["ffn_config"] = {**_DBRX_FFN, **(d["ffn_config"] or {})}
            d["num_key_value_heads"] = d["attn_config"]["kv_n_heads"]
        if mt in ("falcon", "refinedweb", "refinedwebmodel"):
            if d["num_kv_heads"] is None:
                d["num_kv_heads"] = heads
            if d["ffn_hidden_size"] is None:
                d["ffn_hidden_size"] = 4 * d["hidden_size"]
        if mt == "opt" and d["word_embed_proj_dim"] is None:
            d["word_embed_proj_dim"] = d["hidden_size"]
        if mt == "gpt_bigcode":
            d["num_key_value_heads"] = 1 if d["multi_query"] else d["n_head"]
        if mt == "gpt_neox":
            d.setdefault("rope_theta", d["rotary_emb_base"])
        if mt == "mpt":
            d["attn_config"] = {"alibi": True, **(d["attn_config"] or {})}
        if mt == "mamba":
            if d["intermediate_size"] is None:
                d["intermediate_size"] = int(d["expand"] * d["hidden_size"])
            if d["time_step_rank"] == "auto":
                d["time_step_rank"] = -(-d["hidden_size"] // 16)
        if mt == "recurrent_gemma":
            if d["head_dim"] is None:
                d["head_dim"] = d["hidden_size"] // heads
            if d["lru_width"] is None:
                d["lru_width"] = d["hidden_size"]
        for std, own in _ATTRIBUTE_MAPS.get(mt, {}).items():
            d[std] = d[own]
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
