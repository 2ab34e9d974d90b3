"""Random-weight Hugging Face directories of a Llama (or Mixtral), a
Mamba and a RecurrentGemma, written with the port's own safetensors writer
(no ``transformers``, no ``safetensors``).

    from mixq_tensorrt_llm_tpu_torch.tools.random_hf import (
        LLAMA2_7B_HF, write_random_llama)
    planted = write_random_llama(path, LLAMA2_7B_HF, seed=0, device="cuda")
    write_random_mamba(path, dict(MAMBA_2_8B_HF, num_hidden_layers=2))

The directory is what ``save_pretrained`` leaves for a LlamaForCausalLM
(a MixtralForCausalLM where the config sets ``num_local_experts``: each
layer's MLP is ``block_sparse_moe.gate`` and its experts' w1 / w2 / w3):
``config.json``, the weights in HF names and (out, in) layout, split into
shards named in ``model.safetensors.index.json``. Weights are
N(0, WEIGHT_STD) drawn from a ``torch.Generator`` seeded with ``seed`` on
``device``, one layer at a time; norms are ones, except that each layer
may carry ``outliers`` planted channels, drawn from [outliers, hidden), on
which both of its RMSNorm weights are PLANTED_GAIN: the normed inputs of
qkv and gate_up then peak there, which calibration must find and
all-ones act_scales (channels 0..outliers-1) miss.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from ..convert.checkpoint import write_safetensors
from ..device import DeviceLike, resolve_device

# the public meta-llama/Llama-2-7b-hf config.json
LLAMA2_7B_HF = {
    "architectures": ["LlamaForCausalLM"],
    "bos_token_id": 1,
    "eos_token_id": 2,
    "hidden_act": "silu",
    "hidden_size": 4096,
    "initializer_range": 0.02,
    "intermediate_size": 11008,
    "max_position_embeddings": 4096,
    "model_type": "llama",
    "num_attention_heads": 32,
    "num_hidden_layers": 32,
    "num_key_value_heads": 32,
    "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": None,
    "tie_word_embeddings": False,
    "torch_dtype": "float16",
    "use_cache": True,
    "vocab_size": 32000,
}
WEIGHT_STD = 0.02     # Llama-2's initializer_range
PLANTED_GAIN = 20.0   # both RMSNorm weights on a planted channel
_DTYPES = {"float16": torch.float16, "bfloat16": torch.bfloat16,
           "float32": torch.float32}
# the public state-spaces/mamba-2.8b-hf config.json
MAMBA_2_8B_HF = {
    "architectures": ["MambaForCausalLM"],
    "bos_token_id": 0,
    "conv_kernel": 4,
    "eos_token_id": 0,
    "expand": 2,
    "hidden_act": "silu",
    "hidden_size": 2560,
    "initializer_range": 0.1,
    "intermediate_size": 5120,
    "layer_norm_epsilon": 1e-05,
    "model_type": "mamba",
    "num_hidden_layers": 64,
    "pad_token_id": 0,
    "residual_in_fp32": True,
    "state_size": 16,
    "time_step_rank": 160,
    "torch_dtype": "float32",
    "use_bias": False,
    "use_cache": True,
    "use_conv_bias": True,
    "vocab_size": 50280,
}
# the public google/recurrentgemma-2b config.json
RECURRENTGEMMA_2B_HF = {
    "architectures": ["RecurrentGemmaForCausalLM"],
    "attention_bias": False,
    "attention_window_size": 2048,
    "block_types": ["recurrent", "recurrent", "attention"],
    "bos_token_id": 2,
    "conv1d_width": 4,
    "eos_token_id": 1,
    "head_dim": 256,
    "hidden_activation": "gelu_pytorch_tanh",
    "hidden_size": 2560,
    "intermediate_size": 15360,
    "logits_soft_cap": 30.0,
    "lru_width": 2560,
    "model_type": "recurrent_gemma",
    "num_attention_heads": 10,
    "num_hidden_layers": 26,
    "num_key_value_heads": 1,
    "pad_token_id": 0,
    "partial_rotary_factor": 0.5,
    "rms_norm_eps": 1e-06,
    "rope_theta": 10000.0,
    "torch_dtype": "float32",
    "vocab_size": 256000,
}


def write_random_llama(path: str, config: Dict, seed: int = 0,
                       device: DeviceLike = "cuda", layers_per_shard: int = 8,
                       outliers: int = 0) -> Dict[int, torch.Tensor]:
    """Write the directory; returns {layer: its planted channels, sorted}
    (empty without ``outliers``). Tensors are stored in
    ``config["torch_dtype"]``."""
    dev = resolve_device(device)
    dtype = _DTYPES[config.get("torch_dtype", "float16")]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    h, inter = config["hidden_size"], config["intermediate_size"]
    heads = config["num_attention_heads"]
    kv = config.get("num_key_value_heads", heads)
    d = config.get("head_dim") or h // heads
    n_layers = config["num_hidden_layers"]
    experts = config.get("num_local_experts", 0)

    def rnd(*shape):
        w = torch.randn(shape, generator=gen, device=dev) * WEIGHT_STD
        return w.to(dtype).cpu()

    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    n_shards = -(-n_layers // layers_per_shard)
    weight_map, total, planted = {}, 0, {}
    for s in range(n_shards):
        shard: Dict[str, torch.Tensor] = {}
        if s == 0:
            shard["model.embed_tokens.weight"] = rnd(config["vocab_size"], h)
        for i in range(s * layers_per_shard,
                       min((s + 1) * layers_per_shard, n_layers)):
            p = f"model.layers.{i}."
            mlp = (("mlp.gate_proj", (inter, h)),
                   ("mlp.up_proj", (inter, h)),
                   ("mlp.down_proj", (h, inter)))
            if experts:              # Mixtral's block_sparse_moe
                m = "block_sparse_moe."
                mlp = ((m + "gate", (experts, h)),) + tuple(
                    (m + f"experts.{e}.{w}", shape) for e in range(experts)
                    for w, shape in (("w1", (inter, h)), ("w2", (h, inter)),
                                     ("w3", (inter, h))))
            for name, shape in (("self_attn.q_proj", (heads * d, h)),
                                ("self_attn.k_proj", (kv * d, h)),
                                ("self_attn.v_proj", (kv * d, h)),
                                ("self_attn.o_proj", (h, heads * d))) + mlp:
                shard[p + name + ".weight"] = rnd(*shape)
            norm = torch.ones(h)
            if outliers:
                pick = torch.randperm(h - outliers, generator=gen,
                                      device=dev)[:outliers] + outliers
                planted[i] = torch.sort(pick.cpu()).values
                norm[planted[i]] = PLANTED_GAIN
            for name in ("input_layernorm", "post_attention_layernorm"):
                shard[p + name + ".weight"] = norm.to(dtype)
        if s == n_shards - 1:
            shard["model.norm.weight"] = torch.ones(h, dtype=dtype)
            if not config.get("tie_word_embeddings", False):
                shard["lm_head.weight"] = rnd(config["vocab_size"], h)
        fname = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        write_safetensors(os.path.join(path, fname), shard,
                          metadata={"format": "pt"})
        for name, t in shard.items():
            weight_map[name] = fname
            total += t.numel() * t.element_size()
        del shard
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=2)
    return planted


def random_mamba_state(config: Dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """A MambaForCausalLM state dict in HF names and (out, in) layouts,
    f32 numpy, drawn from a numpy seed: N(0, WEIGHT_STD) projections,
    conv (and its bias, under use_conv_bias) and embedding; A_log =
    log(1..N), dt bias -4, D and the norms ones (``config`` a config.json
    dict; MambaConfig's defaults where it leaves a key out)."""
    rng = np.random.default_rng(seed)
    h = config["hidden_size"]
    i = config.get("intermediate_size") or config.get("expand", 2) * h
    n, k = config.get("state_size", 16), config.get("conv_kernel", 4)
    rank = config.get("time_step_rank", "auto")
    rank = -(-h // 16) if rank == "auto" else rank

    def rnd(*shape):
        return (rng.standard_normal(shape) * WEIGHT_STD).astype(np.float32)

    sd = {"backbone.embeddings.weight": rnd(config["vocab_size"], h),
          "backbone.norm_f.weight": np.ones(h, np.float32)}
    for li in range(config["num_hidden_layers"]):
        p = f"backbone.layers.{li}."
        m = p + "mixer."
        sd[p + "norm.weight"] = np.ones(h, np.float32)
        sd[m + "in_proj.weight"] = rnd(2 * i, h)
        sd[m + "conv1d.weight"] = rnd(i, 1, k)
        if config.get("use_conv_bias", True):
            sd[m + "conv1d.bias"] = rnd(i)
        sd[m + "x_proj.weight"] = rnd(rank + 2 * n, i)
        sd[m + "dt_proj.weight"] = rnd(i, rank)
        sd[m + "dt_proj.bias"] = np.full(i, -4.0, np.float32)
        sd[m + "A_log"] = np.log1p(np.arange(n, dtype=np.float32))[
            None].repeat(i, 0)
        sd[m + "D"] = np.ones(i, np.float32)
        sd[m + "out_proj.weight"] = rnd(h, i)
        if config.get("use_bias", False):
            sd[m + "in_proj.bias"] = rnd(2 * i)
            sd[m + "out_proj.bias"] = rnd(h)
    if not config.get("tie_word_embeddings", True):
        sd["lm_head.weight"] = rnd(config["vocab_size"], h)
    return sd


def random_recurrentgemma_state(config: Dict,
                                seed: int = 0) -> Dict[str, np.ndarray]:
    """A RecurrentGemmaForCausalLM state dict in HF names and (out, in)
    layouts, f32 numpy, drawn from a numpy seed: N(0, WEIGHT_STD) weights,
    biases, gates and embedding; recurrent_param ones; the norms' stored w
    N(0, WEIGHT_STD) (RecurrentGemmaRMSNorm computes x * (1 + w))."""
    rng = np.random.default_rng(seed)
    h, inter = config["hidden_size"], config["intermediate_size"] // 2
    heads = config["num_attention_heads"]
    kv = config.get("num_key_value_heads") or heads
    d = config.get("head_dim") or h // heads
    lru, k = config.get("lru_width") or h, config.get("conv1d_width", 4)
    bw = lru // heads
    pattern = config.get("block_types",
                         ["recurrent", "recurrent", "attention"])

    def rnd(*shape):
        return (rng.standard_normal(shape) * WEIGHT_STD).astype(np.float32)

    sd = {"model.embed_tokens.weight": rnd(config["vocab_size"], h),
          "model.final_norm.weight": rnd(h)}
    for li in range(config["num_hidden_layers"]):
        p = f"model.layers.{li}."
        tb = p + "temporal_block."
        sd[p + "temporal_pre_norm.weight"] = rnd(h)
        sd[p + "channel_pre_norm.weight"] = rnd(h)
        for name, (n_out, n_in) in (("gate_proj", (inter, h)),
                                    ("up_proj", (inter, h)),
                                    ("down_proj", (h, inter))):
            sd[p + f"mlp_block.{name}.weight"] = rnd(n_out, n_in)
            sd[p + f"mlp_block.{name}.bias"] = rnd(n_out)
        if pattern[li % len(pattern)] == "attention":
            for name, n_out in (("q", heads * d), ("k", kv * d),
                                ("v", kv * d)):
                sd[tb + f"{name}_proj.weight"] = rnd(n_out, h)
                if config.get("attention_bias", False):
                    sd[tb + f"{name}_proj.bias"] = rnd(n_out)
            sd[tb + "o_proj.weight"] = rnd(h, heads * d)
            sd[tb + "o_proj.bias"] = rnd(h)
            continue
        for name, (n_out, n_in) in (("linear_y", (lru, h)),
                                    ("linear_x", (lru, h)),
                                    ("linear_out", (h, lru))):
            sd[tb + f"{name}.weight"] = rnd(n_out, n_in)
            sd[tb + f"{name}.bias"] = rnd(n_out)
        sd[tb + "conv_1d.weight"] = rnd(lru, 1, k)
        sd[tb + "conv_1d.bias"] = rnd(lru)
        sd[tb + "rg_lru.recurrent_param"] = np.ones(lru, np.float32)
        for gate in ("input_gate", "recurrent_gate"):
            sd[tb + f"rg_lru.{gate}_weight"] = rnd(heads, bw, bw)
            sd[tb + f"rg_lru.{gate}_bias"] = rnd(heads, bw)
    return sd


def write_hf_dir(path: str, config: Dict,
                 state: Dict[str, np.ndarray]) -> None:
    """``config.json`` and ``model.safetensors`` (the state in
    ``config["torch_dtype"]``), as ``save_pretrained`` leaves them."""
    dtype = _DTYPES[config.get("torch_dtype", "float32")]
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    write_safetensors(os.path.join(path, "model.safetensors"),
                      {k: torch.from_numpy(v).to(dtype)
                       for k, v in state.items()},
                      metadata={"format": "pt"})


def write_random_mamba(path: str, config: Dict, seed: int = 0) -> None:
    """A random MambaForCausalLM directory (``random_mamba_state``)."""
    write_hf_dir(path, config, random_mamba_state(config, seed))


def write_random_recurrentgemma(path: str, config: Dict,
                                seed: int = 0) -> None:
    """A random RecurrentGemmaForCausalLM directory
    (``random_recurrentgemma_state``)."""
    write_hf_dir(path, config, random_recurrentgemma_state(config, seed))
