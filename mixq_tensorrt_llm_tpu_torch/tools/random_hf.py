"""A random-weight Hugging Face Llama (or Mixtral) directory, written with
the port's own safetensors writer (no ``transformers``, no
``safetensors``).

    from mixq_tensorrt_llm_tpu_torch.tools.random_hf import (
        LLAMA2_7B_HF, write_random_llama)
    planted = write_random_llama(path, LLAMA2_7B_HF, seed=0, device="cuda")

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
