"""Llama-family params: quantization routing and random init.
Counterpart of mixq_tensorrt_llm_tpu/models/llama.py.

q/k/v and gate/up are fused into single (in, out) weights; quantization
follows the QuantConfig routing (qkv/gate_up/o mix, down weight-only,
lm_head excluded); int4 weights are packed two a byte when in_features is
even, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import dispatch
from .common import ModelConfig

LINEAR_MODULES = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
_HF_NAMES = {
    "qkv_proj": "self_attn.q_proj",
    "o_proj": "self_attn.o_proj",
    "gate_up_proj": "mlp.gate_proj",
    "down_proj": "mlp.down_proj",
}


def act_scale_for(act_scales: Optional[Mapping], i: int, module: str,
                  in_features: int, device=None) -> torch.Tensor:
    """Calibrated per-input-channel absmax for layer i's module, keyed like
    the reference's calibration artifact (``model.layers.{i}.{hf_module}``;
    the fused qkv / gate_up read the q_proj / gate_proj entry). Ones when
    missing."""
    hf_name = _HF_NAMES[module]
    if act_scales is not None:
        for key in (f"model.layers.{i}.{hf_name}", f"layers.{i}.{hf_name}"):
            if key in act_scales:
                a = act_scales[key]
                if not isinstance(a, torch.Tensor):
                    a = torch.from_numpy(np.asarray(a, np.float32))
                return a.to(device=device, dtype=torch.float32)
    return torch.ones((in_features,), dtype=torch.float32, device=device)


def _quantize_layer(cfg: ModelConfig, float_layer: Dict[str, torch.Tensor],
                    act_scales, i: int) -> Dict:
    """Quantize one layer's float weights into the params-dict schema."""
    out: Dict = {
        "input_norm": {"w": float_layer["input_norm"].float()},
        "post_norm": {"w": float_layer["post_norm"].float()},
    }
    for mod in LINEAR_MODULES:
        w = float_layer[mod]
        algo = cfg.module_algo(mod)
        bias = float_layer.get("qkv_bias") if mod == "qkv_proj" else None
        scale = (act_scale_for(act_scales, i, mod, w.shape[0], w.device)
                 if algo.is_mix else None)
        out[mod] = dispatch.quantize_linear_params(
            w, algo, act_scale=scale, num_outliers=cfg.quant.num_outliers,
            group_size=cfg.quant.group_size, bias=bias)
    return out


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device: DeviceLike = "cuda",
                       act_scales=None) -> Dict:
    """Random-weight params, N(0, 0.02), quantized with the production
    routing. Drawn from a ``torch.Generator`` seeded with ``seed`` on the
    target device, one layer at a time, so the float weights of only one
    layer exist at once (a 7B model never holds its f32 weights whole).
    The draws differ from the JAX package's for the same seed."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    std = 0.02

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    h = cfg.hidden_size
    layers = []
    for i in range(cfg.num_layers):
        fl = {
            "qkv_proj": rnd(h, cfg.qkv_out),
            "o_proj": rnd(cfg.q_size, h),
            "gate_up_proj": rnd(h, 2 * cfg.intermediate_size),
            "down_proj": rnd(cfg.intermediate_size, h),
            "input_norm": torch.ones(h, device=dev),
            "post_norm": torch.ones(h, device=dev),
        }
        if cfg.qkv_bias:
            fl["qkv_bias"] = torch.zeros(cfg.qkv_out, device=dev)
        layers.append(_quantize_layer(cfg, fl, act_scales, i))
        del fl
    params: Dict = {
        "embed": {"w": rnd(cfg.vocab_size, h).to(cfg.dtype)},
        "layers": layers,
        "final_norm": {"w": torch.ones(h, device=dev)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": rnd(h, cfg.vocab_size).to(cfg.dtype)}
    return params
