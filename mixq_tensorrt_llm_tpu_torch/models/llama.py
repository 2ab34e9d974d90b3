"""Llama-family params: Hugging Face weight mapping, quantization routing
and random init. Counterpart of mixq_tensorrt_llm_tpu/models/llama.py.

q/k/v and gate/up are fused into single (in, out) weights; quantization
follows the QuantConfig routing (qkv/gate_up/o mix, down weight-only,
lm_head excluded; a Mixtral layer's experts weight-only, models/moe.py);
int4 weights are packed two a byte when in_features is even, as in the
JAX package. ``params_from_hf`` takes the state dict as
stored (file dtype, (out, in), memory-mapped) and brings one layer at a
time to the target device, upcast to f32 there, so scales are computed in
f32 as the JAX package computes them and no whole-model f32 copy exists.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..ops import dispatch
from ..quant.config import QuantConfig
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
    mods = LINEAR_MODULES
    if cfg.num_experts:
        # the experts run weight-only; only qkv / o take the mix algos
        out["moe"] = quantize_moe(cfg, float_layer)
        mods = ("qkv_proj", "o_proj")
    for mod in mods:
        w = float_layer[mod]
        algo = cfg.module_algo(mod)
        bias = float_layer.get("qkv_bias") if mod == "qkv_proj" else None
        scale = (act_scale_for(act_scales, i, mod, w.shape[0], w.device)
                 if algo.is_mix else None)
        out[mod] = dispatch.quantize_linear_params(
            w, algo, act_scale=scale, num_outliers=cfg.quant.num_outliers,
            group_size=cfg.quant.group_size, bias=bias)
    return out


def quantize_moe(cfg: ModelConfig, fl: Dict) -> Dict:
    """A layer's float expert weights (``router_w`` (H, E),
    ``experts_gate_up`` (E, H, 2I), ``experts_down`` (E, I, H), and
    Qwen2-MoE's ``shared_gate_up_w`` / ``shared_down_w`` (w, bias) and
    ``shared_gate_w`` (H, 1)) -> the layer's ``moe`` params, the stacks
    under the experts' weight-only algo (models/moe.expert_algo)."""
    from . import moe
    algo = moe.expert_algo(cfg)
    gs = cfg.quant.group_size
    out = {"router": {"w": fl["router_w"].to(torch.bfloat16)},
           "gate_up": moe.quantize_expert_linear(
               fl["experts_gate_up"].float(), algo, gs),
           "down": moe.quantize_expert_linear(
               fl["experts_down"].float(), algo, gs)}
    if "shared_gate_up_w" in fl:
        for src, dst in (("shared_gate_up_w", "shared_gate_up"),
                         ("shared_down_w", "shared_down")):
            w, b = fl[src]
            out[dst] = dispatch.quantize_linear_params(
                w.float(), algo, group_size=gs,
                bias=None if b is None else b.float())
        out["shared_gate"] = {"w": fl["shared_gate_w"].float()}
    return out


def random_experts(cfg: ModelConfig, rnd) -> Dict:
    """One layer's float expert weights drawn by ``rnd(*shape)`` (the
    router, each expert's gate_up then down, and the shared expert)."""
    h, e = cfg.hidden_size, cfg.num_experts
    mi = cfg.moe_intermediate or cfg.intermediate_size
    fl = {"router_w": rnd(h, e),
          "experts_gate_up": torch.stack([rnd(h, 2 * mi) for _ in range(e)]),
          "experts_down": torch.stack([rnd(mi, h) for _ in range(e)])}
    si = cfg.moe_shared_intermediate
    if si:
        fl["shared_gate_up_w"] = (rnd(h, 2 * si), None)
        fl["shared_down_w"] = (rnd(si, h), None)
        fl["shared_gate_w"] = rnd(h, 1)
    return fl


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device: DeviceLike = "cuda",
                       act_scales=None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """Random-weight params, N(0, 0.02), quantized with the production
    routing. Drawn from ``generator`` (else a ``torch.Generator`` seeded
    with ``seed`` on the target device), one layer at a time, so the float
    weights of only one layer exist at once (a 7B model never holds its
    f32 weights whole; Mixtral-8x7B's f32 experts are 5.6 GB a layer).
    The draws differ from the JAX package's for the same seed."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
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
            "input_norm": torch.ones(h, device=dev),
            "post_norm": torch.ones(h, device=dev),
        }
        if cfg.num_experts:
            fl.update(random_experts(cfg, rnd))
        else:
            fl["gate_up_proj"] = rnd(h, 2 * cfg.intermediate_size)
            fl["down_proj"] = rnd(cfg.intermediate_size, h)
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


def _t(w: torch.Tensor, device: torch.device,
       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """HF (out, in) -> the (in, out) kernel layout on ``device``, contiguous
    in ``dtype`` (moved in the file's dtype, converted there)."""
    return w.to(device).t().to(dtype, memory_format=torch.contiguous_format)


def _vec(w: torch.Tensor, device: torch.device) -> torch.Tensor:
    return w.to(device).float()


def hf_layer_weights(hf: Mapping[str, torch.Tensor], i: int,
                     prefix: str = "model", device: DeviceLike = "cuda"
                     ) -> Dict[str, torch.Tensor]:
    """One decoder layer's float weights from an HF state dict, as f32
    (in, out) tensors on ``device`` keyed by the port's module names: q/k/v
    and gate/up fused; Qwen2's q/k/v biases as ``qkv_bias``; a Mixtral
    layer's router and expert stacks (w1 | w3 fused as gate_up, w2 as
    down) as ``router_w``, ``experts_gate_up``, ``experts_down``."""
    dev = resolve_device(device)
    p = f"{prefix}.layers.{i}."
    out = {
        "qkv_proj": torch.cat([_t(hf[p + f"self_attn.{n}_proj.weight"], dev)
                               for n in "qkv"], dim=1),
        "o_proj": _t(hf[p + "self_attn.o_proj.weight"], dev),
        "input_norm": _vec(hf[p + "input_layernorm.weight"], dev),
        "post_norm": _vec(hf[p + "post_attention_layernorm.weight"], dev),
    }
    m = p + "block_sparse_moe."
    if m + "gate.weight" in hf:          # a Mixtral expert layer
        ne = 0
        while m + f"experts.{ne}.w1.weight" in hf:
            ne += 1
        out["router_w"] = _t(hf[m + "gate.weight"], dev)
        out["experts_gate_up"] = torch.stack([
            torch.cat([_t(hf[m + f"experts.{e}.w1.weight"], dev),
                       _t(hf[m + f"experts.{e}.w3.weight"], dev)], dim=1)
            for e in range(ne)])
        out["experts_down"] = torch.stack([
            _t(hf[m + f"experts.{e}.w2.weight"], dev) for e in range(ne)])
    else:
        out["gate_up_proj"] = torch.cat(
            [_t(hf[p + "mlp.gate_proj.weight"], dev),
             _t(hf[p + "mlp.up_proj.weight"], dev)], dim=1)
        out["down_proj"] = _t(hf[p + "mlp.down_proj.weight"], dev)
    if p + "self_attn.q_proj.bias" in hf:
        out["qkv_bias"] = torch.cat(
            [_vec(hf[p + f"self_attn.{n}_proj.bias"], dev) for n in "qkv"])
    return out


def params_from_hf(cfg: ModelConfig, hf: Mapping[str, torch.Tensor],
                   act_scales: Optional[Mapping] = None,
                   prefix: str = "model", device: DeviceLike = "cuda") -> Dict:
    """HF state dict -> quantized params on ``device``, one layer at a
    time: a layer's f32 weights exist only while it is quantized."""
    dev = resolve_device(device)
    layers = []
    for i in range(cfg.num_layers):
        fl = hf_layer_weights(hf, i, prefix, dev)
        layers.append(_quantize_layer(cfg, fl, act_scales, i))
        del fl
    params: Dict = {
        "embed": {"w": hf[f"{prefix}.embed_tokens.weight"].to(dev).to(
            cfg.dtype)},
        "layers": layers,
        "final_norm": {"w": _vec(hf[f"{prefix}.norm.weight"], dev)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": _t(hf["lm_head.weight"], dev, cfg.dtype)}
    return params


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()
                   ) -> ModelConfig:
    """An HF Llama / Mistral / Mixtral / Qwen2 / Aquila config
    (``AutoConfig`` or ``convert.hf.load_hf_config``) -> ModelConfig, read
    as the JAX package reads it."""
    mt = hf_config.model_type.lower()
    arch = "qwen2" if "qwen2" in mt else ("mixtral" if "mixtral" in mt
                                          else "llama")
    head_dim = getattr(hf_config, "head_dim", None) or (
        hf_config.hidden_size // hf_config.num_attention_heads)
    return ModelConfig(
        arch=arch,
        vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size,
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=getattr(hf_config, "num_key_value_heads",
                             hf_config.num_attention_heads),
        head_dim=head_dim,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        rms_norm_eps=hf_config.rms_norm_eps,
        max_position_embeddings=hf_config.max_position_embeddings,
        qkv_bias=(arch == "qwen2"),
        sliding_window=getattr(hf_config, "sliding_window", None) or 0,
        num_experts=getattr(hf_config, "num_local_experts", 0) or 0,
        top_k_experts=getattr(hf_config, "num_experts_per_tok", 2) or 2,
        tie_word_embeddings=getattr(hf_config, "tie_word_embeddings", False),
        quant=quant,
        **_rope_scaling_axes(hf_config),
    )


def _rope_scaling_axes(hf_config) -> dict:
    """HF rope_scaling -> ModelConfig axes: Llama-3.1's "llama3"
    wavelength-banded scaling, plain "linear" interpolation and "yarn"
    (Qwen2's long-context configs: the ramp's bounds and the attention
    factor, HF _compute_yarn_parameters)."""
    rs = getattr(hf_config, "rope_scaling", None)
    if not rs:
        return {}
    kind = rs.get("rope_type", rs.get("type", "none"))
    if kind == "default":
        return {}
    if kind not in ("llama3", "linear", "yarn"):
        raise NotImplementedError(f"rope_scaling type {kind!r} unsupported "
                                  "(llama3, linear, and yarn are)")
    out = {"rope_scaling_type": kind,
           "rope_scaling_factor": float(rs.get("factor", 1.0))}
    if kind == "llama3":
        out.update(
            rope_low_freq_factor=float(rs.get("low_freq_factor", 1.0)),
            rope_high_freq_factor=float(rs.get("high_freq_factor", 4.0)),
            rope_original_max_pos=int(
                rs.get("original_max_position_embeddings", 8192)))
    if kind == "yarn":
        factor = out["rope_scaling_factor"]
        af = rs.get("attention_factor")
        mscale, mall = rs.get("mscale"), rs.get("mscale_all_dim")

        def get_mscale(scale, m=1):
            return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0
        if af is None:
            af = (get_mscale(factor, mscale) / get_mscale(factor, mall)
                  if mscale and mall else get_mscale(factor))
        out.update(
            rope_beta_fast=float(rs.get("beta_fast") or 32),
            rope_beta_slow=float(rs.get("beta_slow") or 1),
            rope_attention_factor=float(af),
            rope_original_max_pos=int(
                rs.get("original_max_position_embeddings")
                or hf_config.max_position_embeddings))
    return out
