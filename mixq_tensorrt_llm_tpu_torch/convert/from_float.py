"""Requantize a float params tree under a new QuantConfig.
Counterpart of mixq_tensorrt_llm_tpu/convert/from_float.py.

Takes an unquantized (QuantAlgo.NONE) params tree, e.g. the float model
that calibration ran or a float checkpoint, and quantizes it layer by layer
on its device with the HF pipeline's routing (models/llama.py
``_quantize_layer``): float vs int8_mix vs int4_mix on identical weights.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from ..models import llama as mllama
from ..models.common import ModelConfig
from ..quant.config import QuantConfig


def _float_layer(layer: Dict) -> Dict:
    """A float layer's params -> the raw-weight dict ``_quantize_layer``
    takes (module name -> (in, out) weight; an expert layer's router and
    float stacks, and Qwen2-MoE's shared expert, which the JAX package's
    requantize leaves out)."""
    fl: Dict = {"input_norm": layer["input_norm"]["w"],
                "post_norm": layer["post_norm"]["w"]}
    mods = mllama.LINEAR_MODULES
    if "moe" in layer:            # an expert layer: float stacks
        moe = layer["moe"]
        fl.update(router_w=moe["router"]["w"],
                  experts_gate_up=moe["gate_up"]["w"],
                  experts_down=moe["down"]["w"])
        if "shared_gate_up" in moe:
            fl.update(shared_gate_up_w=(moe["shared_gate_up"]["w"], None),
                      shared_down_w=(moe["shared_down"]["w"], None),
                      shared_gate_w=moe["shared_gate"]["w"])
        mods = ("qkv_proj", "o_proj")
    for mod in mods:
        p = layer[mod]
        if "w" not in p:
            raise ValueError(f"requantize needs a float tree; {mod} has "
                             f"keys {sorted(p)}")
        fl[mod] = p["w"]
        if mod == "qkv_proj" and p.get("b") is not None:
            fl["qkv_bias"] = p["b"]
    return fl


def requantize(params_float: Dict, cfg_float: ModelConfig,
               quant: QuantConfig,
               act_scales: Optional[Mapping] = None
               ) -> Tuple[Dict, ModelConfig]:
    """Float params + target QuantConfig -> (quantized params, new cfg),
    on the params' device. Mix algos without act_scales take ones
    (channels 0..k-1), as in the JAX package."""
    if cfg_float.quant.enabled:
        raise ValueError("params_float must be unquantized")
    cfg_q = dataclasses.replace(cfg_float, quant=quant)
    out: Dict = {
        "embed": {"w": params_float["embed"]["w"].to(cfg_q.dtype)},
        "layers": [mllama._quantize_layer(cfg_q, _float_layer(layer),
                                          act_scales, i)
                   for i, layer in enumerate(params_float["layers"])],
        "final_norm": {"w": params_float["final_norm"]["w"].float()},
    }
    if "lm_head" in params_float:
        out["lm_head"] = {"w": params_float["lm_head"]["w"].to(cfg_q.dtype)}
    return out, cfg_q
