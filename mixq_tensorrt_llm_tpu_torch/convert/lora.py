"""LoRA adapters: merged into the base weights before quantization, or
stacked for runtime multi-adapter serving. Counterpart of
convert/lora.py.

Reads standard PEFT directories: ``adapter_config.json`` (r, lora_alpha,
target_modules) and ``adapter_model.safetensors`` (the port's own reader,
convert/checkpoint.read_safetensors) or ``adapter_model.bin``
(``torch.load``), with keys such as
``base_model.model.model.layers.{i}.self_attn.q_proj.lora_A.weight``.

- ``merge_lora_into_state_dict``: W' = W + (alpha / r) B A folded into the
  float weights, so the quantized checkpoint carries the adapter at no
  runtime cost (``convert/hf.quantize_hf_model(lora_dir=...)``).
- ``build_lora_stack`` / ``attach_lora``: adapters kept unmerged, stacked
  per fused module into (N+1, in, R) / (N+1, R, out) bf16 tensors a layer
  (slot 0 the base model, all zero); ``models.common.decoder_layer`` adds
  each lane's delta by its ``lora_ids``.

The arithmetic is numpy's f32, as in the JAX package, so a merged weight
or a stack is bit-equal to the JAX package's.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .checkpoint import read_safetensors

_KEY_RE = re.compile(
    r"(?:base_model\.model\.)?(?P<module>.+)\.lora_(?P<ab>[AB])\.weight$")
_LAYER_RE = re.compile(r"model\.layers\.(\d+)\.(?:self_attn|mlp)\.(\w+)$")


def _f32(x) -> np.ndarray:
    """A tensor or an array as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def load_adapter(adapter_dir: str) -> Tuple[dict, Dict[str, dict]]:
    """Returns (adapter_config, {hf_module_path: {"A": (r, in), "B": (out,
    r)}}), the weights float32 numpy arrays."""
    with open(os.path.join(adapter_dir, "adapter_config.json")) as f:
        cfg = json.load(f)
    files = (glob.glob(os.path.join(adapter_dir, "adapter_model.safetensors"))
             or glob.glob(os.path.join(adapter_dir, "adapter_model.bin")))
    if not files:
        raise FileNotFoundError(f"no adapter weights in {adapter_dir}")
    if files[0].endswith(".safetensors"):
        raw = read_safetensors(files[0])
    else:
        raw = torch.load(files[0], map_location="cpu", weights_only=True)
    tensors: Dict[str, dict] = {}
    for key, val in raw.items():
        m = _KEY_RE.match(key)
        if m:
            tensors.setdefault(m.group("module"), {})[m.group("ab")] = \
                _f32(val)
    return cfg, tensors


def merge_lora_into_state_dict(sd: Mapping, adapter_dir: str) -> Dict:
    """HF state dict + PEFT directory -> the state dict with W' = W +
    (lora_alpha / r) B @ A on every targeted weight (PEFT's lora_A (r, in)
    and lora_B (out, r) for a torch (out, in) weight), those as float32
    tensors; the other entries are passed through."""
    cfg, tensors = load_adapter(adapter_dir)
    scale = cfg.get("lora_alpha", 1) / cfg.get("r", 1)
    out = dict(sd)
    merged = 0
    for module, ab in tensors.items():
        if "A" not in ab or "B" not in ab:
            continue
        wkey = module + ".weight"
        if wkey not in out:
            raise KeyError(f"adapter targets missing base weight: {wkey}")
        delta = (ab["B"] @ ab["A"]) * scale           # (out, in)
        out[wkey] = torch.from_numpy(_f32(out[wkey]) + delta)
        merged += 1
    if merged == 0:
        raise ValueError(f"adapter in {adapter_dir} matched no base weights")
    return out


# PEFT target -> (the fused module, its output slice): several rank-r
# targets of one fused weight land in disjoint column slices of B, so they
# become ONE adapter of rank sum(r) on it
_FUSED_TARGETS = {
    "q_proj": ("qkv_proj", "q"),
    "k_proj": ("qkv_proj", "k"),
    "v_proj": ("qkv_proj", "v"),
    "o_proj": ("o_proj", "full"),
    "gate_proj": ("gate_up_proj", "gate"),
    "up_proj": ("gate_up_proj", "up"),
    "down_proj": ("down_proj", "full"),
}


def _module_geom(cfg):
    """Fused module -> (in_features, out_features, {slice: column
    offset})."""
    return {
        "qkv_proj": (cfg.hidden_size, cfg.qkv_out,
                     {"q": 0, "k": cfg.q_size, "v": cfg.q_size + cfg.kv_size}),
        "o_proj": (cfg.q_size, cfg.hidden_size, {"full": 0}),
        "gate_up_proj": (cfg.hidden_size, 2 * cfg.intermediate_size,
                         {"gate": 0, "up": cfg.intermediate_size}),
        "down_proj": (cfg.intermediate_size, cfg.hidden_size, {"full": 0}),
    }


def build_lora_stack(cfg, adapter_dirs: Sequence[str],
                     device: DeviceLike = "cuda") -> Dict[str, dict]:
    """PEFT directories -> {module: {"A": (L, N+1, in, R), "B": (L, N+1,
    R, out)}} bf16 on ``device``.

    Adapter n (1-based; 0 is the base model, all zero) gives its targets'
    A columns and (alpha / r)-scaled B rows; the ranks are padded to the
    module's largest sum over the adapters. Only modules that some adapter
    targets get an entry."""
    dev = resolve_device(device)
    geom = _module_geom(cfg)
    adapters = []
    for d in adapter_dirs:
        acfg, tensors = load_adapter(d)
        scale = acfg.get("lora_alpha", 1) / acfg.get("r", 1)
        per: Dict[tuple, list] = {}    # (layer, module) -> [(slice, A, B)]
        for module, ab in tensors.items():
            m = _LAYER_RE.search(module)
            if not m or m.group(2) not in _FUSED_TARGETS:
                continue
            ours, skey = _FUSED_TARGETS[m.group(2)]
            per.setdefault((int(m.group(1)), ours), []).append(
                (skey, ab["A"], ab["B"] * scale))
        if not per:
            raise ValueError(f"adapter in {d} matched no supported targets")
        adapters.append(per)

    n = len(adapters)
    stack = {}
    for mod, (nin, nout, offsets) in geom.items():
        rmax = max(sum(a.shape[0] for _, a, _ in per.get((i, mod), []))
                   for per in adapters for i in range(cfg.num_layers))
        if rmax == 0:
            continue
        a_all = np.zeros((cfg.num_layers, n + 1, nin, rmax), np.float32)
        b_all = np.zeros((cfg.num_layers, n + 1, rmax, nout), np.float32)
        for ai, per in enumerate(adapters):
            for i in range(cfg.num_layers):
                r0 = 0
                for skey, a, b in per.get((i, mod), []):
                    r, off = a.shape[0], offsets[skey]
                    a_all[i, ai + 1, :, r0:r0 + r] = a.T
                    b_all[i, ai + 1, r0:r0 + r, off:off + b.shape[0]] = b.T
                    r0 += r
        stack[mod] = {"A": torch.from_numpy(a_all).to(torch.bfloat16).to(dev),
                      "B": torch.from_numpy(b_all).to(torch.bfloat16).to(dev)}
    return stack


def attach_lora(params, stack: Dict[str, dict]):
    """Attach a stack to a params dict in place, layer by layer: module
    ``mod`` of layer i gets ``lora_A`` = A[i] and ``lora_B`` = B[i]."""
    for mod, ab in stack.items():
        for i, lp in enumerate(params["layers"]):
            lp[mod]["lora_A"] = ab["A"][i]
            lp[mod]["lora_B"] = ab["B"][i]
    return params


def has_lora(params) -> bool:
    """Whether adapters are attached to ``params``."""
    return any(isinstance(m, dict) and "lora_A" in m
               for lp in params["layers"] for m in lp.values())
