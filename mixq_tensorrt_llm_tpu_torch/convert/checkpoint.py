"""Checkpoint save/load: config.json + model.safetensors, the JAX package's
format (counterpart of convert/checkpoint.py).

Tensors keep their real dtypes (int8, int32, bf16, f32) under the JAX
package's flattened names (an e4m3 tensor as its U8 bytes, its name
marked ``@e4m3``, as the JAX package writes it), layers stacked on axis 0
(``layers.qkv_proj.qweight`` is (L, in, out), an expert stack
``layers.moe.gate_up.qweight`` (L, E, in, out); RecurrentGemma's layers in
their pattern groups, ``per_pos.*`` (G, 3, ...), ``att.*`` (G, 1, ...) and
``rec.*`` (G, 2, ...)). The safetensors format is
read and written here without the safetensors package: an 8-byte
little-endian header length, a JSON header of ``{name: {"dtype", "shape",
"data_offsets"}}``, then the raw bytes. Loading validates the required
names as the JAX package does (with each family's norms) and goes through
``convert.from_jax.params_from_numpy``, which checks every leaf's dtype and
shape.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Dict, Optional, Tuple

import torch

from ..device import DeviceLike
from ..models.common import ModelConfig
from ..quant import core as qcore
from ..quant.config import QuantAlgo
from .from_jax import layer_norms, params_from_numpy

CONFIG_NAME = "config.json"
WEIGHTS_NAME = "model.safetensors"
FP8_SUFFIX = "@e4m3"           # the JAX package's marker for fp8 bytes

# the params schema's dtypes, and U8 (the JAX package's fp8 bytes)
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32, "I8": torch.int8, "U8": torch.uint8,
              "I32": torch.int32}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """{name: CPU tensor} of a safetensors file, memory-mapped
    copy-on-write (a tensor is read from disk when it is first used)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _ST_DTYPES:
            raise NotImplementedError(f"{name}: safetensors dtype "
                                      f"{info['dtype']} is not read here")
        dt, shape = _ST_DTYPES[info["dtype"]], tuple(info["shape"])
        begin, end = info["data_offsets"]
        if begin == end:
            out[name] = torch.empty(shape, dtype=dt)
            continue
        count = (end - begin) // torch.empty((), dtype=dt).element_size()
        out[name] = torch.frombuffer(buf, dtype=dt, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Dict[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write {name: tensor} in the safetensors layout (widest dtypes first,
    the header padded to 8 bytes, so every tensor starts aligned), one
    tensor at a time: no copy of the whole set is made. ``metadata`` goes
    under ``__metadata__`` (Hugging Face writes {"format": "pt"})."""
    items = sorted(tensors.items(),
                   key=lambda kv: (-kv[1].element_size(), kv[0]))
    header: Dict = {"__metadata__": dict(metadata)} if metadata else {}
    off = 0
    for name, t in items:
        if t.dtype not in _ST_NAMES:
            raise NotImplementedError(f"{name}: dtype {t.dtype} is not "
                                      "written here")
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    # written beside and renamed: a file under ``path`` is always whole
    partial = path + ".partial"
    with open(partial, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for _, t in items:
            t = t.detach().to("cpu").contiguous()
            f.write(t.reshape(-1).view(torch.uint8).numpy().data)
    os.replace(partial, path)


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for key, v in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _required(mod: str, algo: QuantAlgo) -> set:
    if mod.endswith("norm"):
        return {"w"}
    if algo.is_mix:
        return {"qweight", "scale_col", "fp_ind", "fp_weight"}
    if algo.is_lr:
        return {"qweight", "scale_col", "lr_u", "lr_v"}
    if algo == QuantAlgo.W4A16_G:
        return {"qweight", "scale_g"}
    if algo.is_weight_only or algo.is_fp8:
        return {"qweight", "scale_col"}
    return {"w"}


# the recurrent-state models' required names (the JAX package's
# convert/checkpoint.py _validate)
_RG_REQUIRED = (("per_pos", ("temporal_norm", "channel_norm", "gate_up_proj",
                             "down_proj")),
                ("att", ("qkv_proj", "o_proj")),
                ("rec", ("linear_x", "linear_y", "linear_out", "conv_w",
                         "recurrent_param")))
_MAMBA_REQUIRED = ("in_proj", "out_proj", "x_proj", "dt_proj", "norm",
                   "conv_w", "A_log", "D")


def _validate(params: Dict, cfg: ModelConfig) -> None:
    """Required-name validation, the JAX package's rules (its
    convert/checkpoint.py ``_validate``) with the norms the config's axes
    imply (``from_jax.layer_norms``: a shared block norm has no post_norm,
    OLMo-2 neither pre-norm), and the top-level positional and embedding
    norm tensors; the recurrent-state models by their own schemas."""
    missing = [k for k in ("embed", "final_norm") if k not in params]
    if not cfg.tie_word_embeddings and "lm_head" not in params:
        missing.append("lm_head")
    if cfg.arch in ("mamba", "recurrentgemma"):
        groups = (_RG_REQUIRED if cfg.arch == "recurrentgemma"
                  else (("layers", _MAMBA_REQUIRED),))
        missing += [f"{grp}.{mod}" for grp, mods in groups for mod in mods
                    if mod not in params.get(grp, {})]
        if missing:
            raise ValueError(
                f"checkpoint is missing required tensors: {missing}")
        return
    if cfg.pos_embedding == "learned" and "pos_embed" not in params:
        missing.append("pos_embed")
    if cfg.embed_norm and "embed_norm" not in params:
        missing.append("embed_norm")
    layers = params.get("layers", {})
    mods = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj")
    if cfg.num_experts:
        mods = ("qkv_proj", "o_proj")
        if "moe" not in layers:
            missing.append("layers.moe")
        else:
            missing += [f"layers.moe.{sub}" for sub in
                        ("router", "gate_up", "down")
                        if sub not in layers["moe"]]
    for mod in (*mods, *layer_norms(cfg)):
        if mod not in layers:
            missing.append(f"layers.{mod}")
            continue
        for t in sorted(_required(mod, cfg.module_algo(mod))):
            if t not in layers[mod] and not (
                    t == "qweight" and "qweight_packed" in layers[mod]):
                missing.append(f"layers.{mod}.{t}")
    if missing:
        raise ValueError(f"checkpoint is missing required tensors: {missing}")
    first = layers["qkv_proj"]
    while isinstance(first, dict):
        first = next(iter(first.values()))
    if first.shape[0] != cfg.num_layers:
        raise ValueError(f"checkpoint has {first.shape[0]} stacked layers, "
                         f"config says {cfg.num_layers}")


def load_checkpoint(path: str, device: DeviceLike = "cuda"
                    ) -> Tuple[Dict, ModelConfig]:
    """A checkpoint directory (the JAX package's save_checkpoint or this
    module's) -> (port params on ``device``, ModelConfig)."""
    with open(os.path.join(path, CONFIG_NAME)) as f:
        cfg = ModelConfig.from_dict(json.load(f))
    flat = {}
    for k, v in read_safetensors(os.path.join(path, WEIGHTS_NAME)).items():
        if k.endswith(FP8_SUFFIX):
            k, v = k[:-len(FP8_SUFFIX)], v.view(qcore.FP8)
        flat[k] = v
    params = _unflatten(flat)
    _validate(params, cfg)
    return params_from_numpy(params, cfg, device=device), cfg


def _stacked(layers, prefix: str, keys=None,
             groups: int = 0) -> Dict[str, torch.Tensor]:
    """The layers' leaves (of their entries ``keys``, else all) under
    ``prefix``, stacked on a leading axis, (groups, L / groups) when
    ``groups`` is set."""
    per_layer = [_flatten({k: v for k, v in lp.items()
                           if keys is None or k in keys}, prefix)
                 for lp in layers]
    out = {}
    for key in per_layer[0]:
        src = [layer[key].detach().cpu() for layer in per_layer]
        t = torch.stack([qcore.raw(x) for x in src])
        if src[0].dtype == qcore.FP8:
            t = t.view(qcore.FP8)
        if groups:
            t = t.reshape((groups, -1) + tuple(t.shape[1:]))
        out[key] = t
    return out


def _layer_groups(params: Dict, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The stacked layer leaves of a checkpoint: ``layers.*`` (L, ...), or
    RecurrentGemma's pattern groups (models/recurrentgemma.py: each
    layer's ``per_pos`` entries under ``per_pos.*`` (G, 3, ...), its
    attention's under ``att.*`` (G, 1, ...), its recurrent block's under
    ``rec.*`` (G, 2, ...))."""
    layers = params["layers"]
    if cfg.arch != "recurrentgemma":
        return _stacked(layers, "layers.")
    from ..models import recurrentgemma as rg
    g = cfg.num_layers // len(rg.RG_PATTERN)
    kinds = [rg.sublayer(li)[0] for li in range(len(layers))]
    out = _stacked(layers, "per_pos.", rg.PER_POS_MODS, g)
    for grp, kind, mods in (("att", "attention", rg.ATT_MODS),
                            ("rec", "recurrent", rg.REC_MODS)):
        out.update(_stacked([lp for lp, k in zip(layers, kinds)
                             if k == kind], grp + ".", mods, g))
    return out


def save_checkpoint(path: str, params: Dict, cfg: ModelConfig) -> None:
    """Port params (``layers`` a list of per-layer dicts) -> a checkpoint
    directory the JAX package's load_checkpoint reads, layers stacked."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_NAME), "w") as f:
        json.dump(cfg.to_dict(), f, indent=2)
    def name_of(key: str, t: torch.Tensor) -> str:
        return key + FP8_SUFFIX if t.dtype == qcore.FP8 else key

    flat = {}
    for name, sub in params.items():
        if name == "layers":
            for key, t in _layer_groups(params, cfg).items():
                flat[name_of(key, t)] = qcore.raw(t)
        else:
            for key, t in _flatten(sub, name + ".").items():
                flat[name_of(key, t)] = qcore.raw(t)
    write_safetensors(os.path.join(path, WEIGHTS_NAME), flat)


def _flatten(tree: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    """A nested dict's leaves under their dotted names (an expert layer's
    ``moe.gate_up.qweight`` one level deeper than a linear's)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out
