"""Load the JAX package's params pytree into the port.

``params_from_numpy`` takes the pytree of mixq_tensorrt_llm_tpu (any
dense decoder family) as numpy arrays — ``jax.tree.map(np.asarray,
params)``, layers stacked on axis 0 — checks every leaf's dtype and shape against the
params schema the config implies, and returns the port's params: the same
dicts, with ``layers`` a list of per-layer dicts of torch tensors on
``device``. bfloat16 leaves arrive as ml_dtypes arrays and are converted
exactly through float32, float8_e4m3fn leaves (ml_dtypes) through their
bytes. Leaves may also be torch tensors of the schema's
dtypes, as ``convert.checkpoint.load_checkpoint`` reads them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models.common import ModelConfig
from ..models.llama import LINEAR_MODULES
from ..quant import core as qcore
from ..quant.config import QuantAlgo

_NP_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
             torch.int8: "int8", torch.int32: "int32",
             torch.float16: "float16", qcore.FP8: "float8_e4m3fn"}


def _linear_schema(algo: QuantAlgo, n_in: int, n_out: int, k: int,
                   bias: bool, group_size: int = 128, packed: bool = False
                   ) -> Dict[str, Tuple[torch.dtype, tuple]]:
    """{leaf: (dtype, shape)}; ``packed``: the int4 weight is stored two a
    byte as ``qweight_packed`` (in/2, out) instead of ``qweight``."""
    if algo == QuantAlgo.NONE:
        s = {"w": (torch.bfloat16, (n_in, n_out))}
    elif algo.is_fp8:
        s = {"qweight": (qcore.FP8, (n_in, n_out)),
             "scale_col": (torch.float32, (n_out,))}
    elif algo.is_lr:
        r = min(qcore.LR_RANK, n_in, n_out)
        s = {"qweight": (torch.int8, (n_in, n_out)),
             "scale_col": (torch.float32, (n_out,)),
             "lr_u": (torch.bfloat16, (n_in, r)),
             "lr_v": (torch.bfloat16, (r, n_out))}
    elif algo in (QuantAlgo.W8A16, QuantAlgo.W4A16, QuantAlgo.W4A16_G) \
            or algo.is_mix:
        s = {"qweight": (torch.int8, (n_in, n_out))}
        if packed and algo.weight_bits == 4:
            s = {"qweight_packed": (torch.int8, (n_in // 2, n_out))}
        if algo == QuantAlgo.W4A16_G:
            s["scale_g"] = (torch.float32, (n_in // group_size, n_out))
        else:
            s["scale_col"] = (torch.float32, (n_out,))
        if algo.is_mix:
            s["fp_ind"] = (torch.int32, (min(k, n_in),))
            s["fp_weight"] = (torch.bfloat16, (min(k, n_in), n_out))
    else:
        raise ValueError(f"unknown quant algo {algo}")
    if bias:
        s["b"] = (torch.bfloat16, (n_out,))
    return s


def layer_norms(cfg: ModelConfig) -> Dict[str, int]:
    """{norm: width} of one decoder layer under the config's norm axes."""
    h = cfg.hidden_size
    out = {}
    if cfg.pre_block_norms:
        out["input_norm"] = h
        if not cfg.shared_block_norm:
            out["post_norm"] = h
    if cfg.post_block_norms:
        out["post_attn_norm"] = out["post_mlp_norm"] = h
    if cfg.qk_norm:
        flat = cfg.qk_norm_flat
        out["q_norm"] = cfg.q_size if flat else cfg.head_dim
        out["k_norm"] = cfg.kv_size if flat else cfg.head_dim
    return out


def layer_schema(cfg: ModelConfig, packed=(),
                 biases=()) -> Dict[str, Dict[str, tuple]]:
    """{module: {leaf: (dtype, shape)}} for one decoder layer; the modules
    named in ``packed`` hold their int4 weight as ``qweight_packed``.
    Linear biases follow the config's bias axes; a norm or linear named in
    ``biases`` carries a bias ``b`` as well (a LayerNorm's bias is the HF
    checkpoint's: MPT's and Cohere's norms have none)."""
    h, k = cfg.hidden_size, cfg.quant.num_outliers
    up = (2 if cfg.mlp_type == "gated" else 1) * cfg.intermediate_size
    dims = {"qkv_proj": (h, cfg.qkv_out), "o_proj": (cfg.q_size, h),
            "gate_up_proj": (h, up),
            "down_proj": (cfg.intermediate_size, h)}
    has_bias = {"qkv_proj": cfg.qkv_bias, "o_proj": cfg.attn_out_bias,
                "gate_up_proj": cfg.mlp_bias, "down_proj": cfg.mlp_bias}
    out = {mod: _linear_schema(cfg.module_algo(mod), *dims[mod], k,
                               bias=has_bias[mod] or mod in biases,
                               group_size=cfg.quant.group_size,
                               packed=mod in packed)
           for mod in LINEAR_MODULES}
    for name, n in layer_norms(cfg).items():
        out[name] = {"w": (torch.float32, (n,))}
        if name in biases:
            out[name]["b"] = (torch.float32, (n,))
    return out


def top_schema(cfg: ModelConfig, biases=()) -> Dict[str, Dict[str, tuple]]:
    """The params outside the layers; ``biases`` names the norms that carry
    a bias (and ``lm_head``, whose bias the config's lm_head_bias also
    implies)."""
    h, v = cfg.hidden_size, cfg.vocab_size
    out = {"embed": {"w": (cfg.dtype, (v, h))},
           "final_norm": {"w": (torch.float32, (h,))}}
    if cfg.pos_embedding == "learned":
        out["pos_embed"] = {"w": (cfg.dtype, (
            cfg.max_position_embeddings + cfg.learned_pos_offset, h))}
    if cfg.embed_norm:
        out["embed_norm"] = {"w": (torch.float32, (h,))}
    for name in ("final_norm", "embed_norm"):
        if name in out and name in biases:
            out[name]["b"] = (torch.float32, (h,))
    if not cfg.tie_word_embeddings:
        out["lm_head"] = {"w": (cfg.dtype, (h, v))}
        if cfg.lm_head_bias or "lm_head" in biases:
            out["lm_head"]["b"] = (torch.bfloat16, (v,))
    return out


def _with_bias(tree: Dict) -> set:
    """The entries of a params (sub)tree that carry a bias leaf ``b``."""
    return {name for name, sub in tree.items()
            if isinstance(sub, dict) and "b" in sub}


def _leaf(arr):
    """A torch tensor as it is; anything else as a numpy array."""
    return arr if isinstance(arr, torch.Tensor) else np.asarray(arr)


def _convert(arr, dtype: torch.dtype, shape: tuple, where: str,
             device: torch.device) -> torch.Tensor:
    arr = _leaf(arr)
    got = (_NP_NAMES.get(arr.dtype, str(arr.dtype))
           if isinstance(arr, torch.Tensor) else arr.dtype.name)
    if got != _NP_NAMES[dtype] or tuple(arr.shape) != shape:
        raise ValueError(f"{where}: expected {_NP_NAMES[dtype]}{list(shape)}"
                         f", got {got}{list(arr.shape)}")
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, copy=True)
    if dtype == torch.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    if dtype == qcore.FP8:          # the bytes, reinterpreted
        return torch.from_numpy(np.array(arr).view(np.uint8)).view(
            qcore.FP8).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _check_keys(got, want, where: str) -> None:
    if set(got) != set(want):
        raise ValueError(f"{where}: keys {sorted(got)} do not match the "
                         f"schema {sorted(want)}")


def params_from_numpy(tree: Dict, cfg: ModelConfig,
                      device: DeviceLike = "cuda") -> Dict:
    """JAX params pytree (numpy leaves, layers stacked) -> port params."""
    dev = resolve_device(device)
    top = top_schema(cfg, biases=_with_bias(tree))
    _check_keys(set(tree) - {"layers"}, top, "params")
    params: Dict = {
        name: {leaf: _convert(tree[name][leaf], dt, shape,
                              f"{name}.{leaf}", dev)
               for leaf, (dt, shape) in sub.items()}
        for name, sub in top.items()}
    for name, sub in top.items():
        _check_keys(tree[name], sub, name)
    stacked = tree["layers"]
    schema = layer_schema(cfg, packed=[m for m in LINEAR_MODULES
                                       if "qweight_packed" in
                                       stacked.get(m, {})],
                          biases=_with_bias(stacked))
    _check_keys(stacked, schema, "layers")
    layers = []
    for i in range(cfg.num_layers):
        layer = {}
        for mod, sub in schema.items():
            _check_keys(stacked[mod], sub, f"layers.{mod}")
            layer[mod] = {}
            for leaf, (dt, shape) in sub.items():
                arr = _leaf(stacked[mod][leaf])
                if arr.shape[0] != cfg.num_layers:
                    raise ValueError(f"layers.{mod}.{leaf}: {arr.shape[0]} "
                                     f"layers stacked, config has "
                                     f"{cfg.num_layers}")
                layer[mod][leaf] = _convert(arr[i], dt, shape,
                                            f"layers.{i}.{mod}.{leaf}", dev)
        layers.append(layer)
    params["layers"] = layers
    return params
