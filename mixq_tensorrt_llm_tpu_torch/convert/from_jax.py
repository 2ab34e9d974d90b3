"""Load the JAX package's params pytree into the port.

``params_from_numpy`` takes the pytree of mixq_tensorrt_llm_tpu (any
dense decoder family, expert model or recurrent-state model) as numpy
arrays — ``jax.tree.map(np.asarray, params)``, layers stacked on axis 0
(RecurrentGemma's in its three pattern groups ``per_pos`` (G, 3, ...),
``att`` (G, 1, ...) and ``rec`` (G, 2, ...)) — checks every leaf's dtype
and shape against the params schema the config implies, and returns the
port's params: the same dicts, with ``layers`` a list of per-layer dicts
of torch tensors on ``device`` (a RecurrentGemma layer holds its group
entries side by side: models/recurrentgemma.py). bfloat16 leaves arrive as ml_dtypes arrays and are converted
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


def _stack_schema(algo: QuantAlgo, e: int, n_in: int, n_out: int,
                  group_size: int) -> Dict[str, tuple]:
    """An expert stack (models/moe.quantize_expert_linear): float ``w``,
    else an int8-held ``qweight`` (E, in, out) with ``scale_g`` under
    W4A16_G or ``scale_col`` (E, out)."""
    if algo == QuantAlgo.NONE:
        return {"w": (torch.bfloat16, (e, n_in, n_out))}
    s = {"qweight": (torch.int8, (e, n_in, n_out))}
    if algo == QuantAlgo.W4A16_G:
        s["scale_g"] = (torch.float32, (e, n_in // group_size, n_out))
    else:
        s["scale_col"] = (torch.float32, (e, n_out))
    return s


def moe_schema(cfg: ModelConfig, packed=(), biases=()) -> Dict[str, Dict]:
    """One layer's ``moe`` entry: the router (bf16 (H, E)), the gate_up and
    down expert stacks and, with a shared expert, its two linears under
    the experts' algo (``packed`` / ``biases`` name those of them stored
    packed / with a bias) and its gate (f32 (H, 1))."""
    from ..models.moe import expert_algo
    algo, gs = expert_algo(cfg), cfg.quant.group_size
    h, e = cfg.hidden_size, cfg.num_experts
    mi = cfg.moe_intermediate or cfg.intermediate_size
    out = {"router": {"w": (torch.bfloat16, (h, e))},
           "gate_up": _stack_schema(algo, e, h, 2 * mi, gs),
           "down": _stack_schema(algo, e, mi, h, gs)}
    si = cfg.moe_shared_intermediate
    if si:
        for name, dims in (("shared_gate_up", (h, 2 * si)),
                           ("shared_down", (si, h))):
            out[name] = _linear_schema(algo, *dims, 0, name in biases,
                                       gs, packed=name in packed)
        out["shared_gate"] = {"w": (torch.float32, (h, 1))}
    return out


def layer_schema(cfg: ModelConfig, packed=(),
                 biases=()) -> Dict[str, Dict[str, tuple]]:
    """{module: {leaf: (dtype, shape)}} for one decoder layer (an expert
    layer's ``moe`` entry one level deeper: ``moe_schema``); the modules
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
    mods = ("qkv_proj", "o_proj") if cfg.num_experts else LINEAR_MODULES
    out = {mod: _linear_schema(cfg.module_algo(mod), *dims[mod], k,
                               bias=has_bias[mod] or mod in biases,
                               group_size=cfg.quant.group_size,
                               packed=mod in packed)
           for mod in mods}
    if cfg.num_experts:
        out["moe"] = moe_schema(cfg, packed, biases)
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


def mamba_layer_schema(cfg: ModelConfig, packed=(), biases=(),
                       conv_bias: bool = True) -> Dict[str, Dict]:
    """One Mamba layer (models/mamba.py): in_proj / out_proj under the
    gate_up / o_proj algos, x_proj bf16, the rest f32; ``conv_bias``: the
    layer has ``conv_b`` (HF's conv1d bias; random params always do)."""
    h, i, n, k = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.ssm_state_size, cfg.quant.num_outliers)
    gs = cfg.quant.group_size
    f32 = torch.float32
    out = {"norm": {"w": (f32, (h,))},
           "conv_w": (f32, (cfg.conv_kernel, i)),
           "x_proj": {"w": (torch.bfloat16, (i, cfg.dt_rank + 2 * n))},
           "dt_proj": {"w": (f32, (cfg.dt_rank, i)), "b": (f32, (i,))},
           "A_log": (f32, (i, n)), "D": (f32, (i,))}
    for mod, route, dims in (("in_proj", "gate_up_proj", (h, 2 * i)),
                             ("out_proj", "o_proj", (i, h))):
        out[mod] = _linear_schema(cfg.module_algo(route), *dims, k,
                                  bias=cfg.mlp_bias or mod in biases,
                                  group_size=gs, packed=mod in packed)
    if conv_bias:
        out["conv_b"] = (f32, (i,))
    return out


def rg_group_schemas(cfg: ModelConfig, packed=(),
                     biases=()) -> Dict[str, Dict]:
    """RecurrentGemma's three groups (models/recurrentgemma.py), each
    {module: schema} of one sub-layer: ``per_pos`` (the block norms and
    the MLP, every layer), ``att`` (qkv, o), ``rec`` (the recurrent
    block: x / y / out projections, conv, RG-LRU gates)."""
    h, inter, lru = cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size
    k, gs, f32 = cfg.quant.num_outliers, cfg.quant.group_size, torch.float32
    nh = cfg.num_heads
    bw = lru // nh

    def lin(mod, route, n_in, n_out, bias):
        return _linear_schema(cfg.module_algo(route), n_in, n_out, k,
                              bias=bias or mod in biases, group_size=gs,
                              packed=mod in packed)
    return {
        "per_pos": {"temporal_norm": {"w": (f32, (h,))},
                    "channel_norm": {"w": (f32, (h,))},
                    "gate_up_proj": lin("gate_up_proj", "gate_up_proj", h,
                                        2 * inter, True),
                    "down_proj": lin("down_proj", "down_proj", inter, h,
                                     True)},
        "att": {"qkv_proj": lin("qkv_proj", "qkv_proj", h, cfg.qkv_out,
                                cfg.qkv_bias),
                "o_proj": lin("o_proj", "o_proj", cfg.q_size, h, True)},
        "rec": {"linear_y": lin("linear_y", "gate_up_proj", h, lru, True),
                "linear_x": lin("linear_x", "gate_up_proj", h, lru, True),
                "linear_out": lin("linear_out", "o_proj", lru, h, True),
                "conv_w": (f32, (cfg.conv_kernel, lru)),
                "conv_b": (f32, (lru,)),
                "recurrent_param": (f32, (lru,)),
                "input_gate_w": (f32, (nh, bw, bw)),
                "input_gate_b": (f32, (nh, bw)),
                "recurrent_gate_w": (f32, (nh, bw, bw)),
                "recurrent_gate_b": (f32, (nh, bw))},
    }


def _packed(tree: Dict) -> list:
    """The entries of a params (sub)tree that hold a packed int4 weight."""
    return [m for m, sub in tree.items()
            if isinstance(sub, dict) and "qweight_packed" in sub]


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
    groups = (("per_pos", "att", "rec") if cfg.arch == "recurrentgemma"
              else ("layers",))
    top = top_schema(cfg, biases=_with_bias(tree))
    _check_keys(set(tree) - set(groups), top, "params")
    params: Dict = {
        name: {leaf: _convert(tree[name][leaf], dt, shape,
                              f"{name}.{leaf}", dev)
               for leaf, (dt, shape) in sub.items()}
        for name, sub in top.items()}
    for name, sub in top.items():
        _check_keys(tree[name], sub, name)
    if cfg.arch == "recurrentgemma":
        params["layers"] = _rg_layers(tree, cfg, dev)
        return params
    stacked = tree["layers"]
    if cfg.arch == "mamba":
        schema = mamba_layer_schema(cfg, packed=_packed(stacked),
                                    biases=_with_bias(stacked),
                                    conv_bias="conv_b" in stacked)
        _check_tree(stacked, schema, "layers")
        params["layers"] = [_layer(stacked, schema, i, cfg.num_layers, dev,
                                   f"layers.{i}")
                            for i in range(cfg.num_layers)]
        return params
    moe = stacked.get("moe", {})
    entries = {**stacked, **moe}
    schema = layer_schema(cfg, packed=_packed(entries),
                          biases=_with_bias(stacked) | _with_bias(moe))
    _check_tree(stacked, schema, "layers")
    params["layers"] = [_layer(stacked, schema, i, cfg.num_layers, dev,
                               f"layers.{i}")
                        for i in range(cfg.num_layers)]
    return params


def _check_tree(tree: Dict, schema: Dict, where: str) -> None:
    _check_keys(tree, schema, where)
    for name, sub in schema.items():
        if isinstance(sub, dict):
            _check_tree(tree[name], sub, f"{where}.{name}")


def _layer(stacked: Dict, schema: Dict, i: int, num_layers: int,
           dev: torch.device, where: str) -> Dict:
    """Layer i of a stacked (sub)tree, by the schema's nesting."""
    out = {}
    for name, sub in schema.items():
        if isinstance(sub, dict):
            out[name] = _layer(stacked[name], sub, i, num_layers, dev,
                               f"{where}.{name}")
            continue
        arr = _leaf(stacked[name])
        if arr.shape[0] != num_layers:
            raise ValueError(f"{where}.{name}: {arr.shape[0]} layers "
                             f"stacked, config has {num_layers}")
        out[name] = _convert(arr[i], *sub, f"{where}.{name}", dev)
    return out


def _rg_layers(tree: Dict, cfg: ModelConfig, dev: torch.device) -> list:
    """RecurrentGemma's groups (each leaf (G, n, ...)) -> the port's list
    of per-layer dicts, each layer its ``per_pos`` entries and those of
    its attention or recurrent sub-layer."""
    from ..models.recurrentgemma import sublayer
    g = cfg.num_layers // 3
    entries = {**tree["per_pos"], **tree["att"], **tree["rec"]}
    schemas = rg_group_schemas(cfg, packed=_packed(entries),
                               biases=_with_bias(entries))
    flat = {}
    for grp, n in (("per_pos", 3), ("att", 1), ("rec", 2)):
        _check_tree(tree[grp], schemas[grp], grp)
        flat[grp] = _ungroup(tree[grp], g, n, grp)
    layers = []
    for li in range(cfg.num_layers):
        kind, gi, j = sublayer(li)
        lp = _layer(flat["per_pos"], schemas["per_pos"], li,
                    cfg.num_layers, dev, f"per_pos.{li}")
        grp, n = ("att", 1) if kind == "attention" else ("rec", 2)
        lp.update(_layer(flat[grp], schemas[grp], gi * n + j, g * n, dev,
                         f"{grp}.{gi * n + j}"))
        layers.append(lp)
    return layers


def _ungroup(tree: Dict, g: int, n: int, where: str) -> Dict:
    """A group's leaves (G, n, ...) -> (G * n, ...), sub-layers in layer
    order."""
    out = {}
    for name, sub in tree.items():
        if isinstance(sub, dict):
            out[name] = _ungroup(sub, g, n, f"{where}.{name}")
            continue
        arr = _leaf(sub)
        if tuple(arr.shape[:2]) != (g, n):
            raise ValueError(f"{where}.{name}: groups {list(arr.shape[:2])},"
                             f" config has {[g, n]}")
        out[name] = arr.reshape((g * n,) + tuple(arr.shape[2:]))
    return out
