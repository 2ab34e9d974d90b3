"""RecurrentGemma (Griffin): RG-LRU recurrent blocks and windowed
attention. Counterpart of mixq_tensorrt_llm_tpu/models/recurrentgemma.py.

  * Layers follow the repeating block pattern (recurrent, recurrent,
    attention). Params are a list of per-layer dicts, each with its block
    norms and MLP and either the recurrent block's weights or the
    attention's; the JAX package stacks them in three groups (``per_pos``
    (G, 3, ...), ``att`` (G, 1, ...), ``rec`` (G, 2, ...), G = layers / 3),
    which is the checkpoint layout (convert/checkpoint.py,
    convert/from_jax.py map between the two).
  * The RG-LRU recurrence h_t = a_t h_{t-1} + sqrt(1 - a_t^2) i_t x_t is
    an elementwise linear recurrence: prefill runs it as the blocked scan
    of models/mamba.linear_scan, decode is one fused update. The input and
    recurrence gates are per-head block-diagonal linears (one einsum each).
  * Attention sub-layers take the dense path
    (models.common._attention_with_cache) with the model-wide sliding
    window and partial rotary embedding: a full prefill of 128 tokens or
    more goes through K8 over a page view (ops.attention), decode through
    the masked attention over the dense cache. The window masks prefill
    too, as in the JAX package (HF prefill attends fully causally and
    enforces the window only in its rolling decode cache).

State is an ``RGState`` in the dense cache's place, updated in place.
qkv / o / gate_up and the recurrent x / y / out projections take the
standard mix routing (K1 -> K2), down its weight-only algo (K4 under
int8_mix); the gates stay f32.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import dispatch
from ..quant.config import QuantConfig
from .common import ModelConfig
from .mamba import causal_conv, linear_scan


class RGState(NamedTuple):
    """Per-pattern-group recurrent and attention state (the JAX package's
    layout), updated in place.

    k/v:  (G, A, B, S, Hkv, D) windowed-attention KV in the model dtype
          (A = attention sub-layers per pattern period, G = layers / 3)
    conv: (G, R, B, K-1, lru) conv carries (R = recurrent sub-layers)
    lru:  (G, R, B, lru) f32 RG-LRU states
    """
    k: torch.Tensor
    v: torch.Tensor
    conv: torch.Tensor
    lru: torch.Tensor


RG_PATTERN = ("recurrent", "recurrent", "attention")
# the modules of each checkpoint group (JAX convert/checkpoint.py's
# required names are a subset)
PER_POS_MODS = ("temporal_norm", "channel_norm", "gate_up_proj",
                "down_proj")
ATT_MODS = ("qkv_proj", "o_proj")
REC_MODS = ("linear_y", "linear_x", "linear_out", "conv_w", "conv_b",
            "recurrent_param", "input_gate_w", "input_gate_b",
            "recurrent_gate_w", "recurrent_gate_b")


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()
                   ) -> ModelConfig:
    """HF RecurrentGemmaConfig -> ModelConfig, read as the JAX package
    reads it; its refusals kept: another block pattern, a depth that is
    not a multiple of the pattern, lru_width != hidden_size."""
    def g(name, d=None):
        return getattr(hf_config, name, d)
    pattern = tuple(g("block_types") or RG_PATTERN)
    if pattern != RG_PATTERN:
        raise ValueError(f"recurrentgemma: only the ({','.join(RG_PATTERN)})"
                         f" block pattern is supported, not {pattern}")
    if hf_config.num_hidden_layers % len(pattern):
        raise ValueError(
            f"recurrentgemma: num_layers ({hf_config.num_hidden_layers}) "
            "must be a multiple of the block pattern period (3)")
    if g("lru_width") not in (None, hf_config.hidden_size):
        raise ValueError("recurrentgemma: lru_width != hidden_size is "
                         "unsupported")
    head_dim = g("head_dim") or (hf_config.hidden_size
                                 // hf_config.num_attention_heads)
    return ModelConfig(
        arch="recurrentgemma", vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=hf_config.intermediate_size // 2,  # HF halves it
        num_layers=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        num_kv_heads=g("num_key_value_heads")
        or hf_config.num_attention_heads,
        head_dim=head_dim,
        max_position_embeddings=g("max_position_embeddings", 8192),
        rope_theta=g("rope_theta", 10000.0),
        rms_norm_eps=g("rms_norm_eps", 1e-6),
        rotary_dim=int(head_dim * g("partial_rotary_factor", 0.5)),
        sliding_window=g("attention_window_size", 2048),
        hidden_act=g("hidden_activation", "gelu_tanh"),
        qkv_bias=bool(g("attention_bias", False)),
        attn_out_bias=True,                      # o_proj bias is always on
        mlp_bias=True,
        embed_scale=float(hf_config.hidden_size) ** 0.5,
        final_logit_softcap=g("logits_soft_cap", 30.0),
        conv_kernel=g("conv1d_width", 4),
        tie_word_embeddings=True, quant=quant)


def _counts() -> Tuple[int, int]:
    a = sum(1 for t in RG_PATTERN if t == "attention")
    return len(RG_PATTERN) - a, a           # (recurrent, attention)


def sublayer(li: int) -> Tuple[str, int, int]:
    """Layer li -> (its kind, its pattern group, its index among the
    group's sub-layers of that kind)."""
    g, j = divmod(li, len(RG_PATTERN))
    kind = RG_PATTERN[j]
    return kind, g, sum(1 for t in RG_PATTERN[:j] if t == kind)


def init_state(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = "cuda") -> RGState:
    """Zero state; the attention KV in the model dtype whatever the KV
    cache config says, as in the JAX package."""
    dev = resolve_device(device)
    g = cfg.num_layers // len(RG_PATTERN)
    r, a = _counts()
    lru = cfg.hidden_size
    kv = (g, a, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return RGState(
        k=torch.zeros(kv, dtype=cfg.dtype, device=dev),
        v=torch.zeros(kv, dtype=cfg.dtype, device=dev),
        conv=torch.zeros((g, r, batch, cfg.conv_kernel - 1, lru),
                         dtype=cfg.dtype, device=dev),
        lru=torch.zeros((g, r, batch, lru), dtype=torch.float32,
                        device=dev))


def _block_gate(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Per-head block-diagonal linear: x (B, S, lru), w (nh, bw, bw), b
    (nh, bw) -> sigmoid(x_h @ w_h + b_h) flattened back to (B, S, lru)."""
    bsz, s, lru = x.shape
    nh, bw, _ = w.shape
    xh = x.reshape(bsz, s, nh, bw)
    y = torch.einsum("bshi,hio->bsho", xh, w.float()) + b.float()
    return torch.sigmoid(y).reshape(bsz, s, lru)


def _rg_lru(lp: Dict, x: torch.Tensor, state: torch.Tensor,
            pos: torch.Tensor, mask: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RG-LRU over x (B, S, lru) f32 from ``state`` (B, lru) f32. pos
    (B, S) absolute positions (the state resets at 0: a = 0, multiplier 1);
    mask (B, S) valid tokens (pads are identity updates). Returns (hidden
    (B, S, lru), new state)."""
    igate = _block_gate(x, lp["input_gate_w"], lp["input_gate_b"])
    rgate = _block_gate(x, lp["recurrent_gate_w"], lp["recurrent_gate_b"])
    log_a = -8.0 * rgate * torch.nn.functional.softplus(
        lp["recurrent_param"].float())
    a = torch.exp(log_a)
    reset = (pos == 0)[..., None]
    a = torch.where(reset, 0.0, a)
    mult = torch.where(reset, 1.0, torch.sqrt(torch.clamp(
        1.0 - torch.exp(2 * log_a), min=1e-12)))
    b = x * igate * mult
    valid = mask[..., None]
    a = torch.where(valid, a, 1.0)               # pads: h passes through
    b = torch.where(valid, b, 0.0)
    if x.shape[1] == 1:
        h = a[:, 0] * state + b[:, 0]
        return h[:, None], h
    hs = linear_scan(a, b, state)
    return hs, hs[:, -1]


def _recurrent_block(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                     conv_state: torch.Tensor, lru_state: torch.Tensor,
                     pos: torch.Tensor, mask: torch.Tensor,
                     local_valid: torch.Tensor):
    """HF RecurrentGemmaRecurrentBlock: y = act(linear_y); x' = conv1d
    (linear_x); rg_lru; out = linear_out(lru_out * y). Returns (out, new
    conv carry, new LRU state)."""
    from .common import _act
    algo_g = cfg.module_algo("gate_up_proj")
    y = _act(cfg.hidden_act, dispatch.linear(lp["linear_y"], x, algo_g))
    xb = dispatch.linear(lp["linear_x"], x, algo_g)
    xb = torch.where(mask[..., None], xb, 0.0).to(cfg.dtype)
    h, new_conv = causal_conv(cfg, conv_state, xb, lp["conv_w"],
                              lp["conv_b"], local_valid)
    lru_out, new_lru = _rg_lru(lp, h, lru_state, pos, mask)
    out = dispatch.linear(lp["linear_out"], (lru_out * y).to(cfg.dtype),
                          cfg.module_algo("o_proj"))
    return out, new_conv.to(cfg.dtype), new_lru


def _attention_block(cfg: ModelConfig, lp: Dict, x: torch.Tensor, sin,
                     cos, layer_cache: dict, write_pos, valid_len,
                     full_prefill: bool) -> torch.Tensor:
    """qkv -> partial RoPE -> attention over the layer's dense KV (written
    in place) under the model-wide window -> o_proj."""
    from . import common as mcommon
    b, s, _ = x.shape
    qkv = dispatch.linear(lp["qkv_proj"], x, cfg.module_algo("qkv_proj"))
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size],
                          dim=-1)
    q = mcommon._apply_positional(
        cfg, q.reshape(b, s, cfg.num_heads, cfg.head_dim), sin, cos)
    k = mcommon._apply_positional(
        cfg, k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), sin, cos)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    attn = mcommon._attention_with_cache(
        cfg, q, k, v, layer_cache, write_pos, valid_len,
        full_prefill=full_prefill, window=cfg.sliding_window)
    return dispatch.linear(lp["o_proj"], attn.reshape(b, s, cfg.q_size),
                           cfg.module_algo("o_proj"))


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            write_pos: torch.Tensor, cache: RGState,
            valid_len: torch.Tensor, full_prefill: bool = False,
            last_pos=None) -> Tuple[torch.Tensor, RGState]:
    """Full RecurrentGemma forward with models.common.forward's signature:
    the state ``cache`` updated IN PLACE; last_pos: optional (B,) index,
    the head then runs on that one position per lane. Returns (logits
    f32, cache)."""
    from . import common as mcommon
    s = tokens.shape[1]
    x = mcommon._embed(params, cfg, tokens, write_pos)
    sin, cos, _ = mcommon._positional_arrays(cfg, write_pos)
    local_valid = valid_len.long() - write_pos[:, 0].long()
    mask = (torch.arange(s, device=x.device)[None, :]
            < local_valid[:, None])
    for li, lp in enumerate(params["layers"]):
        kind, g, j = sublayer(li)
        x_n = mcommon.block_norm(cfg, x, lp["temporal_norm"])
        if kind == "attention":
            out = _attention_block(
                cfg, lp, x_n, sin, cos,
                {"k": cache.k[g, j], "v": cache.v[g, j]}, write_pos,
                valid_len, full_prefill)
        else:
            out, conv, lru = _recurrent_block(
                cfg, lp, x_n, cache.conv[g, j], cache.lru[g, j], write_pos,
                mask, local_valid)
            cache.conv[g, j].copy_(conv)
            cache.lru[g, j].copy_(lru)
        x = x + out.to(x.dtype)
        h = mcommon.block_norm(cfg, x, lp["channel_norm"])
        up = dispatch.linear(lp["gate_up_proj"], h,
                             cfg.module_algo("gate_up_proj"))
        gate, upv = torch.chunk(up, 2, dim=-1)
        hmlp = (mcommon._act(cfg.hidden_act, gate)
                * upv.float()).to(x.dtype)
        x = x + dispatch.linear(lp["down_proj"], hmlp,
                                cfg.module_algo("down_proj")).to(x.dtype)
    logits = mcommon._head(params, cfg, mcommon._last(x, last_pos))
    return logits.float(), cache


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _q(cfg: ModelConfig, w: torch.Tensor, b: Optional[torch.Tensor],
       route: str, act_scales, i: int) -> Dict:
    from .llama import act_scale_for
    algo = cfg.module_algo(route)
    scale = (act_scale_for(act_scales, i, route, w.shape[0], w.device)
             if algo.is_mix else None)
    return dispatch.quantize_linear_params(
        w.float(), algo, act_scale=scale,
        num_outliers=cfg.quant.num_outliers,
        group_size=cfg.quant.group_size,
        bias=None if b is None else b.float())


def _layer_params(cfg: ModelConfig, fl: Dict, act_scales, i: int) -> Dict:
    """One layer's float weights ({module: (w (in, out), bias)} for the
    linears, f32 tensors for the rest) -> its params."""
    routes = {"gate_up_proj": "gate_up_proj", "down_proj": "down_proj",
              "qkv_proj": "qkv_proj", "o_proj": "o_proj",
              "linear_y": "gate_up_proj", "linear_x": "gate_up_proj",
              "linear_out": "o_proj"}
    return {k: (_q(cfg, *v, routes[k], act_scales, i) if k in routes
                else v) for k, v in fl.items()}


def params_from_hf(cfg: ModelConfig, hf: Mapping[str, torch.Tensor],
                   act_scales=None, device: DeviceLike = "cuda") -> Dict:
    """HF RecurrentGemmaForCausalLM state dict (tensors as stored,
    (out, in)) -> params on ``device``, one layer at a time. Every
    RecurrentGemmaRMSNorm computes x * (1 + w): the +1 is folded in."""
    dev = resolve_device(device)

    def t(name):
        return hf[name].to(dev).float()

    def lin(base):
        b = base + ".bias"
        return t(base + ".weight").t().contiguous(), (t(b) if b in hf
                                                      else None)

    layers = []
    for i in range(cfg.num_layers):
        pre = f"model.layers.{i}."
        tb = pre + "temporal_block."
        (gw, gb), (uw, ub) = (lin(pre + "mlp_block.gate_proj"),
                              lin(pre + "mlp_block.up_proj"))
        fl = {
            "temporal_norm": {"w": t(pre + "temporal_pre_norm.weight")
                              + 1.0},
            "channel_norm": {"w": t(pre + "channel_pre_norm.weight") + 1.0},
            "gate_up_proj": (torch.cat([gw, uw], dim=1),
                             torch.cat([gb, ub])),
            "down_proj": lin(pre + "mlp_block.down_proj"),
        }
        if sublayer(i)[0] == "attention":
            parts = [lin(tb + f"{n}_proj") for n in "qkv"]
            fl["qkv_proj"] = (torch.cat([w for w, _ in parts], dim=1),
                              None if parts[0][1] is None else
                              torch.cat([b for _, b in parts]))
            fl["o_proj"] = lin(tb + "o_proj")
        else:
            fl.update(
                linear_y=lin(tb + "linear_y"),
                linear_x=lin(tb + "linear_x"),
                linear_out=lin(tb + "linear_out"),
                # HF conv1d weight (lru, 1, K): tap K-1 = current token
                conv_w=t(tb + "conv_1d.weight")[:, 0, :].t().contiguous(),
                conv_b=t(tb + "conv_1d.bias"),
                recurrent_param=t(tb + "rg_lru.recurrent_param"),
                input_gate_w=t(tb + "rg_lru.input_gate_weight"),
                input_gate_b=t(tb + "rg_lru.input_gate_bias"),
                recurrent_gate_w=t(tb + "rg_lru.recurrent_gate_weight"),
                recurrent_gate_b=t(tb + "rg_lru.recurrent_gate_bias"))
        layers.append(_layer_params(cfg, fl, act_scales, i))
        del fl
    return {
        "embed": {"w": hf["model.embed_tokens.weight"].to(dev)
                  .to(cfg.dtype)},
        "layers": layers,
        "final_norm": {"w": t("model.final_norm.weight") + 1.0},
    }


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device: DeviceLike = "cuda", act_scales=None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """Random-weight params with the JAX package's init (N(0, 0.02)
    linears, conv and gates, zero biases, recurrent_param ones, norms
    ones), quantized with the production routing, one layer at a time.
    Drawn from ``generator`` (else one seeded with ``seed`` on the
    device); the draws differ from the JAX package's."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    h, inter, lru = cfg.hidden_size, cfg.intermediate_size, cfg.hidden_size
    nh = cfg.num_heads
    bw = lru // nh

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    layers = []
    for i in range(cfg.num_layers):
        fl = {"temporal_norm": {"w": torch.ones(h, device=dev)},
              "channel_norm": {"w": torch.ones(h, device=dev)},
              "gate_up_proj": (rnd(h, 2 * inter), zeros(2 * inter)),
              "down_proj": (rnd(inter, h), zeros(h))}
        if sublayer(i)[0] == "attention":
            fl["qkv_proj"] = (rnd(h, cfg.qkv_out), zeros(cfg.qkv_out)
                              if cfg.qkv_bias else None)
            fl["o_proj"] = (rnd(cfg.q_size, h), zeros(h))
        else:
            fl.update(linear_y=(rnd(h, lru), zeros(lru)),
                      linear_x=(rnd(h, lru), zeros(lru)),
                      linear_out=(rnd(lru, h), zeros(h)),
                      conv_w=rnd(cfg.conv_kernel, lru), conv_b=zeros(lru),
                      recurrent_param=torch.ones(lru, device=dev),
                      input_gate_w=rnd(nh, bw, bw),
                      input_gate_b=zeros(nh, bw),
                      recurrent_gate_w=rnd(nh, bw, bw),
                      recurrent_gate_b=zeros(nh, bw))
        layers.append(_layer_params(cfg, fl, act_scales, i))
        del fl
    return {"embed": {"w": rnd(cfg.vocab_size, h).to(cfg.dtype)},
            "layers": layers,
            "final_norm": {"w": torch.ones(h, device=dev)}}
