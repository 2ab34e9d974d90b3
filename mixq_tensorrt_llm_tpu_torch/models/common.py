"""Model config, RoPE, the dense-cache decoder forward and the paged one
(single device, Llama lineage). Counterpart of
mixq_tensorrt_llm_tpu/models/common.py.

Params are plain dicts of tensors; ``params["layers"]`` is a list of
per-layer dicts (the JAX package stacks them on axis 0 for its layer scan,
here the layers are a Python loop). q/k/v and gate/up are fused GEMMs.

Both KV layouts are updated in place (the JAX package returns new arrays):
the dense ``KVCache`` (``forward``, the GenerationSession's path) stacks
layers on axis 0; the paged pool (``forward_paged``, the Executor's) is
FLAT over layers, as in the JAX package: layer l's block b is page row
``l * num_blocks + b``.
"""

from __future__ import annotations

import dataclasses
import math
import os
from functools import partial
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..quant import core as qcore
from ..quant import dynamic as qdyn
from ..quant.config import KVCacheQuantAlgo, QuantAlgo, QuantConfig
from ..ops import attention as ops_attn
from ..ops import dispatch
from ..ops import ref as ops_ref

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# ModelConfig axes of the JAX package that the port does not honour yet,
# with the value that means "off": a config that sets one raises.
_UNPORTED_AXES = {
    "num_experts": 0, "pos_embedding": "rope", "rotary_dim": 0,
    "rope_interleaved": False, "learned_pos_offset": 0,
    "norm_type": "rmsnorm", "parallel_blocks": False,
    "shared_block_norm": False, "mlp_type": "gated", "attn_out_bias": False,
    "mlp_bias": False, "lm_head_bias": False, "embed_scale": 1.0,
    "embed_norm": False, "final_logit_softcap": 0.0,
    "post_block_norms": False, "qk_norm": False, "sliding_window_pattern": 1,
    "pre_block_norms": True, "qk_norm_flat": False, "logit_scale": 1.0,
    "residual_multiplier": 1.0, "clip_qkv": 0.0, "ssm_state_size": 0,
    "moe_intermediate": 0, "moe_shared_intermediate": 0,
    "rope_freq_factors": (),
}
_PORTED_ARCHS = ("llama", "mistral", "qwen2")
# where the other architectures and their config axes come from
_LATER_MODULES = ("models/families.py, models/moe.py, models/mamba.py or "
                  "models/recurrentgemma.py")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The Llama-path subset of the JAX package's ModelConfig: the same
    field names and defaults (Llama-2-7B), ``dtype`` a torch dtype."""

    arch: str = "llama"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int = 128
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 4096
    qkv_bias: bool = False               # Qwen2
    sliding_window: int = 0              # 0 = full attention (Mistral: 4096)
    tie_word_embeddings: bool = False
    hidden_act: str = "silu"
    attn_scale: float = 0.0              # 0 = 1/sqrt(head_dim)
    attn_logit_softcap: float = 0.0
    rope_scaling_type: str = "none"      # none | linear | llama3
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_pos: int = 8192
    dtype: torch.dtype = torch.bfloat16
    quant: QuantConfig = QuantConfig()

    def __post_init__(self):
        if self.arch not in _PORTED_ARCHS:
            raise NotImplementedError(
                f"arch {self.arch!r} is not ported yet (the port serves the "
                f"Llama lineage: {', '.join(_PORTED_ARCHS)}): it comes with "
                f"{_LATER_MODULES}")
        if self.rope_scaling_type not in ("none", "linear", "llama3"):
            raise NotImplementedError(
                f"rope_scaling_type {self.rope_scaling_type!r} is not ported "
                "yet: it comes with the rest of models/common.py "
                "rope_sin_cos (yarn, longrope)")
        if self.quant.dynamic_outliers and \
                self.quant.algo == QuantAlgo.INT4_MIX:
            # the adaptive path gathers rows of the int8 qweight, which an
            # int4_mix checkpoint packs two a byte (the JAX package fails
            # there with a KeyError)
            raise ValueError("dynamic_outliers with int4_mix is unsupported:"
                             " the adaptive path gathers rows of an unpacked "
                             "qweight")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must be a multiple of num_kv_heads")

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def qkv_out(self) -> int:
        return self.q_size + 2 * self.kv_size

    @property
    def attention_scale(self) -> float:
        return self.attn_scale or self.head_dim ** -0.5

    def module_algo(self, name: str) -> QuantAlgo:
        return self.quant.module_algo(name)

    def to_dict(self) -> dict:
        """The JAX package's ``ModelConfig.to_dict()`` layout (what a
        checkpoint's config.json holds): the ported fields, and the
        unported axes at their "off" values."""
        d = dict(_UNPORTED_AXES)
        d.update(dataclasses.asdict(self))
        d["dtype"] = {v: k for k, v in _DTYPES.items()}[self.dtype]
        d["quant"] = self.quant.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """From ``ModelConfig.to_dict()`` of either package. Raises on any
        axis set to a value the port does not honour yet."""
        d = dict(d)
        for k, off in _UNPORTED_AXES.items():
            v = d.pop(k, off)
            if (tuple(v) if isinstance(v, list) else v) != off:
                raise NotImplementedError(
                    f"ModelConfig axis {k}={v!r} is not ported yet: it "
                    f"comes with {_LATER_MODULES}")
        if d.get("top_k_experts") is not None:
            d.pop("top_k_experts")
        for k in ("rope_beta_fast", "rope_beta_slow", "rope_attention_factor",
                  "conv_kernel", "dt_rank", "use_conv_bias",
                  "moe_norm_topk"):
            d.pop(k, None)       # only read by axes rejected above
        if isinstance(d.get("dtype"), str):
            d["dtype"] = _DTYPES[d["dtype"]]
        if "quant" in d and not isinstance(d["quant"], QuantConfig):
            d["quant"] = QuantConfig.from_dict(d["quant"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise NotImplementedError(
                f"ModelConfig fields not ported yet: {sorted(unknown)}: "
                f"they come with {_LATER_MODULES}")
        return cls(**d)


# ---------------------------------------------------------------------------
# Dense KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Dense KV cache, layers stacked on the leading axis, updated in place.

    bf16 mode: k/v (L, B, Smax, Hkv, D) in the model dtype, no scales.
    int8 / fp8 mode: k/v int8 or float8_e4m3fn of that shape; k_scale /
    v_scale (L, B, Smax, Hkv) f32 (per token and head,
    quant/core.quantize_kv)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def kv_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    """The quantized KV dtype (int8 or float8_e4m3fn), None for KV in the
    model dtype."""
    return {KVCacheQuantAlgo.INT8: torch.int8,
            KVCacheQuantAlgo.FP8: qcore.FP8}.get(cfg.quant.kv_cache)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device: DeviceLike = "cuda") -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    qdt = kv_dtype(cfg)
    if qdt is not None:
        return KVCache(
            k=torch.zeros(shape, dtype=qdt, device=dev),
            v=torch.zeros(shape, dtype=qdt, device=dev),
            k_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev),
            v_scale=torch.ones(shape[:-1], dtype=torch.float32, device=dev))
    return KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shape, dtype=cfg.dtype, device=dev))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float,
                 cfg: Optional[ModelConfig] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., S) int -> sin/cos (..., S, D/2) float32; ``cfg``
    applies HF rope_scaling ("linear", "llama3")."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=dev) / head_dim))
    if cfg is not None and cfg.rope_scaling_type == "llama3":
        factor = cfg.rope_scaling_factor
        low = cfg.rope_original_max_pos / cfg.rope_low_freq_factor
        high = cfg.rope_original_max_pos / cfg.rope_high_freq_factor
        wavelen = 2 * math.pi / inv_freq
        scaled = inv_freq / factor
        smooth = (cfg.rope_original_max_pos / wavelen
                  - cfg.rope_low_freq_factor) / (
            cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
        smoothed = (1 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(wavelen > low, scaled,
                               torch.where(wavelen < high, inv_freq,
                                           smoothed))
    pos = positions.float()
    if cfg is not None and cfg.rope_scaling_type == "linear":
        pos = pos / cfg.rope_scaling_factor
    angles = pos[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); sin/cos (B, S, D/2); rotate_half ordering."""
    s, c = sin[:, :, None, :], cos[:, :, None, :]
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    if name == "silu":
        return torch.nn.functional.silu(xf)
    if name == "gelu":
        return torch.nn.functional.gelu(xf)
    if name in ("gelu_new", "gelu_tanh", "gelu_pytorch_tanh", "gelu_fast"):
        return torch.nn.functional.gelu(xf, approximate="tanh")
    if name == "relu":
        return torch.relu(xf)
    raise ValueError(f"unknown activation {name!r}")


def block_norm(cfg: ModelConfig, x: torch.Tensor, p: Dict) -> torch.Tensor:
    return ops_ref.rmsnorm(x, p["w"], cfg.rms_norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _attention_with_cache(cfg: ModelConfig, q, new_k, new_v,
                          layer_cache: dict, write_pos, kv_valid_len,
                          full_prefill: bool = False,
                          attn_mask=None) -> torch.Tensor:
    """Write new_k/new_v (B, S, Hkv, D) into this layer's dense cache at
    write_pos (B, S) in place, and attend q (B, S, Hq, D) (JAX
    models/common.py:341-432).

    layer_cache: k/v (B, Smax, Hkv, D) views (+ k_scale/v_scale
    (B, Smax, Hkv) in int8 mode); kv_valid_len (B,) counts the entries
    valid AFTER this write. full_prefill asserts the cache held nothing
    before this write: attention then runs over the fresh new_k/new_v
    through ``ops.attention.causal_self_attention`` (K14 for MHA), as JAX
    does, not over the quantized cache. Otherwise the masked einsum over
    the whole cache (causal in absolute positions, below kv_valid_len, the
    window), straight over int8 or e4m3 with its scales in the quantized
    modes: plain torch, as JAX leaves it to XLA. ``attn_mask`` (B, 1, S,
    Smax) bool replaces that mask whole (tree and beam verification,
    where cache slots and token positions part), and turns the
    full_prefill route off, as in JAX."""
    b = q.shape[0]
    window = cfg.sliding_window
    scale, softcap = cfg.attention_scale, cfg.attn_logit_softcap
    bidx = torch.arange(b, device=q.device)[:, None]
    wp = write_pos.long()
    ck, cv = layer_cache["k"], layer_cache["v"]
    quantized = "k_scale" in layer_cache
    if quantized:
        qk, sk = qcore.quantize_kv(new_k, dtype=ck.dtype)
        qv, sv = qcore.quantize_kv(new_v, dtype=cv.dtype)
        qcore.raw(ck)[bidx, wp] = qcore.raw(qk)
        qcore.raw(cv)[bidx, wp] = qcore.raw(qv)
        layer_cache["k_scale"][bidx, wp] = sk
        layer_cache["v_scale"][bidx, wp] = sv
    else:
        ck[bidx, wp] = new_k.to(ck.dtype)
        cv[bidx, wp] = new_v.to(cv.dtype)

    if full_prefill and not softcap and attn_mask is None:
        return ops_attn.causal_self_attention(q, new_k, new_v, scale=scale,
                                              window=window)
    if attn_mask is not None:
        mask = attn_mask
    else:
        kv_idx = torch.arange(ck.shape[1], device=q.device)
        mask = ((kv_idx[None, None, None, :] <= wp[:, None, :, None])
                & (kv_idx[None, None, None, :]
                   < kv_valid_len.long()[:, None, None, None]))
        if window:
            mask &= (kv_idx[None, None, None, :]
                     > wp[:, None, :, None] - window)
    if quantized:
        return ops_ref.attention_int8kv(q, ck, layer_cache["k_scale"], cv,
                                        layer_cache["v_scale"], mask=mask,
                                        scale=scale, softcap=softcap)
    return ops_ref.attention(q, ck, cv, mask=mask, scale=scale,
                             softcap=softcap)


def _kv_splits() -> int:
    """Flash-decoding page-split factor of the decode step (the reference's
    --multi_block_mode): 0/1 = one K7 scan per lane (default); N > 1 sends
    S == 1 through K11. Read from MIXQ_KV_SPLITS, as the JAX package's
    models/common.py _kv_splits does."""
    return int(os.environ.get("MIXQ_KV_SPLITS", "0"))


def _attention_paged(cfg: ModelConfig, q, new_k, new_v, pools: dict,
                     block_table, write_pos, kv_valid_len, block_pos=None,
                     window: int = 0, sink: int = 0) -> torch.Tensor:
    """Write new K/V (B, S, Hkv, D) into the pool in place and attend q
    (B, S, Hq, D) over the lane's pages. The write is kv_cache.paged_write
    given kv_valid_len (positions at or past it go to the trash): on the
    card one launch of K5 or K6.

    Attention is kv_cache.paged_attention: on int8 and bf16 pools K7 (or
    K11 when MIXQ_KV_SPLITS > 1) at S == 1, K9 up to 8 rows, K8 above; an
    e4m3 pool is written and read on the JAX package's route (the e4m3
    cast and a scatter; the gather route and masked torch attention), no
    K5-K11 launch."""
    from ..runtime import kv_cache as pkv

    pkv.paged_write(pools, block_table, write_pos, new_k, new_v,
                    block_pos=block_pos, kv_valid_len=kv_valid_len)
    return pkv.paged_attention(
        q, pools, block_table, write_pos, kv_valid_len,
        scale=cfg.attention_scale, block_pos=block_pos,
        window=window or cfg.sliding_window, sink=sink,
        softcap=cfg.attn_logit_softcap, kv_splits=_kv_splits())


def _attention_paged_tail(cfg: ModelConfig, q, new_k, new_v, pools: dict,
                          tail: dict, tail_idx: int, block_table,
                          prefix_len, block_pos=None) -> torch.Tensor:
    """Decode attention of a beam burst (runtime/beam.py; JAX
    models/common.py:435-551): the paged pool holds each lane's prefix and
    is only read; the burst's own tokens live in a dense per-lane ``tail``
    {k, v (B, kmax, Hkv, D) [, k_scale, v_scale (B, kmax, Hkv)]}, which
    the burst reorders with the beams. The new token's K/V goes into the
    tail at slot ``tail_idx`` in place (int8 tails: quant.core.quantize_kv,
    what K5 would write to a page), and attention of q (B, 1, Hq, D) over
    [pool prefix | tail slots <= tail_idx] is merged exactly from the two
    parts' softmax stats: the prefix below ``prefix_len`` (B,) through
    kv_cache.paged_attention(stats=True) (K10 on the card; e4m3 pages take
    the gather route and ops.ref.attention_stats, as in the JAX package),
    the tail through ops.ref.attention_stats, both f32 until one final
    cast. Windows are refused, as in the JAX package."""
    if cfg.sliding_window:
        raise NotImplementedError("beam bursts do not support windows")
    if q.shape[1] != 1:
        raise ValueError("beam bursts decode one token a step")
    from ..runtime import kv_cache as pkv

    scale, softcap = cfg.attention_scale, cfg.attn_logit_softcap
    t = int(tail_idx)
    if "k_scale" in tail:
        for name, x in (("k", new_k), ("v", new_v)):
            qx, sx = qcore.quantize_kv(x[:, 0], dtype=tail[name].dtype)
            qcore.raw(tail[name])[:, t] = qcore.raw(qx)
            tail[name + "_scale"][:, t] = sx
    else:
        tail["k"][:, t] = new_k[:, 0].to(tail["k"].dtype)
        tail["v"][:, t] = new_v[:, 0].to(tail["v"].dtype)
    prefix = pkv.paged_attention(q, pools, block_table,
                                 prefix_len[:, None] - 1, prefix_len,
                                 scale=scale, block_pos=block_pos,
                                 softcap=softcap, stats=True)
    kmax = tail["k"].shape[1]
    slot_ok = torch.arange(kmax, device=q.device) <= t
    out_t, m_t, l_t = ops_ref.attention_stats(
        q, tail["k"], tail["v"], k_s=tail.get("k_scale"),
        v_s=tail.get("v_scale"), mask=slot_ok[None, None, None, :],
        scale=scale, softcap=softcap)
    return ops_ref.merge_attention_stats(
        [prefix, (out_t, m_t, l_t)]).to(q.dtype)


def _absmax_in(x: torch.Tensor) -> torch.Tensor:
    """Per-input-channel absmax over all leading dims (f32)."""
    return x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)


def decoder_layer(cfg: ModelConfig, lp: Dict, x: torch.Tensor, sin, cos,
                  attend, stats: Optional[dict] = None,
                  ostate: Optional[dict] = None,
                  lora_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One pre-norm Llama block. x (B, S, hidden); ``attend(q, k, v)``
    writes the new k/v (B, S, Hkv, D) into the layer's KV and returns
    attention of q (B, S, Hq, D) over it: ``_attention_with_cache`` (dense
    cache), ``_attention_paged`` (paged pool) or ``_attention_paged_tail``
    (a beam burst's read-only pool and dense tail) with the layer's state
    bound.

    ``stats``, a dict, receives each linear's per-input-channel activation
    absmax (the act_scales calibration signal) from the activations the JAX
    package reads: the normed inputs of qkv and gate_up (the norm then runs
    apart from the linear, as in JAX), the attention output for o_proj, the
    gated activation for down_proj.

    ``ostate``, a dict {module: chan_max (in,)} of this layer's dynamic
    outlier state (quant/dynamic.py), sends each module it holds through
    the adaptive mixed linear when that module's algo at this S is a mix
    algo (prefill chunks; decode steps, weight-only at S <= 4, pass the
    state through), and receives the updated state in place. The norm
    then runs apart from the linear, as in the JAX package.

    ``lora_ids`` (B,) int selects each lane's runtime LoRA adapter (0 = the
    base model) on every module that carries ``lora_A`` (N+1, in, R) /
    ``lora_B`` (N+1, R, out) (convert/lora.attach_lora): the delta (h A) B,
    two f32 batched products, is cast to the linear's output dtype and
    added to it. The norm then runs apart too, so a mix linear takes K1
    without the norm (JAX models/common.py:837-876)."""
    b, s, _ = x.shape

    # decode regime (S <= 4): mix linears run weight-only on the full
    # qweight (models/common.py:830-835, the reference's SMALL_M_FAST_PATH):
    # int8_mix as W8A16, int4_mix as W4A16 on the packed weight
    def algo(mod):
        a = cfg.module_algo(mod)
        if s <= 4 and a.is_mix:
            return (QuantAlgo.W8A16 if a == QuantAlgo.INT8_MIX
                    else QuantAlgo.W4A16)
        return a

    def adaptive(mod):
        return ostate is not None and mod in ostate and algo(mod).is_mix

    def linear(mod, h):
        if not adaptive(mod):
            return dispatch.linear(lp[mod], h, algo(mod))
        p = lp[mod]
        cap = min(cfg.quant.max_outliers, h.shape[-1])
        out, st = qdyn.adaptive_mix_linear(
            h, p["qweight"], p["scale_col"],
            qdyn.DynamicOutlierState(ostate[mod]), cap=cap,
            sigma=cfg.quant.outlier_sigma,
            base_k=min(cfg.quant.num_outliers, cap), out_dtype=h.dtype)
        ostate[mod] = st.chan_max
        return dispatch._maybe_bias(out, p)

    def has_lora(mod):
        return lora_ids is not None and "lora_A" in lp[mod]

    def lora(mod, h, out):
        if not has_lora(mod):
            return out
        ids = lora_ids.long()
        t = torch.bmm(h.float(), lp[mod]["lora_A"][ids].float())
        d = torch.bmm(t, lp[mod]["lora_B"][ids].float())
        return out + d.to(out.dtype)

    def proj_in(mod, norm_key, x_res):
        if stats is None and not adaptive(mod) and not has_lora(mod):
            return dispatch.norm_linear(lp[mod], x_res, algo(mod),
                                        lp[norm_key]["w"],
                                        eps=cfg.rms_norm_eps)
        h = block_norm(cfg, x_res, lp[norm_key])
        if stats is not None:
            stats[mod] = _absmax_in(h)
        return lora(mod, h, linear(mod, h))

    qkv = proj_in("qkv_proj", "input_norm", x)
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size],
                          dim=-1)
    q = apply_rope(q.reshape(b, s, cfg.num_heads, cfg.head_dim), sin, cos)
    k = apply_rope(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim), sin, cos)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    attn_in = attend(q, k, v).reshape(b, s, cfg.q_size)
    if stats is not None:
        stats["o_proj"] = _absmax_in(attn_in)
    attn = lora("o_proj", attn_in, linear("o_proj", attn_in))
    x = x + attn.to(x.dtype)

    up_out = proj_in("gate_up_proj", "post_norm", x)
    gate, up = torch.chunk(up_out, 2, dim=-1)
    h = (_act(cfg.hidden_act, gate) * up.float()).to(x.dtype)
    if stats is not None:
        stats["down_proj"] = _absmax_in(h)
    h = lora("down_proj", h, dispatch.linear(lp["down_proj"], h,
                                             algo("down_proj")))
    return x + h.to(x.dtype)


def _positional_arrays(cfg: ModelConfig, write_pos: torch.Tensor):
    return rope_sin_cos(write_pos, cfg.head_dim, cfg.rope_theta, cfg=cfg)


def _embed(params: Dict, cfg: ModelConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["w"][tokens.long()].to(cfg.dtype)


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied or separate); f32 logits."""
    x = block_norm(cfg, x, params["final_norm"])
    lm_head = params.get("lm_head")
    if lm_head is None:
        return ops_ref.bf16_matmul_f32(x, params["embed"]["w"].T)
    return dispatch.linear(lm_head, x, cfg.module_algo("lm_head")).float()


def _layer_ostate(outlier_state, li: int) -> Optional[dict]:
    """Layer li's slice of a model-level dynamic outlier state."""
    if not outlier_state:
        return None
    return {m: v[li] for m, v in outlier_state.items()}


def _stack_ostate(per_layer) -> dict:
    return {m: torch.stack([st[m] for st in per_layer])
            for m in per_layer[0]}


def forward_paged(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                  write_pos: torch.Tensor, paged_state, block_table,
                  kv_valid_len: torch.Tensor, block_pos=None,
                  window: int = 0, sink: int = 0, last_pos=None,
                  outlier_state: Optional[dict] = None, lora_ids=None):
    """Decoder forward over the paged pool (continuous-batching path).

    tokens/write_pos (B, S); paged_state: runtime.kv_cache.PagedKVState,
    flat over layers and updated IN PLACE; block_table/block_pos (B, MB)
    per-layer page ids (the layer offset is added here) and absolute base
    positions; kv_valid_len (B,) KV length after this call's writes;
    window/sink: StreamingLLM window in tokens (0 = model default);
    last_pos: optional (B,) chunk-relative index — the head then runs on
    that one position per lane and returns (B, 1, V) logits;
    outlier_state: quant.dynamic.init_model_state's dict, threaded through
    the layers' adaptive mix linears (``decoder_layer``); lora_ids: (B,)
    runtime LoRA adapter per lane (``decoder_layer``).
    Returns (logits f32, paged_state[, new outlier_state])."""
    x = _embed(params, cfg, tokens)
    sin, cos = _positional_arrays(cfg, write_pos)
    num_layers = len(params["layers"])
    nb = paged_state.k.shape[0] // num_layers
    pools = paged_state.pools()
    new_ostate = []
    for li, lp in enumerate(params["layers"]):
        attend = partial(_attention_paged, cfg, pools=pools,
                         block_table=block_table + li * nb,
                         write_pos=write_pos, kv_valid_len=kv_valid_len,
                         block_pos=block_pos, window=window, sink=sink)
        ost = _layer_ostate(outlier_state, li)
        x = decoder_layer(cfg, lp, x, sin, cos, attend, ostate=ost,
                          lora_ids=lora_ids)
        new_ostate.append(ost)
    logits = _head(params, cfg, _last(x, last_pos)).float()
    if outlier_state:
        return logits, paged_state, _stack_ostate(new_ostate)
    return logits, paged_state


def _last(x: torch.Tensor, last_pos) -> torch.Tensor:
    """x (B, S, H) -> (B, 1, H) at each lane's last_pos, or x unchanged."""
    if last_pos is None:
        return x
    idx = last_pos.long().clamp(0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            write_pos: torch.Tensor, cache: KVCache,
            kv_valid_len: torch.Tensor, collect_stats: bool = False,
            full_prefill: bool = False, outlier_state=None, lora_ids=None,
            attn_mask=None, return_hidden: bool = False, rope_pos=None,
            last_pos=None):
    """Decoder forward over the dense cache (the GenerationSession's path).

    tokens/write_pos (B, S): token ids and their absolute positions (RoPE
    and cache slot); cache: KVCache, updated IN PLACE; kv_valid_len (B,)
    valid KV length after this call's writes; full_prefill: the cache is
    empty before this call, so attention runs over the fresh K/V (K14 on
    the card for MHA); last_pos: optional (B,) index, the head then runs on
    that one position per lane and returns (B, 1, V) logits (a port-only
    option: JAX's session gathers after its head); collect_stats: also
    return each linear's per-input-channel activation absmax,
    ``stats[module]`` (L, in) f32 (``decoder_layer``); outlier_state:
    quant.dynamic.init_model_state's dict, threaded through the layers'
    adaptive mix linears; lora_ids: (B,) runtime LoRA adapter per lane
    (``decoder_layer``); attn_mask: (B, 1, S, Smax) bool, replaces the
    causal construction and the full_prefill route (tree and beam
    verification, runtime/medusa.py and runtime/redrafter.py); rope_pos:
    (B, S) the tokens' true positions for RoPE where they differ from
    their cache slots ``write_pos``; return_hidden: also return the
    pre-final-norm hidden (B, S, H) as the last element, never cut by
    last_pos.
    Returns (logits f32, cache[, new outlier_state][, stats][, hidden])."""
    x = _embed(params, cfg, tokens)
    sin, cos = _positional_arrays(
        cfg, write_pos if rope_pos is None else rope_pos)
    layer_stats, new_ostate = [], []
    for li, lp in enumerate(params["layers"]):
        layer_cache = {"k": cache.k[li], "v": cache.v[li]}
        if cache.quantized:
            layer_cache.update(k_scale=cache.k_scale[li],
                               v_scale=cache.v_scale[li])
        attend = partial(_attention_with_cache, cfg, layer_cache=layer_cache,
                         write_pos=write_pos, kv_valid_len=kv_valid_len,
                         full_prefill=full_prefill, attn_mask=attn_mask)
        st = {} if collect_stats else None
        ost = _layer_ostate(outlier_state, li)
        x = decoder_layer(cfg, lp, x, sin, cos, attend, stats=st,
                          ostate=ost, lora_ids=lora_ids)
        layer_stats.append(st)
        new_ostate.append(ost)
    out = (_head(params, cfg, _last(x, last_pos)).float(), cache)
    if outlier_state:
        out += (_stack_ostate(new_ostate),)
    if collect_stats:
        out += ({m: torch.stack([st[m] for st in layer_stats])
                 for m in layer_stats[0]},)
    if return_hidden:
        out += (x,)
    return out
