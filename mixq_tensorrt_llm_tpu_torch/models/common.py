"""Model config, RoPE and ALiBi, the dense-cache decoder forward and the
paged one (single device), config-driven across the dense decoder
families (models/llama.py, models/families.py) and the expert models
(models/moe.py); ``init_kv_cache`` and ``forward`` hand the recurrent-state
models (models/mamba.py, models/recurrentgemma.py) to their own modules.
Counterpart of mixq_tensorrt_llm_tpu/models/common.py.

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
from . import moe as moe_mod

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}

# the recurrent-state models: their state takes the dense cache's place
# and only the GenerationSession serves them (no paged path)
RECURRENT_ARCHS = ("mamba", "recurrentgemma")
# the dense decoder families (models/llama.py, models/families.py), the
# expert models (models/moe.py) and the recurrent-state models
_PORTED_ARCHS = ("llama", "mistral", "qwen2", "opt", "gpt2", "gptj",
                 "gpt_neox", "falcon", "bloom", "mpt", "phi", "phi3",
                 "gemma", "gemma2", "qwen3", "glm", "glm4", "olmo2",
                 "cohere", "granite", "baichuan", "gpt_bigcode",
                 "starcoder2", "stablelm", "mixtral", "dbrx", "qwen2_moe",
                 "qwen3_moe") + RECURRENT_ARCHS
_ROPE_TYPES = ("none", "linear", "llama3", "yarn", "longrope")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The JAX package's ModelConfig: the same field names and defaults
    (Llama-2-7B), ``dtype`` a torch dtype. One config-driven decoder
    serves every dense family; the axes beyond the Llama lineage
    reproduce the zoo's structural spread, and the Mamba axes the
    selective SSM's (JAX models/common.py:38-118)."""

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
    num_experts: int = 0                 # 0 = dense MLP (Mixtral: 8)
    top_k_experts: int = 2
    tie_word_embeddings: bool = False
    pos_embedding: str = "rope"          # rope | learned | alibi | none
    rotary_dim: int = 0                  # 0 = full head_dim (partial rotary)
    rope_interleaved: bool = False       # GPT-J pairwise ordering
    learned_pos_offset: int = 0          # OPT embeds positions at pos + 2
    norm_type: str = "rmsnorm"           # rmsnorm | layernorm
    parallel_blocks: bool = False        # attn and mlp from one residual
    shared_block_norm: bool = False      # parallel with ONE norm
    mlp_type: str = "gated"              # gated | dense (fc1-act-fc2)
    hidden_act: str = "silu"
    attn_out_bias: bool = False
    mlp_bias: bool = False
    lm_head_bias: bool = False           # GPT-J / Phi
    embed_scale: float = 1.0             # Gemma: sqrt(hidden)
    embed_norm: bool = False             # BLOOM word_embeddings_layernorm
    attn_scale: float = 0.0              # 0 = 1/sqrt(head_dim)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0     # Gemma-2
    post_block_norms: bool = False       # Gemma-2 / GLM-4 / OLMo-2
    qk_norm: bool = False                # Qwen3 per-head q/k RMSNorm
    sliding_window_pattern: int = 1      # every p-th layer global (Gemma-2)
    pre_block_norms: bool = True         # OLMo-2 False: raw residual in
    qk_norm_flat: bool = False           # OLMo-2: q/k norm over H*D
    logit_scale: float = 1.0             # Cohere; Granite 1/logits_scaling
    residual_multiplier: float = 1.0     # Granite
    clip_qkv: float = 0.0                # clamp qkv to +-clip; 0 = off
    rope_scaling_type: str = "none"      # none|linear|llama3|yarn|longrope
    rope_scaling_factor: float = 1.0
    rope_low_freq_factor: float = 1.0    # llama3
    rope_high_freq_factor: float = 4.0   # llama3
    rope_original_max_pos: int = 8192    # llama3 / yarn original context
    rope_beta_fast: float = 32.0         # yarn extrapolation boundary
    rope_beta_slow: float = 1.0          # yarn interpolation boundary
    rope_attention_factor: float = 1.0   # yarn / longrope cos/sin scale
    rope_freq_factors: tuple = ()        # longrope per-dim divisors
    # Mamba (selective SSM); intermediate_size doubles as d_inner, and
    # conv_kernel is RecurrentGemma's conv width too
    ssm_state_size: int = 0              # d_state (N); 0 = not an SSM arch
    conv_kernel: int = 4                 # depthwise causal conv width (K)
    dt_rank: int = 0                     # low-rank dt projection width
    use_conv_bias: bool = True
    moe_norm_topk: bool = True           # renormalize the kept top-k mass
    #                                      (HF norm_topk_prob; Mixtral yes,
    #                                      Qwen2-MoE no)
    moe_intermediate: int = 0            # expert FFN width (0 = the
    #                                      intermediate_size)
    moe_shared_intermediate: int = 0     # Qwen2-MoE's shared expert (0 =
    #                                      none)
    dtype: torch.dtype = torch.bfloat16
    quant: QuantConfig = QuantConfig()

    def __post_init__(self):
        if self.arch not in _PORTED_ARCHS:
            raise ValueError(f"unknown arch {self.arch!r}")
        if self.arch == "recurrentgemma" and self.num_layers % 3:
            # the (recurrent, recurrent, attention) pattern's period, as
            # the JAX package's config_from_hf asserts
            raise ValueError(f"recurrentgemma: num_layers "
                             f"({self.num_layers}) must be a multiple of "
                             "the block pattern period (3)")
        if self.rope_scaling_type not in _ROPE_TYPES:
            raise ValueError(
                f"rope_scaling_type {self.rope_scaling_type!r} unknown "
                f"({', '.join(_ROPE_TYPES)})")
        if self.pos_embedding not in ("rope", "learned", "alibi", "none"):
            raise ValueError(f"pos_embedding {self.pos_embedding!r} unknown")
        if self.norm_type not in ("rmsnorm", "layernorm"):
            raise ValueError(f"norm_type {self.norm_type!r} unknown")
        if self.mlp_type not in ("gated", "dense"):
            raise ValueError(f"mlp_type {self.mlp_type!r} unknown")
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
        if self.num_experts and not 1 <= self.top_k_experts \
                <= self.num_experts:
            raise ValueError(f"top_k_experts {self.top_k_experts} outside "
                             f"1..num_experts ({self.num_experts})")

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

    def layer_window(self, layer: int) -> Optional[int]:
        """The static sliding window (tokens) of one layer under an
        alternating pattern (Gemma-2: every p-th layer global, 0); None =
        ``sliding_window`` on every layer."""
        p = self.sliding_window_pattern
        if p <= 1 or not self.sliding_window:
            return None
        return self.sliding_window if (layer + 1) % p else 0

    def module_algo(self, name: str) -> QuantAlgo:
        return self.quant.module_algo(name)

    def to_dict(self) -> dict:
        """The JAX package's ``ModelConfig.to_dict()`` layout (what a
        checkpoint's config.json holds): every field."""
        d = dataclasses.asdict(self)
        d["dtype"] = {v: k for k, v in _DTYPES.items()}[self.dtype]
        d["quant"] = self.quant.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        """From ``ModelConfig.to_dict()`` of either package."""
        d = dict(d)
        if isinstance(d.get("dtype"), str):
            d["dtype"] = _DTYPES[d["dtype"]]
        if "quant" in d and not isinstance(d["quant"], QuantConfig):
            d["quant"] = QuantConfig.from_dict(d["quant"])
        if "rope_freq_factors" in d:     # JSON round-trips tuples as lists
            d["rope_freq_factors"] = tuple(d["rope_freq_factors"])
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown ModelConfig fields {sorted(unknown)}")
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
                  device: DeviceLike = "cuda"):
    """The dense KVCache, or a recurrent-state model's state in its place
    (models/mamba.init_state: a KVCache of conv carry and SSM state, O(1)
    in max_len; models/recurrentgemma.init_state: an RGState)."""
    dev = resolve_device(device)
    if cfg.arch == "mamba":
        from . import mamba
        return mamba.init_state(cfg, batch, dev)
    if cfg.arch == "recurrentgemma":
        from . import recurrentgemma
        return recurrentgemma.init_state(cfg, batch, max_len, dev)
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
    applies HF rope_scaling (JAX models/common.py:215-300): "linear"
    divides the positions, "llama3" rescales inv_freq by wavelength band,
    "yarn" blends interpolated and original frequencies over a ramp and
    scales cos/sin by the attention factor, "longrope" divides inv_freq per
    dim (the short/long set chosen at config time) and scales cos/sin."""
    dev = positions.device
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=dev) / head_dim))
    kind = cfg.rope_scaling_type if cfg is not None else "none"
    if kind == "longrope":
        ext = torch.tensor(cfg.rope_freq_factors, dtype=torch.float32,
                           device=dev)
        angles = positions.float()[..., None] * (inv_freq / ext)
        af = cfg.rope_attention_factor
        return torch.sin(angles) * af, torch.cos(angles) * af
    if kind == "yarn":
        def corr_dim(rot):
            return head_dim * math.log(cfg.rope_original_max_pos
                                       / (rot * 2 * math.pi)) / (
                2 * math.log(theta))
        low = max(math.floor(corr_dim(cfg.rope_beta_fast)), 0)
        high = min(math.ceil(corr_dim(cfg.rope_beta_slow)), head_dim - 1)
        ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                         device=dev) - low)
                           / max(high - low, 1e-3), 0, 1)
        extrap = 1.0 - ramp
        inv_freq = (inv_freq / cfg.rope_scaling_factor) * (1 - extrap) \
            + inv_freq * extrap
        angles = positions.float()[..., None] * inv_freq
        af = cfg.rope_attention_factor
        return torch.sin(angles) * af, torch.cos(angles) * af
    if kind == "llama3":
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
    if kind == "linear":
        pos = pos / cfg.rope_scaling_factor
    angles = pos[..., None] * inv_freq
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """x (B, S, H, D); sin/cos (B, S, D/2). rotate_half ordering, or
    (interleaved, GPT-J) pairs (even, odd)."""
    s, c = sin[:, :, None, :], cos[:, :, None, :]
    if interleaved:
        x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
        ro = torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
        return ro.reshape(x.shape).to(x.dtype)
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _apply_positional(cfg: ModelConfig, x: torch.Tensor, sin,
                      cos) -> torch.Tensor:
    """RoPE on the (possibly partial) rotary span of the head dims; the
    rest passes through."""
    rd = cfg.rotary_dim or cfg.head_dim
    if rd == cfg.head_dim:
        return apply_rope(x, sin, cos, interleaved=cfg.rope_interleaved)
    rot = apply_rope(x[..., :rd], sin, cos, interleaved=cfg.rope_interleaved)
    return torch.cat([rot, x[..., rd:]], dim=-1)


_ALIBI: Dict[tuple, torch.Tensor] = {}


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi's per-head slopes (Press et al.; HF build_alibi_tensor), the
    closest-power-of-2 scheme for other head counts; f32 (H,). Made once a
    (head count, device): a captured decode graph's forward then copies
    nothing from the host."""
    key = (num_heads, str(device))
    if key not in _ALIBI:
        n = 2 ** math.floor(math.log2(num_heads))
        base = 2.0 ** (-8.0 / n)
        slopes = [base ** (i + 1) for i in range(n)]
        if n < num_heads:
            extra = 2.0 ** (-4.0 / n)
            slopes += [extra ** (2 * i + 1) for i in range(num_heads - n)]
        _ALIBI[key] = torch.tensor(slopes, dtype=torch.float32,
                                   device=device)
    return _ALIBI[key]


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
    """The block norm: RMSNorm (Llama lineage) or LayerNorm (+ bias)."""
    if cfg.norm_type == "layernorm":
        return ops_ref.layernorm(x, p["w"], p.get("b"), cfg.rms_norm_eps)
    return ops_ref.rmsnorm(x, p["w"], cfg.rms_norm_eps)


def _pattern_period(cfg: ModelConfig) -> int:
    """The alternating-window period (Gemma-2: 2), checked against the
    depth as the JAX package's grouped layer scan checks it."""
    p = cfg.sliding_window_pattern
    if p <= 1 or not cfg.sliding_window:
        return 1
    if cfg.num_layers % p:
        raise ValueError(
            f"num_layers ({cfg.num_layers}) must be a multiple of "
            f"sliding_window_pattern ({p})")
    return p


def _layer_window(cfg: ModelConfig, li: int) -> int:
    """Layer li's window before a runtime window: its pattern entry, else
    ``sliding_window`` (0 = global)."""
    lw = cfg.layer_window(li)
    return cfg.sliding_window if lw is None else lw


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _attention_with_cache(cfg: ModelConfig, q, new_k, new_v,
                          layer_cache: dict, write_pos, kv_valid_len,
                          full_prefill: bool = False,
                          attn_mask=None, alibi=None,
                          window: int = 0) -> torch.Tensor:
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
    full_prefill route off, as in JAX. ``window`` is the layer's sliding
    window (0 = global); ``alibi`` (Hq,) f32 slopes add slope_h * kv_pos
    to the logits (softmax-equivalent to slope_h * (kv - q)) and, as a
    softcap does, keep the full_prefill route off."""
    b = q.shape[0]
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

    if full_prefill and not softcap and attn_mask is None and alibi is None:
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
    bias = None
    if alibi is not None:
        kv_idx = torch.arange(ck.shape[1], device=q.device)
        bias = alibi[None, :, None, None] * kv_idx[None, None, None, :]
    if quantized:
        return ops_ref.attention_int8kv(q, ck, layer_cache["k_scale"], cv,
                                        layer_cache["v_scale"], mask=mask,
                                        scale=scale, softcap=softcap,
                                        bias=bias)
    return ops_ref.attention(q, ck, cv, mask=mask, scale=scale,
                             softcap=softcap, bias=bias)


def _kv_splits() -> int:
    """Flash-decoding page-split factor of the decode step (the reference's
    --multi_block_mode): 0/1 = one K7 scan per lane (default); N > 1 sends
    S == 1 through K11. Read from MIXQ_KV_SPLITS, as the JAX package's
    models/common.py _kv_splits does."""
    return int(os.environ.get("MIXQ_KV_SPLITS", "0"))


def _attention_paged(cfg: ModelConfig, q, new_k, new_v, pools: dict,
                     block_table, write_pos, kv_valid_len, block_pos=None,
                     window: int = 0, sink: int = 0,
                     layer_window: int = 0, alibi=None) -> torch.Tensor:
    """Write new K/V (B, S, Hkv, D) into the pool in place and attend q
    (B, S, Hq, D) over the lane's pages. The write is kv_cache.paged_write
    given kv_valid_len (positions at or past it go to the trash): on the
    card one launch of K5 or K6.

    Attention is kv_cache.paged_attention: on int8 and bf16 pools K7 (or
    K11 when MIXQ_KV_SPLITS > 1) at S == 1, K9 up to 8 rows, K8 above; an
    e4m3 pool is written and read on the JAX package's route (the e4m3
    cast and a scatter; the gather route and masked torch attention), no
    K5-K11 launch. ALiBi models (``alibi`` (Hq,) slopes) take that
    gather route on every pool, as in the JAX package (its paged kernels
    take no additive bias), the write still K5 / K6.

    The window is the runtime StreamingLLM ``window`` when set, else the
    layer's own ``layer_window`` (Gemma-2's alternation; 0 = global), as
    the JAX package orders them."""
    from ..runtime import kv_cache as pkv

    pkv.paged_write(pools, block_table, write_pos, new_k, new_v,
                    block_pos=block_pos, kv_valid_len=kv_valid_len)
    return pkv.paged_attention(
        q, pools, block_table, write_pos, kv_valid_len,
        scale=cfg.attention_scale, block_pos=block_pos,
        window=window or layer_window, sink=sink,
        softcap=cfg.attn_logit_softcap, kv_splits=_kv_splits(), alibi=alibi)


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
    """One decoder block, config-driven across the dense zoo (JAX
    models/common.py:763-980). x (B, S, hidden); ``attend(q, k, v)``
    writes the new k/v (B, S, Hkv, D) into the layer's KV and returns
    attention of q (B, S, Hq, D) over it: ``_attention_with_cache`` (dense
    cache), ``_attention_paged`` (paged pool) or ``_attention_paged_tail``
    (a beam burst's read-only pool and dense tail) with the layer's state
    bound. ``sin``/``cos`` are None where the model has no RoPE.

    Structure axes: sequential pre-norm blocks or parallel attn + mlp
    (one shared norm, or two); RMSNorm or LayerNorm; gated or dense MLP;
    qkv clipping, q/k norms (per head, or over the flat projection),
    post-block norms, Granite's residual multiplier, OLMo-2's projections
    of the raw residual; an expert block (models/moe.py) in place of the
    MLP when ``num_experts`` is set. A mix linear takes K1 with the
    RMSNorm fused where nothing else reads the normed activations;
    LayerNorm families, shared norms, raw-residual projections, stats,
    adaptive outliers and LoRA compute the norm apart and take K1
    without it.

    ``stats``, a dict, receives each linear's per-input-channel activation
    absmax (the act_scales calibration signal) from the activations the JAX
    package reads: the inputs of qkv and gate_up, the attention output for
    o_proj, the MLP's activation for down_proj.

    ``ostate``, a dict {module: chan_max (in,)} of this layer's dynamic
    outlier state (quant/dynamic.py), sends each module it holds through
    the adaptive mixed linear when that module's algo at this S is a mix
    algo (prefill chunks; decode steps, weight-only at S <= 4, pass the
    state through), and receives the updated state in place.

    ``lora_ids`` (B,) int selects each lane's runtime LoRA adapter (0 = the
    base model) on every module that carries ``lora_A`` (N+1, in, R) /
    ``lora_B`` (N+1, R, out) (convert/lora.attach_lora): the delta (h A) B,
    two f32 batched products, is cast to the linear's output dtype and
    added to it."""
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

    def proj_in(mod, norm_key, x_res, shared_h=None):
        h = shared_h
        if h is None and not cfg.pre_block_norms:
            h = x_res           # OLMo-2: the projection reads the residual
        if h is None and (stats is not None or adaptive(mod)
                          or has_lora(mod) or cfg.norm_type != "rmsnorm"):
            h = block_norm(cfg, x_res, lp[norm_key])
        if stats is not None:
            stats[mod] = _absmax_in(h)
        if h is None:
            return dispatch.norm_linear(lp[mod], x_res, algo(mod),
                                        lp[norm_key]["w"],
                                        eps=cfg.rms_norm_eps)
        return lora(mod, h, linear(mod, h))

    def res(base, delta):
        if cfg.residual_multiplier != 1.0:
            delta = delta.float() * cfg.residual_multiplier
        return base + delta.to(base.dtype)

    shared_h = None
    if cfg.parallel_blocks and cfg.shared_block_norm:
        shared_h = block_norm(cfg, x, lp["input_norm"])

    qkv = proj_in("qkv_proj", "input_norm", x, shared_h)
    if cfg.clip_qkv:
        qkv = qkv.clamp(-cfg.clip_qkv, cfg.clip_qkv)
    q, k, v = torch.split(qkv, [cfg.q_size, cfg.kv_size, cfg.kv_size],
                          dim=-1)
    if cfg.qk_norm and cfg.qk_norm_flat:
        q = ops_ref.rmsnorm(q, lp["q_norm"]["w"], cfg.rms_norm_eps)
        k = ops_ref.rmsnorm(k, lp["k_norm"]["w"], cfg.rms_norm_eps)
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm and not cfg.qk_norm_flat:
        q = ops_ref.rmsnorm(q, lp["q_norm"]["w"], cfg.rms_norm_eps)
        k = ops_ref.rmsnorm(k, lp["k_norm"]["w"], cfg.rms_norm_eps)
    if sin is not None:
        q = _apply_positional(cfg, q, sin, cos)
        k = _apply_positional(cfg, k, sin, cos)
    attn_in = attend(q, k, v).reshape(b, s, cfg.q_size)
    if stats is not None:
        stats["o_proj"] = _absmax_in(attn_in)
    attn = lora("o_proj", attn_in, linear("o_proj", attn_in))
    if cfg.post_block_norms:
        attn = block_norm(cfg, attn, lp["post_attn_norm"])

    if cfg.parallel_blocks:
        mlp_res, mlp_shared = x, shared_h      # the mlp reads the input
    else:
        x = res(x, attn)
        mlp_res, mlp_shared = x, None
    mlp_norm = "input_norm" if cfg.shared_block_norm else "post_norm"
    if cfg.num_experts:
        # the expert block (models/moe.py) on the normed input; its stats
        # record that shared input for gate_up and down (JAX :947-955)
        h_in = mlp_shared if mlp_shared is not None else block_norm(
            cfg, mlp_res, lp[mlp_norm])
        if stats is not None:
            stats["gate_up_proj"] = stats["down_proj"] = _absmax_in(h_in)
        h = moe_mod.moe_mlp(cfg, lp["moe"], h_in)
    else:
        up_out = proj_in("gate_up_proj", mlp_norm, mlp_res, mlp_shared)
        if cfg.mlp_type == "gated":
            gate, up = torch.chunk(up_out, 2, dim=-1)
            h = (_act(cfg.hidden_act, gate) * up.float()).to(x.dtype)
        else:
            h = _act(cfg.hidden_act, up_out).to(x.dtype)
        if stats is not None:
            stats["down_proj"] = _absmax_in(h)
        h = lora("down_proj", h, dispatch.linear(lp["down_proj"], h,
                                                 algo("down_proj")))
    if cfg.post_block_norms:
        h = block_norm(cfg, h, lp["post_mlp_norm"])
    if cfg.parallel_blocks:
        return res(res(x, attn), h)
    return res(x, h)


def _positional_arrays(cfg: ModelConfig, write_pos: torch.Tensor):
    """(sin, cos, alibi slopes) for the decoder layers; unused slots
    None."""
    if cfg.pos_embedding == "rope":
        sin, cos = rope_sin_cos(write_pos, cfg.rotary_dim or cfg.head_dim,
                                cfg.rope_theta, cfg=cfg)
        return sin, cos, None
    if cfg.pos_embedding == "alibi":
        return None, None, alibi_slopes(cfg.num_heads, write_pos.device)
    return None, None, None


def _embed(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
           write_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token embedding, then the non-rotary positional schemes: Gemma's
    scale (cast to the model dtype first, as HF rounds it), BLOOM's
    embedding LayerNorm, learned positions at ``write_pos`` (+ offset)."""
    x = params["embed"]["w"][tokens.long()].to(cfg.dtype)
    if cfg.embed_scale != 1.0:
        # the scale rounded to the model dtype, then one product rounded
        # once, as the JAX package's x * asarray(scale, dtype)
        x = x * torch.tensor(cfg.embed_scale, dtype=cfg.dtype).item()
    if cfg.embed_norm:
        x = ops_ref.layernorm(x, params["embed_norm"]["w"],
                              params["embed_norm"].get("b"),
                              cfg.rms_norm_eps)
    if cfg.pos_embedding == "learned":
        pos = write_pos.long() + cfg.learned_pos_offset
        x = x + params["pos_embed"]["w"][pos].to(cfg.dtype)
    return x


def _head(params: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm + LM head (tied or separate, optional bias); f32 logits,
    Cohere/Granite's logit scale and Gemma-2's final softcap applied."""
    x = block_norm(cfg, x, params["final_norm"])
    lm_head = params.get("lm_head")
    if lm_head is None:
        logits = ops_ref.bf16_matmul_f32(x, params["embed"]["w"].T)
    else:
        logits = dispatch.linear(lm_head, x, cfg.module_algo("lm_head"))
    logits = logits.float()
    if cfg.logit_scale != 1.0:
        logits = logits * cfg.logit_scale
    if cfg.final_logit_softcap:
        cap = cfg.final_logit_softcap
        logits = torch.tanh(logits / cap) * cap
    return logits


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
    window/sink: StreamingLLM window in tokens (0 = each layer's own:
    ``layer_window``, else ``sliding_window``);
    last_pos: optional (B,) chunk-relative index — the head then runs on
    that one position per lane and returns (B, 1, V) logits;
    outlier_state: quant.dynamic.init_model_state's dict, threaded through
    the layers' adaptive mix linears (``decoder_layer``); lora_ids: (B,)
    runtime LoRA adapter per lane (``decoder_layer``).
    Returns (logits f32, paged_state[, new outlier_state]).
    The recurrent-state models are refused: their state has nothing to
    page."""
    if cfg.arch in RECURRENT_ARCHS:
        raise NotImplementedError(
            f"{cfg.arch} carries recurrent state: use GenerationSession "
            "(the dense path); the paged path has nothing to page")
    _pattern_period(cfg)
    x = _embed(params, cfg, tokens, write_pos)
    sin, cos, alibi = _positional_arrays(cfg, write_pos)
    num_layers = len(params["layers"])
    nb = paged_state.k.shape[0] // num_layers
    pools = paged_state.pools()
    new_ostate = []
    for li, lp in enumerate(params["layers"]):
        attend = partial(_attention_paged, cfg, pools=pools,
                         block_table=block_table + li * nb,
                         write_pos=write_pos, kv_valid_len=kv_valid_len,
                         block_pos=block_pos, window=window, sink=sink,
                         layer_window=_layer_window(cfg, li), alibi=alibi)
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
    (B, S) the tokens' true positions for RoPE and learned positions where
    they differ from their cache slots ``write_pos``; return_hidden: also
    return the pre-final-norm hidden (B, S, H) as the last element, never
    cut by last_pos.
    Returns (logits f32, cache[, new outlier_state][, stats][, hidden]).

    A recurrent-state model (``RECURRENT_ARCHS``) runs its own module's
    forward over its state, updated in place; of the options it takes
    full_prefill and last_pos, and refuses the others, as the JAX package
    asserts."""
    if cfg.arch in RECURRENT_ARCHS:
        asked = [name for name, on in (
            ("collect_stats", collect_stats),
            ("outlier_state", outlier_state is not None),
            ("lora_ids", lora_ids is not None),
            ("attn_mask", attn_mask is not None),
            ("return_hidden", return_hidden),
            ("rope_pos", rope_pos is not None)) if on]
        if asked:
            raise NotImplementedError(
                f"{cfg.arch}: the recurrent-state forward does not support "
                f"{', '.join(asked)}")
        from . import mamba, recurrentgemma
        mod = mamba if cfg.arch == "mamba" else recurrentgemma
        return mod.forward(params, cfg, tokens, write_pos, cache,
                           kv_valid_len, full_prefill=full_prefill,
                           last_pos=last_pos)
    _pattern_period(cfg)
    pos = write_pos if rope_pos is None else rope_pos
    x = _embed(params, cfg, tokens, pos)
    sin, cos, alibi = _positional_arrays(cfg, pos)
    layer_stats, new_ostate = [], []
    for li, lp in enumerate(params["layers"]):
        layer_cache = {"k": cache.k[li], "v": cache.v[li]}
        if cache.quantized:
            layer_cache.update(k_scale=cache.k_scale[li],
                               v_scale=cache.v_scale[li])
        attend = partial(_attention_with_cache, cfg, layer_cache=layer_cache,
                         write_pos=write_pos, kv_valid_len=kv_valid_len,
                         full_prefill=full_prefill, attn_mask=attn_mask,
                         alibi=alibi, window=_layer_window(cfg, li))
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
