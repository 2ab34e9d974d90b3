"""The dense decoder families beyond the Llama lineage: OPT, GPT-2, GPT-J,
GPT-NeoX, Falcon, BLOOM, MPT, Phi, Phi-3, Gemma, Gemma-2, Qwen3, GLM /
GLM-4, OLMo-2, Cohere (Command-R), Granite, Baichuan, GPT-BigCode,
StarCoder2 and StableLM. Counterpart of mixq_tensorrt_llm_tpu/models/
families.py.

There is one decoder (models/common.decoder_layer) driven by ModelConfig
axes; each family is a config translation plus a mapping of its HF state
dict into the uniform fused-QKV params schema. Quantization routing is
shared with models/llama.py (qkv / gate_up / o mix, down weight-only).
``params_from_hf`` takes the state dict as stored (file dtype, (out, in),
memory-mapped) and brings one layer at a time to the device, upcast to f32
there, as models/llama.params_from_hf does.

How HF fuses QKV, by family:
- gpt_neox / bloom / old Falcon MHA: rows interleaved per head as
  (H, [q|k|v], D)
- Falcon's new decoder architecture: grouped (n_kv, [q*g|k|v], D)
- Falcon multi-query (7B), MPT Wqkv, Baichuan W_pack, GPT-BigCode c_attn:
  contiguous [q, k, v]
- GPT-2 c_attn: Conv1D, (in, 3*out) already the kernel layout

The expert models ``dbrx``, ``qwen2_moe`` and ``qwen3_moe`` are read here
too (their expert stacks, router and Qwen2-MoE's shared expert), their MLP
served by models/moe.py; stacks that mix dense and expert layers are
refused, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..ops import dispatch
from ..quant.config import QuantConfig
from .common import ModelConfig
from .llama import LINEAR_MODULES, act_scale_for, quantize_moe, \
    random_experts

# a layer's float expert entries (models/llama.quantize_moe takes them)
_MOE_RAW = ("router_w", "experts_gate_up", "experts_down",
            "shared_gate_up_w", "shared_down_w", "shared_gate_w")

Lin = Tuple[torch.Tensor, Optional[torch.Tensor]]


def _f32(w: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return w.to(dev).float()


def _t(w: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """HF (out, in) -> the (in, out) kernel layout, f32, contiguous."""
    return w.to(dev).t().to(torch.float32,
                            memory_format=torch.contiguous_format)


def _norm(hf: Mapping, base: str, dev: torch.device) -> Dict:
    out = {"w": _f32(hf[base + ".weight"], dev)}
    if base + ".bias" in hf:
        out["b"] = _f32(hf[base + ".bias"], dev)
    return out


def _lin(hf: Mapping, base: str, dev: torch.device) -> Lin:
    b = _f32(hf[base + ".bias"], dev) if base + ".bias" in hf else None
    return _t(hf[base + ".weight"], dev), b


def _cat(parts, biases) -> Lin:
    w = torch.cat(parts, dim=1)
    b = None
    if any(x is not None for x in biases):
        b = torch.cat([x if x is not None else
                       torch.zeros(p.shape[1], dtype=p.dtype,
                                   device=p.device)
                       for x, p in zip(biases, parts)])
    return w, b


def _cat_lins(hf: Mapping, bases, dev: torch.device) -> Lin:
    return _cat(*zip(*[_lin(hf, b, dev) for b in bases]))


def _split_interleaved_qkv(w: torch.Tensor, b, num_heads: int,
                           head_dim: int) -> Lin:
    """(3*H*D, in) rows ordered (H, [q|k|v], D) -> the fused (in, out)
    kernel-layout qkv."""
    nin = w.shape[1]
    w3 = w.reshape(num_heads, 3, head_dim, nin)
    parts = [w3[:, j].reshape(num_heads * head_dim, nin).t()
             for j in range(3)]
    bs = [None] * 3
    if b is not None:
        b3 = b.reshape(num_heads, 3, head_dim)
        bs = [b3[:, j].reshape(-1) for j in range(3)]
    return _cat(parts, bs)


def _split_grouped_qkv(w: torch.Tensor, b, num_kv: int, q_per_group: int,
                       head_dim: int) -> Lin:
    """Falcon new_decoder_architecture rows (n_kv, [q*g|k|v], D)."""
    nin, g = w.shape[1], q_per_group
    w4 = w.reshape(num_kv, g + 2, head_dim, nin)
    q = w4[:, :g].reshape(num_kv * g * head_dim, nin).t()
    k = w4[:, g].reshape(num_kv * head_dim, nin).t()
    v = w4[:, g + 1].reshape(num_kv * head_dim, nin).t()
    bs = [None] * 3
    if b is not None:
        b4 = b.reshape(num_kv, g + 2, head_dim)
        bs = [b4[:, :g].reshape(-1), b4[:, g].reshape(-1),
              b4[:, g + 1].reshape(-1)]
    return _cat([q, k, v], bs)


# ---------------------------------------------------------------------------
# Config translation
# ---------------------------------------------------------------------------

def _heads(c, g) -> dict:
    """The head geometry of the HF configs that name their fields as the
    Llama lineage does."""
    return dict(vocab_size=c.vocab_size, hidden_size=c.hidden_size,
                intermediate_size=c.intermediate_size,
                num_layers=c.num_hidden_layers,
                num_heads=c.num_attention_heads,
                num_kv_heads=g("num_key_value_heads")
                or c.num_attention_heads,
                head_dim=g("head_dim") or (c.hidden_size
                                           // c.num_attention_heads),
                max_position_embeddings=c.max_position_embeddings,
                rope_theta=g("rope_theta", 10000.0))


def _longrope(c, g) -> dict:
    """Phi-3's longrope: the long or short per-dim factor set, chosen once
    by whether the served context exceeds the original window, and the
    cos/sin attention factor (JAX families.py phi3)."""
    rs = g("rope_scaling")
    if rs is None:
        return {}
    kind = rs.get("rope_type", rs.get("type"))
    if kind != "longrope":
        raise NotImplementedError(f"phi3 rope_scaling {kind!r} unsupported "
                                  "(longrope is)")
    orig = g("original_max_position_embeddings") or c.max_position_embeddings
    factor = c.max_position_embeddings / orig
    ext = rs["long_factor"] if c.max_position_embeddings > orig \
        else rs["short_factor"]
    af = rs.get("attention_factor")
    if af is None:
        af = 1.0 if factor <= 1.0 else math.sqrt(
            1 + math.log(factor) / math.log(orig))
    return dict(rope_scaling_type="longrope",
                rope_freq_factors=tuple(float(x) for x in ext),
                rope_attention_factor=float(af))


def _dbrx_config(c, g, quant: QuantConfig) -> ModelConfig:
    """DBRX (HF DbrxConfig): the nested attn / ffn configs (objects from
    AutoConfig, dicts from load_hf_config), the fused Wqkv clamped to
    +-clip_qkv, bias-free LayerNorms, a GLU expert MLP whose router
    renormalizes with p = 1 (Mixtral's sum)."""
    def sub(name):
        v = g(name) or {}
        return v.get if isinstance(v, dict) else \
            (lambda k, d=None: getattr(v, k, d))
    ac, fc = sub("attn_config"), sub("ffn_config")
    act = fc("ffn_act_fn") or {}
    if act.get("name", "silu") != "silu":
        raise NotImplementedError(f"DBRX ffn_act_fn {act} unsupported "
                                  "(silu is)")
    p = fc("moe_normalize_expert_weights", 1.0)
    if p not in (None, 1, 1.0):
        raise NotImplementedError(f"only p=1 (sum) router renormalization "
                                  f"is supported, got {p}")
    h = c.n_heads
    return ModelConfig(
        arch="dbrx", vocab_size=c.vocab_size, hidden_size=c.d_model,
        intermediate_size=fc("ffn_hidden_size"), num_layers=c.n_layers,
        num_heads=h, num_kv_heads=ac("kv_n_heads", h),
        head_dim=c.d_model // h, max_position_embeddings=c.max_seq_len,
        rope_theta=ac("rope_theta", 10000.0), rms_norm_eps=1e-5,
        norm_type="layernorm", clip_qkv=ac("clip_qkv", 0.0) or 0.0,
        num_experts=fc("moe_num_experts"), top_k_experts=fc("moe_top_k"),
        moe_norm_topk=p is not None,
        tie_word_embeddings=g("tie_word_embeddings", False), quant=quant)


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()
                   ) -> ModelConfig:
    """An HF config (``AutoConfig`` or ``convert.hf.load_hf_config``) of a
    dense family or of DBRX / Qwen2-MoE / Qwen3-MoE -> ModelConfig, read as
    the JAX package reads it."""
    c = hf_config
    mt = c.model_type.lower()

    def g(name, d=None):
        return getattr(c, name, d)

    if mt == "dbrx":
        return _dbrx_config(c, g, quant)
    if mt in ("qwen2_moe", "qwen3_moe"):
        # every layer sparse (HF Qwen2MoeSparseMoeBlock /
        # Qwen3MoeSparseMoeBlock): qwen2_moe adds the sigmoid-gated shared
        # expert and qkv biases, qwen3_moe per-head q/k norms
        if g("mlp_only_layers") or (g("decoder_sparse_step", 1) or 1) != 1:
            raise NotImplementedError(
                "mixed dense/MoE layer stacks are not supported")
        return ModelConfig(
            arch=mt, **_heads(c, g), rms_norm_eps=c.rms_norm_eps,
            num_experts=c.num_experts, top_k_experts=c.num_experts_per_tok,
            moe_norm_topk=bool(g("norm_topk_prob", False)),
            moe_intermediate=g("moe_intermediate_size", 0) or 0,
            moe_shared_intermediate=(
                g("shared_expert_intermediate_size", 0) or 0
                if mt == "qwen2_moe" else 0),
            qkv_bias=(mt == "qwen2_moe"), qk_norm=(mt == "qwen3_moe"),
            sliding_window=(g("sliding_window", 0) or 0)
            if g("use_sliding_window", False) else 0,
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant)
    if mt == "opt":
        if not g("do_layer_norm_before", True):
            raise NotImplementedError("OPT-350m's post-norm variant is "
                                      "unsupported")
        if g("word_embed_proj_dim", c.hidden_size) != c.hidden_size:
            raise NotImplementedError("OPT's embedding projection is "
                                      "unsupported")
        return ModelConfig(
            arch="opt", vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            intermediate_size=c.ffn_dim, num_layers=c.num_hidden_layers,
            num_heads=c.num_attention_heads,
            num_kv_heads=c.num_attention_heads,
            head_dim=c.hidden_size // c.num_attention_heads,
            max_position_embeddings=c.max_position_embeddings,
            rms_norm_eps=1e-5, norm_type="layernorm",
            pos_embedding="learned", learned_pos_offset=2,
            mlp_type="dense", hidden_act=g("activation_function", "relu"),
            qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_word_embeddings=g("tie_word_embeddings", True), quant=quant)
    if mt in ("gpt2", "gpt_bigcode"):
        inner = g("n_inner") or 4 * c.n_embd
        mqa = mt == "gpt_bigcode" and g("multi_query", True)
        return ModelConfig(
            arch=mt, vocab_size=c.vocab_size, hidden_size=c.n_embd,
            intermediate_size=inner, num_layers=c.n_layer,
            num_heads=c.n_head, num_kv_heads=1 if mqa else c.n_head,
            head_dim=c.n_embd // c.n_head,
            max_position_embeddings=c.n_positions,
            rms_norm_eps=g("layer_norm_epsilon", 1e-5),
            norm_type="layernorm", pos_embedding="learned",
            mlp_type="dense",
            hidden_act=g("activation_function",
                         "gelu_new" if mt == "gpt2" else "gelu_pytorch_tanh"),
            qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_word_embeddings=True, quant=quant)
    if mt == "gptj":
        return ModelConfig(
            arch="gptj", vocab_size=c.vocab_size, hidden_size=c.n_embd,
            intermediate_size=g("n_inner") or 4 * c.n_embd,
            num_layers=c.n_layer, num_heads=c.n_head, num_kv_heads=c.n_head,
            head_dim=c.n_embd // c.n_head,
            max_position_embeddings=c.n_positions,
            rms_norm_eps=g("layer_norm_epsilon", 1e-5),
            norm_type="layernorm", rotary_dim=g("rotary_dim") or 0,
            rope_interleaved=True, parallel_blocks=True,
            shared_block_norm=True, mlp_type="dense",
            hidden_act=g("activation_function", "gelu_new"),
            mlp_bias=True, lm_head_bias=True, quant=quant)
    if mt == "gpt_neox":
        head_dim = c.hidden_size // c.num_attention_heads
        return ModelConfig(
            arch="gpt_neox", vocab_size=c.vocab_size,
            hidden_size=c.hidden_size, intermediate_size=c.intermediate_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            num_kv_heads=c.num_attention_heads, head_dim=head_dim,
            max_position_embeddings=c.max_position_embeddings,
            rope_theta=g("rotary_emb_base", 10000.0),
            rms_norm_eps=g("layer_norm_eps", 1e-5), norm_type="layernorm",
            rotary_dim=int(head_dim * g("rotary_pct", 0.25)),
            parallel_blocks=bool(g("use_parallel_residual", True)),
            mlp_type="dense", hidden_act=g("hidden_act", "gelu"),
            qkv_bias=True, attn_out_bias=True, mlp_bias=True, quant=quant)
    if mt in ("falcon", "refinedweb", "refinedwebmodel"):
        h = c.num_attention_heads
        new_arch = g("new_decoder_architecture", False)
        if new_arch:
            n_kv = g("num_kv_heads") or h
        else:
            n_kv = 1 if g("multi_query", True) else h
        parallel = bool(g("parallel_attn", True))
        bias = bool(g("bias", False))
        return ModelConfig(
            arch="falcon", vocab_size=c.vocab_size,
            hidden_size=c.hidden_size,
            intermediate_size=g("ffn_hidden_size") or 4 * c.hidden_size,
            num_layers=c.num_hidden_layers, num_heads=h, num_kv_heads=n_kv,
            head_dim=c.hidden_size // h,
            max_position_embeddings=g("max_position_embeddings", 2048),
            rope_theta=g("rope_theta", 10000.0),
            rms_norm_eps=g("layer_norm_epsilon", 1e-5),
            norm_type="layernorm",
            pos_embedding="alibi" if g("alibi", False) else "rope",
            parallel_blocks=parallel,
            shared_block_norm=parallel and not new_arch,
            mlp_type="dense", hidden_act=g("activation", "gelu"),
            qkv_bias=bias, attn_out_bias=bias, mlp_bias=bias,
            tie_word_embeddings=True, quant=quant)
    if mt == "bloom":
        h = c.n_head
        return ModelConfig(
            arch="bloom", vocab_size=c.vocab_size, hidden_size=c.hidden_size,
            intermediate_size=4 * c.hidden_size, num_layers=c.n_layer,
            num_heads=h, num_kv_heads=h, head_dim=c.hidden_size // h,
            max_position_embeddings=g("seq_length", 2048),
            rms_norm_eps=g("layer_norm_epsilon", 1e-5),
            norm_type="layernorm", pos_embedding="alibi", embed_norm=True,
            mlp_type="dense", hidden_act="gelu_tanh",
            qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            tie_word_embeddings=True, quant=quant)
    if mt == "mpt":
        attn_cfg = g("attn_config", None)
        if isinstance(attn_cfg, dict):
            alibi = bool(attn_cfg.get("alibi", True))
        else:
            alibi = bool(getattr(attn_cfg, "alibi", True)) \
                if attn_cfg is not None else True
        with_bias = not bool(g("no_bias", True))
        return ModelConfig(
            arch="mpt", vocab_size=c.vocab_size, hidden_size=c.d_model,
            intermediate_size=int(g("expansion_ratio", 4) * c.d_model),
            num_layers=c.n_layers, num_heads=c.n_heads,
            num_kv_heads=c.n_heads, head_dim=c.d_model // c.n_heads,
            max_position_embeddings=g("max_seq_len", 2048),
            rms_norm_eps=g("layer_norm_epsilon", 1e-5),
            norm_type="layernorm",
            pos_embedding="alibi" if alibi else "learned",
            mlp_type="dense", hidden_act="gelu", qkv_bias=with_bias,
            attn_out_bias=with_bias, mlp_bias=with_bias,
            tie_word_embeddings=True, quant=quant)
    if mt == "phi":
        head_dim = c.hidden_size // c.num_attention_heads
        return ModelConfig(
            arch="phi", **dict(_heads(c, g), head_dim=head_dim),
            rms_norm_eps=g("layer_norm_eps", 1e-5), norm_type="layernorm",
            rotary_dim=int(head_dim * g("partial_rotary_factor", 0.5)),
            parallel_blocks=True, shared_block_norm=True,
            mlp_type="dense", hidden_act=g("hidden_act", "gelu_new"),
            qkv_bias=True, attn_out_bias=True, mlp_bias=True,
            lm_head_bias=True, quant=quant)
    if mt == "phi3":
        head_dim = c.hidden_size // c.num_attention_heads
        prf = g("partial_rotary_factor", 1.0)
        return ModelConfig(
            arch="phi3", **dict(_heads(c, g), head_dim=head_dim),
            rms_norm_eps=c.rms_norm_eps,
            rotary_dim=int(head_dim * prf) if prf != 1.0 else 0,
            sliding_window=g("sliding_window", 0) or 0,
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant, **_longrope(c, g))
    if mt in ("gemma", "gemma2"):
        extra = {}
        if mt == "gemma2":
            extra = dict(
                attn_scale=float(g("query_pre_attn_scalar", 256)) ** -0.5,
                attn_logit_softcap=g("attn_logit_softcapping", 0.0) or 0.0,
                final_logit_softcap=g("final_logit_softcapping", 0.0) or 0.0,
                post_block_norms=True,
                # even layers sliding, odd global (HF Gemma2: is_sliding =
                # not bool(layer_idx % 2))
                sliding_window=g("sliding_window", 0) or 0,
                sliding_window_pattern=2)
            act = g("hidden_activation", "gelu_pytorch_tanh")
        else:
            act = g("hidden_activation") or g("hidden_act") or "gelu_tanh"
        return ModelConfig(
            arch=mt, **_heads(c, g), rms_norm_eps=c.rms_norm_eps,
            hidden_act=act, embed_scale=float(c.hidden_size) ** 0.5,
            tie_word_embeddings=True, quant=quant, **extra)
    if mt == "qwen3":
        return ModelConfig(
            arch="qwen3", **_heads(c, g), rms_norm_eps=c.rms_norm_eps,
            qk_norm=True,
            sliding_window=(g("sliding_window", 0) or 0)
            if g("use_sliding_window", False) else 0,
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant)
    if mt in ("glm", "glm4"):
        heads = _heads(c, g)
        return ModelConfig(
            arch=mt, **heads, rms_norm_eps=c.rms_norm_eps,
            rotary_dim=int(heads["head_dim"]
                           * g("partial_rotary_factor", 0.5)),
            rope_interleaved=True, qkv_bias=g("attention_bias", True),
            post_block_norms=(mt == "glm4"),
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant)
    if mt == "olmo2":
        return ModelConfig(
            arch="olmo2", **_heads(c, g), rms_norm_eps=c.rms_norm_eps,
            pre_block_norms=False, post_block_norms=True,
            qk_norm=True, qk_norm_flat=True,
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant)
    if mt == "cohere":
        return ModelConfig(
            arch="cohere", **_heads(c, g),
            rms_norm_eps=g("layer_norm_eps", 1e-5), norm_type="layernorm",
            rope_interleaved=True, parallel_blocks=True,
            shared_block_norm=True, qkv_bias=g("attention_bias", False),
            attn_out_bias=g("attention_bias", False),
            logit_scale=g("logit_scale", 1.0),
            tie_word_embeddings=True, quant=quant)
    if mt == "granite":
        return ModelConfig(
            arch="granite", **_heads(c, g), rms_norm_eps=c.rms_norm_eps,
            embed_scale=g("embedding_multiplier", 1.0),
            residual_multiplier=g("residual_multiplier", 1.0),
            attn_scale=g("attention_multiplier", 0.0) or 0.0,
            logit_scale=1.0 / g("logits_scaling", 1.0),
            qkv_bias=g("attention_bias", False),
            attn_out_bias=g("attention_bias", False),
            mlp_bias=g("mlp_bias", False),
            tie_word_embeddings=g("tie_word_embeddings", False),
            quant=quant)
    if mt == "starcoder2":
        use_bias = bool(g("use_bias", True))
        return ModelConfig(
            arch="starcoder2",
            **dict(_heads(c, g),
                   head_dim=c.hidden_size // c.num_attention_heads),
            rms_norm_eps=g("norm_epsilon", 1e-5), norm_type="layernorm",
            mlp_type="dense", hidden_act=g("hidden_act",
                                           "gelu_pytorch_tanh"),
            qkv_bias=use_bias, attn_out_bias=use_bias, mlp_bias=use_bias,
            tie_word_embeddings=g("tie_word_embeddings", True), quant=quant)
    if mt == "stablelm":
        head_dim = c.hidden_size // c.num_attention_heads
        return ModelConfig(
            arch="stablelm", **dict(_heads(c, g), head_dim=head_dim),
            rms_norm_eps=g("layer_norm_eps", 1e-5), norm_type="layernorm",
            rotary_dim=int(head_dim * g("partial_rotary_factor", 0.25)),
            hidden_act=g("hidden_act", "silu"),
            qkv_bias=bool(g("use_qkv_bias", False)), quant=quant)
    if mt == "baichuan":
        # 7B ships RoPE, 13B ALiBi (the released geometries; the config
        # carries no explicit flag)
        alibi = g("position_embedding", None) == "alibi" or \
            c.hidden_size >= 5120
        return ModelConfig(
            arch="baichuan", vocab_size=c.vocab_size,
            hidden_size=c.hidden_size, intermediate_size=c.intermediate_size,
            num_layers=c.num_hidden_layers, num_heads=c.num_attention_heads,
            num_kv_heads=c.num_attention_heads,
            head_dim=c.hidden_size // c.num_attention_heads,
            max_position_embeddings=g("max_position_embeddings", 4096),
            rms_norm_eps=c.rms_norm_eps,
            pos_embedding="alibi" if alibi else "rope",
            tie_word_embeddings=g("tie_word_embeddings", False), quant=quant)
    raise ValueError(f"families.config_from_hf: unknown model_type {mt!r}")


# ---------------------------------------------------------------------------
# Weights: HF state dict -> uniform float layer dicts
# ---------------------------------------------------------------------------

def _gemma_norms(fl: Dict, keys) -> Dict:
    """Gemma's RMSNorm is x * (1 + w): the +1 folded into the stored weight
    so the shared decoder's plain RMSNorm applies unchanged."""
    for k in keys:
        fl[k] = {"w": fl[k]["w"] + 1.0}
    return fl


def _llama_like(hf: Mapping, p: str, dev, gate_up: str = "split",
                norms=("input_layernorm", "post_attention_layernorm")
                ) -> Dict:
    """The Llama-lineage naming (model.layers.{i}.self_attn.{q,k,v,o}_proj,
    mlp.{gate,up,down}_proj, two norms)."""
    fl = {"qkv_proj": _cat_lins(hf, [p + f"self_attn.{n}_proj"
                                     for n in "qkv"], dev),
          "o_proj": _lin(hf, p + "self_attn.o_proj", dev),
          "down_proj": _lin(hf, p + "mlp.down_proj", dev)}
    if gate_up == "split":
        fl["gate_up_proj"] = _cat_lins(hf, [p + "mlp.gate_proj",
                                            p + "mlp.up_proj"], dev)
    else:                 # HF stores it fused already, gate first
        fl["gate_up_proj"] = _lin(hf, p + "mlp.gate_up_proj", dev)
    for key, name in zip(("input_norm", "post_norm"), norms):
        if name is not None:
            fl[key] = _norm(hf, p + name, dev)
    return fl


def _float_layer(cfg: ModelConfig, hf: Mapping, i: int,
                 dev: torch.device) -> Dict:
    """Layer i's float weights: {module: (w (in, out) f32, bias or None),
    norm: {"w"[, "b"]} f32} on ``dev``."""
    a = cfg.arch
    if a == "opt":
        p = f"model.decoder.layers.{i}."
        return {
            "qkv_proj": _cat_lins(hf, [p + f"self_attn.{n}_proj"
                                       for n in "qkv"], dev),
            "o_proj": _lin(hf, p + "self_attn.out_proj", dev),
            "gate_up_proj": _lin(hf, p + "fc1", dev),
            "down_proj": _lin(hf, p + "fc2", dev),
            "input_norm": _norm(hf, p + "self_attn_layer_norm", dev),
            "post_norm": _norm(hf, p + "final_layer_norm", dev)}
    if a == "gpt2":
        p = f"transformer.h.{i}."

        def conv1d(base):            # already (in, out)
            return (_f32(hf[base + ".weight"], dev),
                    _f32(hf[base + ".bias"], dev))
        return {
            "qkv_proj": conv1d(p + "attn.c_attn"),
            "o_proj": conv1d(p + "attn.c_proj"),
            "gate_up_proj": conv1d(p + "mlp.c_fc"),
            "down_proj": conv1d(p + "mlp.c_proj"),
            "input_norm": _norm(hf, p + "ln_1", dev),
            "post_norm": _norm(hf, p + "ln_2", dev)}
    if a == "gptj":
        p = f"transformer.h.{i}."
        return {
            "qkv_proj": _cat_lins(hf, [p + f"attn.{n}_proj" for n in "qkv"],
                                  dev),
            "o_proj": _lin(hf, p + "attn.out_proj", dev),
            "gate_up_proj": _lin(hf, p + "mlp.fc_in", dev),
            "down_proj": _lin(hf, p + "mlp.fc_out", dev),
            "input_norm": _norm(hf, p + "ln_1", dev)}
    if a in ("gpt_neox", "bloom", "falcon"):
        if a == "gpt_neox":
            p, attn = f"gpt_neox.layers.{i}.", "attention."
        else:
            p, attn = f"transformer.h.{i}.", "self_attention."
        w = _f32(hf[p + attn + "query_key_value.weight"], dev)
        bname = p + attn + "query_key_value.bias"
        b = _f32(hf[bname], dev) if bname in hf else None
        if a != "falcon" or (cfg.num_kv_heads == cfg.num_heads
                             and w.shape[0] == 3 * cfg.hidden_size
                             and not cfg.parallel_blocks):
            qkv = _split_interleaved_qkv(w, b, cfg.num_heads, cfg.head_dim)
        elif cfg.num_kv_heads == 1:
            qkv = (w.t().contiguous(), b)
        else:
            qkv = _split_grouped_qkv(w, b, cfg.num_kv_heads,
                                     cfg.num_heads // cfg.num_kv_heads,
                                     cfg.head_dim)
        out = {"qkv_proj": qkv,
               "o_proj": _lin(hf, p + attn + "dense", dev),
               "gate_up_proj": _lin(hf, p + "mlp.dense_h_to_4h", dev),
               "down_proj": _lin(hf, p + "mlp.dense_4h_to_h", dev)}
        if p + "ln_attn.weight" in hf:       # Falcon's new decoder
            out["input_norm"] = _norm(hf, p + "ln_attn", dev)
            out["post_norm"] = _norm(hf, p + "ln_mlp", dev)
        else:
            out["input_norm"] = _norm(hf, p + "input_layernorm", dev)
            if p + "post_attention_layernorm.weight" in hf:
                out["post_norm"] = _norm(hf, p + "post_attention_layernorm",
                                         dev)
        return out
    if a == "dbrx":
        p = f"transformer.blocks.{i}."
        e, ffn, d = cfg.num_experts, cfg.intermediate_size, cfg.hidden_size
        # DbrxExpertGLU keeps w1 / v1 / w2 flat (E * ffn, d): w1 and v1
        # multiply as x @ w.T, w2 as (x1 * x2) @ w2, already (ffn, d)
        x = p + "ffn.experts.mlp."
        w1, v1, w2 = (_f32(hf[x + n], dev).reshape(e, ffn, d)
                      for n in ("w1", "v1", "w2"))
        return {
            "qkv_proj": _lin(hf, p + "norm_attn_norm.attn.Wqkv", dev),
            "o_proj": _lin(hf, p + "norm_attn_norm.attn.out_proj", dev),
            "input_norm": _norm(hf, p + "norm_attn_norm.norm_1", dev),
            "post_norm": _norm(hf, p + "norm_attn_norm.norm_2", dev),
            "router_w": _t(hf[p + "ffn.router.layer.weight"], dev),
            "experts_gate_up": torch.cat([w1.transpose(1, 2),
                                          v1.transpose(1, 2)],
                                         dim=2).contiguous(),
            "experts_down": w2.contiguous()}
    if a == "mpt":
        p = f"transformer.blocks.{i}."
        return {"qkv_proj": _lin(hf, p + "attn.Wqkv", dev),
                "o_proj": _lin(hf, p + "attn.out_proj", dev),
                "gate_up_proj": _lin(hf, p + "ffn.up_proj", dev),
                "down_proj": _lin(hf, p + "ffn.down_proj", dev),
                "input_norm": _norm(hf, p + "norm_1", dev),
                "post_norm": _norm(hf, p + "norm_2", dev)}
    p = f"model.layers.{i}."
    if a == "phi":
        return {
            "qkv_proj": _cat_lins(hf, [p + f"self_attn.{n}_proj"
                                       for n in "qkv"], dev),
            "o_proj": _lin(hf, p + "self_attn.dense", dev),
            "gate_up_proj": _lin(hf, p + "mlp.fc1", dev),
            "down_proj": _lin(hf, p + "mlp.fc2", dev),
            "input_norm": _norm(hf, p + "input_layernorm", dev)}
    if a == "phi3":
        # HF Phi-3 ships qkv and gate_up fused, in the port's ordering
        return {"qkv_proj": _lin(hf, p + "self_attn.qkv_proj", dev),
                "o_proj": _lin(hf, p + "self_attn.o_proj", dev),
                "gate_up_proj": _lin(hf, p + "mlp.gate_up_proj", dev),
                "down_proj": _lin(hf, p + "mlp.down_proj", dev),
                "input_norm": _norm(hf, p + "input_layernorm", dev),
                "post_norm": _norm(hf, p + "post_attention_layernorm", dev)}
    if a == "gemma":
        return _gemma_norms(_llama_like(hf, p, dev),
                            ("input_norm", "post_norm"))
    if a == "gemma2":
        fl = _llama_like(hf, p, dev, norms=("input_layernorm",
                                            "pre_feedforward_layernorm"))
        fl["post_attn_norm"] = _norm(hf, p + "post_attention_layernorm", dev)
        fl["post_mlp_norm"] = _norm(hf, p + "post_feedforward_layernorm",
                                    dev)
        return _gemma_norms(fl, ("input_norm", "post_norm", "post_attn_norm",
                                 "post_mlp_norm"))
    if a == "qwen3":
        fl = _llama_like(hf, p, dev)
        fl["q_norm"] = _norm(hf, p + "self_attn.q_norm", dev)
        fl["k_norm"] = _norm(hf, p + "self_attn.k_norm", dev)
        return fl
    if a in ("qwen2_moe", "qwen3_moe"):
        m = p + "mlp."
        fl = {"qkv_proj": _cat_lins(hf, [p + f"self_attn.{n}_proj"
                                         for n in "qkv"], dev),
              "o_proj": _lin(hf, p + "self_attn.o_proj", dev),
              "input_norm": _norm(hf, p + "input_layernorm", dev),
              "post_norm": _norm(hf, p + "post_attention_layernorm", dev),
              "router_w": _t(hf[m + "gate.weight"], dev),
              "experts_gate_up": torch.stack([
                  torch.cat([_t(hf[m + f"experts.{e}.gate_proj.weight"],
                                dev),
                             _t(hf[m + f"experts.{e}.up_proj.weight"], dev)],
                            dim=1) for e in range(cfg.num_experts)]),
              "experts_down": torch.stack([
                  _t(hf[m + f"experts.{e}.down_proj.weight"], dev)
                  for e in range(cfg.num_experts)])}
        if a == "qwen3_moe":
            fl["q_norm"] = _norm(hf, p + "self_attn.q_norm", dev)
            fl["k_norm"] = _norm(hf, p + "self_attn.k_norm", dev)
        if cfg.moe_shared_intermediate:
            fl["shared_gate_up_w"] = _cat_lins(
                hf, [m + "shared_expert.gate_proj",
                     m + "shared_expert.up_proj"], dev)
            fl["shared_down_w"] = _lin(hf, m + "shared_expert.down_proj",
                                       dev)
            fl["shared_gate_w"] = _t(hf[m + "shared_expert_gate.weight"],
                                     dev)
        return fl
    if a in ("glm", "glm4"):
        fl = _llama_like(hf, p, dev, gate_up="fused")
        if a == "glm4":
            fl["post_attn_norm"] = _norm(hf, p + "post_self_attn_layernorm",
                                         dev)
            fl["post_mlp_norm"] = _norm(hf, p + "post_mlp_layernorm", dev)
        return fl
    if a == "olmo2":
        fl = _llama_like(hf, p, dev, norms=(None, None))
        fl["post_attn_norm"] = _norm(hf, p + "post_attention_layernorm", dev)
        fl["post_mlp_norm"] = _norm(hf, p + "post_feedforward_layernorm",
                                    dev)
        fl["q_norm"] = _norm(hf, p + "self_attn.q_norm", dev)
        fl["k_norm"] = _norm(hf, p + "self_attn.k_norm", dev)
        return fl
    if a == "cohere":          # ONE shared norm feeds both parallel blocks
        return _llama_like(hf, p, dev, norms=("input_layernorm", None))
    if a in ("granite", "stablelm"):
        return _llama_like(hf, p, dev)
    if a == "gpt_bigcode":
        p = f"transformer.h.{i}."
        return {"qkv_proj": _lin(hf, p + "attn.c_attn", dev),
                "o_proj": _lin(hf, p + "attn.c_proj", dev),
                "gate_up_proj": _lin(hf, p + "mlp.c_fc", dev),
                "down_proj": _lin(hf, p + "mlp.c_proj", dev),
                "input_norm": _norm(hf, p + "ln_1", dev),
                "post_norm": _norm(hf, p + "ln_2", dev)}
    if a == "starcoder2":
        return {
            "qkv_proj": _cat_lins(hf, [p + f"self_attn.{n}_proj"
                                       for n in "qkv"], dev),
            "o_proj": _lin(hf, p + "self_attn.o_proj", dev),
            "gate_up_proj": _lin(hf, p + "mlp.c_fc", dev),
            "down_proj": _lin(hf, p + "mlp.c_proj", dev),
            "input_norm": _norm(hf, p + "input_layernorm", dev),
            "post_norm": _norm(hf, p + "post_attention_layernorm", dev)}
    if a == "baichuan":
        fl = {"qkv_proj": (_t(hf[p + "self_attn.W_pack.weight"], dev), None),
              "o_proj": _lin(hf, p + "self_attn.o_proj", dev),
              "gate_up_proj": _cat_lins(hf, [p + "mlp.gate_proj",
                                             p + "mlp.up_proj"], dev),
              "down_proj": _lin(hf, p + "mlp.down_proj", dev)}
        fl["input_norm"] = _norm(hf, p + "input_layernorm", dev)
        fl["post_norm"] = _norm(hf, p + "post_attention_layernorm", dev)
        return fl
    raise ValueError(f"no layer extractor for arch {cfg.arch!r}")


_TOPLEVEL = {
    # arch: (embed, pos_embed, embed_norm, final_norm, lm_head)
    "opt": ("model.decoder.embed_tokens", "model.decoder.embed_positions",
            None, "model.decoder.final_layer_norm", "lm_head"),
    "gpt2": ("transformer.wte", "transformer.wpe", None, "transformer.ln_f",
             None),
    "gptj": ("transformer.wte", None, None, "transformer.ln_f", "lm_head"),
    "gpt_neox": ("gpt_neox.embed_in", None, None,
                 "gpt_neox.final_layer_norm", "embed_out"),
    "falcon": ("transformer.word_embeddings", None, None, "transformer.ln_f",
               None),
    "bloom": ("transformer.word_embeddings", None,
              "transformer.word_embeddings_layernorm", "transformer.ln_f",
              None),
    "mpt": ("transformer.wte", None, None, "transformer.norm_f", None),
    "dbrx": ("transformer.wte", None, None, "transformer.norm_f",
             "lm_head"),
    "phi": ("model.embed_tokens", None, None, "model.final_layernorm",
            "lm_head"),
    "gpt_bigcode": ("transformer.wte", "transformer.wpe", None,
                    "transformer.ln_f", None),
    **{a: ("model.embed_tokens", None, None, "model.norm", "lm_head")
       for a in ("phi3", "gemma", "gemma2", "qwen3", "glm", "glm4", "olmo2",
                 "cohere", "granite", "baichuan", "starcoder2", "stablelm",
                 "qwen2_moe", "qwen3_moe")},
}


def _quantize_layer(cfg: ModelConfig, fl: Dict, act_scales,
                    i: int) -> Dict:
    """A uniform float layer dict -> quantized params (llama.py's routing;
    an expert layer's ``moe`` through llama.quantize_moe); every other
    entry (the norms) is carried as it is."""
    out: Dict = {k: v for k, v in fl.items()
                 if k not in LINEAR_MODULES and k not in _MOE_RAW}
    if "router_w" in fl:
        out["moe"] = quantize_moe(cfg, fl)
    for mod in LINEAR_MODULES:
        if mod not in fl:
            continue
        w, b = fl[mod]
        algo = cfg.module_algo(mod)
        scale = (act_scale_for(act_scales, i, mod, w.shape[0], w.device)
                 if algo.is_mix else None)
        out[mod] = dispatch.quantize_linear_params(
            w, algo, act_scale=scale, num_outliers=cfg.quant.num_outliers,
            group_size=cfg.quant.group_size, bias=b)
    return out


def params_from_hf(cfg: ModelConfig, hf: Mapping[str, torch.Tensor],
                   act_scales: Optional[Mapping] = None,
                   device: DeviceLike = "cuda") -> Dict:
    """A family's HF state dict -> quantized params on ``device``, one
    layer at a time: a layer's f32 weights exist only while it is
    quantized."""
    dev = resolve_device(device)
    embed, pos_embed, embed_norm, final_norm, lm_head = _TOPLEVEL[cfg.arch]
    layers = []
    for i in range(cfg.num_layers):
        fl = _float_layer(cfg, hf, i, dev)
        layers.append(_quantize_layer(cfg, fl, act_scales, i))
        del fl
    gemma = 1.0 if cfg.arch in ("gemma", "gemma2") else 0.0
    params: Dict = {
        "embed": {"w": hf[embed + ".weight"].to(dev).to(cfg.dtype)},
        "layers": layers,
        "final_norm": _norm(hf, final_norm, dev),
    }
    params["final_norm"]["w"] = params["final_norm"]["w"] + gemma
    if pos_embed is not None:
        params["pos_embed"] = {
            "w": hf[pos_embed + ".weight"].to(dev).to(cfg.dtype)}
    if embed_norm is not None:
        params["embed_norm"] = _norm(hf, embed_norm, dev)
    if lm_head is not None and not cfg.tie_word_embeddings:
        head = {"w": _t(hf[lm_head + ".weight"], dev).to(cfg.dtype)}
        if lm_head + ".bias" in hf:
            head["b"] = hf[lm_head + ".bias"].to(dev).to(torch.bfloat16)
        params["lm_head"] = head
    return params


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device: DeviceLike = "cuda",
                       act_scales=None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """Random-weight params honouring every ModelConfig axis,
    N(0, 0.02), quantized with the production routing; norms ones (their
    biases zero: Gemma's stored 1 + w at w = 0), linear biases zero. Drawn
    from ``generator`` (else one seeded with ``seed`` on the target device)
    a layer at a time, so the float weights of one layer exist at once.
    The draws differ from the JAX package's for the same seed."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    std = 0.02
    h = cfg.hidden_size

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * std

    def norm_init(n=h):
        p = {"w": torch.ones(n, device=dev)}
        if cfg.norm_type == "layernorm":
            p["b"] = torch.zeros(n, device=dev)
        return p

    def bias(n, on):
        return torch.zeros(n, device=dev) if on else None

    up_out = (2 * cfg.intermediate_size if cfg.mlp_type == "gated"
              else cfg.intermediate_size)
    layers = []
    for i in range(cfg.num_layers):
        fl = {
            "qkv_proj": (rnd(h, cfg.qkv_out), bias(cfg.qkv_out,
                                                   cfg.qkv_bias)),
            "o_proj": (rnd(cfg.q_size, h), bias(h, cfg.attn_out_bias)),
        }
        if cfg.num_experts:
            fl.update(random_experts(cfg, rnd))
        else:
            fl["gate_up_proj"] = (rnd(h, up_out), bias(up_out, cfg.mlp_bias))
            fl["down_proj"] = (rnd(cfg.intermediate_size, h),
                               bias(h, cfg.mlp_bias))
        if cfg.pre_block_norms:
            fl["input_norm"] = norm_init()
            if not cfg.shared_block_norm:
                fl["post_norm"] = norm_init()
        if cfg.post_block_norms:
            fl["post_attn_norm"] = norm_init()
            fl["post_mlp_norm"] = norm_init()
        if cfg.qk_norm:
            flat = cfg.qk_norm_flat
            fl["q_norm"] = {"w": torch.ones(
                cfg.q_size if flat else cfg.head_dim, device=dev)}
            fl["k_norm"] = {"w": torch.ones(
                cfg.kv_size if flat else cfg.head_dim, device=dev)}
        layers.append(_quantize_layer(cfg, fl, act_scales, i))
        del fl
    params: Dict = {
        "embed": {"w": rnd(cfg.vocab_size, h).to(cfg.dtype)},
        "layers": layers,
        "final_norm": norm_init(),
    }
    if cfg.pos_embedding == "learned":
        params["pos_embed"] = {"w": rnd(
            cfg.max_position_embeddings + cfg.learned_pos_offset,
            h).to(cfg.dtype)}
    if cfg.embed_norm:
        params["embed_norm"] = norm_init()
    if not cfg.tie_word_embeddings:
        head = {"w": rnd(h, cfg.vocab_size).to(cfg.dtype)}
        if cfg.lm_head_bias:
            head["b"] = torch.zeros(cfg.vocab_size, dtype=torch.bfloat16,
                                    device=dev)
        params["lm_head"] = head
    return params
