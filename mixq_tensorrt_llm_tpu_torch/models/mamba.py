"""Mamba (selective state-space) family. Counterpart of
mixq_tensorrt_llm_tpu/models/mamba.py.

  * The recurrence h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t*x_t is an
    elementwise linear recurrence over (d_inner, d_state) lanes. Prefill
    runs it as a blocked scan (``linear_scan``: the function the JAX
    package's ``jax.lax.associative_scan`` computes) over chunks of
    ``SCAN_CHUNK`` tokens, carrying h from chunk to chunk, so that no
    (B, S, I, N) f32 tensor of the whole sequence exists; decode (S == 1)
    is one fused state update.
  * The depthwise causal conv (kernel K = 4) is K shifted multiply-adds
    over a (K-1)-token carry.
  * The state takes the dense cache's place (``init_state``: the conv
    carry in a KVCache's ``k``, the SSM state in its ``v``) and is updated
    in place, so the GenerationSession serves Mamba as it serves a decoder.

in_proj / out_proj take the gate_up / o_proj routing (K1 -> K2 under the
mix algos: ``ops.dispatch.linear``, K1 without its norm, since the block
norm runs first); x_proj stays bf16 and dt_proj, A_log, D and the conv
f32, as in the JAX package. The scan, the conv and the gates are torch
ops, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import DeviceLike, resolve_device
from ..ops import dispatch
from ..ops import ref as ops_ref
from ..quant.config import QuantConfig
from .common import KVCache, ModelConfig

# tokens a prefill scan holds at once: each (B, SCAN_CHUNK, I, N) f32
# tensor is 671 MB at Mamba-2.8B's d_inner 5120 and 8 lanes
SCAN_CHUNK = 256
# the block of linear_scan's sequential pass
SCAN_BLOCK = 16


def config_from_hf(hf_config, quant: QuantConfig = QuantConfig()
                   ) -> ModelConfig:
    """HF MambaConfig -> ModelConfig (mamba-1, state-spaces/*-hf), read
    as the JAX package reads it."""
    def g(name, d=None):
        return getattr(hf_config, name, d)
    d_inner = g("intermediate_size") or int(g("expand", 2)
                                            * hf_config.hidden_size)
    rank = g("time_step_rank")
    return ModelConfig(
        arch="mamba", vocab_size=hf_config.vocab_size,
        hidden_size=hf_config.hidden_size,
        intermediate_size=d_inner,
        num_layers=hf_config.num_hidden_layers,
        num_heads=1, num_kv_heads=1, head_dim=1,        # no attention
        max_position_embeddings=g("max_position_embeddings", 1 << 20),
        pos_embedding="none",
        ssm_state_size=g("state_size", 16),
        conv_kernel=g("conv_kernel", 4),
        dt_rank=(rank if isinstance(rank, int)
                 else -(-hf_config.hidden_size // 16)),
        use_conv_bias=bool(g("use_conv_bias", True)),
        mlp_bias=bool(g("use_bias", False)),            # in/out_proj bias
        rms_norm_eps=g("layer_norm_epsilon", 1e-5),
        tie_word_embeddings=bool(g("tie_word_embeddings", True)),
        quant=quant)


def init_state(cfg: ModelConfig, batch: int,
               device: DeviceLike = "cuda") -> KVCache:
    """Per-layer recurrent state in the KVCache container: k = conv carry
    (L, B, K-1, I) in the model dtype; v = SSM state (L, B, I, N) f32 (the
    recurrence accumulates in f32)."""
    dev = resolve_device(device)
    return KVCache(
        k=torch.zeros((cfg.num_layers, batch, cfg.conv_kernel - 1,
                       cfg.intermediate_size), dtype=cfg.dtype, device=dev),
        v=torch.zeros((cfg.num_layers, batch, cfg.intermediate_size,
                       cfg.ssm_state_size), dtype=torch.float32,
                      device=dev))


def _block_prefixes(a: torch.Tensor, b: torch.Tensor):
    """Inclusive prefixes along axis 2 of (B, n, blk, ...) blocks under
    the associative combine of h_t = a_t * h_{t-1} + b_t, (a1, b1) then
    (a2, b2) -> (a1 * a2, a2 * b1 + b2) (the JAX package's
    ``_scan_combine``): every block at once, one token a step."""
    pa, pb = a.clone(), b.clone()
    for t in range(1, a.shape[2]):
        pb[:, :, t].addcmul_(a[:, :, t], pb[:, :, t - 1])
        pa[:, :, t].mul_(pa[:, :, t - 1])
    return pa, pb


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: torch.Tensor) -> torch.Tensor:
    """Every h_t of h_t = a_t * h_{t-1} + b_t from h_{-1} = h0, over axis
    1: a, b (B, S, ...), h0 (B, ...) -> (B, S, ...), what the JAX
    package's ``jax.lax.associative_scan`` computes. Blocked: the tokens
    in blocks of SCAN_BLOCK (the last padded with identity steps), each
    block's prefixes in one pass over the blocks together, the state
    entering each block from the same scan of the blocks' totals, then
    every token fixed up with its block's entering state: ~14 passes over
    the tensors and ~2 x SCAN_BLOCK launches a level. The sums run in
    another order than the JAX package's."""
    bsz, s = a.shape[:2]
    rest = tuple(a.shape[2:])
    blk = min(SCAN_BLOCK, s)
    pad = -s % blk
    if pad:
        a = torch.cat([a, a.new_ones((bsz, pad) + rest)], dim=1)
        b = torch.cat([b, b.new_zeros((bsz, pad) + rest)], dim=1)
    n = a.shape[1] // blk
    pa, pb = _block_prefixes(a.reshape((bsz, n, blk) + rest),
                             b.reshape((bsz, n, blk) + rest))
    carry = h0[:, None]
    if n > 1:
        ends = linear_scan(pa[:, :, -1], pb[:, :, -1], h0)
        carry = torch.cat([carry, ends[:, :-1]], dim=1)
    hs = torch.addcmul(pb, pa, carry[:, :, None])
    return hs.reshape((bsz, n * blk) + rest)[:, :s]


def _dot_f32(x: torch.Tensor, w: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """x @ w with both operands in ``dtype`` and an f32 result (the JAX
    package's ``preferred_element_type=f32`` product)."""
    if dtype == torch.bfloat16:
        return ops_ref.bf16_matmul_f32(x, w)
    return x.to(dtype).float() @ w.to(dtype).float()


def causal_conv(cfg: ModelConfig, conv_state: torch.Tensor,
                x_in: torch.Tensor, conv_w: torch.Tensor,
                conv_b: Optional[torch.Tensor],
                local_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The depthwise causal conv over [carry | tokens]: x_in (B, S, C) in
    the model dtype (pads zeroed), conv_state (B, K-1, C), conv_w (K, C)
    f32 (tap K-1 the current token). Returns (the conv f32 (B, S, C), the
    new carry: the K-1 inputs ending at each lane's last valid token)."""
    s, k = x_in.shape[1], cfg.conv_kernel
    xc = torch.cat([conv_state.to(cfg.dtype), x_in], dim=1)
    xcf, w = xc.float(), conv_w.float()
    h = sum(xcf[:, j:j + s] * w[j] for j in range(k))
    if conv_b is not None:
        h = h + conv_b.float()
    idx = (local_valid.long()[:, None]
           + torch.arange(k - 1, device=xc.device)[None, :])
    new_conv = torch.gather(xc, 1, idx[..., None].expand(-1, -1,
                                                         xc.shape[-1]))
    return h, new_conv


def mamba_mixer(cfg: ModelConfig, lp: Dict, x: torch.Tensor,
                conv_state: torch.Tensor, ssm_state: torch.Tensor,
                mask: torch.Tensor, local_valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One MambaMixer (HF MambaMixer.slow_forward semantics).

    x (B, S, H) normalized block input; conv_state (B, K-1, I); ssm_state
    (B, I, N) f32; mask (B, S) marks valid (non-pad) tokens; local_valid
    (B,) = number of valid tokens in THIS call. Invalid positions leave
    both states untouched (dt = 0 -> a = 1, b = 0). Returns (out (B, S, H),
    new conv_state, new ssm_state)."""
    b, s, _ = x.shape
    i, n = cfg.intermediate_size, cfg.ssm_state_size
    xz = dispatch.linear(lp["in_proj"], x, cfg.module_algo("gate_up_proj"))
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_in = torch.where(mask[..., None], x_in, 0.0).to(cfg.dtype)
    h, new_conv = causal_conv(cfg, conv_state, x_in, lp["conv_w"],
                              lp.get("conv_b"), local_valid)
    x_conv = F.silu(h)                                      # (B, S, I) f32

    # ssm parameters (float path: dt_rank + 2N columns are few)
    dbc = _dot_f32(x_conv, lp["x_proj"]["w"], cfg.dtype)
    dt, bmat, cmat = torch.split(dbc, [cfg.dt_rank, n, n], dim=-1)
    dt = dt @ lp["dt_proj"]["w"].float() + lp["dt_proj"]["b"].float()
    dt = F.softplus(dt)
    dt = torch.where(mask[..., None], dt, 0.0)              # pads: identity
    a_mat = -torch.exp(lp["A_log"].float())                 # (I, N)

    def coeffs(sl):
        """(da, db) (B, s', I, N) of the tokens in slice ``sl``."""
        dts = dt[:, sl, :, None]
        return (torch.exp(dts * a_mat),
                dts * bmat[:, sl, None, :] * x_conv[:, sl, :, None])

    if s == 1:   # decode: one fused state update, no scan machinery
        da, db = coeffs(slice(0, 1))
        hstate = da[:, 0] * ssm_state + db[:, 0]
        y = torch.einsum("bin,bn->bi", hstate, cmat[:, 0])[:, None]
    else:
        ys, hstate = [], ssm_state
        for c0 in range(0, s, SCAN_CHUNK):
            sl = slice(c0, min(c0 + SCAN_CHUNK, s))
            hs = linear_scan(*coeffs(sl), hstate)           # (B, c, I, N)
            ys.append(torch.einsum("bsin,bsn->bsi", hs, cmat[:, sl]))
            hstate = hs[:, -1]
            del hs
        y = torch.cat(ys, dim=1)
    y = y + lp["D"].float() * x_conv
    y = y * F.silu(z.float())
    out = dispatch.linear(lp["out_proj"], y.to(cfg.dtype),
                          cfg.module_algo("o_proj"))
    return out, new_conv.to(cfg.dtype), hstate


def forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
            write_pos: torch.Tensor, cache: KVCache,
            valid_len: torch.Tensor, full_prefill: bool = False,
            last_pos=None) -> Tuple[torch.Tensor, KVCache]:
    """Full Mamba forward with models.common.forward's signature.

    write_pos (B, S): absolute positions (only [:, 0] is read: the count of
    tokens already absorbed into the state); valid_len (B,): total valid
    tokens after this call; cache: ``init_state``'s, updated IN PLACE;
    full_prefill is accepted and changes nothing (Mamba has no attention);
    last_pos: optional (B,) index, the head then runs on that one position
    per lane. Returns (logits f32, cache)."""
    from . import common as mcommon
    s = tokens.shape[1]
    x = mcommon._embed(params, cfg, tokens, write_pos)
    local_valid = (valid_len.long() - write_pos[:, 0].long())
    mask = (torch.arange(s, device=x.device)[None, :]
            < local_valid[:, None])
    for li, lp in enumerate(params["layers"]):
        h = mcommon.block_norm(cfg, x, lp["norm"])
        out, new_conv, new_ssm = mamba_mixer(cfg, lp, h, cache.k[li],
                                             cache.v[li], mask, local_valid)
        cache.k[li].copy_(new_conv)
        cache.v[li].copy_(new_ssm)
        x = x + out.to(x.dtype)
    logits = mcommon._head(params, cfg, mcommon._last(x, last_pos))
    return logits.float(), cache


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _quantize_mixer(cfg: ModelConfig, fl: Dict, act_scales, i: int) -> Dict:
    """One layer's float weights -> its params: in_proj / out_proj under
    the gate_up / o_proj routing, the rest as they are."""
    from .llama import act_scale_for
    out = {k: v for k, v in fl.items() if k not in ("in_proj", "out_proj")}
    for mod, route in (("in_proj", "gate_up_proj"), ("out_proj", "o_proj")):
        w, bias = fl[mod]
        algo = cfg.module_algo(route)
        scale = (act_scale_for(act_scales, i, route, w.shape[0], w.device)
                 if algo.is_mix else None)
        out[mod] = dispatch.quantize_linear_params(
            w.float(), algo, act_scale=scale,
            num_outliers=cfg.quant.num_outliers,
            group_size=cfg.quant.group_size,
            bias=None if bias is None else bias.float())
    return out


def params_from_hf(cfg: ModelConfig, hf: Mapping[str, torch.Tensor],
                   act_scales=None, device: DeviceLike = "cuda") -> Dict:
    """HF MambaForCausalLM state dict (tensors as stored, (out, in)) ->
    params on ``device``, one layer at a time."""
    dev = resolve_device(device)

    def t(name):
        return hf[name].to(dev)

    layers = []
    for i in range(cfg.num_layers):
        p = f"backbone.layers.{i}.mixer."

        def lin(mod):
            b = p + mod + ".bias"
            return (t(p + mod + ".weight").t().float(),
                    t(b).float() if b in hf else None)
        fl = {
            "norm": {"w": t(f"backbone.layers.{i}.norm.weight").float()},
            "in_proj": lin("in_proj"),
            "out_proj": lin("out_proj"),
            # HF conv1d weight (I, 1, K): tap K-1 multiplies the current
            # token -> the (K, I) shifted-MAC layout
            "conv_w": t(p + "conv1d.weight")[:, 0, :].t().float()
            .contiguous(),
            "x_proj": {"w": t(p + "x_proj.weight").t().float()
                       .to(torch.bfloat16).contiguous()},
            "dt_proj": {"w": t(p + "dt_proj.weight").t().float()
                        .contiguous(),
                        "b": t(p + "dt_proj.bias").float()},
            "A_log": t(p + "A_log").float(),
            "D": t(p + "D").float(),
        }
        if p + "conv1d.bias" in hf:
            fl["conv_b"] = t(p + "conv1d.bias").float()
        layers.append(_quantize_mixer(cfg, fl, act_scales, i))
        del fl
    params: Dict = {
        "embed": {"w": t("backbone.embeddings.weight").to(cfg.dtype)},
        "layers": layers,
        "final_norm": {"w": t("backbone.norm_f.weight").float()},
    }
    if "lm_head.weight" in hf and not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": t("lm_head.weight").t().to(cfg.dtype)
                             .contiguous()}
    return params


def init_random_params(cfg: ModelConfig, seed: int = 0,
                       device: DeviceLike = "cuda", act_scales=None,
                       generator: Optional[torch.Generator] = None) -> Dict:
    """Random-weight params with the JAX package's init (N(0, 0.02)
    linears, conv and x/dt projections; A_log = log(1..N), dt bias -4,
    D ones), quantized with the production routing, one layer at a time.
    Drawn from ``generator`` (else one seeded with ``seed`` on the
    device); the draws differ from the JAX package's."""
    dev = resolve_device(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
    h, i, n = cfg.hidden_size, cfg.intermediate_size, cfg.ssm_state_size

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32) * 0.02

    a_log = torch.log1p(torch.arange(n, dtype=torch.float32, device=dev))
    layers = []
    for li in range(cfg.num_layers):
        fl = {
            "norm": {"w": torch.ones(h, device=dev)},
            "in_proj": (rnd(h, 2 * i), None),
            "out_proj": (rnd(i, h), None),
            "conv_w": rnd(cfg.conv_kernel, i),
            "conv_b": torch.zeros(i, device=dev),
            "x_proj": {"w": rnd(i, cfg.dt_rank + 2 * n).to(torch.bfloat16)},
            "dt_proj": {"w": rnd(cfg.dt_rank, i),
                        "b": torch.full((i,), -4.0, device=dev)},
            "A_log": a_log[None, :].repeat(i, 1),
            "D": torch.ones(i, device=dev),
        }
        layers.append(_quantize_mixer(cfg, fl, act_scales, li))
        del fl
    params: Dict = {
        "embed": {"w": rnd(cfg.vocab_size, h).to(cfg.dtype)},
        "layers": layers,
        "final_norm": {"w": torch.ones(h, device=dev)},
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = {"w": rnd(h, cfg.vocab_size).to(cfg.dtype)}
    return params

