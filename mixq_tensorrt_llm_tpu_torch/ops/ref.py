"""Plain PyTorch versions of the hot ops (counterpart of ops/ref.py).

These are the ground truth the kernels are held against; the kernel
modules' ``*_plain`` functions, which the ported model takes on the CPU,
are built from them. Shapes, dtypes and the order of the arithmetic follow
mixq_tensorrt_llm_tpu/ops/ref.py.

The int8 GEMM (``mixed_matmul``) accumulates exactly in int32 through
``torch._int_mm`` — a plain large product that the JAX package leaves to
XLA, so it stays a library call here too. On CUDA ``_int_mm`` needs more
than 16 rows and K, N multiples of 8; smaller row counts are zero-padded.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..quant import core as qcore

_INT_MM_MIN_ROWS = 17      # cuBLASLt int8 GEMM via torch._int_mm needs M > 16


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 accumulation, output in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm (mean-centred) in float32, optional bias, output in x's
    dtype: the norm of the OPT/GPT/NeoX/Falcon/BLOOM/Phi families."""
    xf = x.float()
    xc = xf - torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(xc * xc, dim=-1, keepdim=True)
    out = xc * torch.rsqrt(var + eps) * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rmsnorm_quant_split(x: torch.Tensor, weight: torch.Tensor,
                        fp_ind: torch.Tensor, eps: float = 1e-6
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """RMSNorm -> outlier gather -> per-token int8 quantize.
    Returns (q_x int8, scale_row f32, x_outliers bf16)."""
    return quant_split(rmsnorm(x, weight, eps), fp_ind)


def quant_split(x: torch.Tensor, fp_ind: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Outlier gather -> per-token int8 quantize (no norm)."""
    x_out, x_zeroed = qcore.extract_outliers_and_zero(x, fp_ind)
    q_x, scale_row = qcore.quantize_activations(x_zeroed)
    return q_x, scale_row, x_out.to(torch.bfloat16)


def int8_matmul(q_x: torch.Tensor, qweight: torch.Tensor) -> torch.Tensor:
    """Exact int32 (m, in) @ (in, out) for int8 operands."""
    m = q_x.shape[0]
    if q_x.is_cuda and m < _INT_MM_MIN_ROWS:
        pad = q_x.new_zeros((_INT_MM_MIN_ROWS - m, q_x.shape[1]))
        return torch._int_mm(torch.cat([q_x, pad]), qweight)[:m]
    return torch._int_mm(q_x.contiguous(), qweight)


def mixed_matmul(q_x: torch.Tensor, scale_row: torch.Tensor,
                 x_outliers: torch.Tensor, qweight: torch.Tensor,
                 scale_col: torch.Tensor, fp_weight: torch.Tensor,
                 silu: bool = False,
                 out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8O16: (q_x @ qweight) * scale_row * scale_col
    + x_outliers @ fp_weight (in f32), optional SiLU. q_x (m, in)."""
    acc = int8_matmul(q_x, qweight).float()
    acc = acc * scale_row[..., None] * scale_col[None, :]
    side = x_outliers.float() @ fp_weight.float()
    out = acc + side
    if silu:
        out = out * torch.sigmoid(out)
    return out.to(out_dtype)


def mix_linear(x: torch.Tensor, qweight: torch.Tensor,
               scale_col: torch.Tensor, fp_ind: torch.Tensor,
               fp_weight: torch.Tensor, silu: bool = False,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Whole unfused mixed linear from float activations x (m, in)."""
    q_x, scale_row, x_out = quant_split(x, fp_ind)
    return mixed_matmul(q_x, scale_row, x_out, qweight, scale_col,
                        fp_weight, silu=silu, out_dtype=out_dtype)


def lr_linear(x: torch.Tensor, qweight: torch.Tensor,
              scale_col: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """W8A8 plus a rank-r correction (int8_lr), x (m, in):
        (q(x) @ qweight) * s_row * s_col + bf16(x @ u) @ v
    x @ u is a bf16 product with an f32 result, rounded to bf16; the
    correction is then ``mixed_matmul``'s side GEMM with x_outliers =
    bf16(x @ u) and fp_weight = v, so this is mixed_matmul over the whole
    quantized x (nothing zeroed)."""
    q_x, scale_row = qcore.quantize_activations(x)
    xu = bf16_matmul_f32(x, u).to(torch.bfloat16)
    return mixed_matmul(q_x, scale_row, xu, qweight, scale_col, v,
                        out_dtype=out_dtype)


def bf16_matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w with both operands rounded to bf16, result in f32.

    The JAX package accumulates such a product in f32
    (``preferred_element_type=f32``). On the CPU this computes exactly that,
    in f32 from the bf16-rounded operands. On CUDA it is one cuBLAS bf16
    GEMM that writes its f32 accumulator (``aten::mm.dtype``)."""
    xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
    if x.is_cuda:
        lead, k = xb.shape[:-1], xb.shape[-1]
        out = torch.mm(xb.reshape(-1, k), wb, out_dtype=torch.float32)
        return out.reshape(*lead, wb.shape[-1])
    return xb.float() @ wb.float()


def wo_matmul(x: torch.Tensor, qweight: torch.Tensor,
              scale_col: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """Weight-only W8A16: (bf16 x @ int8 W) * scale_col, f32 accumulate."""
    acc = bf16_matmul_f32(x, qweight)
    return (acc * scale_col[None, :]).to(out_dtype)


def wo_matmul_grouped(x: torch.Tensor, qweight: torch.Tensor,
                      scale_g: torch.Tensor,
                      out_dtype=torch.bfloat16) -> torch.Tensor:
    """Group-wise W4A16: x (m, in), qweight int4 values (in, out), scale_g
    f32 (in/G, out). Each group's partial product (bf16 operands, f32
    result; int4 is exact in bf16) is scaled by its group's scales and
    added into one f32 (m, out) accumulator, group by group: JAX's (G, m,
    out) tensor of partials is never materialized."""
    m, k = x.shape
    g, n = scale_g.shape
    gs = k // g
    acc = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for i in range(g):
        rows = slice(i * gs, (i + 1) * gs)
        acc += bf16_matmul_f32(x[:, rows], qweight[rows]) \
            * scale_g[i].float()[None, :]
    return acc.to(out_dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              scale: Optional[float] = None,
              softcap: float = 0.0,
              bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention with GQA (hq % hkv == 0), f32 softmax.

    q (b, sq, hq, d); k/v (b, skv, hkv, d); mask and ``bias`` (an additive
    f32 logits bias: ALiBi) broadcastable to (b, hq, sq, skv), True =
    keep; the bias is added before the softcap, as in the JAX package.
    GQA groups q heads against the un-repeated kv. Returns q's dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = (q.float() * scale).reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float())
    if mask is not None or softcap or bias is not None:
        logits = logits.reshape(b, hq, sq, -1)
        if bias is not None:
            logits = logits + bias.float()
        if softcap:
            logits = torch.tanh(logits / softcap) * softcap
        if mask is not None:
            logits = torch.where(mask, logits,
                                 torch.finfo(torch.float32).min)
        logits = logits.reshape(b, hkv, g, sq, -1)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


# the stock Pallas flash kernel's DEFAULT_MASK_VALUE, -0.7 * float32 max
FLASH_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """Causal MHA as the stock Pallas TPU flash kernel computes it (K14's
    plain version). q, k, v (B, S, H, D), taken as bf16 -> (B, S, H, D)
    bf16.

    Logits are f32 products of the bf16 inputs times ``scale``, with the
    causal mask (key <= row) as the stock kernel's additive
    FLASH_MASK_VALUE; the softmax is f32 and p is rounded to bf16 before
    p·v, whose f32 sum is divided by the f32 row sum and rounded to bf16
    once (jax/experimental/pallas/ops/tpu/flash_attention.py
    _flash_attention_kernel, which divides by the running sum as it goes).
    The (B, H, S, S) logits are materialized."""
    s = q.shape[1]
    qf, kf, vf = (t.to(torch.bfloat16).float() for t in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    logits = logits + torch.where(keep, 0.0, FLASH_MASK_VALUE)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1)                                        # (B, H, S)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf)
    return (out / l.transpose(1, 2)[..., None]).to(torch.bfloat16)


def attention_int8kv(q: torch.Tensor, k_q: torch.Tensor, k_s: torch.Tensor,
                     v_q: torch.Tensor, v_s: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None,
                     softcap: float = 0.0,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention straight over int8 K/V with per-(token, head) scales: the
    K scale multiplies the logits, the V scale the probabilities.
    k_q/v_q (b, skv, hkv, d) int8; k_s/v_s (b, skv, hkv) f32; ``bias`` as
    in ``attention``."""
    b, sq, hq, d = q.shape
    hkv = k_q.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q5 = (q.float() * scale).reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5, k_q.float())
    logits = logits * k_s.permute(0, 2, 1)[:, :, None, None, :]
    if bias is not None:
        bias = bias.expand(bias.shape[0], hq, *bias.shape[2:])
        logits = logits + bias.reshape(bias.shape[0], hkv, g,
                                       *bias.shape[2:]).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        mask = mask.expand(mask.shape[0], hq, *mask.shape[2:])
        mask = mask.reshape(mask.shape[0], hkv, g, *mask.shape[2:])
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * v_s.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v_q.float())
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    k_s: Optional[torch.Tensor] = None,
                    v_s: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None,
                    softcap: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Attention that also returns the softmax's running stats: (out (b,
    sq, hq, d), m (b, hq, sq), l (b, hq, sq)), out = exp(logits - m) @ v / l,
    so callers can merge exactly with attention over keys held elsewhere
    (``merge_attention_stats``). k/v (b, skv, hkv, d) float or int8 with
    k_s/v_s (b, skv, hkv) scales on the logits and the probabilities; mask
    broadcastable to (b, hq, sq, skv). A row that sees no key gives m
    -1e30, l 0 and out 0.

    Everything stays f32: parts are merged in f32 and cast once at the end
    (rounding each part to bf16 first costs ~1e-2 relative against the
    single softmax, which flipped beam choices in the JAX package)."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else d ** -0.5
    q5 = (q.float() * scale).reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.float())
    if k_s is not None:
        logits = logits * k_s.permute(0, 2, 1)[:, :, None, None, :]
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        mask = mask.expand(b, hq, sq, k.shape[1])
        logits = torch.where(mask.reshape(b, hkv, g, sq, -1), logits, -1e30)
    m = logits.amax(dim=-1)                                # (b, hkv, g, sq)
    p = torch.exp(logits - torch.clamp(m[..., None], min=-0.5e30))
    l = p.sum(dim=-1)
    if v_s is not None:
        p = p * v_s.permute(0, 2, 1)[:, :, None, None, :]
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out / torch.clamp(l, min=1e-20).permute(0, 3, 1, 2)[..., None]
    return (out.reshape(b, sq, hq, d), m.reshape(b, hq, sq),
            l.reshape(b, hq, sq))


def merge_attention_stats(parts) -> torch.Tensor:
    """Exactly combine attention results over DISJOINT key sets.

    parts: sequence of (out (b, sq, hq, d) normalized, m (b, hq, sq),
    l (b, hq, sq)). The online-softmax merge: with acc_i = out_i * l_i,
    out = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M). Parts that saw
    no key (m -1e30, l 0) contribute nothing. Returns f32; callers cast
    once."""
    return merge_stacked_stats(torch.stack([o for o, _, _ in parts]),
                               torch.stack([m for _, m, _ in parts]),
                               torch.stack([l for _, _, l in parts]))


def merge_stacked_stats(out: torch.Tensor, m: torch.Tensor,
                        l: torch.Tensor) -> torch.Tensor:
    """merge_attention_stats over parts stacked on a leading axis: out
    (P, b, sq, hq, d), m and l (P, b, hq, sq). A handful of whole-tensor
    ops, whatever P is (the JAX package loops over the parts)."""
    big = torch.clamp(m.amax(dim=0), min=-0.5e30)       # all-empty rows
    w = (l * torch.exp(m - big)).float()                 # (P, b, hq, sq)
    num = (out.float() * w.transpose(-1, -2)[..., None]).sum(dim=0)
    denom = torch.clamp(w.sum(dim=0), min=1e-20)
    return num / denom.transpose(-1, -2)[..., None]
