"""The MixQ quantization recipe on torch tensors.

Counterpart of mixq_tensorrt_llm_tpu/quant/core.py, bit-exact with it:

  * weights: per-output-channel symmetric int8, ``scale_col = absmax/127``;
    int4 per channel ``absmax/10`` clamped to [-8, 7] (the reference's
    saturating rule), int4 per group of rows ``absmax/7`` in [-7, 7]
  * activations: per-token symmetric int8, ``scale_row = absmax/127``,
    computed after the outlier channels have been zeroed
  * KV: per-(token, head) symmetric int8 over head_dim, or float8_e4m3fn
    (``absmax/448``, the cast rounding to nearest even)
  * fp8 weights: per-output-channel float8_e4m3fn, ``scale_col = absmax/448``
  * int8_lr: int8 weights plus a rank-r SVD of the quantization residual
  * outlier channels: top-k input channels by calibrated activation absmax

Rounding order, kept from the JAX package: the scale is absmax divided by
127 (10, 7) and floored at 1e-8, the value is DIVIDED by the scale (never
multiplied by its reciprocal), rounded half to even, clipped. ``_div``
divides by a tensor of the divisor rather than a Python scalar because
PyTorch's CUDA division by a host scalar multiplies by the reciprocal,
which can move the scale by one ulp; the CUDA write kernels
(csrc/paged_write.cu) use the same exact division, so kernel and plain
version agree bit for bit.

Packed int4 (``pack_int4``) is the JAX package's K-half layout: byte k of
a column holds row k in its low nibble and row k + in/2 in its high one.

Weight layout: (in_features, out_features), y = x @ w.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INT8_MAX = 127.0
INT4_DIV = 10.0            # the reference's per-channel int4 divisor
INT4_LO, INT4_HI = -8, 7
INT4_G_MAX = 7.0           # per-group int4: absmax / 7 over [-7, 7]
FP8_MAX = 448.0            # float8_e4m3fn's largest finite value
SCALE_FLOOR = 1e-8
FP8 = torch.float8_e4m3fn


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full_like(x, d)


def _absmax_scale(xf: torch.Tensor, dim: int, keepdim: bool,
                  div: float = INT8_MAX) -> torch.Tensor:
    return _div(xf.abs().amax(dim=dim, keepdim=keepdim), div).clamp_min(
        SCALE_FLOOR)


def _round_clip_int8(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp_(-INT8_MAX, INT8_MAX).to(torch.int8)


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------

def weight_scale_int8(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel scale: absmax / 127. ``w`` (in, out) -> (out,) f32."""
    return _absmax_scale(w.float(), dim=0, keepdim=False)


def quantize_weight_int8(w: torch.Tensor,
                         scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8. Returns (q int8 (in, out), scale)."""
    if scale is None:
        scale = weight_scale_int8(w)
    return _round_clip_int8(w.float() / scale[None, :]), scale


def weight_scale_int4(w: torch.Tensor) -> torch.Tensor:
    """Per-output-channel int4 scale: absmax / 10 (the reference's rule)."""
    return _absmax_scale(w.float(), dim=0, keepdim=False, div=INT4_DIV)


def quantize_weight_int4(w: torch.Tensor,
                         scale: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int4 with the reference's saturating
    clamp to [-8, 7]. Returns (q int8 holding int4 values, scale)."""
    if scale is None:
        scale = weight_scale_int4(w)
    q = torch.round(w.float() / scale[None, :]).clamp_(INT4_LO, INT4_HI)
    return q.to(torch.int8), scale


def quantize_weight_int4_grouped(w: torch.Tensor, group_size: int = 128
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Group-wise symmetric int4: every ``group_size`` input rows of a
    column share one absmax/7 scale. w (in, out) -> (q int8 holding int4
    values (in, out), scale f32 (in/group_size, out))."""
    k, n = w.shape
    if k % group_size:
        raise ValueError(f"in_features {k} is not a multiple of the group "
                         f"size {group_size}")
    wg = w.float().reshape(k // group_size, group_size, n)
    scale = _absmax_scale(wg, dim=1, keepdim=False, div=INT4_G_MAX)
    q = torch.round(wg / scale[:, None, :]).clamp_(-INT4_G_MAX, INT4_G_MAX)
    return q.to(torch.int8).reshape(k, n), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """(in, out) integer weights times per-out-channel scales."""
    return (q.float() * scale[None, :].float()).to(dtype)


def dequantize_weight_grouped(q: torch.Tensor, scale: torch.Tensor,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """(in, out) int4 weights times their (in/G, out) group scales."""
    k, n = q.shape
    g = scale.shape[0]
    wg = q.float().reshape(g, k // g, n) * scale[:, None, :]
    return wg.reshape(k, n).to(dtype)


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8-held int4 values (in, out) -> int8 (in/2, out) in the K-half
    layout: byte k holds row k in its low nibble, row k + in/2 in its
    high nibble (the JAX package's pack_int4)."""
    if q.shape[0] % 2:
        raise ValueError("in_features must be even to pack int4")
    half = q.shape[0] // 2
    lo = q[:half].to(torch.int16) & 0xF
    hi = q[half:].to(torch.int16) & 0xF
    # 0..255 through uint8, then reinterpreted: the wrap JAX's int8 gives
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """int8 (in/2, out) -> int8 (in, out), each nibble sign-extended: low
    nibbles are rows [0, in/2), high nibbles rows [in/2, in)."""
    p = packed.to(torch.int8)
    lo = ((p & 0xF) ^ 8) - 8          # the low nibble as a signed 4-bit value
    hi = p >> 4                       # arithmetic shift: sign-extends
    return torch.cat([lo, hi], dim=0)


# ---------------------------------------------------------------------------
# Outlier selection
# ---------------------------------------------------------------------------

def select_outliers(act_scale: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k input channels by calibrated activation absmax, as sorted
    ascending int32 indices. Equal scales go lower index first, as
    ``jax.lax.top_k`` takes them (a stable descending sort), so all-ones
    scales (no calibration) pick channels 0..k-1 on every device."""
    order = torch.sort(act_scale.float(), descending=True, stable=True)
    return torch.sort(order.indices[:k]).values.to(torch.int32)


def split_outlier_weight(w: torch.Tensor, fp_ind: torch.Tensor,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """Outlier weight rows W[fp_ind, :] -> (k, out)."""
    return w[fp_ind.long(), :].to(dtype)


def outlier_mask(fp_ind: torch.Tensor, in_features: int) -> torch.Tensor:
    """Boolean (in,) mask, True at outlier channels; a negative index (the
    dynamic path's padding) marks nothing."""
    ind = fp_ind.long()
    mask = torch.zeros((in_features + 1,), dtype=torch.bool,
                       device=fp_ind.device)
    mask[torch.where(ind >= 0, ind, in_features)] = True
    return mask[:in_features]


# ---------------------------------------------------------------------------
# Activation quantization (per-token dynamic)
# ---------------------------------------------------------------------------

def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 along the last axis.

    ``x`` (..., in) with outlier channels already zeroed -> (q int8 same
    shape, scale_row (...,) f32)."""
    xf = x.float()
    scale = _absmax_scale(xf, dim=-1, keepdim=False)
    return _round_clip_int8(xf / scale[..., None]), scale


def extract_outliers_and_zero(x: torch.Tensor, fp_ind: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (x_outliers (..., k), x with the outlier channels zeroed).
    A negative index gathers 0 and zeroes nothing, as K1 does
    (csrc/norm_quant.cu) and as the JAX package's one-hot selector does
    for the dynamic path's -1 padding."""
    ind = fp_ind.long()
    x_out = torch.index_select(x, -1, ind.clamp(min=0))
    x_out = torch.where(ind >= 0, x_out, torch.zeros((), dtype=x.dtype,
                                                     device=x.device))
    keep = (~outlier_mask(fp_ind, x.shape[-1])).to(x.dtype)
    return x_out, x * keep


# ---------------------------------------------------------------------------
# KV-cache quantization
# ---------------------------------------------------------------------------

def quantize_kv(kv: torch.Tensor, axis: int = -1, dtype=torch.int8
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric KV with per-(token, head) scales over ``axis``: int8
    (absmax/127, rounded, clipped) or float8_e4m3fn (absmax/448, cast).

    Returns (q of ``dtype``, same shape; scale f32 with ``axis``
    removed)."""
    kvf = kv.float()
    if dtype == FP8:
        scale = _absmax_scale(kvf, dim=axis, keepdim=True, div=FP8_MAX)
        return (kvf / scale).to(FP8), scale.squeeze(axis)
    if dtype != torch.int8:
        raise ValueError(f"quantize_kv: dtype {dtype} (int8 or "
                         "float8_e4m3fn)")
    scale = _absmax_scale(kvf, dim=axis, keepdim=True)
    return _round_clip_int8(kvf / scale), scale.squeeze(axis)


def raw(t: torch.Tensor) -> torch.Tensor:
    """``t`` for indexing and index assignment: an e4m3 tensor as its
    uint8 bytes (a view), any other tensor as it is."""
    return t.view(torch.uint8) if t.dtype == FP8 else t


def quantize_weight_fp8(w: torch.Tensor) -> Tuple[torch.Tensor,
                                                  torch.Tensor]:
    """Per-out-channel float8_e4m3fn weights: scale_col = absmax / 448,
    qweight = w / scale cast to e4m3 (round to nearest even; |w / scale|
    <= 448, so nothing saturates). w (in, out)."""
    wf = w.float()
    scale = _absmax_scale(wf, dim=0, keepdim=False, div=FP8_MAX)
    return (wf / scale[None, :]).to(FP8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16, axis: int = -1) -> torch.Tensor:
    return (q.float() * scale.unsqueeze(axis)).to(dtype)


# ---------------------------------------------------------------------------
# Full per-linear quantization artifact
# ---------------------------------------------------------------------------

class MixQLinearArtifact(NamedTuple):
    """qweight int8 (in, out) — the full weight, outlier rows included;
    scale_col f32 (out,); fp_ind int32 (k,) sorted; fp_weight bf16 (k, out).
    """
    qweight: torch.Tensor
    scale_col: torch.Tensor
    fp_ind: torch.Tensor
    fp_weight: torch.Tensor


def make_mix_artifact(w: torch.Tensor, act_scale: torch.Tensor,
                      num_outliers: int, bits: int = 8
                      ) -> MixQLinearArtifact:
    """Quantize one linear weight (in, out) into the MixQ artifact set.
    num_outliers is clamped to in_features; bits 8 (int8_mix) or 4
    (int4_mix: the int4 per-channel rule)."""
    if bits not in (4, 8):
        raise ValueError(f"unsupported bits={bits}")
    fp_ind = select_outliers(act_scale, min(num_outliers, w.shape[0]))
    fp_weight = split_outlier_weight(w, fp_ind)
    qweight, scale = (quantize_weight_int8(w) if bits == 8
                      else quantize_weight_int4(w))
    return MixQLinearArtifact(qweight, scale.float(), fp_ind, fp_weight)


LR_RANK = 32


def make_lr_artifact(w: torch.Tensor, rank: int = LR_RANK):
    """W8A8 plus a low-rank correction (int8_lr): the residual
    R = W - deq(Q) of the int8 weight is approximated by its rank-r SVD.
    Returns (qweight int8 (in, out), scale_col f32 (out,), u bf16 (in, r)
    = U_r * S_r, v bf16 (r, out) = Vt_r), r = min(rank, in, out). The SVD
    runs in f32 on w's device; singular vectors are defined up to sign,
    so only u @ v is comparable across devices and packages."""
    qweight, scale = quantize_weight_int8(w)
    resid = w.float() - qweight.float() * scale[None, :]
    r = int(min(rank, *w.shape))
    u_f, s_f, vt_f = torch.linalg.svd(resid, full_matrices=False)
    u = (u_f[:, :r] * s_f[:r][None, :]).to(torch.bfloat16)
    v = vt_f[:r].to(torch.bfloat16)
    return qweight, scale.float(), u, v
