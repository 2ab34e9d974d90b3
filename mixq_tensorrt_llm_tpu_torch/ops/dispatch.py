"""Quantized linear dispatch: params dict + algo -> forward.

Counterpart of mixq_tensorrt_llm_tpu/ops/dispatch.py on its ``pallas``
routing with the packed-int4 kernels on (the JAX package's TPU route),
which is the port's only routing: the linears go through the kernels
K1-K4, K12 and K13 on the card and through their plain versions on the
CPU.

  INT8_MIX/INT4_MIX after a norm:  K1 rmsnorm_quant_split -> K2
  INT8_MIX/INT4_MIX otherwise:     K1 quant_split -> K2 (mix_linear); an
                                   int4 weight is unpacked first (K2 takes
                                   int4 values in an int8 container)
  W8A16:                           K4 wo_matmul
  W4A16, packed, M <= 128:         K12 wo_matmul_packed
  W4A16 otherwise:                 unpack_int4 -> K4
  W4A16_G, packed, M <= 128,       K13 wo_matmul_packed_grouped
    group_size % 128 == 0:
  W4A16_G otherwise:               unpack_int4 -> ref.wo_matmul_grouped
                                   (plain: JAX leaves it to XLA)
  FP8:                             the e4m3 weight dequantized to bf16,
                                   then one bf16 product with an f32
                                   result (ref.bf16_matmul_f32), as the
                                   JAX package leaves it to XLA
  INT8_LR:                         K1 quant_split with no outliers (the
                                   whole row quantized), a bf16 x @ u
                                   (library: XLA's in the JAX package),
                                   then K2 with x_outliers = bf16(x @ u)
                                   and fp_weight = v: the rank-r
                                   correction is K2's side GEMM
  NONE:                            one bf16 product with an f32 result
                                   (ref.bf16_matmul_f32), as the JAX
                                   package leaves it to XLA

An expert stack (models/moe.py: a leading E axis) goes one expert at a
time through ``expert_linear``: K4 on int8 or unpacked int4 stacks with
per-channel scales, bf16 products for float and group-scaled stacks.

Param schemas (weights in (in, out) layout), unchanged from the JAX package:
  NONE:      {"w": bf16 (in, out)} [+ "b"]
  W8A16:     {"qweight": int8 (in, out), "scale_col": f32 (out,)} [+ "b"]
  W4A16:     the same with int4 values, or "qweight_packed" int8 (in/2, out)
  W4A16_G:   {"qweight" or "qweight_packed", "scale_g": f32 (in/G, out)}
  INT8_MIX:  {"qweight", "scale_col", "fp_ind": int32 (k,),
              "fp_weight": bf16 (k, out)} [+ "b"]
  INT4_MIX:  the same with int4 values, or "qweight_packed"
  FP8:       {"qweight": float8_e4m3fn (in, out), "scale_col"} [+ "b"]
  INT8_LR:   {"qweight", "scale_col", "lr_u": bf16 (in, r),
              "lr_v": bf16 (r, out)} [+ "b"]
"""

from __future__ import annotations

from typing import Optional

import torch

from ..quant.config import QuantAlgo
from ..quant import core as qcore
from . import mixed_matmul as mm
from . import norm_quant as nq
from . import ref
from . import wo_matmul as wm

# the packed-int4 kernels serve the bandwidth-bound small-M regime (JAX:
# ops/dispatch.py _packed_kernel_ok, whose limit is 128 by default)
PACKED_M_MAX = 128
_GROUP_ALIGN = 128          # K13 group sizes, as the JAX kernel asks


def _maybe_bias(out: torch.Tensor, params: dict) -> torch.Tensor:
    b = params.get("b")
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def _unpacked_qweight(params: dict) -> torch.Tensor:
    """The (in, out) int8 weight; a packed int4 one is unpacked (a
    transient copy of 1 byte a weight)."""
    if "qweight_packed" in params:
        return qcore.unpack_int4(params["qweight_packed"])
    return params["qweight"]


def norm_linear(params: dict, x: torch.Tensor, algo: QuantAlgo,
                norm_w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm -> linear. On the mix path the norm is fused into K1, whose
    f32 normed row feeds the int8 quantization directly; other algos take
    the norm in x's dtype, then the linear."""
    if not algo.is_mix:
        return linear(params, ref.rmsnorm(x, norm_w, eps), algo)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    q_x, srow, xout = nq.rmsnorm_quant_split(x2, norm_w, params["fp_ind"],
                                             eps=eps)
    out = mm.mixed_matmul(q_x, srow, xout, _unpacked_qweight(params),
                          params["scale_col"], params["fp_weight"],
                          out_dtype=x.dtype)
    return _maybe_bias(out, params).reshape(*lead, -1)


def linear(params: dict, x: torch.Tensor, algo: QuantAlgo) -> torch.Tensor:
    """Apply a (possibly quantized) linear. x (..., in) -> (..., out)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    small = x2.shape[0] <= PACKED_M_MAX and "qweight_packed" in params
    if algo == QuantAlgo.NONE:
        out = ref.bf16_matmul_f32(x2, params["w"]).to(x.dtype)
    elif algo == QuantAlgo.W4A16_G:
        scale_g = params["scale_g"]
        gs = x2.shape[-1] // scale_g.shape[0]
        if small and gs % _GROUP_ALIGN == 0 \
                and params["qweight_packed"].shape[0] % gs == 0:
            out = wm.wo_matmul_packed_grouped(x2, params["qweight_packed"],
                                              scale_g, gs, out_dtype=x.dtype)
        else:
            out = ref.wo_matmul_grouped(x2, _unpacked_qweight(params),
                                        scale_g, out_dtype=x.dtype)
    elif algo in (QuantAlgo.W8A16, QuantAlgo.W4A16):
        if small:
            out = wm.wo_matmul_packed(x2, params["qweight_packed"],
                                      params["scale_col"], out_dtype=x.dtype)
        else:
            out = wm.wo_matmul(x2, _unpacked_qweight(params),
                               params["scale_col"], out_dtype=x.dtype)
    elif algo.is_mix:
        out = mm.mix_linear(x2, _unpacked_qweight(params),
                            params["scale_col"], params["fp_ind"],
                            params["fp_weight"], out_dtype=x.dtype)
    elif algo.is_fp8:
        w = qcore.dequantize_weight(params["qweight"], params["scale_col"])
        out = ref.bf16_matmul_f32(x2, w).to(x.dtype)
    elif algo.is_lr:
        out = lr_linear(x2, params, out_dtype=x.dtype)
    else:
        raise ValueError(f"unknown algo {algo}")
    return _maybe_bias(out, params).reshape(*lead, -1)


def expert_linear(params: dict, e: int, x: torch.Tensor) -> torch.Tensor:
    """Expert ``e`` of an expert-stacked linear (models/moe.py: the stack
    carries a leading E axis), x (M, in) -> (M, out) f32, chosen by the
    stack's format, never by an error:

      int8 or unpacked int4, "scale_col" (E, out):  K4 (wo_matmul) on the
                                    expert's (in, out) view, f32 out
      int4 with group scales, "scale_g" (E, in/G, out): the JAX package's
                                    route (no kernel of the port takes
                                    group scales on an unpacked weight):
                                    the expert dequantized to bf16, then
                                    ref.bf16_matmul_f32
      float, "w" (E, in, out):      ref.bf16_matmul_f32 on bf16 operands

    The JAX package dequantizes the whole stack to bf16 before its
    product (XLA's ragged_dot); K4 applies scale_col after the f32 sum, so
    an int8 expert agrees with it at the GEMM tolerance, not bit for
    bit."""
    if "w" in params:
        return ref.bf16_matmul_f32(x, params["w"][e])
    if "scale_g" in params:
        w = qcore.dequantize_weight_grouped(params["qweight"][e],
                                            params["scale_g"][e])
        return ref.bf16_matmul_f32(x, w)
    return wm.wo_matmul(x, params["qweight"][e], params["scale_col"][e],
                        out_dtype=torch.float32)


def lr_linear(x: torch.Tensor, params: dict,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """int8_lr, x (M, K): K1 without the norm over an empty fp_ind (the
    whole row quantized), x @ u in bf16 with an f32 result, then K2 with
    the rank-r correction as its side GEMM. On the CPU the same route
    takes the kernels' plain versions (``ref.lr_linear``'s function)."""
    empty = torch.empty((0,), dtype=torch.int32, device=x.device)
    q_x, scale_row, _ = nq.quant_split(x, empty)
    xu = ref.bf16_matmul_f32(x, params["lr_u"]).to(torch.bfloat16)
    return mm.mixed_matmul(q_x, scale_row, xu, params["qweight"],
                           params["scale_col"], params["lr_v"],
                           out_dtype=out_dtype)


def quantize_linear_params(w: torch.Tensor, algo: QuantAlgo,
                           act_scale: Optional[torch.Tensor] = None,
                           num_outliers: int = 128,
                           bias: Optional[torch.Tensor] = None,
                           pack: Optional[bool] = None,
                           group_size: int = 128) -> dict:
    """Build the params dict for one linear from a float weight (in, out).
    pack: store int4 weights two a byte (``qweight_packed``); by default
    whenever in_features is even, as the JAX package does."""
    if pack is None:
        pack = w.shape[0] % 2 == 0
    out: dict = {}

    def int4(q):
        if pack:
            out["qweight_packed"] = qcore.pack_int4(q)
        else:
            out["qweight"] = q

    if algo == QuantAlgo.NONE:
        out["w"] = w.to(torch.bfloat16)
    elif algo == QuantAlgo.W8A16:
        q, s = qcore.quantize_weight_int8(w)
        out["qweight"], out["scale_col"] = q, s.float()
    elif algo == QuantAlgo.FP8:
        q, s = qcore.quantize_weight_fp8(w)
        out["qweight"], out["scale_col"] = q, s.float()
    elif algo == QuantAlgo.INT8_LR:
        q, s, u, v = qcore.make_lr_artifact(w)
        out["qweight"], out["scale_col"] = q, s
        out["lr_u"], out["lr_v"] = u, v
    elif algo == QuantAlgo.W4A16:
        q, s = qcore.quantize_weight_int4(w)
        int4(q)
        out["scale_col"] = s.float()
    elif algo == QuantAlgo.W4A16_G:
        q, s = qcore.quantize_weight_int4_grouped(w, group_size)
        int4(q)
        out["scale_g"] = s.float()
    elif algo.is_mix:
        if act_scale is None:
            raise ValueError("mix quantization needs a calibrated act_scale")
        art = qcore.make_mix_artifact(w, act_scale, num_outliers,
                                      bits=algo.weight_bits)
        if algo == QuantAlgo.INT4_MIX:
            int4(art.qweight)
        else:
            out["qweight"] = art.qweight
        out["scale_col"] = art.scale_col
        out["fp_ind"], out["fp_weight"] = art.fp_ind, art.fp_weight
    else:
        raise ValueError(f"unknown algo {algo}")
    if bias is not None:
        out["b"] = bias.to(torch.bfloat16)
    return out
