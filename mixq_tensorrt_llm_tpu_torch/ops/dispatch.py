"""Quantized linear dispatch: params dict + algo -> forward.

Counterpart of mixq_tensorrt_llm_tpu/ops/dispatch.py on its ``pallas``
routing, which is the port's only routing: the linears go through the
kernels K1-K4 (on the CPU through their plain versions).

  INT8_MIX after a norm:  K1 rmsnorm_quant_split -> K2 mixed_matmul
  INT8_MIX otherwise:     K1 quant_split -> K2 (mixed_matmul.mix_linear)
  W8A16:                  K4 wo_matmul
  NONE:                   one bf16 product with an f32 result
                          (ref.bf16_matmul_f32), as the JAX package leaves
                          it to XLA

Param schemas (weights in (in, out) layout), unchanged from the JAX package:
  NONE:      {"w": bf16 (in, out)} [+ "b"]
  W8A16:     {"qweight": int8 (in, out), "scale_col": f32 (out,)} [+ "b"]
  INT8_MIX:  {"qweight", "scale_col", "fp_ind": int32 (k,),
              "fp_weight": bf16 (k, out)} [+ "b"]
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

_LATER = {
    QuantAlgo.W4A16: "the int4 slice",
    QuantAlgo.W4A16_G: "the int4 slice",
    QuantAlgo.INT4_MIX: "the int4 slice",
    QuantAlgo.FP8: "the fp8 slice",
    QuantAlgo.INT8_LR: "a later slice",
}


def _not_ported(algo: QuantAlgo) -> NotImplementedError:
    return NotImplementedError(
        f"quant algo {algo.value!r} is not ported yet; it comes with "
        f"{_LATER.get(algo, 'a later slice')}")


def _maybe_bias(out: torch.Tensor, params: dict) -> torch.Tensor:
    b = params.get("b")
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def norm_linear(params: dict, x: torch.Tensor, algo: QuantAlgo,
                norm_w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm -> linear. On the mix path the norm is fused into K1, whose
    f32 normed row feeds the int8 quantization directly; other algos take
    the norm in x's dtype, then the linear."""
    if algo != QuantAlgo.INT8_MIX:
        return linear(params, ref.rmsnorm(x, norm_w, eps), algo)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    q_x, srow, xout = nq.rmsnorm_quant_split(x2, norm_w, params["fp_ind"],
                                             eps=eps)
    out = mm.mixed_matmul(q_x, srow, xout, params["qweight"],
                          params["scale_col"], params["fp_weight"],
                          out_dtype=x.dtype)
    return _maybe_bias(out, params).reshape(*lead, -1)


def linear(params: dict, x: torch.Tensor, algo: QuantAlgo) -> torch.Tensor:
    """Apply a (possibly quantized) linear. x (..., in) -> (..., out)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if algo == QuantAlgo.NONE:
        out = ref.bf16_matmul_f32(x2, params["w"]).to(x.dtype)
    elif algo == QuantAlgo.W8A16:
        out = wm.wo_matmul(x2, params["qweight"], params["scale_col"],
                           out_dtype=x.dtype)
    elif algo == QuantAlgo.INT8_MIX:
        out = mm.mix_linear(x2, params["qweight"], params["scale_col"],
                            params["fp_ind"], params["fp_weight"],
                            out_dtype=x.dtype)
    else:
        raise _not_ported(algo)
    return _maybe_bias(out, params).reshape(*lead, -1)


def quantize_linear_params(w: torch.Tensor, algo: QuantAlgo,
                           act_scale: Optional[torch.Tensor] = None,
                           num_outliers: int = 128,
                           bias: Optional[torch.Tensor] = None) -> dict:
    """Build the params dict for one linear from a float weight (in, out)."""
    out: dict = {}
    if algo == QuantAlgo.NONE:
        out["w"] = w.to(torch.bfloat16)
    elif algo == QuantAlgo.W8A16:
        q, s = qcore.quantize_weight_int8(w)
        out["qweight"], out["scale_col"] = q, s.float()
    elif algo == QuantAlgo.INT8_MIX:
        if act_scale is None:
            raise ValueError("mix quantization needs a calibrated act_scale")
        art = qcore.make_mix_artifact(w, act_scale, num_outliers)
        out["qweight"], out["scale_col"] = art.qweight, art.scale_col
        out["fp_ind"], out["fp_weight"] = art.fp_ind, art.fp_weight
    else:
        raise _not_ported(algo)
    if bias is not None:
        out["b"] = bias.to(torch.bfloat16)
    return out
