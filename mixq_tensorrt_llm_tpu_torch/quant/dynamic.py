"""Runtime-adaptive outliers (the reference's PyTorch-path MixQ).
Counterpart of mixq_tensorrt_llm_tpu/quant/dynamic.py.

The outlier capacity is fixed (``cfg.quant.max_outliers``, the cap) and
the outlier set is data: a running per-input-channel absmax
(``chan_max``, seeded so that the calibrated static set ranks first).
Each call of a mix linear on this path:

  1. chan_max <- max(chan_max, absmax(x))            (running stats)
  2. fp_ind = the top-cap channels by chan_max, kept where they rank below
     base_k (the static set) or exceed sigma, else -1
  3. fp_weight = dequant(qweight[fp_ind])            (gathered per call)
  4. the mixed GEMM with that split

Steps 1-3 are torch ops (the JAX package computes them in jnp); step 4 is
the port's ``mix_linear``: K1 without the norm, whose -1 entries gather 0
and zero nothing (csrc/norm_quant.cu), then K2 with ko = cap. On the CPU
both take their plain versions. The JAX package's one-hot selector and
the direct gather give the same x_outliers (a one-hot product is exact).

Ties in the ranking go lower channel first, as ``jax.lax.top_k`` takes
them (a stable descending sort): the seeded state holds each layer's
static set at exactly 2 sigma, so ties are the normal case.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from ..ops import mixed_matmul as mm

MIX_STATE_MODULES = ("qkv_proj", "o_proj", "gate_up_proj")


class DynamicOutlierState(NamedTuple):
    chan_max: torch.Tensor      # (in,) f32 running activation absmax


def init_state(act_scale: torch.Tensor) -> DynamicOutlierState:
    """Seeded from a calibrated activation absmax (ones if uncalibrated)."""
    return DynamicOutlierState(chan_max=act_scale.float())


def dynamic_fp_ind(chan_max: torch.Tensor, cap: int, sigma: float,
                   base_k: int) -> torch.Tensor:
    """Up to ``cap`` outlier channels, in descending order of chan_max:
    always the top ``base_k``, plus any channel above sigma; the rest of
    the cap is -1. int32 (cap,)."""
    order = torch.sort(chan_max, descending=True, stable=True)
    top_val, top_idx = order.values[:cap], order.indices[:cap]
    rank = torch.arange(cap, device=chan_max.device)
    keep = (rank < base_k) | (top_val > sigma)
    return torch.where(keep, top_idx, -1).to(torch.int32)


def dynamic_split(x: torch.Tensor, state: DynamicOutlierState,
                  qweight: torch.Tensor, scale_col: torch.Tensor, cap: int,
                  sigma: float, base_k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor,
                             DynamicOutlierState]:
    """(fp_ind (cap,) int32 padded with -1, fp_weight bf16 (cap, out),
    new state) for activations x (..., in). A padded row of fp_weight is
    qweight's row 0 dequantized; K1 gathers 0 for its channel, so it adds
    nothing."""
    absmax = x.float().abs().reshape(-1, x.shape[-1]).amax(dim=0)
    chan_max = torch.maximum(state.chan_max, absmax)
    fp_ind = dynamic_fp_ind(chan_max, cap, sigma, base_k)
    rows = qweight[fp_ind.long().clamp(min=0)]
    fp_weight = (rows.float() * scale_col[None, :]).to(torch.bfloat16)
    return fp_ind, fp_weight, DynamicOutlierState(chan_max)


def adaptive_mix_linear(x: torch.Tensor, qweight: torch.Tensor,
                        scale_col: torch.Tensor, state: DynamicOutlierState,
                        cap: int, sigma: float, base_k: int,
                        out_dtype=torch.bfloat16
                        ) -> Tuple[torch.Tensor, DynamicOutlierState]:
    """The adaptive mixed linear, x (..., in) -> ((..., out), new state):
    the dynamic split, then K1 (no norm) -> K2 at ko = cap."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    fp_ind, fp_weight, new_state = dynamic_split(
        x2, state, qweight, scale_col, cap, sigma, base_k)
    out = mm.mix_linear(x2, qweight, scale_col, fp_ind, fp_weight,
                        out_dtype=out_dtype)
    return out.reshape(*lead, -1), new_state


def init_model_state(params, cfg) -> Dict[str, torch.Tensor]:
    """{module: chan_max (L, in) f32}, each layer's static fp_ind seeded
    at 2 sigma (the reference's initial outlier set expressed as state),
    every other channel at 0; channels join when their running absmax
    crosses sigma."""
    layers = params["layers"]
    sigma = cfg.quant.outlier_sigma
    out = {}
    for mod in MIX_STATE_MODULES:
        first = layers[0].get(mod, {})
        if "fp_ind" not in first:
            continue
        d_in = first["qweight"].shape[0]
        seed = torch.zeros((len(layers), d_in), dtype=torch.float32,
                           device=first["fp_ind"].device)
        for li, layer in enumerate(layers):
            seed[li, layer[mod]["fp_ind"].long()] = 2.0 * sigma
        out[mod] = seed
    return out

