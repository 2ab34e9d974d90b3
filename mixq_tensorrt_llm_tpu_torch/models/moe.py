"""Mixture-of-Experts MLP (Mixtral, DBRX, Qwen2-MoE, Qwen3-MoE).
Counterpart of mixq_tensorrt_llm_tpu/models/moe.py.

Experts are a stacked leading axis on the weight dicts: ``gate_up``
(E, H, 2I) and ``down`` (E, I, H), in the schema of a dense linear (int8
or unpacked int4 with ``scale_col`` (E, out), ``scale_g`` (E, in/G, out)
for W4A16_G, or float ``w``). Each expert's product is
``ops.dispatch.expert_linear``: on the card one K4 launch an expert and
projection for the integer stacks with per-channel scales.

The router is an f32 dot on the bf16-stored weight, a softmax, the top k
(ties to the lower expert id, as ``jax.lax.top_k``: a stable descending
sort) and, under ``moe_norm_topk``, the kept mass renormalized to 1 (a
1e-9 floor). The JAX package's default dispatch (ragged: every token only
through its k experts) is computed by two routes that give the same
function:

  * sorted: the (token, expert) pairs sorted stably by expert, the E group
    sizes read back to the host ONCE a call, and each non-empty expert's
    contiguous rows through its products. For eager calls: the
    Executor's prefill chunks, the session, ``forward``.
  * all rows: every expert over all T rows, its output weighted by a
    (T, E) f32 matrix holding each token's top-k weights (0 elsewhere)
    and summed over the experts in ascending id order. No host readback
    and static shapes: for every call inside ``static_shapes()`` (the
    Executor's decode rungs, beam bursts: CUDA graph bodies) and every
    call of at most ALL_ROWS_MAX rows, where the products are
    bandwidth-bound and nearly every expert is touched anyway.

Both add a token's k contributions in ascending expert order into an f32
zero, as JAX's scatter-add over the expert-sorted pairs does; the cast to
the activation dtype comes last. ``moe_mlp(ragged=False)`` is JAX's dense
route: the threshold weights of ``router_probs`` (ties may keep more than
k) over every expert and token. Each route counts itself in
``ops._build.LAUNCHES`` (``moe.sorted``: one host readback each,
``moe.all_rows``, ``moe.dense``), and the sorted route its non-empty
experts (``moe.groups``). The port has no expert-parallel mesh (JAX's
``parallel/expert.py``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import torch

from ..ops import _build
from ..ops import dispatch
from ..quant import core as qcore
from ..quant.config import QuantAlgo

# calls of at most this many rows take the all-rows route
ALL_ROWS_MAX = 64
_static_depth = 0


@contextlib.contextmanager
def static_shapes():
    """Every MoE call inside takes the all-rows route: the body of a
    captured CUDA graph (no host readback, no data-dependent shape)."""
    global _static_depth
    _static_depth += 1
    try:
        yield
    finally:
        _static_depth -= 1


def expert_algo(cfg) -> QuantAlgo:
    """The experts' (and the shared expert's) algo: the mix algos run
    weight-only (int8_mix as W8A16, int4_mix as W4A16), as the reference
    routes MoE."""
    algo = cfg.module_algo("gate_up_proj")
    if algo.is_mix:
        return (QuantAlgo.W8A16 if algo == QuantAlgo.INT8_MIX
                else QuantAlgo.W4A16)
    return algo


def _logits(x: torch.Tensor, router_w: torch.Tensor) -> torch.Tensor:
    return x.float() @ router_w.float()


def router_probs(x: torch.Tensor, router_w: torch.Tensor, top_k: int,
                 norm_topk: bool = True) -> torch.Tensor:
    """x (B, S, H), router_w (H, E) -> weights (B, S, E), zero outside the
    top k: the softmax over every expert, kept where at least the k-th
    largest (ties keep more), renormalized to 1 under ``norm_topk``."""
    probs = torch.softmax(_logits(x, router_w), dim=-1)
    thresh = torch.sort(probs, dim=-1, descending=True,
                        stable=True).values[..., top_k - 1:top_k]
    kept = torch.where(probs >= thresh, probs, torch.zeros_like(probs))
    if not norm_topk:
        return kept
    return kept / torch.clamp(kept.sum(-1, keepdim=True), min=1e-9)


def top_k(probs: torch.Tensor, k: int, norm: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """probs (T, E) -> (top values (T, k) f32, expert ids (T, k) int64) in
    descending order, ties to the lower id (``jax.lax.top_k``); the values
    renormalized to sum 1 under ``norm``."""
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = srt.values[:, :k], srt.indices[:, :k]
    if norm:
        vals = vals / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    return vals, ids


def _dequant_stack(params: Dict) -> torch.Tensor:
    """An expert stack (E, in, out) as bf16: the weight-only dequant with
    scale_col (E, out) or scale_g (E, in/G, out), as the JAX package
    dequantizes before its product (the plain route of a whole stack)."""
    if "w" in params:
        return params["w"].to(torch.bfloat16)
    q = params["qweight"]
    if "scale_g" in params:
        e, k, n = q.shape
        g = params["scale_g"].shape[1]
        wg = (q.float().reshape(e, g, k // g, n)
              * params["scale_g"][:, :, None])
        return wg.reshape(e, k, n).to(torch.bfloat16)
    return (q.float() * params["scale_col"][:, None, :]).to(torch.bfloat16)


def _expert_mlp(p: Dict, e: int, xs: torch.Tensor) -> torch.Tensor:
    """Expert e over rows xs (M, H) bf16 -> (M, H) f32: gate_up, SiLU(gate)
    * up in f32 cast to bf16, down."""
    gu = dispatch.expert_linear(p["gate_up"], e, xs)
    gate, up = torch.chunk(gu, 2, dim=-1)
    act = (torch.nn.functional.silu(gate) * up).to(torch.bfloat16)
    return dispatch.expert_linear(p["down"], e, act)


def _mix_all(p: Dict, xb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every expert over all rows xb (T, H), weighted by w (T, E) f32 and
    summed in ascending expert order -> (T, H) f32."""
    out = torch.zeros((xb.shape[0], xb.shape[1]), dtype=torch.float32,
                      device=xb.device)
    for e in range(w.shape[1]):
        out = out + _expert_mlp(p, e, xb) * w[:, e:e + 1]
    return out


def _ragged_all_rows(p: Dict, xf: torch.Tensor, vals: torch.Tensor,
                     ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    _build.count_launch("moe.all_rows")
    w = torch.zeros((xf.shape[0], num_experts), dtype=torch.float32,
                    device=xf.device).scatter_(1, ids, vals.float())
    return _mix_all(p, xf.to(torch.bfloat16), w)


def _ragged_sorted(p: Dict, xf: torch.Tensor, vals: torch.Tensor,
                   ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    t, h = xf.shape
    k = ids.shape[1]
    _build.count_launch("moe.sorted")
    # each token's experts ascending: the pairs are then combined in
    # ascending expert order, as JAX's scatter-add over the sorted pairs
    ids, perm = torch.sort(ids, dim=-1)
    vals = torch.gather(vals, 1, perm)
    eid = ids.reshape(-1)
    order = torch.sort(eid, stable=True).indices
    xs = xf[order // k].to(torch.bfloat16)
    sizes = torch.bincount(eid, minlength=num_experts)
    dn = torch.empty((t * k, h), dtype=torch.float32, device=xf.device)
    off = 0
    for e, n in enumerate(sizes.tolist()):       # the one host readback
        if n:
            _build.count_launch("moe.groups")
            dn[off:off + n] = _expert_mlp(p, e, xs[off:off + n])
        off += n
    contrib = torch.empty_like(dn)
    contrib[order] = dn * vals.reshape(-1)[order][:, None]
    contrib = contrib.view(t, k, h)
    out = torch.zeros((t, h), dtype=torch.float32, device=xf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def _moe_mlp_ragged(cfg, moe_params: Dict, x: torch.Tensor) -> torch.Tensor:
    """JAX's ragged dispatch: each token through its top-k experts only,
    by the sorted route or, inside ``static_shapes()`` or at most
    ALL_ROWS_MAX rows, the all-rows route."""
    b, s, h = x.shape
    xf = x.reshape(b * s, h)
    probs = torch.softmax(_logits(xf, moe_params["router"]["w"]), dim=-1)
    vals, ids = top_k(probs, cfg.top_k_experts, cfg.moe_norm_topk)
    route = (_ragged_all_rows if _static_depth or b * s <= ALL_ROWS_MAX
             else _ragged_sorted)
    out = route(moe_params, xf, vals, ids, cfg.num_experts)
    return out.reshape(b, s, h).to(x.dtype)


def _moe_mlp_dense(cfg, moe_params: Dict, x: torch.Tensor) -> torch.Tensor:
    """JAX's dense dispatch: ``router_probs``' threshold weights over every
    expert and token."""
    b, s, h = x.shape
    _build.count_launch("moe.dense")
    w = router_probs(x, moe_params["router"]["w"], cfg.top_k_experts,
                     norm_topk=cfg.moe_norm_topk).reshape(b * s, -1)
    out = _mix_all(moe_params, x.reshape(b * s, h).to(torch.bfloat16), w)
    return out.reshape(b, s, h).to(x.dtype)


def moe_mlp(cfg, moe_params: Dict, x: torch.Tensor,
            ragged: bool = True) -> torch.Tensor:
    """The MoE block, x (B, S, H) -> (B, S, H).

    moe_params: {"router": {"w" (H, E)}, "gate_up": an expert stack
    (E, H, 2I), "down": (E, I, H)}, and for Qwen2-MoE's always-on shared
    expert {"shared_gate_up", "shared_down": dense linear params,
    "shared_gate": {"w" (H, 1)}}: its output, through ``dispatch.linear``
    with the experts' weight-only algo (K4, or K12 on a packed int4
    weight), is gated by sigmoid(x @ shared_gate) in f32 and added.
    ``ragged=False`` takes JAX's dense route."""
    out = (_moe_mlp_ragged if ragged else _moe_mlp_dense)(cfg, moe_params, x)
    if "shared_gate_up" in moe_params:
        algo = expert_algo(cfg)
        gu = dispatch.linear(moe_params["shared_gate_up"], x, algo)
        gate, up = torch.chunk(gu, 2, dim=-1)
        act = (torch.nn.functional.silu(gate.float())
               * up.float()).to(x.dtype)
        shared = dispatch.linear(moe_params["shared_down"], act, algo)
        g = torch.sigmoid(x.float() @ moe_params["shared_gate"]["w"].float())
        out = out + (g * shared.float()).to(out.dtype)
    return out


def quantize_expert_linear(w_stack: torch.Tensor, algo: QuantAlgo,
                           group_size: int = 128) -> Dict:
    """w_stack (E, in, out) float -> an expert stack: bf16 ``w`` for NONE;
    int8 (every 8-bit algo, fp8 and int8_lr too, as the JAX package
    stores them) or unpacked int4 ``qweight`` (E, in, out) with
    ``scale_col`` (E, out) f32; W4A16_G with ``scale_g`` (E, in/G, out)."""
    if algo == QuantAlgo.NONE:
        return {"w": w_stack.to(torch.bfloat16)}
    qs, ss = [], []
    for e in range(w_stack.shape[0]):
        if algo == QuantAlgo.W4A16_G:
            q, sc = qcore.quantize_weight_int4_grouped(w_stack[e], group_size)
        elif algo.weight_bits == 8:
            q, sc = qcore.quantize_weight_int8(w_stack[e])
        else:
            q, sc = qcore.quantize_weight_int4(w_stack[e])
        qs.append(q)
        ss.append(sc.float())
    key = "scale_g" if algo == QuantAlgo.W4A16_G else "scale_col"
    return {"qweight": torch.stack(qs), key: torch.stack(ss)}
