"""Dense causal self-attention for the full prefill, counterpart of
ops/attention.py, with K14 (csrc/flash_attention.cu).

``causal_self_attention`` routes as the JAX package does on its TPU:

- MHA without a window at ``_flash_available`` shapes -> K14
  (``flash_causal_attention``), the kernel that replaces the stock Pallas
  ``flash_attention`` JAX calls there; q, k and v are cast to bf16 and the
  result back to q's dtype;
- GQA or a window at those shapes -> ``_flash_prefill_page_view``: K8
  (paged_prefill_attention, bf16 pages) over a page view of k/v with an
  identity block table;
- anything else -> the masked ``ops.ref.attention``.

The route is the same on both devices: a CUDA tensor launches the kernels,
a CPU tensor takes their plain versions (``ops.ref.flash_causal_attention``
for K14), so a CPU run exercises the card's routing. (The JAX package sends
every CPU call to the masked reference instead.)
"""

from __future__ import annotations

import torch

from . import _build, ref

_FLASH_DIMS = (64, 128, 256)


def _flash_available(s: int, d: int) -> bool:
    # the shapes where the JAX package takes the stock flash kernel
    return s >= 128 and s % 128 == 0 and d in _FLASH_DIMS


def _strided_ok(t: torch.Tensor) -> bool:
    """K14's tensor maps take a 16-byte aligned base and positive strides
    that are multiples of 16 bytes, rows of D bf16 contiguous."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st > 0 and st % 8 == 0 for st in t.stride()[:-1]))


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           scale: float) -> torch.Tensor:
    """K14: causal MHA, q, k, v (B, S, H, D) bf16 -> (B, S, H, D) bf16.

    A CUDA tensor launches the kernel (read by TMA through its strides; a
    view whose rows are not 16-byte aligned is copied first), or raises; a
    CPU tensor takes ``ops.ref.flash_causal_attention``."""
    if not q.is_cuda:
        return ref.flash_causal_attention(q, k, v, scale)
    what = "flash_causal_attention"
    b, s, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not (t.is_cuda and t.device == q.device
                and t.dtype == torch.bfloat16 and t.shape == q.shape):
            raise ValueError(f"{what}: {name} must be a bfloat16 tensor of "
                             f"q's shape {tuple(q.shape)} on {q.device}")
    if d not in _FLASH_DIMS:
        raise ValueError(f"{what}: head_dim {d}; the kernel takes "
                         f"{_FLASH_DIMS}")
    q, k, v = (t if _strided_ok(t) else _build.aligned(t) for t in (q, k, v))
    out = torch.empty((b, s, h, d), dtype=torch.bfloat16, device=q.device)
    fn = _build.bind("flash_attention", "mixq_flash_causal_attention",
                     [_build.P] * 4 + [_build.I] * 4 + [_build.LL] * 12
                     + [_build.F, _build.P])
    strides = [st for t in (q, k, v, out) for st in t.stride()[:3]]
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
             h, d, *strides, float(scale), _build.stream_ptr(q.device))
    _build.count_launch(what)
    _build.check("flash_attention", err, what)
    return out


def causal_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, window: int = 0,
                          sink: int = 0) -> torch.Tensor:
    """Full causal self-attention. q (B, S, Hq, D), k/v (B, S, Hkv, D) ->
    (B, S, Hq, D) in q's dtype; window/sink are StreamingLLM token counts
    (0 = dense)."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if not _flash_available(s, d):
        idx = torch.arange(s, device=q.device)
        mask = idx[None, :] <= idx[:, None]
        if window:
            mask &= (idx[None, :] > idx[:, None] - window) | \
                (idx[None, :] < sink)
        return ref.attention(q, k, v, mask=mask[None, None], scale=scale)
    if hkv != hq or window:
        return _flash_prefill_page_view(q, k, v, scale, window, sink)
    bf = torch.bfloat16
    return flash_causal_attention(q.to(bf), k.to(bf), v.to(bf),
                                  scale).to(q.dtype)


def _flash_prefill_page_view(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, scale: float, window: int,
                             sink: int) -> torch.Tensor:
    """Causal attention through K8 (paged_prefill_attention) over a page
    view of k/v.

    k/v (B, S, Hkv, D) are laid out as (B*S/BS, Hkv, BS, D) bf16 pages
    addressed by the identity table, so grouped KV heads are read as they
    are and the window is masked inside the kernel. The view is only a
    layout: BS is the largest page size K8 takes (16..256 in steps of 16)
    that divides S, where the JAX package's Pallas kernel takes up to 512."""
    from .paged_attention import paged_prefill_attention
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    bs = 256
    while s % bs and bs > 16:
        bs -= 16
    if s % bs:
        raise ValueError(f"prefill length {s} is not a multiple of 16")
    mb = s // bs

    def pages(x):   # a contiguous copy: K8 reads whole pages in place
        return (x.to(torch.bfloat16).reshape(b, mb, bs, hkv, d)
                .transpose(2, 3).contiguous().reshape(b * mb, hkv, bs, d))

    dev = q.device
    table = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * mb
             + torch.arange(mb, dtype=torch.int32, device=dev)[None, :])
    q_start = torch.zeros((b,), dtype=torch.int32, device=dev)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    return paged_prefill_attention(q, pages(k), pages(v), None, None, table,
                                   q_start, lens, scale, window=window,
                                   sink=sink).to(q.dtype)
