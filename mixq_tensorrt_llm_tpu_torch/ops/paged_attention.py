"""Attention over the paged KV pool: K7 (decode, one query token per lane)
and K8 (chunked prefill), counterparts of ops/paged_attention.py.

Pages are (NP, Hkv, BS, D): int8 with per-(token, head) scales (NP, Hkv,
BS), or unquantized bf16/f32 pages without scales (JAX's quantized=False
mode); block_table/block_pos (B, MB) int32 give each lane's page rows
and their absolute base positions (padding entries carry PAD_POS and are
skipped); lens (B,) counts the KV written. Masks work on absolute
positions: causal, optional sliding window + sinks, optional tanh softcap
on the logits.

A CPU tensor takes the plain version: gather and dequantize the lane's
pages to f32 (``gather_pages``), then ``ops.ref.attention`` — the math of
the JAX package's gather path (models/common.py:713-738) — with rows that
see no key at all set to 0, as the kernels give them. A CUDA tensor
launches the kernel of csrc/paged_attention.cu, or raises: its int8
instantiation for int8 pools, its unquantized one (no scale multiplies,
null scales; launches counted as ``*_fp``) for bf16 and f32 pools. The kernels accept
16 <= BS <= 256, BS % 16 == 0, and head_dim a multiple of 32 up to 256.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {**_DTYPES, torch.int8: 2}


def check_kernel_geometry(block_size: int, head_dim: int) -> None:
    """Raise unless the CUDA attention kernels take this page geometry."""
    if not (16 <= block_size <= 256 and block_size % 16 == 0):
        raise ValueError(f"block_size {block_size}: the CUDA paged-attention "
                         "kernels take 16..256 in steps of 16")
    if not (head_dim % 32 == 0 and head_dim <= 256):
        raise ValueError(f"head_dim {head_dim}: the CUDA paged-attention "
                         "kernels take multiples of 32 up to 256")


def identity_block_pos(block_table: torch.Tensor, bs: int) -> torch.Tensor:
    mb = block_table.shape[1]
    pos = torch.arange(mb, dtype=torch.int32, device=block_table.device) * bs
    return pos[None, :].expand(block_table.shape[0], mb)


def gather_pages(pages: torch.Tensor, scales: Optional[torch.Tensor],
                 block_table: torch.Tensor, dtype) -> torch.Tensor:
    """(NP, H, BS, D) pool -> (B, MB*BS, H, D) view of each lane's pages,
    dequantized when ``scales`` is given."""
    tb = block_table.long()
    x = pages[tb]                                   # (B, MB, H, BS, D)
    b, mb, h, bs, d = x.shape
    if scales is not None:
        x = x.float() * scales[tb][..., None]
    return x.to(dtype).permute(0, 1, 3, 2, 4).reshape(b, mb * bs, h, d)


def paged_attention_plain(q: torch.Tensor, k_pages, v_pages, k_scale,
                          v_scale, block_table: torch.Tensor,
                          q_pos: torch.Tensor, lens: torch.Tensor,
                          scale: float, block_pos=None, window: int = 0,
                          sink: int = 0, softcap: float = 0.0
                          ) -> torch.Tensor:
    """q (B, S, Hq, D) at absolute positions q_pos (B, S) -> (B, S, Hq, D)
    in q's dtype, computed in f32 over the gathered, dequantized pages."""
    b, mb = block_table.shape
    bs = k_pages.shape[2]
    if block_pos is None:
        block_pos = identity_block_pos(block_table, bs)
    k = gather_pages(k_pages, k_scale, block_table, torch.float32)
    v = gather_pages(v_pages, v_scale, block_table, torch.float32)
    kv_pos = (block_pos.long()[:, :, None]
              + torch.arange(bs, device=q.device)).reshape(b, 1, 1, mb * bs)
    qp = q_pos.long()[:, None, :, None]                      # (B,1,S,1)
    keep = (kv_pos <= qp) & (kv_pos < lens.long()[:, None, None, None])
    if window:
        keep &= (kv_pos > qp - window) | (kv_pos < sink)
    out = ref.attention(q.float(), k, v, mask=keep, scale=scale,
                        softcap=softcap)
    seen = keep.any(dim=-1).permute(0, 2, 1)[..., None]      # (B,S,1,1)
    return torch.where(seen, out, 0.0).to(q.dtype)


def _cuda_args(q, k_pages, v_pages, k_scale, v_scale, block_table,
               block_pos, what: str) -> Tuple:
    """Check what the kernels take. Returns (page pointers: K, V, K scale
    and V scale or null; page dtype code; launch-count suffix: "" for int8
    pages with scales, "_fp" for unquantized ones; hkv, bs, d, table,
    bpos)."""
    quant = k_scale is not None
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what}: q dtype {q.dtype} unsupported "
                         "(float32 or bfloat16)")
    np_, hkv, bs, d = k_pages.shape
    check_kernel_geometry(bs, d)
    if quant:
        want = (("k_pages", k_pages, torch.int8),
                ("v_pages", v_pages, torch.int8),
                ("k_scale", k_scale, torch.float32),
                ("v_scale", v_scale, torch.float32))
    elif k_pages.dtype in _DTYPES:
        want = (("k_pages", k_pages, k_pages.dtype),
                ("v_pages", v_pages, k_pages.dtype))
    else:
        raise ValueError(f"{what}: pages of {k_pages.dtype} without scales "
                         "unsupported (bfloat16 or float32)")
    for name, t, dt in want:
        if not (t.is_cuda and t.dtype == dt and t.is_contiguous()):
            raise ValueError(f"{what}: {name} must be a contiguous CUDA "
                             f"{dt} tensor")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError(f"{what}: page pools must be 16-byte aligned")
    if block_pos is None:
        block_pos = identity_block_pos(block_table, bs)
    dev = q.device
    table = block_table.to(dev, torch.int32).contiguous()
    bpos = block_pos.to(dev, torch.int32).contiguous()
    ptrs = [t.data_ptr() if t is not None else None
            for t in (k_pages, v_pages, k_scale, v_scale)]
    return (ptrs, _PAGE_DTYPES[k_pages.dtype], "" if quant else "_fp", hkv,
            bs, d, table, bpos)


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages, k_scale,
                           v_scale, block_table: torch.Tensor,
                           lens: torch.Tensor, scale: float,
                           block_pos=None, window: int = 0, sink: int = 0,
                           softcap: float = 0.0) -> torch.Tensor:
    """K7: q (B, Hq, D), the query at position lens-1 -> (B, Hq, D)."""
    if not q.is_cuda:
        return paged_attention_plain(
            q[:, None], k_pages, v_pages, k_scale, v_scale, block_table,
            (lens - 1)[:, None], lens, scale, block_pos, window, sink,
            softcap)[:, 0]
    ptrs, page_dtype, sfx, hkv, bs, d, table, bpos = _cuda_args(
        q, k_pages, v_pages, k_scale, v_scale, block_table, block_pos,
        "paged_decode_attention")
    b, hq, _ = q.shape
    if q.shape[2] != d or hq % hkv:
        raise ValueError(f"paged_decode_attention: q {tuple(q.shape)} does "
                         f"not fit pages with {hkv} heads of dim {d}")
    q = q.contiguous()
    lens = lens.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "mixq_paged_decode_attention",
                     [_build.P] * 9 + [_build.I] * 6
                     + [_build.F, _build.I, _build.I, _build.F, _build.I,
                        _build.I, _build.P])
    err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
             lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, bs,
             table.shape[1], float(scale), int(window), int(sink),
             float(softcap), _DTYPES[q.dtype], page_dtype,
             _build.stream_ptr(q.device))
    name = "paged_decode_attention" + sfx
    _build.count_launch(name)
    _build.check("paged_attention", err, name)
    return out


def paged_prefill_attention(q: torch.Tensor, k_pages, v_pages, k_scale,
                            v_scale, block_table: torch.Tensor,
                            q_start: torch.Tensor, lens: torch.Tensor,
                            scale: float, block_pos=None, window: int = 0,
                            sink: int = 0, softcap: float = 0.0
                            ) -> torch.Tensor:
    """K8: q (B, C, Hq, D) at positions q_start[b] + 0..C-1 -> (B, C, Hq, D).

    Any C: the kernel tiles 16 query tokens per block and masks the tail.
    Rows past the prompt are don't-care; callers select by position."""
    if not q.is_cuda:
        c = q.shape[1]
        q_pos = q_start[:, None] + torch.arange(c, device=q.device)
        return paged_attention_plain(q, k_pages, v_pages, k_scale, v_scale,
                                     block_table, q_pos, lens, scale,
                                     block_pos, window, sink, softcap)
    ptrs, page_dtype, sfx, hkv, bs, d, table, bpos = _cuda_args(
        q, k_pages, v_pages, k_scale, v_scale, block_table, block_pos,
        "paged_prefill_attention")
    b, c, hq, _ = q.shape
    if q.shape[3] != d or hq % hkv:
        raise ValueError(f"paged_prefill_attention: q {tuple(q.shape)} does "
                         f"not fit pages with {hkv} heads of dim {d}")
    q = q.contiguous()
    q_start = q_start.to(q.device, torch.int32).contiguous()
    lens = lens.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "mixq_paged_prefill_attention",
                     [_build.P] * 10 + [_build.I] * 7
                     + [_build.F, _build.I, _build.I, _build.F, _build.I,
                        _build.I, _build.P])
    err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
             q_start.data_ptr(), lens.data_ptr(), out.data_ptr(), b, c, hq,
             hkv, d, bs, table.shape[1], float(scale), int(window),
             int(sink), float(softcap), _DTYPES[q.dtype], page_dtype,
             _build.stream_ptr(q.device))
    name = "paged_prefill_attention" + sfx
    _build.count_launch(name)
    _build.check("paged_attention", err, name)
    return out
