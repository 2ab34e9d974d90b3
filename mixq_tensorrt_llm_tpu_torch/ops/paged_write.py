"""In-place paged KV writes: K5 (one decode token per lane) and K6 (a
page-aligned prefill chunk) for int8 pools, K5p and K6p for unquantized
(bf16 or f32) pools: counterparts of ops/paged_write.py.

Pools are updated IN PLACE (JAX returns new arrays; here the pool tensors
passed in are mutated and the same dict is returned). Pools are
``{"k","v": (NP, H, BS, D)}`` plus ``{"k_scale","v_scale": (NP, H, BS)}``
f32 for int8 pools, whose new values are quantized per (token, head) here;
an unquantized pool takes the new values cast to its dtype.

A CPU tensor takes the plain version (quant.core.quantize_kv and a
scatter). A CUDA tensor launches the kernel of csrc/paged_write.cu, which
quantizes or casts inside the kernel bit-identically to the plain version,
or raises. Row 0 is the trash page: masked lanes write there,
concurrently, and its contents are garbage by contract.
"""

from __future__ import annotations

import torch

from ..quant import core as qcore
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {**_DTYPES, torch.int8: 2}


def paged_write_token_plain(pools: dict, pg: torch.Tensor, off: torch.Tensor,
                            new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """pools[...][pg[i], :, off[i]] = row i of new_k/new_v (N, H, D),
    quantized for int8 pools."""
    pg, off = pg.long(), off.long()
    if "k_scale" in pools:
        qk, sk = qcore.quantize_kv(new_k)
        qv, sv = qcore.quantize_kv(new_v)
        pools["k"][pg, :, off] = qk
        pools["v"][pg, :, off] = qv
        pools["k_scale"][pg, :, off] = sk
        pools["v_scale"][pg, :, off] = sv
    else:
        pools["k"][pg, :, off] = new_k.to(pools["k"].dtype)
        pools["v"][pg, :, off] = new_v.to(pools["v"].dtype)
    return pools


def chunk_write_mask(blk: torch.Tensor, off: torch.Tensor,
                     bs: int) -> torch.Tensor:
    """(B, S) bool: which tokens of a page-aligned chunk land. A slab of BS
    tokens goes to its page max(blk); a token lands only if that page is
    real (> 0), its own blk is that page and its off is its slot in the
    slab (paged_write.py:199-207)."""
    b, s = blk.shape
    blk_s = blk.reshape(b, s // bs, bs)
    pg = blk_s.amax(dim=-1, keepdim=True)
    slot = torch.arange(bs, device=off.device, dtype=off.dtype)
    mask = (blk_s == pg) & (pg > 0) & (off.reshape(b, s // bs, bs) == slot)
    return mask.reshape(b, s)


def paged_write_chunk_plain(pools: dict, blk: torch.Tensor,
                            off: torch.Tensor, new_k: torch.Tensor,
                            new_v: torch.Tensor) -> dict:
    mask = chunk_write_mask(blk, off, pools["k"].shape[2])
    return paged_write_token_plain(pools, blk[mask], off[mask], new_k[mask],
                                   new_v[mask])


def _check_cuda_pools(pools: dict, new_k: torch.Tensor, what: str) -> tuple:
    """Raise unless a kernel takes these pools. Returns the C entry points'
    pool pointers (K/V pages, K/V scales or null), the page dtype code, and
    the launch-count suffix: "" for int8 pools (K5, K6), "_fp" for
    unquantized ones (K5p, K6p)."""
    quant = "k_scale" in pools
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    for name in names:
        t = pools[name]
        if not (t.is_cuda and t.is_contiguous()):
            raise ValueError(f"{what}: pool {name!r} must be a contiguous "
                             "CUDA tensor")
    if quant:
        if pools["k"].dtype != torch.int8 or pools["v"].dtype != torch.int8:
            raise ValueError(f"{what}: a pool with scales must be int8")
        if pools["k_scale"].dtype != torch.float32 or \
                pools["v_scale"].dtype != torch.float32:
            raise ValueError(f"{what}: scale pools must be float32")
    elif pools["k"].dtype not in _DTYPES or \
            pools["v"].dtype != pools["k"].dtype:
        raise ValueError(f"{what}: unquantized pools of {pools['k'].dtype} "
                         "unsupported (bfloat16 or float32)")
    if new_k.dtype not in _DTYPES:
        raise ValueError(f"{what}: new K/V dtype {new_k.dtype} unsupported "
                         "(float32 or bfloat16)")
    ptrs = [pools[n].data_ptr() for n in names] + [None] * (4 - len(names))
    return ptrs, _PAGE_DTYPES[pools["k"].dtype], "" if quant else "_fp"


def paged_write_token(pools: dict, pg: torch.Tensor, off: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """K5 (int8 pools) / K5p (bf16, f32 pools): write one token per lane
    into page ``pg[b]``, slot ``off[b]``.

    pg/off (B,) int; new_k/new_v (B, H, D). Lanes must own distinct pages
    (the trash page 0 excepted)."""
    if not new_k.is_cuda:
        return paged_write_token_plain(pools, pg, off, new_k, new_v)
    ptrs, page_dtype, sfx = _check_cuda_pools(pools, new_k,
                                              "paged_write_token")
    np_, h, bs, d = pools["k"].shape
    b = new_k.shape[0]
    if new_k.shape != (b, h, d) or new_v.shape != new_k.shape:
        raise ValueError(f"paged_write_token: new K/V {tuple(new_k.shape)} "
                         f"do not match pool heads/dim ({h}, {d})")
    new_k, new_v = new_k.contiguous(), new_v.to(new_k.dtype).contiguous()
    pg = pg.to(new_k.device, torch.int32).contiguous()
    off = off.to(new_k.device, torch.int32).contiguous()
    fn = _build.bind("paged_write", "mixq_paged_write_token",
                     [_build.P] * 8 + [_build.I] * 6 + [_build.P])
    err = fn(*ptrs, pg.data_ptr(), off.data_ptr(), new_k.data_ptr(),
             new_v.data_ptr(), b, h, bs, d, _DTYPES[new_k.dtype], page_dtype,
             _build.stream_ptr(new_k.device))
    name = "paged_write_token" + sfx
    _build.count_launch(name)
    _build.check("paged_write", err, name)
    return pools


def paged_write_chunk(pools: dict, blk: torch.Tensor, off: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """K6 (int8 pools) / K6p (bf16, f32 pools): write a page-aligned chunk
    per lane.

    blk/off (B, S) page row and in-page slot per token (blk 0 = trash);
    new_k/new_v (B, S, H, D); S % BS == 0. Tokens that do not sit at their
    slab slot are dropped rather than written to a wrong slot; callers
    that cannot guarantee alignment use the scatter path of
    runtime/kv_cache.paged_write."""
    bs = pools["k"].shape[2]
    b, s = blk.shape
    if s % bs:
        raise ValueError(f"paged_write_chunk: chunk {s} is not a multiple "
                         f"of the block size {bs}")
    if not new_k.is_cuda:
        return paged_write_chunk_plain(pools, blk, off, new_k, new_v)
    ptrs, page_dtype, sfx = _check_cuda_pools(pools, new_k,
                                              "paged_write_chunk")
    np_, h, _, d = pools["k"].shape
    if new_k.shape != (b, s, h, d) or new_v.shape != new_k.shape:
        raise ValueError(f"paged_write_chunk: new K/V {tuple(new_k.shape)} "
                         f"do not match ({b}, {s}, {h}, {d})")
    new_k, new_v = new_k.contiguous(), new_v.to(new_k.dtype).contiguous()
    blk = blk.to(new_k.device, torch.int32).contiguous()
    off = off.to(new_k.device, torch.int32).contiguous()
    fn = _build.bind("paged_write", "mixq_paged_write_chunk",
                     [_build.P] * 8 + [_build.I] * 7 + [_build.P])
    err = fn(*ptrs, blk.data_ptr(), off.data_ptr(), new_k.data_ptr(),
             new_v.data_ptr(), b, s, h, bs, d, _DTYPES[new_k.dtype],
             page_dtype, _build.stream_ptr(new_k.device))
    name = "paged_write_chunk" + sfx
    _build.count_launch(name)
    _build.check("paged_write", err, name)
    return pools
