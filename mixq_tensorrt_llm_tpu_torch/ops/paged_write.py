"""In-place paged KV writes: K5 (a few tokens a lane) and K6 (a
page-aligned prefill chunk) for int8 pools, K5p and K6p for unquantized
(bf16 or f32) pools: counterparts of ops/paged_write.py.

Pools are updated IN PLACE (JAX returns new arrays; here the pool tensors
passed in are mutated and the same dict is returned). Pools are
``{"k","v": (NP, H, BS, D)}`` plus ``{"k_scale","v_scale": (NP, H, BS)}``
f32 for int8 pools, whose new values are quantized per (token, head) here;
an unquantized pool takes the new values cast to its dtype.

A CPU tensor takes the plain version (quant.core.quantize_kv and a
scatter). A CUDA tensor launches one kernel of csrc/paged_write.cu, which
quantizes or casts inside the kernel bit-identically to the plain version,
or raises. ``paged_write_located`` is the layer's write
(runtime/kv_cache.paged_write on the card): the kernel also locates each
token's page and slot from the block table, so the call is one launch.
Row 0 is the trash page: masked tokens go there, and its contents are
garbage by contract (the kernels do not write it at all).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..quant import core as qcore
from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {**_DTYPES, torch.int8: 2}

# the S <= 8 columns (speculative verify, short draft prefills) take K5's
# kernel, as the JAX package routes them to its token kernel
MAX_TOKEN_COLUMNS = 8
# csrc/paged_write.cu: threads a block of each kernel, rows a lane group of
# K6 holds in flight, K6 blocks resident an SM (its __launch_bounds__), the
# largest page (K6's slab in shared memory) and head_dim (8 values a lane,
# at most 32 lanes a row)
TOKEN_THREADS, CHUNK_THREADS = 128, 256
CHUNK_ROWS = 4
CHUNK_BLOCKS_PER_SM = 4
MAX_BLOCK_SIZE = 1024
MAX_HEAD_DIM = 256


def paged_write_token_plain(pools: dict, pg: torch.Tensor, off: torch.Tensor,
                            new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """pools[...][pg[i], :, off[i]] = row i of new_k/new_v (N, H, D),
    quantized for int8 and e4m3 pools."""
    pg, off = pg.long(), off.long()
    if "k_scale" in pools:
        qk, sk = qcore.quantize_kv(new_k, dtype=pools["k"].dtype)
        qv, sv = qcore.quantize_kv(new_v, dtype=pools["v"].dtype)
        qcore.raw(pools["k"])[pg, :, off] = qcore.raw(qk)
        qcore.raw(pools["v"])[pg, :, off] = qcore.raw(qv)
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


def chunk_route(s: int, bs: int) -> bool:
    """Whether S tokens a lane take K6 (a page-aligned chunk) rather than
    K5: S % BS == 0 above the token route's MAX_TOKEN_COLUMNS."""
    return s > MAX_TOKEN_COLUMNS and s % bs == 0


class WritePlan(NamedTuple):
    """How a write kernel covers its rows: `vec` values a lane loads at
    once (8: 16-byte loads, 1: scalar, for rows that are not 16-byte
    aligned), `group` lanes a (token, head) row, `grid` blocks; K6 has
    `per_slab` blocks a (lane, slab), K5 0."""
    vec: int
    group: int
    grid: int
    per_slab: int


@functools.lru_cache(maxsize=4096)
def write_plan(chunk: bool, b: int, s: int, h: int, bs: int, d: int,
               aligned: bool, sms: int) -> WritePlan:
    """Shapes only (no readback, nothing allocated). A row of D values
    takes the power of two of lanes that gives each at most 8 of them. K5:
    a block per TOKEN_THREADS // group rows, at most 16 blocks an SM (the
    kernel walks the rest). K6: as many blocks a slab as make two waves of
    resident blocks over the lanes' slabs (a lane with nothing to write
    leaves its blocks idle), but no more than give each block one pass
    (CHUNK_ROWS rows a lane group)."""
    waves = 2
    vec = 8 if aligned and d % 8 == 0 else 1
    group = 1
    while 8 * group < d:
        group *= 2
    rows_pass = CHUNK_THREADS // group * CHUNK_ROWS
    if chunk:
        units = b * (s // bs)
        most = -(-(bs * 2 * h) // rows_pass)
        want = -(-waves * CHUNK_BLOCKS_PER_SM * sms // units)
        per_slab = max(1, min(most, want))
        return WritePlan(vec, group, units * per_slab, per_slab)
    rows = b * s * 2 * h
    grid = max(1, min(-(-rows // (TOKEN_THREADS // group)), 16 * sms))
    return WritePlan(vec, group, grid, 0)


def _check_cuda_pools(pools: dict, new_k: torch.Tensor, what: str) -> tuple:
    """Raise unless a kernel takes these pools. Returns the C entry point's
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


# the C entry's two element strides of each of its seven index tensors
# (32-bit: an index tensor is far below 2^31 elements)
_IndexStrides = ctypes.c_int * 14


def _index(t: Optional[torch.Tensor], dev, dtype=torch.int32):
    """An index tensor as the kernel reads it (on the card, int32 or bool,
    through its strides) and its two element strides (0 past its
    dimensions): the tensor itself, whatever its layout, when it already
    is on the card in that dtype, as the Executor's are, so the call
    queues nothing but the kernel."""
    if t is None:
        return None, (0, 0)
    if t.device != dev or t.dtype != dtype:
        t = t.to(dev, dtype)
    return t, (tuple(t.stride()) + (0, 0))[:2]


def _launch(pools: dict, new_k: torch.Tensor, new_v: torch.Tensor,
            chunk: bool, what: str, pg=None, off=None, table=None,
            block_pos=None, write_pos=None, valid=None,
            kv_valid_len=None) -> dict:
    """One launch of K5's (chunk False) or K6's kernel for new K/V (B, S,
    H, D), read through their strides, with the pages and slots given (pg,
    off) or located in the kernel from the table."""
    ptrs, page_dtype, sfx = _check_cuda_pools(pools, new_k, what)
    np_, h, bs, d = pools["k"].shape
    b, s = new_k.shape[:2]
    if new_k.shape != (b, s, h, d) or new_v.shape != new_k.shape:
        raise ValueError(f"{what}: new K/V {tuple(new_k.shape)} do not "
                         f"match pool heads/dim ({h}, {d})")
    if d > MAX_HEAD_DIM or bs > MAX_BLOCK_SIZE:
        raise ValueError(f"{what}: head_dim {d} / block size {bs} above "
                         f"the kernel's {MAX_HEAD_DIM} / {MAX_BLOCK_SIZE}")
    new_v = new_v.to(new_k.dtype)
    new_k, new_v = (t if t.stride(-1) == 1 else t.contiguous()
                    for t in (new_k, new_v))
    dev = new_k.device
    strides = [x for t in (new_k, new_v) for x in t.stride()[:3]]
    aligned = all(p % 16 == 0 for p in (new_k.data_ptr(), new_v.data_ptr(),
                                        ptrs[0], ptrs[1])) and \
        all(x % 8 == 0 for x in strides)
    plan = write_plan(chunk, b, s, h, bs, d, aligned, _build.device_sms(dev))
    mb = table.shape[1] if table is not None else 0
    fn = _build.bind("paged_write", "mixq_paged_write",
                     [_build.P] * 13 + [_build.LL] * 6 + [_build.P]
                     + [_build.I] * 13 + [_build.P])
    # held until the launch: a converted copy must outlive its pointer
    index = [_index(t, dev) for t in (pg, off, table, block_pos, write_pos)]
    index += [_index(valid, dev, torch.bool), _index(kv_valid_len, dev)]
    err = fn(*ptrs, *(None if t is None else t.data_ptr() for t, _ in index),
             new_k.data_ptr(), new_v.data_ptr(), *strides,
             _IndexStrides(*(x for _, st in index for x in st)), b, s, mb, h,
             bs, d, plan.group, plan.vec, int(chunk), plan.grid,
             plan.per_slab, _DTYPES[new_k.dtype], page_dtype,
             _build.stream_ptr(dev))
    name = ("paged_write_chunk" if chunk else "paged_write_token") + sfx
    _build.count_launch(name)
    _build.check("paged_write", err, name)
    return pools


def paged_write_located(pools: dict, block_table: torch.Tensor,
                        write_pos: torch.Tensor, new_k: torch.Tensor,
                        new_v: torch.Tensor,
                        valid: Optional[torch.Tensor] = None,
                        block_pos: Optional[torch.Tensor] = None,
                        kv_valid_len: Optional[torch.Tensor] = None) -> dict:
    """runtime/kv_cache.paged_write on the card, in one launch: new K/V (B,
    S, H, D) at positions write_pos (B, S) through the layer's block_table
    (B, MB) of global page rows, block_pos (B, MB) or None (the identity
    layout), and valid (B, S) and / or kv_valid_len (B,) (a position at or
    past it is invalid); invalid tokens are not written. S % BS == 0 above
    MAX_TOKEN_COLUMNS takes K6's kernel and its drop rule, anything else
    K5's. Index tensors are read as int32 (bool for valid) where they lie,
    through their strides; one in another dtype or on another device is
    converted first."""
    if not new_k.is_cuda:
        raise ValueError("paged_write_located: a CUDA tensor's route; the "
                         "CPU takes runtime/kv_cache.paged_write_plain")
    b, s = new_k.shape[:2]
    mb = block_table.shape[1]
    if mb < 1:
        raise ValueError("paged_write_located: an empty block table")
    if block_table.shape[0] != b or write_pos.shape != (b, s) or any(
            t is not None and t.shape != want for t, want in (
                (block_pos, (b, mb)), (valid, (b, s)),
                (kv_valid_len, (b,)))):
        raise ValueError("paged_write_located: index shapes do not match "
                         f"new K/V's (B, S) = ({b}, {s}) and the table's "
                         f"width {mb}")
    chunk = chunk_route(s, pools["k"].shape[2])
    return _launch(pools, new_k, new_v, chunk, "paged_write", table=
                   block_table, block_pos=block_pos, write_pos=write_pos,
                   valid=valid, kv_valid_len=kv_valid_len)


def paged_write_token(pools: dict, pg: torch.Tensor, off: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """K5 (int8 pools) / K5p (bf16, f32 pools): write one token per lane
    into page ``pg[b]``, slot ``off[b]`` (in [0, BS)).

    pg/off (B,) int; new_k/new_v (B, H, D). Lanes must own distinct pages
    (the trash page 0 excepted)."""
    if not new_k.is_cuda:
        return paged_write_token_plain(pools, pg, off, new_k, new_v)
    return _launch(pools, new_k[:, None], new_v[:, None], False,
                   "paged_write_token", pg=pg, off=off)


def paged_write_chunk(pools: dict, blk: torch.Tensor, off: torch.Tensor,
                      new_k: torch.Tensor, new_v: torch.Tensor) -> dict:
    """K6 (int8 pools) / K6p (bf16, f32 pools): write a page-aligned chunk
    per lane.

    blk/off (B, S) page row and in-page slot per token (blk 0 = trash);
    new_k/new_v (B, S, H, D); S % BS == 0. Tokens that do not sit at their
    slab slot are dropped rather than written to a wrong slot; callers
    that cannot guarantee alignment use the token route of
    runtime/kv_cache.paged_write."""
    bs = pools["k"].shape[2]
    b, s = blk.shape
    if s % bs:
        raise ValueError(f"paged_write_chunk: chunk {s} is not a multiple "
                         f"of the block size {bs}")
    if not new_k.is_cuda:
        return paged_write_chunk_plain(pools, blk, off, new_k, new_v)
    return _launch(pools, new_k, new_v, True, "paged_write_chunk", pg=blk,
                   off=off)
