"""Attention over the paged KV pool, counterparts of ops/paged_attention.py:
K7 (decode, one query token per lane), K9 (small-q verify, 2..8 query rows
per lane), K10 (decode with the softmax's running stats), K11 (decode split
over page ranges, merged exactly) and K8 (chunked prefill).

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
see no key at all set to 0, as the kernels give them; K10's plain version
is ``ops.ref.attention_stats`` over the gathered pages and scales. A CUDA
tensor launches the kernel of csrc/paged_attention.cu, or raises: its int8
instantiation for int8 pools, its unquantized one (no scale multiplies,
null scales; launches counted as ``*_fp``) for bf16 and f32 pools. The
kernels accept 16 <= BS <= 256, BS % 16 == 0, head_dim a multiple of 32
up to 256, and at most 227 KB of shared memory a block. K7 splits each
lane's table across the blocks of its one launch (``decode_plan``, from
the shapes alone) and merges the splits in the same launch; K9 and K10
share K7's skeleton with the S * Hq/Hkv rows of a KV head in groups of up
to 16 a warp (``rows_plan``); a decode whose query heads do not fit K7's
block takes that rows layout at S = 1 (``decode_route``). Routes by
dtype: bf16 q on int8 or bf16 pages runs K9/K10 on mma.sync and K8 on
wgmma tensor cores; f32 q or f32
pages (the f32 test models) run f32 arithmetic on CUDA cores (K9/K10's
body in f32, K8's prefill_kernel). K11 is one launch of K7's kernel over
the lanes' own tables, its splits inside the kv_splits ranges
(``split_decode_plan``), merged exactly in f32 in the same launch and
cast once (in JAX the merge is jnp outside the Pallas call); its plain
version splits the lanes and merges K10's plain parts with torch ops.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..quant import core as qcore
from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_PAGE_DTYPES = {**_DTYPES, torch.int8: 2}
# base position of a padded block_pos entry, beyond any real position
PAD_POS = 1 << 30
MAX_VERIFY_ROWS = 8           # the verify route's query rows per lane
_MAX_SMEM = 232448            # bytes of shared memory a block may opt in to
# K7's blocks (csrc/paged_attention.cu decode_split_kernel)
SPLIT_THREADS = 256
SPLIT_STAGES = 2              # stages of the ring
SPLIT_STAGE_KV = 32 * 1024    # bytes of K and V a ring stage, at most
# the grid a plan aims at: the blocks an SM holds at the main shapes (about
# 72 KB of shared memory each); other targets measured no faster at the
# smoke's decode shapes (PERF.md)
SPLIT_BLOCKS_PER_SM = 3
# K9 / K10's blocks (csrc/paged_attention.cu decode_rows_body): ROWS_WARPS
# warps where a KV head has at most 16 rows (one m-tile), 8 above (up to
# 16 rows a warp), a 2-stage ring (SPLIT_STAGES) of at most ROWS_STAGE_KV
# bytes of K and V a stage; the grid a plan aims at: ROWS_BLOCKS_PER_SM
# blocks an SM (measured faster at the smoke's shapes than 2 or 3 with
# more splits, and than 8 warps at one m-tile; PERF.md)
ROWS_WARPS = 4
ROWS_STAGE_KV = 32 * 1024
ROWS_BLOCKS_PER_SM = 1
# test hook for the negative controls: 1 leaves the last split that saw a
# key out of K7's (and K11's, the same kernel's) merge (a fault the checks
# must catch); 0 otherwise
K7_MERGE_DROP = 0


class DecodePlan(NamedTuple):
    """How K7 cuts each lane's table: `splits` ranges of
    `pages_per_split` entries, one block each per (lane, KV head)."""
    splits: int
    pages_per_split: int
    grid: Tuple[int, int, int]
    scratch: Optional[int]     # f32 partials, if split


@functools.lru_cache(maxsize=4096)
def decode_plan(b: int, hkv: int, g: int, d: int, mb: int,
                sms: int) -> DecodePlan:
    """As many splits as bring the grid to SPLIT_BLOCKS_PER_SM blocks an
    SM, one wave of resident blocks, at most one an entry of the table
    (the lengths stay on the device, so the table width MB bounds them),
    then equal ranges of whole entries: every entry in exactly one split,
    none empty (the last may be shorter)."""
    splits = max(1, min(mb, -(-SPLIT_BLOCKS_PER_SM * sms // (b * hkv))))
    per = -(-mb // splits)
    splits = -(-mb // per)
    return DecodePlan(splits, per, (hkv, b, splits),
                      b * hkv * splits * g * (d + 2) if splits > 1 else None)


class SplitDecodePlan(NamedTuple):
    """How K11 cuts each lane's table: kv_splits ranges of `range_pages`
    entries (the table's width rounded up to a multiple of kv_splits, as
    the JAX package pads it), each cut into `splits_per_range` splits of
    `pages_per_split` entries; `splits` in all, one block each per (lane,
    KV head), merged in split order."""
    range_pages: int
    splits_per_range: int
    pages_per_split: int
    splits: int
    scratch: Optional[int]     # f32 partials, if split


@functools.lru_cache(maxsize=4096)
def split_decode_plan(b: int, hkv: int, g: int, d: int, mb: int,
                      kv_splits: int, sms: int) -> SplitDecodePlan:
    """K11's plan: kv_splits ranges of ceil(MB / kv_splits) entries, each
    cut into the fewest equal splits that give at least decode_plan's
    split count in all (so the grid fills the card as K7's does). A split
    lies inside one range; entries past MB (the JAX package's padding)
    belong to no split, and a range past MB is an empty split. Shapes
    only, as decode_plan."""
    if kv_splits < 1:
        raise ValueError(f"kv_splits {kv_splits}: must be >= 1")
    width = -(-mb // kv_splits)
    least = decode_plan(b, hkv, g, d, mb, sms).splits
    # cutting a range into `sub` equal parts of `per` entries leaves
    # ceil(width / per) non-empty ones; sub = width (one entry each) gives
    # kv_splits * width >= MB >= least, so the search ends
    sub = -(-least // kv_splits)
    while kv_splits * -(-width // -(-width // sub)) < least:
        sub += 1
    per = -(-width // sub)
    sub = -(-width // per)
    splits = kv_splits * sub
    return SplitDecodePlan(width, sub, per, splits,
                           b * hkv * splits * g * (d + 2) if splits > 1
                           else None)


@functools.lru_cache(maxsize=4096)
def decode_split_smem(g: int, d: int, bs: int, page_bytes: int,
                      quant: bool) -> int:
    """K7's dynamic shared memory a block (csrc split_layout): the ring's
    stages of ST tokens' K, V (and scales), q padded per 16-byte chunk,
    the probabilities, the token groups' partial sums and 3 stats a row."""
    st = bs
    while st % 2 == 0 and st > 8 and 2 * st * d * page_bytes > SPLIT_STAGE_KV:
        st //= 2
    stage = -(-(2 * st * d * page_bytes + (8 * st if quant else 0)) // 128) \
        * 128
    ce = 16 // page_bytes
    q_floats = g * (d * page_bytes // 16) * (ce if (ce // 4) % 2 else ce + 4)
    tg = SPLIT_THREADS // (d // 4)
    return SPLIT_STAGES * stage + 4 * (q_floats + g * st + tg * g * d + 3 * g)


def rows_warps(rows: int) -> int:
    """The warps of a K9 / K10 block for `rows` rows of a KV head."""
    return ROWS_WARPS if rows <= 16 else 8


class RowsPlan(NamedTuple):
    """How K9 / K10 cut their work: blocks of `warps` warps, the S *
    Hq/Hkv rows of a KV head in `groups` of up to 16 a warp, each lane's
    table in `splits` ranges of `pages_per_split` entries; one block each
    per (lane, KV head)."""
    warps: int
    groups: int
    splits: int
    pages_per_split: int
    grid: Tuple[int, int, int]
    scratch: Optional[int]     # f32 partials, if split
    tickets: int


@functools.lru_cache(maxsize=4096)
def rows_plan(b: int, hkv: int, rows: int, d: int, mb: int,
              sms: int) -> RowsPlan:
    """decode_plan's rule for K9 / K10's blocks of rows_warps(rows) warps
    (16 rows each at most): as many splits as bring the grid to
    ROWS_BLOCKS_PER_SM blocks an SM, at most one an entry of the table,
    then equal ranges of whole entries (none empty). The lengths stay on
    the device: shapes only."""
    warps = rows_warps(rows)
    groups = -(-rows // (16 * warps))
    lanes = b * hkv * groups
    splits = max(1, min(mb, -(-ROWS_BLOCKS_PER_SM * sms // lanes)))
    per = -(-mb // splits)
    splits = -(-mb // per)
    return RowsPlan(warps, groups, splits, per, (hkv, b, groups * splits),
                    b * hkv * splits * rows * (d + 2) if splits > 1 else None,
                    lanes)


@functools.lru_cache(maxsize=4096)
def rows_smem(rows: int, d: int, bs: int, page_bytes: int, quant: bool,
              mma: bool) -> int:
    """K9 / K10's dynamic shared memory a block of rows_warps(rows) warps
    (csrc rows_layout): the ring's 2 stages of ST tokens' K, V (and
    scales; ST the largest multiple of 16 dividing BS whose K and V fit
    ROWS_STAGE_KV) and q (mma fragments, or f32 rows) for the m-tiles of
    min(rows, 16 x warps) rows; the warps' merge slots reuse that memory
    at the end."""
    warps = rows_warps(rows)
    st = next((c for c in range(bs, 16, -16)
               if bs % c == 0 and 2 * c * d * page_bytes <= ROWS_STAGE_KV), 16)
    stage = -(-(2 * st * d * page_bytes + (8 * st if quant else 0)) // 128) \
        * 128
    mt = -(-min(rows, 16 * warps) // 16)
    mtp = 8 if mt > 4 else 4 if mt > 2 else mt
    merge = 4 * warps * 32 * (d // 2 + 4)
    q_bytes = mtp * (d // 16) * 32 * 16 if mma else mtp * 16 * d * 4
    return max(SPLIT_STAGES * stage + q_bytes, merge)


def check_kernel_geometry(block_size: int, head_dim: int) -> None:
    """Raise unless the CUDA attention kernels take this page geometry."""
    if not (16 <= block_size <= 256 and block_size % 16 == 0):
        raise ValueError(f"block_size {block_size}: the CUDA paged-attention "
                         "kernels take 16..256 in steps of 16")
    if not (head_dim % 32 == 0 and head_dim <= 256):
        # K7's token groups are kSplitThreads / (D / 4) threads
        # (csrc/paged_attention.cu): not whole at D = 80 (Phi-2, OPT-2.7B,
        # Pythia-2.8B, StableLM-3B), whose port is still to come
        raise ValueError(f"head_dim {head_dim}: the CUDA paged-attention "
                         "kernels of csrc/paged_attention.cu take multiples "
                         "of 32 up to 256")


def identity_block_pos(block_table: torch.Tensor, bs: int) -> torch.Tensor:
    mb = block_table.shape[1]
    pos = torch.arange(mb, dtype=torch.int32, device=block_table.device) * bs
    return pos[None, :].expand(block_table.shape[0], mb)


def gather_pages(pages: torch.Tensor, scales: Optional[torch.Tensor],
                 block_table: torch.Tensor, dtype) -> torch.Tensor:
    """(NP, H, BS, D) pool -> (B, MB*BS, H, D) view of each lane's pages,
    dequantized when ``scales`` is given."""
    tb = block_table.long()
    x = qcore.raw(pages)[tb].view(pages.dtype)      # (B, MB, H, BS, D)
    b, mb, h, bs, d = x.shape
    if scales is not None:
        x = x.float() * scales[tb][..., None]
    return x.to(dtype).permute(0, 1, 3, 2, 4).reshape(b, mb * bs, h, d)


def keep_mask(block_table, block_pos, bs: int, q_pos, lens, window: int,
               sink: int) -> torch.Tensor:
    """(B, 1, S, MB*BS) keep mask of queries at q_pos (B, S) over the
    lane's pages: causal, below lens, optional window + sinks."""
    b, mb = block_table.shape
    if block_pos is None:
        block_pos = identity_block_pos(block_table, bs)
    kv_pos = (block_pos.long()[:, :, None]
              + torch.arange(bs, device=block_table.device)
              ).reshape(b, 1, 1, mb * bs)
    qp = q_pos.long()[:, None, :, None]                      # (B,1,S,1)
    keep = (kv_pos <= qp) & (kv_pos < lens.long()[:, None, None, None])
    if window:
        keep &= (kv_pos > qp - window) | (kv_pos < sink)
    return keep


def paged_attention_plain(q: torch.Tensor, k_pages, v_pages, k_scale,
                          v_scale, block_table: torch.Tensor,
                          q_pos: torch.Tensor, lens: torch.Tensor,
                          scale: float, block_pos=None, window: int = 0,
                          sink: int = 0, softcap: float = 0.0
                          ) -> torch.Tensor:
    """q (B, S, Hq, D) at absolute positions q_pos (B, S) -> (B, S, Hq, D)
    in q's dtype, computed in f32 over the gathered, dequantized pages."""
    keep = keep_mask(block_table, block_pos, k_pages.shape[2], q_pos, lens,
                      window, sink)
    k = gather_pages(k_pages, k_scale, block_table, torch.float32)
    v = gather_pages(v_pages, v_scale, block_table, torch.float32)
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
    if any(t is not None and t.data_ptr() % 16
           for t in (k_pages, v_pages, k_scale, v_scale)):
        raise ValueError(f"{what}: page pools and scales must be 16-byte "
                         "aligned")
    if block_pos is None:
        block_pos = identity_block_pos(block_table, bs)
    dev = q.device
    table = block_table.to(dev, torch.int32).contiguous()
    bpos = block_pos.to(dev, torch.int32).contiguous()
    ptrs = [t.data_ptr() if t is not None else None
            for t in (k_pages, v_pages, k_scale, v_scale)]
    return (ptrs, _PAGE_DTYPES[k_pages.dtype], "" if quant else "_fp", hkv,
            bs, d, table, bpos)


_TAIL = [_build.F, _build.I, _build.I, _build.F, _build.I, _build.I,
         _build.P]          # scale, window, sink, softcap, dtypes, stream


def _check_heads(q_d: int, hq: int, hkv: int, d: int, what: str) -> None:
    if q_d != d or hq % hkv:
        raise ValueError(f"{what}: q with {hq} heads of dim {q_d} does not "
                         f"fit pages with {hkv} heads of dim {d}")


def _check_q(q, hq: int, hkv: int, d: int, s: int, bs: int, k_pages,
             quant: bool, what: str) -> None:
    """Raise unless q's heads fit the pages and K9 / K10's block fits its
    shared memory (``rows_smem``)."""
    _check_heads(q.shape[-1], hq, hkv, d, what)
    rows = s * (hq // hkv)
    mma = q.dtype == torch.bfloat16 and k_pages.dtype != torch.float32
    need = rows_smem(rows, d, bs, k_pages.element_size(), quant, mma)
    if need > _MAX_SMEM:
        raise ValueError(f"{what}: {rows} query rows per KV head need {need} "
                         f"bytes of shared memory (at most {_MAX_SMEM})")


def _check_split(q_d: int, hq: int, hkv: int, d: int, bs: int,
                 page_bytes: int, quant: bool, what: str) -> None:
    """Raise unless q's heads fit the pages and K7's block fits its shared
    memory (K11 has no other layout)."""
    _check_heads(q_d, hq, hkv, d, what)
    need = decode_split_smem(hq // hkv, d, bs, page_bytes, quant)
    if need > _MAX_SMEM:
        raise ValueError(f"{what}: {hq // hkv} query heads per KV head need "
                         f"{need} bytes of shared memory (at most "
                         f"{_MAX_SMEM})")


@functools.lru_cache(maxsize=4096)
def decode_route(g: int, d: int, bs: int, page_bytes: int, quant: bool,
                 mma: bool) -> str:
    """K7's layout for g query heads per KV head, from the shapes alone:
    "split" (decode_split_kernel) where its block fits the shared memory,
    else "rows" (K9's decode_rows_body at S = 1: the JAX package's decode
    kernel is one function for any number of rows) where that block fits;
    raises where neither does. Falcon-7B's 71 heads on one KV head and the
    MQA coders' 48 take the rows layout."""
    split = decode_split_smem(g, d, bs, page_bytes, quant)
    if split <= _MAX_SMEM:
        return "split"
    rows = rows_smem(g, d, bs, page_bytes, quant, mma)
    if rows <= _MAX_SMEM:
        return "rows"
    raise ValueError(f"paged_decode_attention: {g} query heads per KV head "
                     f"need {split} bytes of shared memory in K7's split "
                     f"layout and {rows} in its rows layout (at most "
                     f"{_MAX_SMEM})")


def paged_decode_attention(q: torch.Tensor, k_pages, v_pages, k_scale,
                           v_scale, block_table: torch.Tensor,
                           lens: torch.Tensor, scale: float,
                           block_pos=None, window: int = 0, sink: int = 0,
                           softcap: float = 0.0, stats: bool = False):
    """K7: q (B, Hq, D), the query at position lens-1 -> (B, Hq, D) in q's
    dtype. Its layout comes from the shapes (``decode_route``): the split
    kernel, or, where a KV head's query heads do not fit its block
    (Falcon-7B's 71, the MQA coders' 48), K9's rows kernel at S = 1,
    counted as ``paged_decode_attention_rows``.

    stats=True is K10: -> (out (B, Hq, D), m (B, Hq), l (B, Hq)), all f32:
    the normalized output and the softmax's running max and denominator,
    so a caller can merge exactly with attention over other keys
    (``ref.merge_attention_stats``). A row that sees no key gives out 0,
    m -1e30 and l 0."""
    if not q.is_cuda:
        if stats:
            return paged_decode_attention_stats_plain(
                q, k_pages, v_pages, k_scale, v_scale, block_table, lens,
                scale, block_pos, window, sink, softcap)
        return paged_attention_plain(
            q[:, None], k_pages, v_pages, k_scale, v_scale, block_table,
            (lens - 1)[:, None], lens, scale, block_pos, window, sink,
            softcap)[:, 0]
    what = "paged_decode_attention" + ("_stats" if stats else "")
    ptrs, page_dtype, sfx, hkv, bs, d, table, bpos = _cuda_args(
        q, k_pages, v_pages, k_scale, v_scale, block_table, block_pos, what)
    b, hq, _ = q.shape
    q = q.contiguous()
    lens = lens.to(q.device, torch.int32).contiguous()
    mb = table.shape[1]
    tail = (float(scale), int(window), int(sink), float(softcap))
    codes = (_DTYPES[q.dtype], page_dtype, _build.stream_ptr(q.device))
    if stats:
        _check_q(q, hq, hkv, d, 1, bs, k_pages, k_scale is not None, what)
        plan = rows_plan(b, hkv, hq // hkv, d, mb,
                         _build.device_sms(q.device))
        part, tickets = _build.scratch(q.device, plan.scratch or 0,
                                       plan.tickets)
        out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
        m = torch.empty((b, hq), dtype=torch.float32, device=q.device)
        l = torch.empty_like(m)
        fn = _build.bind("paged_attention",
                         "mixq_paged_decode_attention_stats",
                         [_build.P] * 13 + [_build.I] * 10 + _TAIL)
        err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), m.data_ptr(), l.data_ptr(),
                 part, tickets, b, hq, hkv, d, bs, mb, plan.groups,
                 plan.splits, plan.pages_per_split, plan.warps, *tail, *codes)
        result = (out, m, l)
    else:
        _check_heads(q.shape[2], hq, hkv, d, what)
        route = decode_route(hq // hkv, d, bs, k_pages.element_size(),
                             k_scale is not None,
                             q.dtype == torch.bfloat16
                             and k_pages.dtype != torch.float32)
        if route == "rows":
            err, out = _decode_rows(q[:, None], ptrs, table, bpos, lens,
                                    lens - 1, hkv, d, bs, tail, codes)
            result = out[:, 0]
            what += "_rows"
        else:
            plan = decode_plan(b, hkv, hq // hkv, d, mb,
                               _build.device_sms(q.device))
            err, result = _decode_split(
                q, ptrs, table, bpos, lens, plan.splits,
                plan.splits * plan.pages_per_split, plan.splits,
                plan.pages_per_split, plan.scratch, hkv, d, bs, tail, codes)
    name = what + sfx
    _build.count_launch(name)
    _build.check("paged_attention", err, name)
    return result


def _decode_split(q, ptrs, table, bpos, lens, splits: int, range_pages: int,
                  splits_per_range: int, pages_per_split: int,
                  scratch: Optional[int], hkv: int, d: int, bs: int, tail,
                  codes):
    """One launch of decode_split_kernel (K7 and K11) on checked
    arguments: `splits` splits in ranges of range_pages entries,
    splits_per_range a range, `scratch` f32 partials. Returns (error
    code, out in q's dtype)."""
    b, hq, _ = q.shape
    part, tickets = _build.scratch(q.device, scratch or 0, b * hkv)
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "mixq_paged_decode_attention",
                     [_build.P] * 11 + [_build.I] * 10
                     + [_build.F, _build.I, _build.I, _build.F]
                     + [_build.I] * 3 + [_build.P])
    err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
             lens.data_ptr(), out.data_ptr(), part, tickets, b, hq, hkv, d,
             bs, table.shape[1], splits, range_pages, splits_per_range,
             pages_per_split, *tail, int(K7_MERGE_DROP), *codes)
    return err, out


def _decode_rows(q, ptrs, table, bpos, lens, qstart, hkv: int, d: int,
                 bs: int, tail, codes):
    """One launch of verify_rows_kernel (K9, and K7's rows layout at S =
    1) on checked arguments: q (B, S, Hq, D), row r of lane b at position
    qstart[b] + r. Returns (error code, out (B, S, Hq, D) in q's dtype)."""
    b, s, hq, _ = q.shape
    q = q.contiguous()
    qstart = qstart.to(q.device, torch.int32).contiguous()
    lens = lens.to(q.device, torch.int32).contiguous()
    mb = table.shape[1]
    plan = rows_plan(b, hkv, s * (hq // hkv), d, mb,
                     _build.device_sms(q.device))
    part, tickets = _build.scratch(q.device, plan.scratch or 0, plan.tickets)
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "mixq_paged_verify_attention",
                     [_build.P] * 12 + [_build.I] * 11 + _TAIL)
    err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
             lens.data_ptr(), qstart.data_ptr(), out.data_ptr(), part,
             tickets, b, s, hq, hkv, d, bs, mb, plan.groups, plan.splits,
             plan.pages_per_split, plan.warps, *tail, *codes)
    return err, out


def _gather_scales(scales: torch.Tensor, block_table: torch.Tensor
                   ) -> torch.Tensor:
    """(NP, H, BS) page scales -> (B, MB*BS, H), as gather_pages lays out
    the pages."""
    x = scales[block_table.long()]                  # (B, MB, H, BS)
    b, mb, h, bs = x.shape
    return x.permute(0, 1, 3, 2).reshape(b, mb * bs, h)


def paged_decode_attention_stats_plain(q: torch.Tensor, k_pages, v_pages,
                                       k_scale, v_scale, block_table,
                                       lens: torch.Tensor, scale: float,
                                       block_pos=None, window: int = 0,
                                       sink: int = 0, softcap: float = 0.0):
    """K10's plain version: ``ref.attention_stats`` over the lane's
    gathered pages, the int8 K scale on the logits and the V scale on the
    probabilities as the kernel applies them -> (out, m, l) f32."""
    keep = keep_mask(block_table, block_pos, k_pages.shape[2],
                      (lens - 1)[:, None], lens, window, sink)
    k = gather_pages(k_pages, None, block_table, torch.float32)
    v = gather_pages(v_pages, None, block_table, torch.float32)
    ks = vs = None
    if k_scale is not None:
        ks = _gather_scales(k_scale, block_table)
        vs = _gather_scales(v_scale, block_table)
    out, m, l = ref.attention_stats(q[:, None], k, v, ks, vs, mask=keep,
                                    scale=scale, softcap=softcap)
    return out[:, 0], m[..., 0], l[..., 0]


def paged_verify_attention(q: torch.Tensor, k_pages, v_pages, k_scale,
                           v_scale, block_table: torch.Tensor,
                           lens: torch.Tensor, qstart: torch.Tensor,
                           scale: float, block_pos=None, window: int = 0,
                           sink: int = 0, softcap: float = 0.0
                           ) -> torch.Tensor:
    """K9: q (B, S, Hq, D), 1 <= S <= 8 query rows per lane at absolute
    positions qstart .. qstart+S-1 -> (B, S, Hq, D) in q's dtype: the
    speculative verify's gamma+1 rows, on the decode kernel's rows. At
    S = 1 with qstart = lens-1 it is K10's output in q's dtype, bit for
    bit. A row past lens-1 (a short draft prefill's padding) sees only
    the keys below lens, as in the JAX package's gather path; its Pallas
    kernel lets such rows see the page's unwritten slots, and no caller
    reads them."""
    b, s, hq, _ = q.shape
    if not q.is_cuda:
        q_pos = qstart[:, None] + torch.arange(s, device=q.device)
        return paged_attention_plain(q, k_pages, v_pages, k_scale, v_scale,
                                     block_table, q_pos, lens, scale,
                                     block_pos, window, sink, softcap)
    what = "paged_verify_attention"
    if not 1 <= s <= MAX_VERIFY_ROWS:
        raise ValueError(f"{what}: {s} query rows; the kernel takes 1.."
                         f"{MAX_VERIFY_ROWS} (K8 takes longer chunks)")
    ptrs, page_dtype, sfx, hkv, bs, d, table, bpos = _cuda_args(
        q, k_pages, v_pages, k_scale, v_scale, block_table, block_pos, what)
    _check_q(q, hq, hkv, d, s, bs, k_pages, k_scale is not None, what)
    err, out = _decode_rows(
        q, ptrs, table, bpos, lens, qstart, hkv, d, bs,
        (float(scale), int(window), int(sink), float(softcap)),
        (_DTYPES[q.dtype], page_dtype, _build.stream_ptr(q.device)))
    name = what + sfx
    _build.count_launch(name)
    _build.check("paged_attention", err, name)
    return out


def _split_lanes(q, lens, block_table, block_pos, bs: int, splits: int):
    """Each lane's page list cut into ``splits`` consecutive ranges, one
    lane each (JAX :505-528): a table width that is not a multiple of
    ``splits`` is padded with its last real block and PAD_POS bases; table
    and block_pos reshaped to (B*splits, MB/splits), q and lens repeated
    per split."""
    if splits < 1:
        raise ValueError(f"kv_splits {splits}: must be >= 1")
    b, mb = block_table.shape
    if block_pos is None:
        block_pos = identity_block_pos(block_table, bs)
    pad = -mb % splits
    if pad:
        block_table = torch.cat(
            [block_table, block_table[:, -1:].expand(b, pad)], dim=1)
        block_pos = torch.cat(
            [block_pos, torch.full((b, pad), PAD_POS, dtype=block_pos.dtype,
                                   device=block_pos.device)], dim=1)
    return (q.repeat_interleave(splits, dim=0),
            lens.repeat_interleave(splits, dim=0),
            block_table.reshape(b * splits, -1),
            block_pos.reshape(b * splits, -1))


def _merge_splits(out, m, l, splits: int, dtype) -> torch.Tensor:
    """K10's (B*splits, ...) parts merged exactly in f32, cast once."""
    b, hq, d = out.shape[0] // splits, out.shape[1], out.shape[2]
    merged = ref.merge_stacked_stats(
        out.reshape(b, splits, 1, hq, d).transpose(0, 1),
        m.reshape(b, splits, hq, 1).transpose(0, 1),
        l.reshape(b, splits, hq, 1).transpose(0, 1))
    return merged[:, 0].to(dtype)


def paged_decode_attention_split_plain(q, k_pages, v_pages, k_scale,
                                       v_scale, block_table, lens, scale,
                                       block_pos=None, window: int = 0,
                                       sink: int = 0, softcap: float = 0.0,
                                       kv_splits: int = 2) -> torch.Tensor:
    """K11's plain version: the same split and merge over K10's plain
    version."""
    q2, lens2, table2, bpos2 = _split_lanes(q, lens, block_table, block_pos,
                                            k_pages.shape[2], kv_splits)
    parts = paged_decode_attention_stats_plain(
        q2, k_pages, v_pages, k_scale, v_scale, table2, lens2, scale, bpos2,
        window, sink, softcap)
    return _merge_splits(*parts, kv_splits, q.dtype)


def paged_decode_attention_split(q: torch.Tensor, k_pages, v_pages, k_scale,
                                 v_scale, block_table: torch.Tensor,
                                 lens: torch.Tensor, scale: float,
                                 block_pos=None, window: int = 0,
                                 sink: int = 0, softcap: float = 0.0,
                                 kv_splits: int = 2) -> torch.Tensor:
    """K11, flash-decoding: paged_decode_attention with each lane's page
    list split into ``kv_splits`` ranges (for long contexts at small
    batch), the ranges' softmax parts merged exactly in f32 and cast once
    to q's dtype. On the card: one launch of K7's kernel over the lanes'
    own tables, its splits inside those ranges (``split_decode_plan``),
    merged in the launch."""
    if not q.is_cuda:
        return paged_decode_attention_split_plain(
            q, k_pages, v_pages, k_scale, v_scale, block_table, lens, scale,
            block_pos, window, sink, softcap, kv_splits)
    what = "paged_decode_attention_split"
    ptrs, page_dtype, sfx, hkv, bs, d, table, bpos = _cuda_args(
        q, k_pages, v_pages, k_scale, v_scale, block_table, block_pos, what)
    b, hq, _ = q.shape
    _check_split(q.shape[2], hq, hkv, d, bs, k_pages.element_size(),
                 k_scale is not None, what)
    plan = split_decode_plan(b, hkv, hq // hkv, d, table.shape[1], kv_splits,
                             _build.device_sms(q.device))
    lens = lens.to(q.device, torch.int32).contiguous()
    tail = (float(scale), int(window), int(sink), float(softcap))
    codes = (_DTYPES[q.dtype], page_dtype, _build.stream_ptr(q.device))
    err, out = _decode_split(q.contiguous(), ptrs, table, bpos, lens,
                             plan.splits, plan.range_pages,
                             plan.splits_per_range, plan.pages_per_split,
                             plan.scratch, hkv, d, bs, tail, codes)
    _build.count_launch(what + sfx)
    _build.check("paged_attention", err, what + sfx)
    return out


def paged_prefill_attention(q: torch.Tensor, k_pages, v_pages, k_scale,
                            v_scale, block_table: torch.Tensor,
                            q_start: torch.Tensor, lens: torch.Tensor,
                            scale: float, block_pos=None, window: int = 0,
                            sink: int = 0, softcap: float = 0.0
                            ) -> torch.Tensor:
    """K8: q (B, C, Hq, D) at positions q_start[b] + 0..C-1 -> (B, C, Hq, D).

    Any C >= 1: bf16 q on int8 or bf16 pages runs on wgmma, a block of 128
    rows (the Hq/Hkv query heads of a KV head x 128 / (Hq/Hkv) tokens)
    reading each page once; f32 q or f32 pages run the f32 CUDA-core
    kernel (16 tokens of one query head a block). Rows past the prompt are
    don't-care; callers select by position."""
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
    q = _build.aligned(q)
    q_start = q_start.to(q.device, torch.int32).contiguous()
    lens = lens.to(q.device, torch.int32).contiguous()
    out = torch.empty_like(q)
    fn = _build.bind("paged_attention", "mixq_paged_prefill_attention",
                     [_build.P] * 10 + [_build.I] * 7 + _TAIL)
    err = fn(q.data_ptr(), *ptrs, table.data_ptr(), bpos.data_ptr(),
             q_start.data_ptr(), lens.data_ptr(), out.data_ptr(), b, c, hq,
             hkv, d, bs, table.shape[1], float(scale), int(window),
             int(sink), float(softcap), _DTYPES[q.dtype], page_dtype,
             _build.stream_ptr(q.device))
    name = "paged_prefill_attention" + sfx
    _build.count_launch(name)
    _build.check("paged_attention", err, name)
    return out
