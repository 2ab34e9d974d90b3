"""Weight-only GEMMs: K4 (W8A16, ``wo_matmul``), K12 (packed W4A16,
``wo_matmul_packed``) and K13 (packed W4A16 with group scales,
``wo_matmul_packed_grouped``), counterparts of ops/wo_matmul.py.

``out = (bf16 x @ int8 qweight) * scale_col`` with f32 sums, the weight in
the JAX package's (K, N) layout. A CPU tensor takes the plain version
(``ops.ref.wo_matmul``). A CUDA tensor launches the kernel of
csrc/wo_matmul.cu, which reads the int8 weight in place — a GEMV-style
kernel for M <= 16 (decode), a bf16 tensor-core GEMM over int8 tiles
converted in shared memory above that (prefill) — or raises. The kernel
takes K % 32 == 0 and N % 128 == 0 (the JAX kernel asks for multiples of
128 of both).

K12/K13 take the weight packed two int4 values a byte in quant.core's
K-half layout, int8 (K/2, N), and read it in place (0.5 byte a weight),
for any M (16-row slabs above 16 rows). K12 runs on the tensor cores with
K/2 split across blocks by ``packed_plan``, its splits summed in a fixed
order inside the one launch; K13 is a CUDA-core GEMV. Their plain versions
unpack (``quant.core.unpack_int4``) and run ``ref.wo_matmul`` /
``ref.wo_matmul_grouped``. They take K even and N % 128 == 0; K13 also
group_size % 8 == 0 and (K/2) % group_size == 0.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..quant import core as qcore
from . import _build, ref

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GEMV_MAX_ROWS = 16          # the kernel's decode regime: M <= 16

# K12's tiling (csrc/wo_matmul.cu packed_mma_kernel)
PACKED_COLS = 128           # output columns a block
PACKED_CHUNK = 64           # packed rows a ring stage
PACKED_STAGES = 4           # stages of the ring
PACKED_SLAB = 16            # rows of x a block
BLOCKS_PER_SM = 2           # the grid the split plan aims for


class PackedPlan(NamedTuple):
    """How K12 cuts one (M, K) x (K/2, N) product into blocks."""
    mt: int                 # rows of x an mma covers: 8 (M <= 8) or 16
    slabs: int              # 16-row slabs of x
    tiles: int              # 128-column tiles
    chunks: int             # 64-row chunks of the K/2 packed rows
    splits: int             # K ranges, one block each per tile and slab
    chunks_per_split: int
    grid: Tuple[int, int, int]
    smem: int               # dynamic shared memory a block, bytes
    scratch: Optional[Tuple[int, int, int, int]]   # f32 partials, if split


@functools.lru_cache(maxsize=4096)
def packed_plan(m: int, k: int, n: int, sms: int) -> PackedPlan:
    """K12's split of K/2: enough splits that the grid holds
    BLOCKS_PER_SM blocks an SM where the K range allows it, then equal
    ranges of whole chunks, none empty (the last may be shorter). A ring
    stage holds a chunk of the weight (rows padded by 16 bytes) and both
    halves of x at its rows (padded by 8 values)."""
    mt = 8 if m <= 8 else 16
    slabs = -(-m // PACKED_SLAB)
    tiles = n // PACKED_COLS
    chunks = -(-(k // 2) // PACKED_CHUNK)
    splits = max(1, -(-BLOCKS_PER_SM * sms // (tiles * slabs)))
    cps = -(-chunks // min(splits, chunks))
    splits = -(-chunks // cps)
    smem = PACKED_STAGES * (PACKED_CHUNK * (PACKED_COLS + 16)
                            + 2 * mt * (PACKED_CHUNK + 8) * 2)
    return PackedPlan(mt, slabs, tiles, chunks, splits, cps,
                      (tiles, splits, slabs), smem,
                      (splits, slabs, mt, n) if splits > 1 else None)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# device -> K12's buffers, reused by every launch on the device's stream
# in turn: the split tickets (zeros, and left zeroed by every launch: the
# last block of a column tile resets its counter) and the f32 partials
_TICKETS: dict = {}
_PARTIALS: dict = {}


def _grown(cache: dict, dev: torch.device, n: int, make) -> torch.Tensor:
    buf = cache.get(dev)
    if buf is None or buf.numel() < n:
        buf = make(max(n, 4096))
        cache[dev] = buf
    return buf


def wo_matmul_plain(x: torch.Tensor, qweight: torch.Tensor,
                    scale_col: torch.Tensor,
                    out_dtype=torch.bfloat16) -> torch.Tensor:
    return ref.wo_matmul(x, qweight, scale_col, out_dtype=out_dtype)


def wo_matmul(x: torch.Tensor, qweight: torch.Tensor,
              scale_col: torch.Tensor,
              out_dtype=torch.bfloat16) -> torch.Tensor:
    """K4: x (M, K) (cast to bf16, as the JAX kernel does), qweight (K, N)
    int8, scale_col (N,) f32 -> (M, N) out_dtype."""
    if not x.is_cuda:
        return wo_matmul_plain(x, qweight, scale_col, out_dtype)
    m, k = x.shape
    n = qweight.shape[1]
    if k % 32 or n % 128:
        raise ValueError(f"wo_matmul: weight ({k}, {n}) — the CUDA kernel "
                         "takes K % 32 == 0 and N % 128 == 0")
    if qweight.shape[0] != k or scale_col.shape != (n,):
        raise ValueError(f"wo_matmul: x {tuple(x.shape)}, qweight "
                         f"{tuple(qweight.shape)}, scale_col "
                         f"{tuple(scale_col.shape)} do not fit")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"wo_matmul: out_dtype {out_dtype} unsupported "
                         "(float32 or bfloat16)")
    if not (qweight.is_cuda and qweight.dtype == torch.int8
            and qweight.is_contiguous() and qweight.data_ptr() % 16 == 0):
        raise ValueError("wo_matmul: qweight must be a contiguous, 16-byte "
                         "aligned CUDA int8 tensor")
    xb = _build.aligned(x.to(torch.bfloat16))
    scol = scale_col.to(x.device, torch.float32).contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = _build.bind("wo_matmul", "mixq_wo_matmul",
                     [_build.P] * 4 + [_build.I] * 4 + [_build.P])
    err = fn(xb.data_ptr(), qweight.data_ptr(), scol.data_ptr(),
             out.data_ptr(), m, k, n, _OUT_DTYPES[out_dtype],
             _build.stream_ptr(x.device))
    _build.count_launch("wo_matmul")
    _build.check("wo_matmul", err, "wo_matmul")
    return out


def wo_matmul_packed_plain(x: torch.Tensor, qweight_packed: torch.Tensor,
                           scale_col: torch.Tensor,
                           out_dtype=torch.bfloat16) -> torch.Tensor:
    return ref.wo_matmul(x, qcore.unpack_int4(qweight_packed), scale_col,
                         out_dtype=out_dtype)


def wo_matmul_packed_grouped_plain(x: torch.Tensor,
                                   qweight_packed: torch.Tensor,
                                   scale_g: torch.Tensor, group_size: int,
                                   out_dtype=torch.bfloat16) -> torch.Tensor:
    if x.shape[1] != group_size * scale_g.shape[0]:
        raise ValueError(f"wo_matmul_packed_grouped: K {x.shape[1]} is not "
                         f"{scale_g.shape[0]} groups of {group_size}")
    return ref.wo_matmul_grouped(x, qcore.unpack_int4(qweight_packed),
                                 scale_g, out_dtype=out_dtype)


def _packed_checks(x, qweight_packed, out_dtype, what: str):
    m, k = x.shape
    kp, n = qweight_packed.shape
    if k != 2 * kp or n % 128:
        raise ValueError(f"{what}: x {tuple(x.shape)} and packed weight "
                         f"{tuple(qweight_packed.shape)} — the CUDA kernel "
                         "takes a (K/2, N) weight with N % 128 == 0")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{what}: out_dtype {out_dtype} unsupported "
                         "(float32 or bfloat16)")
    if not (qweight_packed.is_cuda and qweight_packed.dtype == torch.int8
            and qweight_packed.is_contiguous()
            and qweight_packed.data_ptr() % 16 == 0):
        raise ValueError(f"{what}: the packed weight must be a contiguous, "
                         "16-byte aligned CUDA int8 tensor")
    return m, k, n


def _launch_packed(x, qweight_packed, scale_col, out_dtype) -> torch.Tensor:
    what = "wo_matmul_packed"
    m, k, n = _packed_checks(x, qweight_packed, out_dtype, what)
    dev = x.device
    xb = _build.aligned(x.to(torch.bfloat16))
    sc = _build.aligned(scale_col.to(dev, torch.float32))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    plan = packed_plan(m, k, n, sm_count(dev.index
                                         if dev.index is not None
                                         else torch.cuda.current_device()))
    part = (_grown(_PARTIALS, dev, math.prod(plan.scratch),
                   lambda size: torch.empty((size,), dtype=torch.float32,
                                            device=dev))
            if plan.scratch else None)
    tickets = _grown(_TICKETS, dev, plan.tiles * plan.slabs,
                     lambda size: torch.zeros((size,), dtype=torch.int32,
                                              device=dev))
    fn = _build.bind("wo_matmul", "mixq_wo_matmul_packed",
                     [_build.P] * 6 + [_build.I] * 6 + [_build.P])
    err = fn(xb.data_ptr(), qweight_packed.data_ptr(), sc.data_ptr(),
             out.data_ptr(), None if part is None else part.data_ptr(),
             tickets.data_ptr(), m, k, n, plan.splits, plan.chunks_per_split,
             _OUT_DTYPES[out_dtype], _build.stream_ptr(dev))
    _build.count_launch(what)
    _build.check("wo_matmul", err, what)
    return out


def _launch_packed_grouped(x, qweight_packed, scale_g, group_size,
                           out_dtype) -> torch.Tensor:
    what = "wo_matmul_packed_grouped"
    m, k, n = _packed_checks(x, qweight_packed, out_dtype, what)
    xb = _build.aligned(x.to(torch.bfloat16))
    sc = _build.aligned(scale_g.to(x.device, torch.float32))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = _build.bind("wo_matmul", "mixq_wo_matmul_packed_grouped",
                     [_build.P] * 4 + [_build.I] * 5 + [_build.P])
    err = fn(xb.data_ptr(), qweight_packed.data_ptr(), sc.data_ptr(),
             out.data_ptr(), m, k, n, group_size, _OUT_DTYPES[out_dtype],
             _build.stream_ptr(x.device))
    _build.count_launch(what)
    _build.check("wo_matmul", err, what)
    return out


def wo_matmul_packed(x: torch.Tensor, qweight_packed: torch.Tensor,
                     scale_col: torch.Tensor,
                     out_dtype=torch.bfloat16) -> torch.Tensor:
    """K12: x (M, K) (cast to bf16), qweight_packed int8 (K/2, N) in the
    K-half layout, scale_col (N,) f32 -> (M, N) out_dtype."""
    if not x.is_cuda:
        return wo_matmul_packed_plain(x, qweight_packed, scale_col, out_dtype)
    if scale_col.shape != (qweight_packed.shape[1],):
        raise ValueError(f"wo_matmul_packed: scale_col "
                         f"{tuple(scale_col.shape)} does not fit the weight")
    return _launch_packed(x, qweight_packed, scale_col, out_dtype)


def wo_matmul_packed_grouped(x: torch.Tensor, qweight_packed: torch.Tensor,
                             scale_g: torch.Tensor, group_size: int,
                             out_dtype=torch.bfloat16) -> torch.Tensor:
    """K13: as K12 with scale_g (K/group_size, N) f32: low-nibble row k is
    in group k // group_size, high-nibble row k in K/(2 group_size) +
    k // group_size."""
    if not x.is_cuda:
        return wo_matmul_packed_grouped_plain(x, qweight_packed, scale_g,
                                              group_size, out_dtype)
    kp, n = qweight_packed.shape
    if group_size <= 0 or group_size % 8 or kp % group_size \
            or scale_g.shape != (2 * kp // group_size, n):
        raise ValueError(f"wo_matmul_packed_grouped: group_size "
                         f"{group_size}, scale_g {tuple(scale_g.shape)} and "
                         f"packed weight {(kp, n)} — the CUDA kernel takes "
                         "group_size % 8 == 0 and (K/2) % group_size == 0")
    return _launch_packed_grouped(x, qweight_packed, scale_g, group_size,
                                  out_dtype)
