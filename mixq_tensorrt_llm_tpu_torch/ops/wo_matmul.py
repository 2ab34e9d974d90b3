"""Weight-only GEMMs: K4 (W8A16, ``wo_matmul``), K12 (packed W4A16,
``wo_matmul_packed``) and K13 (packed W4A16 with group scales,
``wo_matmul_packed_grouped``), counterparts of ops/wo_matmul.py.

``out = (bf16 x @ int8 qweight) * scale_col`` with f32 sums, the weight in
the JAX package's (K, N) layout. A CPU tensor takes the plain version
(``ops.ref.wo_matmul``). A CUDA tensor launches a kernel of
csrc/wo_matmul.cu, which reads the int8 weight in place, or raises. K4
runs in two regimes, chosen by ``wo_plan`` from M alone: up to
K4_MMA_MAX_ROWS rows (decode, the speculative verify) the mma kernel, its
weight rows split across blocks and summed in a fixed order in the one
launch; above that (prefill) the wgmma + TMA GEMM. It takes K % 32 == 0
and N % 64 == 0 (the JAX kernel asks for multiples of 128 of both): the
last 128-column tile of the mma kernel may be half full (its copies and
stores predicated on N), the wgmma GEMM's last 256-column tile a quarter
to three quarters (TMA's zero fill, stores stopped at N); such launches
count as ``wo_matmul.n_tail`` too.

K12/K13 take the weight packed two int4 values a byte in quant.core's
K-half layout, int8 (K/2, N), and read it in place (0.5 byte a weight),
for any M (16-row slabs above 16 rows), on the same mma kernel: K/2 split
by ``packed_plan`` / ``grouped_plan`` (K13's splits hold whole groups).
Their plain versions unpack (``quant.core.unpack_int4``) and run
``ref.wo_matmul`` / ``ref.wo_matmul_grouped``. They take K even and N %
128 == 0; K13 also group_size % 64 == 0 and (K/2) % group_size == 0 (its
plain version any group size).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..quant import core as qcore
from . import _build, ref
from ._build import sm_count  # noqa: F401  (kept as wo_matmul.sm_count)

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# the mma kernel's tiling (csrc/wo_matmul.cu wo_mma_body): K4 at small and
# mid M, K12 and K13
MMA_COLS = 128              # output columns a block
MMA_CHUNK = 64              # weight rows a ring stage
MMA_STAGES = 4              # stages of the ring
K4_MTS = (8, 16, 24, 32, 40, 48, 64)   # K4's rows of x a block
# K4 above this M runs the wgmma GEMM (wo_wgmma_kernel), whose block is
# GEMM_ROWS rows of x by GEMM_COLS columns with a GEMM_SMEM-byte ring: the
# crossover measured on the H100 (PERF.md, chip_smoke.py's K4 regimes)
K4_MMA_MAX_ROWS = 128
GEMM_ROWS, GEMM_COLS = 128, 256
GEMM_SMEM = 4 * (2 * 64 * 128 + 128 * 64 * 2) + 1024


def blocks_per_sm(mt: int) -> int:
    """Blocks of the mma kernel an SM holds: two (128 registers a thread)
    but at 64 rows of x (csrc/wo_matmul.cu's launch bounds)."""
    return 2 if mt < 64 else 1


class MmaPlan(NamedTuple):
    """How one weight-only product is cut into blocks. mt = 0 is K4's
    wgmma GEMM (no split, grid of row and column tiles)."""
    mt: int                 # rows of x a block
    slabs: int              # mt-row slabs of x
    tiles: int              # 128-column tiles
    chunks: int             # 64-row chunks of the weight's rows
    splits: int             # ranges of chunks, one block each per tile, slab
    chunks_per_split: int
    grid: Tuple[int, int, int]
    smem: int               # dynamic shared memory a block, bytes
    scratch: Optional[Tuple[int, int, int, int]]   # f32 partials, if split


def _mma_plan(mt: int, m: int, rows: int, n: int, sms: int, halves: int,
              unit: int = 1) -> MmaPlan:
    """Split the weight's `rows` so that the grid fills the blocks the
    SMs hold (``blocks_per_sm``) once, or twice where one wave would leave
    a quarter of them idle (the blocks of a second, partial wave stream
    alone at a fraction of the card's rate); then equal ranges of whole
    units of `unit` chunks, none empty (the last may be shorter). A ring
    stage holds a chunk of the weight (rows padded by 16 bytes) and
    `halves` slices of x at its rows (padded by 8 values)."""
    slabs = -(-m // mt)
    tiles = -(-n // MMA_COLS)
    chunks = -(-rows // MMA_CHUNK)
    units = -(-chunks // unit)
    slots, base = blocks_per_sm(mt) * sms, tiles * slabs
    splits = max(1, slots // base)
    if base * splits < 0.75 * slots:
        splits = max(1, 2 * slots // base)
    per_split = -(-units // min(splits, units))
    splits = -(-units // per_split)
    smem = MMA_STAGES * (MMA_CHUNK * (MMA_COLS + 16)
                         + halves * mt * (MMA_CHUNK + 8) * 2)
    return MmaPlan(mt, slabs, tiles, chunks, splits, per_split * unit,
                   (tiles, splits, slabs), smem,
                   (splits, slabs, mt, n) if splits > 1 else None)


@functools.lru_cache(maxsize=4096)
def packed_plan(m: int, k: int, n: int, sms: int) -> MmaPlan:
    """K12's split of the K/2 packed rows; 8 or 16 rows of x a block."""
    return _mma_plan(8 if m <= 8 else 16, m, k // 2, n, sms, 2)


@functools.lru_cache(maxsize=4096)
def grouped_plan(m: int, k: int, n: int, group_size: int,
                 sms: int) -> MmaPlan:
    """K13's: as K12's, every split whole groups of group_size packed rows
    (group_size % 64 == 0 and (K/2) % group_size == 0, which the wrapper
    checks)."""
    return _mma_plan(8 if m <= 8 else 16, m, k // 2, n, sms, 2,
                     unit=group_size // MMA_CHUNK)


@functools.lru_cache(maxsize=4096)
def wo_plan(m: int, k: int, n: int, sms: int,
            mma_max_rows: int = K4_MMA_MAX_ROWS) -> MmaPlan:
    """K4's regime and cut: up to mma_max_rows rows of x the mma kernel,
    the smallest of K4_MTS that holds M (64-row slabs above 64) and K split
    as K12's; above that the wgmma GEMM."""
    if m > mma_max_rows:
        grid = (-(-m // GEMM_ROWS), -(-n // GEMM_COLS), 1)
        return MmaPlan(0, grid[0], grid[1], -(-k // MMA_CHUNK), 1,
                       -(-k // MMA_CHUNK), grid, GEMM_SMEM, None)
    mt = next((t for t in K4_MTS if t >= m), K4_MTS[-1])
    return _mma_plan(mt, m, k, n, sms, 1)


def k4_regime(plan: MmaPlan) -> str:
    """K4's regime under ``plan``: "decode" (the mma kernel, <= 16 rows of
    x a block), "mid" (the mma kernel, more) or "prefill" (wgmma)."""
    return "prefill" if plan.mt == 0 else "decode" if plan.mt <= 16 else "mid"


def _scratch(dev: torch.device, plan: MmaPlan):
    """(partials or None, tickets) for a launch of the mma kernel."""
    return _build.scratch(dev, math.prod(plan.scratch) if plan.scratch
                          else 0, plan.tiles * plan.slabs)


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
    if k % 32 or n % 64:
        raise ValueError(f"wo_matmul: weight ({k}, {n}) — the CUDA kernel "
                         "takes K % 32 == 0 and N % 64 == 0")
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
    dev = x.device
    xb = _build.aligned(x.to(torch.bfloat16))
    scol = _build.aligned(scale_col.to(dev, torch.float32))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    plan = wo_plan(m, k, n, _build.device_sms(dev), K4_MMA_MAX_ROWS)
    part, tickets = _scratch(dev, plan)
    fn = _build.bind("wo_matmul", "mixq_wo_matmul",
                     [_build.P] * 6 + [_build.I] * 7 + [_build.P])
    err = fn(xb.data_ptr(), qweight.data_ptr(), scol.data_ptr(),
             out.data_ptr(), part, tickets, m, k, n, plan.mt, plan.splits,
             plan.chunks_per_split, _OUT_DTYPES[out_dtype],
             _build.stream_ptr(dev))
    _build.count_launch("wo_matmul")
    _build.count_launch("wo_matmul." + k4_regime(plan))   # by regime
    if n % MMA_COLS:                # a half column tile last
        _build.count_launch("wo_matmul.n_tail")
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


def _launch_packed(x, qweight_packed, scale, out_dtype,
                   group_size: int = 0) -> torch.Tensor:
    """K12 (group_size 0) or K13 on the mma kernel."""
    what = ("wo_matmul_packed_grouped" if group_size
            else "wo_matmul_packed")
    m, k, n = _packed_checks(x, qweight_packed, out_dtype, what)
    dev = x.device
    xb = _build.aligned(x.to(torch.bfloat16))
    sc = _build.aligned(scale.to(dev, torch.float32))
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    if group_size:
        plan = grouped_plan(m, k, n, group_size, _build.device_sms(dev))
        fn = _build.bind("wo_matmul", "mixq_wo_matmul_packed_grouped",
                         [_build.P] * 6 + [_build.I] * 8 + [_build.P])
        lead = (group_size,)
    else:
        plan = packed_plan(m, k, n, _build.device_sms(dev))
        fn = _build.bind("wo_matmul", "mixq_wo_matmul_packed",
                         [_build.P] * 6 + [_build.I] * 7 + [_build.P])
        lead = ()
    part, tickets = _scratch(dev, plan)
    err = fn(xb.data_ptr(), qweight_packed.data_ptr(), sc.data_ptr(),
             out.data_ptr(), part, tickets, m, k, n, *lead, plan.mt,
             plan.splits, plan.chunks_per_split, _OUT_DTYPES[out_dtype],
             _build.stream_ptr(dev))
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
    if group_size <= 0 or group_size % MMA_CHUNK or kp % group_size \
            or scale_g.shape != (2 * kp // group_size, n):
        raise ValueError(f"wo_matmul_packed_grouped: group_size "
                         f"{group_size}, scale_g {tuple(scale_g.shape)} and "
                         f"packed weight {(kp, n)} — the CUDA kernel takes "
                         f"group_size % {MMA_CHUNK} == 0 and (K/2) % "
                         "group_size == 0")
    return _launch_packed(x, qweight_packed, scale_g, out_dtype, group_size)
