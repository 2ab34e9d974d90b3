"""The MixQ mixed-precision GEMM: K2 (``mixed_matmul``) and K3
(``mixed_matmul_hybrid``), counterparts of ops/mixed_matmul.py, and
``mix_linear`` (K1 without the norm, then K2).

    out = (q_x @ qweight) * scale_row * scale_col + x_out @ fp_weight
          (int32 exact, then f32), optional SiLU, then out_dtype

A CPU tensor takes the plain version (``ops.ref.mixed_matmul``). A CUDA
tensor launches the kernels of csrc/mixed_matmul.cu or raises: K2 does the
int8 GEMM (int8 wgmma over a TMA ring), the outlier side GEMM and the
epilogue in one launch, cut into blocks by ``mixed_plan`` from the shapes
alone; K3 runs the same side GEMM and epilogue over an int32 accumulator
from ``torch._int_mm`` (the JAX function leaves that product to an XLA
dot). K2 takes K % 64 == 0, N % 64 == 0 (its last 256-column tile may be
a quarter, half or three quarters full: TMA fills the columns past N with
zeros and the stores stop at N; counted as ``mixed_matmul.n_tail`` too)
and ko % 8 == 0, any M; K3 N % 128 == 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build, ref
from . import norm_quant as nq

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# K2's tiling (csrc/mixed_matmul.cu mixed_wgmma_kernel)
MIX_NX = (16, 48, 128)      # rows of x a block: wgmma's n, chosen from M
MIX_COLS = 256              # output columns a block
MIX_DEPTH = 128             # k a ring stage
MIX_STAGES = 4


class MixedPlan(NamedTuple):
    """How one K2 product is cut into blocks."""
    nx: int                 # rows of x a block
    row_tiles: int
    col_tiles: int
    steps: int              # 128-deep k steps
    splits: int             # ranges of k steps, one block each per tile
    steps_per_split: int
    grid: Tuple[int, int, int]
    smem: int               # dynamic shared memory a block, bytes
    scratch: Optional[int]  # int32 partials, if split


@functools.lru_cache(maxsize=4096)
def mixed_plan(m: int, k: int, n: int, sms: int) -> MixedPlan:
    """The smallest of MIX_NX that holds M (128-row tiles above), 256
    columns a block, and K split into equal ranges of whole k steps where
    the tiles fill less than one block an SM (the 40-row verify: 48 tiles
    at qkv): as many splits as keep the grid within one wave, none empty
    (the last may be shorter)."""
    nx = next((t for t in MIX_NX if t >= m), MIX_NX[-1])
    row_tiles, col_tiles = -(-m // nx), -(-n // MIX_COLS)
    steps = -(-k // MIX_DEPTH)
    tiles = row_tiles * col_tiles
    splits = max(1, min(steps, sms // tiles))
    per_split = -(-steps // splits)
    splits = -(-steps // per_split)
    smem = MIX_STAGES * (2 * MIX_DEPTH * 128 + nx * 128) + 1024
    return MixedPlan(nx, row_tiles, col_tiles, steps, splits, per_split,
                     (row_tiles, col_tiles, splits), smem,
                     splits * tiles * nx * MIX_COLS if splits > 1 else None)


def mixed_matmul_plain(q_x, scale_row, x_outliers, qweight, scale_col,
                       fp_weight, silu: bool = False,
                       out_dtype=torch.bfloat16) -> torch.Tensor:
    return ref.mixed_matmul(q_x, scale_row, x_outliers, qweight, scale_col,
                            fp_weight, silu=silu, out_dtype=out_dtype)


# the hybrid schedule computes the same function
mixed_matmul_hybrid_plain = mixed_matmul_plain


def _operands(q_x, scale_row, x_outliers, qweight, scale_col, fp_weight,
              out_dtype, what: str, n_unit: int):
    """Check what the CUDA kernel takes (N a multiple of ``n_unit``); the
    operands ready to launch."""
    m, k = q_x.shape
    n, ko = qweight.shape[1], x_outliers.shape[1]
    if k % 64 or n % n_unit or ko % 8:
        raise ValueError(f"{what}: K = {k}, N = {n}, ko = {ko} — the CUDA "
                         f"kernel takes K % 64 == 0, N % {n_unit} == 0 and "
                         "ko % 8 == 0")
    if (qweight.shape[0] != k or scale_row.shape != (m,)
            or x_outliers.shape[0] != m or scale_col.shape != (n,)
            or fp_weight.shape != (ko, n)):
        raise ValueError(f"{what}: operand shapes do not fit q_x {m}x{k} and "
                         f"qweight {tuple(qweight.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"{what}: out_dtype {out_dtype} unsupported "
                         "(float32 or bfloat16)")
    for name, t, dt in (("q_x", q_x, torch.int8),
                        ("qweight", qweight, torch.int8),
                        ("fp_weight", fp_weight, torch.bfloat16)):
        if not (t.is_cuda and t.dtype == dt):
            raise ValueError(f"{what}: {name} must be a CUDA {dt} tensor")
    if not (qweight.is_contiguous() and qweight.data_ptr() % 16 == 0
            and fp_weight.is_contiguous() and fp_weight.data_ptr() % 16 == 0):
        raise ValueError(f"{what}: qweight and fp_weight must be contiguous "
                         "and 16-byte aligned")
    dev = q_x.device
    return (m, k, n, ko, _build.aligned(q_x),
            scale_row.to(dev, torch.float32).contiguous(),
            _build.aligned(x_outliers.to(dev, torch.bfloat16)),
            scale_col.to(dev, torch.float32).contiguous())


def mixed_matmul(q_x: torch.Tensor, scale_row: torch.Tensor,
                 x_outliers: torch.Tensor, qweight: torch.Tensor,
                 scale_col: torch.Tensor, fp_weight: torch.Tensor,
                 silu: bool = False, out_dtype=torch.bfloat16
                 ) -> torch.Tensor:
    """K2: q_x (M, K) int8, scale_row (M,), x_outliers (M, ko) bf16,
    qweight (K, N) int8, scale_col (N,), fp_weight (ko, N) bf16 -> (M, N)."""
    if not q_x.is_cuda:
        return mixed_matmul_plain(q_x, scale_row, x_outliers, qweight,
                                  scale_col, fp_weight, silu, out_dtype)
    m, k, n, ko, qx, srow, xo, scol = _operands(
        q_x, scale_row, x_outliers, qweight, scale_col, fp_weight, out_dtype,
        "mixed_matmul", 64)
    out = torch.empty((m, n), dtype=out_dtype, device=q_x.device)
    if m == 0:
        return out
    dev = q_x.device
    plan = mixed_plan(m, k, n, _build.device_sms(dev))
    part, tickets = _build.scratch(dev, plan.scratch or 0,
                                   plan.row_tiles * plan.col_tiles)
    fn = _build.bind("mixed_matmul", "mixq_mixed_matmul",
                     [_build.P] * 9 + [_build.I] * 9 + [_build.P])
    err = fn(qx.data_ptr(), srow.data_ptr(), xo.data_ptr(),
             qweight.data_ptr(), scol.data_ptr(), fp_weight.data_ptr(),
             out.data_ptr(), part, tickets, m, k, n, ko, int(silu), plan.nx,
             plan.splits, plan.steps_per_split, _OUT_DTYPES[out_dtype],
             _build.stream_ptr(dev))
    _build.count_launch("mixed_matmul")
    if n % MIX_COLS:                # the last column tile is partial
        _build.count_launch("mixed_matmul.n_tail")
    _build.check("mixed_matmul", err, "mixed_matmul")
    return out


def mixed_matmul_hybrid(q_x: torch.Tensor, scale_row: torch.Tensor,
                        x_outliers: torch.Tensor, qweight: torch.Tensor,
                        scale_col: torch.Tensor, fp_weight: torch.Tensor,
                        silu: bool = False, out_dtype=torch.bfloat16
                        ) -> torch.Tensor:
    """K3: the int32 product by ``torch._int_mm``, then one epilogue
    launch (side GEMM, rescale, SiLU). Same arguments as K2."""
    if not q_x.is_cuda:
        return mixed_matmul_hybrid_plain(q_x, scale_row, x_outliers, qweight,
                                         scale_col, fp_weight, silu,
                                         out_dtype)
    m, k, n, ko, qx, srow, xo, scol = _operands(
        q_x, scale_row, x_outliers, qweight, scale_col, fp_weight, out_dtype,
        "mixed_matmul_hybrid", 128)
    out = torch.empty((m, n), dtype=out_dtype, device=q_x.device)
    if m == 0:
        return out
    acc = _build.aligned(ref.int8_matmul(qx, qweight))
    fn = _build.bind("mixed_matmul", "mixq_mixed_epilogue",
                     [_build.P] * 6 + [_build.I] * 5 + [_build.P])
    err = fn(acc.data_ptr(), srow.data_ptr(), xo.data_ptr(), scol.data_ptr(),
             fp_weight.data_ptr(), out.data_ptr(), m, n, ko, int(silu),
             _OUT_DTYPES[out_dtype], _build.stream_ptr(q_x.device))
    _build.count_launch("mixed_matmul_hybrid")
    _build.check("mixed_matmul", err, "mixed_matmul_hybrid")
    return out


def mix_linear(x: torch.Tensor, qweight: torch.Tensor,
               scale_col: torch.Tensor, fp_ind: torch.Tensor,
               fp_weight: torch.Tensor, silu: bool = False,
               out_dtype=torch.bfloat16) -> torch.Tensor:
    """Float activations x (M, K) -> K1 (no norm) -> K2."""
    q_x, scale_row, x_out = nq.quant_split(x, fp_ind)
    return mixed_matmul(q_x, scale_row, x_out, qweight, scale_col, fp_weight,
                        silu=silu, out_dtype=out_dtype)
