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
K-half layout, int8 (K/2, N), and read it in place (0.5 byte a weight):
one GEMV-style kernel of the same file for any M, in 16-row slabs above
16 rows. Their plain versions unpack (``quant.core.unpack_int4``) and run
``ref.wo_matmul`` / ``ref.wo_matmul_grouped``. They take K even and
N % 128 == 0; K13 also group_size % 8 == 0 and (K/2) % group_size == 0.
"""

from __future__ import annotations

import torch

from ..quant import core as qcore
from . import _build, ref

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
GEMV_MAX_ROWS = 16          # the kernel's decode regime: M <= 16


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


def _launch_packed(x, qweight_packed, scale, group_size, out_dtype,
                   what: str) -> torch.Tensor:
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
    xb = _build.aligned(x.to(torch.bfloat16))
    sc = _build.aligned(scale.to(x.device, torch.float32))
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0:
        return out
    fn = _build.bind("wo_matmul", "mixq_wo_matmul_packed",
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
    return _launch_packed(x, qweight_packed, scale_col, 0, out_dtype,
                          "wo_matmul_packed")


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
    return _launch_packed(x, qweight_packed, scale_g, group_size, out_dtype,
                          "wo_matmul_packed_grouped")
