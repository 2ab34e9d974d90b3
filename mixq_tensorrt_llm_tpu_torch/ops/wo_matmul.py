"""Weight-only W8A16 GEMM: K4, counterpart of ops/wo_matmul.py ``wo_matmul``.

``out = (bf16 x @ int8 qweight) * scale_col`` with f32 sums, the weight in
the JAX package's (K, N) layout. A CPU tensor takes the plain version
(``ops.ref.wo_matmul``). A CUDA tensor launches the kernel of
csrc/wo_matmul.cu, which reads the int8 weight in place — a GEMV-style
kernel for M <= 16 (decode), a bf16 tensor-core GEMM over int8 tiles
converted in shared memory above that (prefill) — or raises. The kernel
takes K % 32 == 0 and N % 128 == 0 (the JAX kernel asks for multiples of
128 of both). The packed-int4 kernels of the same file (K12, K13) come
with the int4 slice.
"""

from __future__ import annotations

import torch

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
