"""Fused RMSNorm -> outlier split -> per-token int8 quantization: K1,
counterpart of ops/norm_quant.py (``rmsnorm_quant_split``, ``quant_split``).

Both return ``(q_x int8 (..., K), scale_row f32 (...), x_out bf16
(..., ko))`` with the outlier channels zeroed before quantization. The
normed row stays in f32, as in the TPU kernel; ``ops.ref``'s
``rmsnorm_quant_split`` rounds it to x's dtype first, so for bf16 inputs
the two can differ by one int8 step at rounding boundaries.

A CPU tensor takes the plain version. A CUDA tensor launches a kernel of
csrc/norm_quant.cu (one block per row; the TPU kernel's one-hot outlier
matmul is a direct gather there) or raises. The kernels take float32 or
bfloat16 rows with K % 8 == 0, K <= 32768: rows of up to
REG_THREADS * REG_MAX_CHUNKS chunks of 8 values live in registers
(``norm_quant_regs_kernel``), wider ones in shared memory
(``norm_quant_smem_kernel``); ``norm_quant_plan`` picks by K. The grid is
one wave of the blocks the card holds, each block walking rows (the C
side asks the runtime how many blocks an SM holds).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from . import _build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_K = 32768                     # the row must fit in shared memory (f32)
# the register kernel: at most REG_THREADS threads a row, each holding at
# most REG_MAX_CHUNKS chunks of 8 values (K <= 16384)
REG_THREADS = 512
REG_MAX_CHUNKS = 4
SHARED_THREADS = 512              # the shared-memory kernel's block
# chunks a thread, at fewer rows than SMs (one row a block: a short chain
# a row) and where the rows fill the card (fewer instructions a value;
# each block walks several rows); measured fastest at 7B and 13B widths,
# 40 and 1024 rows (PERF.md). Test hooks too.
FEW_ROW_CHUNKS = 2
MANY_ROW_CHUNKS = 4


class NormQuantPlan(NamedTuple):
    """K1's launch: which kernel, its threads a row (one block per row)
    and, for the register kernel, the chunks of 8 values a thread holds
    (0 for the shared-memory kernel)."""
    variant: str                  # "registers" or "shared"
    threads: int
    chunks_per_thread: int


def norm_quant_plan(m: int, k: int, sms: int) -> NormQuantPlan:
    """Rows of up to REG_THREADS * REG_MAX_CHUNKS chunks go to the
    register kernel: MANY_ROW_CHUNKS chunks a thread where the m rows give
    every one of the sms SMs a block, else FEW_ROW_CHUNKS, raised until
    the row fits REG_THREADS threads; threads a multiple of 32. Wider rows
    go to the shared-memory kernel."""
    chunks = k // 8
    if chunks > REG_THREADS * REG_MAX_CHUNKS:
        return NormQuantPlan("shared", SHARED_THREADS, 0)
    cpt = min(MANY_ROW_CHUNKS if m >= sms else FEW_ROW_CHUNKS,
              REG_MAX_CHUNKS)
    while -(-chunks // cpt) > REG_THREADS:
        cpt += 1
    return NormQuantPlan("registers", -(-chunks // (32 * cpt)) * 32, cpt)

Split = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def rmsnorm_quant_split_plain(x: torch.Tensor, gamma: torch.Tensor,
                              fp_ind: torch.Tensor,
                              eps: float = 1e-6) -> Split:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ref.quant_split(xf * torch.rsqrt(var + eps) * gamma.float(),
                           fp_ind)


def quant_split_plain(x: torch.Tensor, fp_ind: torch.Tensor) -> Split:
    return ref.quant_split(x, fp_ind)


def _launch(x: torch.Tensor, gamma, fp_ind: torch.Tensor, eps: float,
            what: str) -> Split:
    lead, k = x.shape[:-1], x.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what}: x dtype {x.dtype} unsupported (float32 or "
                         "bfloat16)")
    if k % 8 or k > MAX_K:
        raise ValueError(f"{what}: K = {k} — the CUDA kernel takes K % 8 == 0"
                         f" and K <= {MAX_K}")
    x2 = _build.aligned(x.reshape(-1, k))
    m, ko = x2.shape[0], fp_ind.shape[0]
    dev = x.device
    ind = fp_ind.to(dev, torch.int32).contiguous()
    g = (_build.aligned(gamma.to(dev, torch.float32)) if gamma is not None
         else None)
    q = torch.empty((m, k), dtype=torch.int8, device=dev)
    srow = torch.empty((m,), dtype=torch.float32, device=dev)
    xout = torch.empty((m, ko), dtype=torch.bfloat16, device=dev)
    if m:
        plan = norm_quant_plan(m, k, _build.device_sms(dev))
        fn = _build.bind("norm_quant", "mixq_norm_quant_split",
                         [_build.P] * 6 + [_build.I] * 3
                         + [_build.F] + [_build.I] * 4 + [_build.P])
        err = fn(x2.data_ptr(), None if g is None else g.data_ptr(),
                 ind.data_ptr(), q.data_ptr(), srow.data_ptr(),
                 xout.data_ptr(), m, k, ko, float(eps), int(g is not None),
                 _DTYPES[x.dtype], plan.threads, plan.chunks_per_thread,
                 _build.stream_ptr(dev))
        _build.count_launch("rmsnorm_quant_split")
        _build.check("norm_quant", err, what)
    return q.reshape(*lead, k), srow.reshape(lead), xout.reshape(*lead, ko)


def rmsnorm_quant_split(x: torch.Tensor, gamma: torch.Tensor,
                        fp_ind: torch.Tensor, eps: float = 1e-6) -> Split:
    """K1 with the norm: x (..., K), gamma (K,), fp_ind (ko,) int."""
    if not x.is_cuda:
        return rmsnorm_quant_split_plain(x, gamma, fp_ind, eps)
    return _launch(x, gamma, fp_ind, eps, "rmsnorm_quant_split")


def quant_split(x: torch.Tensor, fp_ind: torch.Tensor) -> Split:
    """K1 without the norm (the o_proj input)."""
    if not x.is_cuda:
        return quant_split_plain(x, fp_ind)
    return _launch(x, None, fp_ind, 0.0, "quant_split")
