#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (mixq_tensorrt_llm_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; exits non-zero without one, or without the port
beside this script. Phases, each printing its own lines; any failed check
exits non-zero:

  1. device: name, count, power limit
  2. build: every CUDA kernel from csrc/ (one nvcc per source, in parallel)
  3. kernels against their plain PyTorch versions on the card at the main
     path's shapes (Llama-2-7B: Hkv 32, D 128, BS 128, plus a GQA case
     Hq 32 / Hkv 8; linears at 1024 prefill rows and 8 decode rows):
     K5/K6 pages and scales bit-equal outside trash row 0, K7/K8 within
     2e-2; K1 codes at most 1 apart (> 99.9% equal), scales rtol 1e-5;
     K2/K3/K4 within 1e-4 of the largest output (+ one bf16 step), K2
     bit-equal on the int32-exact case; each kernel's device time per
     launch and its plain version's device time per call come from
     torch.profiler, the wrapper's time per call (host included) from
     CUDA events, and the library call's where one computes the same
     function (K4: torch._weight_int8pack_mm)
  4. main path at full width: a Llama-2-7B-geometry int8_mix (128
     outliers) / int8-KV model with random weights serves 8 ragged
     requests (100-700 prompt tokens, 32 greedy tokens each) through the
     Executor (the serving loop of tools/serving_profile.py); K1, K2 and
     K4-K8 must launch in that run (K3 is not on the path)
  5. cross-device: the same weights at 2 layers, the first prefill chunk's
     last-position logits and one decode step's logits on the card
     (kernels) against the CPU (plain), plus negative controls: faults
     injected into K8's, K2's or K4's call must land outside the tolerance
  6. a `kernels` JSON line, the nvidia-smi line, then the result line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ATTN_TOL = 2e-2       # K7/K8 against their plain f32 versions (bf16 output)
GEMM_TOL = 1e-4       # K2/K3/K4 vs plain: f32 sums in another order, of max
XDEV_TOL = 5e-2       # phase 5, relative to the largest |logit|
HBM_BYTES_PER_MS = 3.35e9          # H100 SXM: 3.35 TB/s
BF16_FLOP_PER_MS = 989e9           # H100 SXM dense bf16 tensor-core peak
INT8_OP_PER_MS = 1979e9            # H100 SXM dense int8 tensor-core peak
SRC = "mixq_tensorrt_llm_tpu_torch/csrc/"
REPLACES = {
    "rmsnorm_quant_split": "mixq_tensorrt_llm_tpu/ops/norm_quant.py:30",
    "mixed_matmul": "mixq_tensorrt_llm_tpu/ops/mixed_matmul.py:32",
    "mixed_matmul_hybrid": "mixq_tensorrt_llm_tpu/ops/mixed_matmul.py:122",
    "wo_matmul": "mixq_tensorrt_llm_tpu/ops/wo_matmul.py:26",
    "paged_write_token": "mixq_tensorrt_llm_tpu/ops/paged_write.py:42",
    "paged_write_chunk": "mixq_tensorrt_llm_tpu/ops/paged_write.py:147",
    "paged_decode_attention": "mixq_tensorrt_llm_tpu/ops/paged_attention.py:70",
    "paged_prefill_attention":
        "mixq_tensorrt_llm_tpu/ops/paged_attention.py:307",
}
SOURCES = {"rmsnorm_quant_split": "norm_quant.cu",
           "mixed_matmul": "mixed_matmul.cu",
           "mixed_matmul_hybrid": "mixed_matmul.cu",
           "wo_matmul": "wo_matmul.cu",
           "paged_write_token": "paged_write.cu",
           "paged_write_chunk": "paged_write.cu",
           "paged_decode_attention": "paged_attention.cu",
           "paged_prefill_attention": "paged_attention.cu"}
# K3 (the hybrid schedule's epilogue) is not on the main path, as in the
# JAX package, where only its kernel test calls mixed_matmul_hybrid
ON_PATH = [n for n in REPLACES if n != "mixed_matmul_hybrid"]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def time_cuda(torch, fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean ms per call over `iters` back-to-back calls (CUDA events). For
    a small kernel this is the wrapper's pace (argument checks, the ctypes
    call, launch), not the kernel's: see ``device_ms``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def device_ms(torch, fn, iters: int, kernel: str = "") -> float:
    """Device time per call of `fn`: the summed duration of the device
    activity (kernels, copies) that `iters` calls launch, traced by
    torch.profiler after a warm-up. With `kernel`, only the kernels whose
    name holds it count, and there must be exactly one per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and kernel in e.name]
    check(len(evs) > 0, f"torch.profiler traced no device time ({kernel})")
    if kernel:
        check(len(evs) == iters, f"{kernel}: {len(evs)} launches traced "
              f"for {iters} calls")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


def measure(torch, kernel_fn, plain_fn, kernel: str, iters: int,
            plain_iters: int):
    """(kernel device ms per launch, plain device ms per call, wrapper ms
    per call)."""
    return (device_ms(torch, kernel_fn, iters, kernel),
            device_ms(torch, plain_fn, plain_iters),
            time_cuda(torch, kernel_fn, iters))


def bound(nbytes: float, flops: float = 0.0, int8_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations over their tensor-core peaks (bf16 flops, int8 ops)."""
    tb = nbytes / HBM_BYTES_PER_MS
    tf = flops / BF16_FLOP_PER_MS + int8_ops / INT8_OP_PER_MS
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def gemm_err(out, want) -> float:
    """max |out - want| relative to max |want|."""
    return float((out.float() - want.float()).abs().max()
                 / want.float().abs().max())


def gemm_tol(dtype) -> float:
    """GEMM_TOL in f32; in bf16 one bf16 step (2^-7) of the largest value
    more, since an f32 difference of an ulp can round to neighbours."""
    import torch
    return GEMM_TOL + (2 ** -7 if dtype == torch.bfloat16 else 0.0)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def make_pools(torch, gen, dev, np_, hkv, bs, d):
    pools = {
        "k": torch.randint(-127, 128, (np_, hkv, bs, d), generator=gen,
                           device=dev, dtype=torch.int8),
        "v": torch.randint(-127, 128, (np_, hkv, bs, d), generator=gen,
                           device=dev, dtype=torch.int8),
        "k_scale": torch.rand((np_, hkv, bs), generator=gen, device=dev)
        * 0.02 + 0.002,
        "v_scale": torch.rand((np_, hkv, bs), generator=gen, device=dev)
        * 0.02 + 0.002,
    }
    return pools


def clone_pools(pools):
    return {k: v.clone() for k, v in pools.items()}


def pools_equal_outside_trash(a, b) -> float:
    """0.0 if every pool row but 0 is bit-equal, else the max abs diff."""
    err = 0.0
    for name in a:
        x, y = a[name][1:], b[name][1:]
        if not bool((x == y).all()):
            err = max(err, float((x.float() - y.float()).abs().max()))
    return err


def check_writes(torch, gen, dev, results):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_write as pw
    h, bs, d, np_ = 32, 128, 128, 64
    # K5: 8 lanes on distinct pages, the last masked to trash row 0
    b = 8
    pools = make_pools(torch, gen, dev, np_, h, bs, d)
    pg = (torch.randperm(np_ - 1, generator=gen, device=dev)[:b] + 1).int()
    pg[-1] = 0
    off = torch.randint(0, bs, (b,), generator=gen, device=dev).int()
    mag = torch.rand((b, h, 1), generator=gen, device=dev) * 4 + 0.01
    nk = (torch.randn((b, h, d), generator=gen, device=dev) * mag).bfloat16()
    nv = (torch.randn((b, h, d), generator=gen, device=dev) * mag).bfloat16()
    ker, pln = clone_pools(pools), clone_pools(pools)
    pw.paged_write_token(ker, pg, off, nk, nv)
    pw.paged_write_token_plain(pln, pg, off, nk, nv)
    torch.cuda.synchronize()
    err = pools_equal_outside_trash(ker, pln)
    check(err == 0.0, f"K5 paged_write_token differs from plain ({err})")
    ms, pms, wms = measure(
        torch, lambda: pw.paged_write_token(ker, pg, off, nk, nv),
        lambda: pw.paged_write_token_plain(pln, pg, off, nk, nv),
        "write_token_kernel", 200, 50)
    nbytes = 2 * b * h * d * (2 + 1) + 2 * b * h * 4 + 2 * b * 4
    results["paged_write_token"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                        bound=bound(nbytes))
    print(f"K5 paged_write_token: bit-equal; device {ms:.5f} ms per launch "
          f"(plain {pms:.5f} ms; wrapper {wms:.5f} ms per call) B={b} H={h} "
          f"D={d}", flush=True)

    # K6: 4 lanes x 256-token chunk (2 slabs): a short prompt (tail masked),
    # a full chunk, an inactive lane, and a lane whose offsets are shifted
    # (every token dropped)
    b, s = 4, 256
    pools = make_pools(torch, gen, dev, np_, h, bs, d)
    pages = (torch.randperm(np_ - 1, generator=gen, device=dev)[:2 * b]
             + 1).int().reshape(b, 2)
    blk = pages.repeat_interleave(bs, dim=1)
    off = torch.arange(s, device=dev, dtype=torch.int32).remainder(bs)
    off = off[None].repeat(b, 1)
    blk[0, 200:] = 0                     # prompt of 200 tokens
    blk[2] = 0                           # inactive lane
    off[3] = (off[3] + 1) % bs           # misaligned: dropped
    mag = torch.rand((b, s, h, 1), generator=gen, device=dev) * 4 + 0.01
    nk = (torch.randn((b, s, h, d), generator=gen, device=dev) * mag).bfloat16()
    nv = (torch.randn((b, s, h, d), generator=gen, device=dev) * mag).bfloat16()
    ker, pln = clone_pools(pools), clone_pools(pools)
    pw.paged_write_chunk(ker, blk, off, nk, nv)
    pw.paged_write_chunk_plain(pln, blk, off, nk, nv)
    torch.cuda.synchronize()
    err = pools_equal_outside_trash(ker, pln)
    check(err == 0.0, f"K6 paged_write_chunk differs from plain ({err})")
    check(bool((ker["k"][pages[3]] == pools["k"][pages[3]]).all()),
          "K6 wrote tokens whose offsets do not match their slot")
    ms, pms, wms = measure(
        torch, lambda: pw.paged_write_chunk(ker, blk, off, nk, nv),
        lambda: pw.paged_write_chunk_plain(pln, blk, off, nk, nv),
        "write_chunk_kernel", 100, 20)
    landed = int(pw.chunk_write_mask(blk, off, bs).sum())
    nbytes = 2 * b * s * h * d * 2 + 2 * b * s * 4 + landed * h * (d + 4) * 2
    results["paged_write_chunk"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                        bound=bound(nbytes))
    print(f"K6 paged_write_chunk: bit-equal; device {ms:.5f} ms per launch "
          f"(plain {pms:.5f} ms; wrapper {wms:.5f} ms per call) B={b} S={s} "
          f"H={h} D={d}, {landed} tokens landed", flush=True)


def _attn_tables(torch, gen, dev, b, mb, bs, np_, lens, recycled_lane):
    """Distinct random pages per lane; identity block_pos, PAD_POS past
    each lane's pages; one lane with a recycled (out-of-order) table."""
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import PAD_POS
    table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:b * mb]
             + 1).int().reshape(b, mb)
    bpos = torch.full((b, mb), int(PAD_POS), dtype=torch.int32, device=dev)
    for i, ln in enumerate(lens):
        n = max(1, -(-ln // bs)) if ln > 0 else 0
        bpos[i, :n] = torch.arange(n, device=dev, dtype=torch.int32) * bs
        if n:
            table[i, n:] = table[i, n - 1]
    if recycled_lane is not None:
        i = recycled_lane
        n = -(-lens[i] // bs)
        # sink block first, then the window's blocks out of order
        perm = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                          torch.randperm(n - 1, generator=gen,
                                         device=dev) + 1])
        bpos[i, :n] = bpos[i, :n][perm]
    return table, bpos


def check_attention(torch, gen, dev, results):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    bs, d, hq, np_ = 128, 128, 32, 128
    scale = d ** -0.5
    worst = {"paged_decode_attention": 0.0, "paged_prefill_attention": 0.0}
    times = {}
    for hkv in (32, 8):
        pools = make_pools(torch, gen, dev, np_, hkv, bs, d)
        args = (pools["k"], pools["v"], pools["k_scale"], pools["v_scale"])
        # K7 decode: 8 lanes, ragged lengths; lane 1 inactive (table 0,
        # block_pos PAD_POS, len 1), lane 3 recycled
        b, mb = 8, 6
        lens = [700, 1, 256, 640, 129, 513, 384, 300]
        table, bpos = _attn_tables(torch, gen, dev, b, mb, bs, np_, lens, 3)
        table[1] = 0
        bpos[1] = 1 << 30
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
        for window, sink, softcap in ((0, 0, 0.0), (256, 128, 0.0),
                                      (0, 0, 30.0)):
            kw = dict(block_pos=bpos, window=window, sink=sink,
                      softcap=softcap)
            out = pa.paged_decode_attention(q, *args, table, lens_t, scale,
                                            **kw)
            ref = pa.paged_attention_plain(q[:, None], *args, table,
                                           (lens_t - 1)[:, None], lens_t,
                                           scale, **kw)[:, 0]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), "K7 output not finite")
            check(bool((out[1] == 0).all()), "K7 inactive lane is not 0")
            err = float((out.float() - ref.float()).abs().max())
            check(err <= ATTN_TOL, f"K7 hkv={hkv} window={window} "
                  f"softcap={softcap}: max abs err {err} > {ATTN_TOL}")
            worst["paged_decode_attention"] = max(
                worst["paged_decode_attention"], err)
            print(f"K7 paged_decode_attention Hq={hq} Hkv={hkv} "
                  f"window={window} sink={sink} softcap={softcap}: "
                  f"max abs err {err:.3e}", flush=True)
        kw = dict(block_pos=bpos)
        ms, pms, wms = measure(
            torch, lambda: pa.paged_decode_attention(
                q, *args, table, lens_t, scale, **kw),
            lambda: pa.paged_attention_plain(
                q[:, None], *args, table, (lens_t - 1)[:, None], lens_t,
                scale, **kw), "decode_kernel", 200, 20)
        visited = int((bpos < lens_t[:, None]).sum())
        keys = sum(lens)
        nbytes = (visited * hkv * bs * (2 * d + 8)
                  + 2 * b * hq * d * 2 + b * mb * 8 + b * 4)
        bnd = bound(nbytes, 4.0 * hq * d * keys)
        times[("paged_decode_attention", hkv)] = (ms, pms, bnd)
        print(f"K7 timing B={b} Hq={hq} Hkv={hkv} pages={visited}: device "
              f"{ms:.5f} ms per launch (plain {pms:.5f} ms; wrapper "
              f"{wms:.5f} ms per call; bound {bnd[0]:.5f} ms)", flush=True)

        # K8 prefill: 4 lanes x 256-token chunk; lane 0 a 200-token prompt,
        # lanes 1-2 later chunks (lane 2's prompt ends inside it), lane 3
        # inactive, lane 1 recycled
        b, c, mb = 4, 256, 6
        qstart = [0, 256, 512, 0]
        lens = [200, 512, 700, 0]
        table, bpos = _attn_tables(torch, gen, dev, b, mb, bs, np_,
                                   [200, 512, 700, 1], 1)
        table[3] = 0
        bpos[3] = 1 << 30
        qs_t = torch.tensor(qstart, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, c, hq, d), generator=gen, device=dev).bfloat16()
        pos = qs_t[:, None] + torch.arange(c, device=dev)
        valid = (pos < lens_t[:, None])[:, :, None, None]
        for window, sink, softcap in ((0, 0, 0.0), (256, 128, 0.0),
                                      (0, 0, 30.0)):
            kw = dict(block_pos=bpos, window=window, sink=sink,
                      softcap=softcap)
            out = pa.paged_prefill_attention(q, *args, table, qs_t, lens_t,
                                             scale, **kw)
            ref = pa.paged_attention_plain(q, *args, table, pos, lens_t,
                                           scale, **kw)
            torch.cuda.synchronize()
            diff = torch.where(valid, (out.float() - ref.float()).abs(), 0.0)
            check(bool(torch.isfinite(torch.where(valid, out.float(),
                                                  0.0)).all()),
                  "K8 output not finite")
            err = float(diff.max())
            check(err <= ATTN_TOL, f"K8 hkv={hkv} window={window} "
                  f"softcap={softcap}: max abs err {err} > {ATTN_TOL}")
            worst["paged_prefill_attention"] = max(
                worst["paged_prefill_attention"], err)
            print(f"K8 paged_prefill_attention Hq={hq} Hkv={hkv} "
                  f"window={window} sink={sink} softcap={softcap}: "
                  f"max abs err {err:.3e}", flush=True)
        kw = dict(block_pos=bpos)
        ms, pms, wms = measure(
            torch, lambda: pa.paged_prefill_attention(
                q, *args, table, qs_t, lens_t, scale, **kw),
            lambda: pa.paged_attention_plain(
                q, *args, table, pos, lens_t, scale, **kw),
            "prefill_kernel", 50, 10)
        last = [min(qs + c, ln) - 1 for qs, ln in zip(qstart, lens)]
        visited = sum(int(((bpos[i] <= last[i])
                           & (bpos[i] < lens[i])).sum())
                      for i in range(b))
        pairs = sum(sum(p + 1 for p in range(qs, min(qs + c, ln)))
                    for qs, ln in zip(qstart, lens))
        # the bound reads each visited page once; K8's blocks are per query
        # head, so under GQA the kernel reads each page Hq/Hkv times
        nbytes = (visited * hkv * bs * (2 * d + 8)
                  + 2 * b * c * hq * d * 2 + b * mb * 8 + b * 8)
        bnd = bound(nbytes, 4.0 * hq * d * pairs)
        times[("paged_prefill_attention", hkv)] = (ms, pms, bnd)
        print(f"K8 timing B={b} C={c} Hq={hq} Hkv={hkv} pages={visited} "
              f"(read {hq // hkv}x each): device {ms:.5f} ms per launch "
              f"(plain {pms:.5f} ms; wrapper {wms:.5f} ms per call; bound "
              f"{bnd[0]:.5f} ms)", flush=True)
    # the kernels line carries the main path's geometry: MHA, Hkv = 32
    for name in worst:
        ms, pms, bnd = times[(name, 32)]
        results[name] = dict(max_abs_err=worst[name], ms=ms, plain_ms=pms,
                             bound=bnd)


def check_linears(torch, gen, dev, results):
    """K1-K4 at the main path's Llama-2-7B shapes: a prefill call has up
    to 4 lanes x 256 tokens = 1024 rows, a decode step 8 rows."""
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
    from mixq_tensorrt_llm_tpu_torch.ops import ref
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    m, h, ko = 1024, 4096, 128
    bf = torch.bfloat16

    # K1: input_norm -> qkv (with the norm) and the o_proj input (without)
    x = (torch.randn((m, h), generator=gen, device=dev) * 2).to(bf)
    gamma = torch.rand((h,), generator=gen, device=dev) + 0.5
    ind = torch.randperm(h, generator=gen, device=dev)[:ko].sort().values
    ind = ind.int()
    k1 = (lambda: nq.rmsnorm_quant_split(x, gamma, ind),
          lambda: nq.rmsnorm_quant_split_plain(x, gamma, ind))
    worst = 0
    for label, (kfn, pfn) in (("norm", k1),
                              ("no norm", (lambda: nq.quant_split(x, ind),
                                           lambda: nq.quant_split_plain(
                                               x, ind)))):
        got, want = kfn(), pfn()
        torch.cuda.synchronize()
        diff = (got[0].int() - want[0].int()).abs()
        dmax, same = int(diff.max()), float((diff == 0).float().mean())
        srel = float(((got[1] - want[1]).abs() / want[1]).max())
        oerr = float((got[2].float() - want[2].float()).abs().max())
        check(dmax <= 1 and same > 0.999 and srel <= 1e-5 and oerr <= 1e-2,
              f"K1 ({label}) differs from plain: codes {dmax} apart, "
              f"{same:.5f} equal, scale rel {srel}, x_out {oerr}")
        worst = max(worst, dmax)
        print(f"K1 rmsnorm_quant_split ({label}) M={m} K={h} ko={ko}: codes "
              f"at most {dmax} apart, {same:.6f} equal; scale_row max rel "
              f"err {srel:.2e}; x_out max abs err {oerr:.2e}", flush=True)
    ms, pms, wms = measure(torch, *k1, "norm_quant_kernel", 200, 20)
    bnd = bound(m * h * 2 + h * 4 + ko * 4 + m * h + m * 4 + m * ko * 2)
    results["rmsnorm_quant_split"] = dict(max_abs_err=float(worst), ms=ms,
                                          plain_ms=pms, bound=bnd)
    print(f"K1 timing: device {ms:.5f} ms per launch (plain {pms:.5f} ms; "
          f"wrapper {wms:.5f} ms per call; bound {bnd[0]:.5f} ms)",
          flush=True)

    # K2 at the three mix shapes, K3 and the int32-exact case at qkv's
    q_x, srow, xo = nq.rmsnorm_quant_split(x, gamma, ind)
    for label, n in (("qkv", 12288), ("o_proj", 4096), ("gate_up", 22016)):
        qw = torch.randint(-127, 128, (h, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        fpw = (torch.randn((ko, n), generator=gen, device=dev) * 0.02).to(bf)
        args = (q_x, srow, xo, qw, scol, fpw)
        k2 = (lambda: mm.mixed_matmul(*args), lambda: mm.mixed_matmul_plain(
            *args))
        err = gemm_err(k2[0](), k2[1]())
        check(err <= gemm_tol(bf), f"K2 {label}: rel err {err} > "
              f"{gemm_tol(bf)}")
        ms, pms, wms = measure(torch, *k2, "mixed_matmul_kernel", 20, 5)
        nbytes = (m * h + m * 4 + m * ko * 2 + h * n + n * 4 + ko * n * 2
                  + m * n * 2)
        bnd = bound(nbytes, 2.0 * m * n * ko, 2.0 * m * n * h)
        print(f"K2 mixed_matmul {label} M={m} K={h} N={n} ko={ko}: max rel "
              f"err {err:.2e}; device {ms:.5f} ms per launch (plain "
              f"{pms:.5f} ms; wrapper {wms:.5f} ms; bound {bnd[0]:.5f} ms, "
              f"{2.0 * m * n * h / ms / 1e9:.1f} int8 TOP/s)", flush=True)
        if label != "qkv":
            continue
        results["mixed_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound=bnd)
        imm = device_ms(torch, lambda: torch._int_mm(q_x, qw), 20)
        print(f"  torch._int_mm at the same shape (the int32 product alone, "
              f"not the same function): device {imm:.5f} ms", flush=True)

        ones_r = torch.ones((m,), device=dev)
        ones_c = torch.ones((n,), device=dev)
        zero_o = torch.zeros((m, ko), device=dev, dtype=bf)
        got = mm.mixed_matmul(q_x, ones_r, zero_o, qw, ones_c, fpw,
                              out_dtype=torch.float32)
        exact = ref.int8_matmul(q_x, qw).float()
        torch.cuda.synchronize()
        check(torch.equal(got, exact), "K2 int32-exact case is not bit-equal")
        print("K2 int32-exact case (unit scales, no outliers, f32 out): "
              "bit-equal to torch._int_mm", flush=True)

        k3 = (lambda: mm.mixed_matmul_hybrid(*args),
              lambda: mm.mixed_matmul_hybrid_plain(*args))
        err3 = gemm_err(k3[0](), k3[1]())
        check(err3 <= gemm_tol(bf), f"K3 rel err {err3} > {gemm_tol(bf)}")
        ms, pms, wms = measure(torch, *k3, "mixed_epilogue_kernel", 20, 5)
        bnd = bound(m * n * 4 + m * 4 + m * ko * 2 + n * 4 + ko * n * 2
                    + m * n * 2, 2.0 * m * n * ko)
        results["mixed_matmul_hybrid"] = dict(max_abs_err=err3, ms=ms,
                                              plain_ms=pms, bound=bnd)
        print(f"K3 mixed_matmul_hybrid epilogue {label}: max rel err "
              f"{err3:.2e}; device {ms:.5f} ms per launch (plain {pms:.5f} "
              f"ms, int32 product included; wrapper {wms:.5f} ms with its "
              f"torch._int_mm; bound {bnd[0]:.5f} ms)", flush=True)
        del got, exact

    # K4: every decode linear at 8 lanes, then prefill's down_proj
    step_ms = 0.0
    for label, k, n, mk in (("qkv", h, 12288, 8), ("o_proj", h, h, 8),
                            ("gate_up", h, 22016, 8),
                            ("down_proj", 11008, h, 8),
                            ("down_proj prefill", 11008, h, m)):
        xk = torch.randn((mk, k), generator=gen, device=dev).to(bf)
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        k4 = (lambda: wm.wo_matmul(xk, qw, scol),
              lambda: wm.wo_matmul_plain(xk, qw, scol))
        err = gemm_err(k4[0](), k4[1]())
        check(err <= gemm_tol(bf), f"K4 {label}: rel err {err}")
        name = "wo_gemv_kernel" if mk <= wm.GEMV_MAX_ROWS else "wo_gemm_kernel"
        ms, pms, wms = measure(torch, *k4, name, 100 if mk <= 16 else 20, 10)
        bnd = bound(mk * k * 2 + k * n + n * 4 + mk * n * 2, 2.0 * mk * n * k)
        lib = None
        if mk <= 16:
            step_ms += ms
            wt = qw.t().contiguous()              # the library's (N, K)
            sb = scol.to(bf)
            try:
                torch._weight_int8pack_mm(xk, wt, sb)
                lib = device_ms(torch, lambda: torch._weight_int8pack_mm(
                    xk, wt, sb), 50)
            except (RuntimeError, NotImplementedError) as e:
                print(f"  torch._weight_int8pack_mm: none on this card "
                      f"({str(e).splitlines()[0][:100]})", flush=True)
            del wt
        print(f"K4 wo_matmul {label} M={mk} K={k} N={n}: max rel err "
              f"{err:.2e}; device {ms:.5f} ms per launch (plain {pms:.5f} "
              f"ms; wrapper {wms:.5f} ms; bound {bnd[0]:.5f} ms, by "
              f"{bnd[1]}; {(k * n) / ms / 1e9:.3f} TB/s of weight; "
              f"torch._weight_int8pack_mm "
              f"{'none' if lib is None else f'{lib:.5f} ms'})", flush=True)
        if label == "qkv":
            results["wo_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                        bound=bnd, library_ms=lib)
    print(f"K4 one decode step's four linears: {step_ms:.5f} ms a layer, "
          f"{32 * step_ms:.3f} ms for 32 layers (bound: 202.4 MB of int8 "
          f"weights a layer, {32 * 202.4e6 / HBM_BYTES_PER_MS:.3f} ms)",
          flush=True)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

def serve(torch, params, cfg, seed: int, dev):
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    torch.cuda.synchronize()
    _build.reset_launches()
    done, ids, wall, prefill_s = sp.serve(params, cfg, prompts, seed, dev)
    launches = dict(_build.LAUNCHES)
    gen_total = sum(len(done[r].generated) for r in ids)
    check(all(done[r].done and len(done[r].generated) == 32 for r in ids),
          "not every request finished with 32 tokens")
    check(all(math.isfinite(lp) for r in ids for lp in done[r].logprobs),
          "non-finite logits on the main path")
    print(f"main path: 8 requests, prompts {[len(p) for p in prompts]} "
          f"tokens, 32 "
          f"generated each; wall {wall:.3f} s = prefill {prefill_s:.3f} s"
          f" + decode {wall - prefill_s:.3f} s; {gen_total / wall:.1f} "
          f"generated tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"main path launches: {json.dumps(launches)}", flush=True)
    # per layer: a prefill call writes its chunk once (K6) and runs three
    # mix linears (K1 -> K2) and down_proj (K4); a decode step writes one
    # token (K5) and runs four weight-only linears (K4)
    chunk, token = (launches.get("paged_write_chunk", 0),
                    launches.get("paged_write_token", 0))
    print(f"main path launches against the per-layer counts: K1 "
          f"{launches.get('rmsnorm_quant_split', 0)} (3 x K6 = {3 * chunk}),"
          f" K2 {launches.get('mixed_matmul', 0)} (3 x K6 = {3 * chunk}), "
          f"K4 {launches.get('wo_matmul', 0)} (4 x K5 + K6 = "
          f"{4 * token + chunk}), K3 {launches.get('mixed_matmul_hybrid', 0)}"
          f" (not on the path)", flush=True)
    for name in ON_PATH:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path")
    return launches


def cross_device(torch, params, cfg, seed: int, dev):
    """2 layers at full width: the first prefill chunk's last-position
    logits and one decode step's logits on the card (kernels) against the
    CPU (plain versions). Then negative controls: the card run again with
    a fault injected into one kernel's call, to show where such faults
    land against the tolerance."""
    import dataclasses
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models.common import forward_paged
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    sub = {k: v for k, v in params.items() if k != "layers"}
    sub["layers"] = params["layers"][:2]
    cpu = torch.device("cpu")
    sub_cpu = {k: ([{m: {n: t.to(cpu) for n, t in p.items()}
                     for m, p in layer.items()} for layer in v]
                   if k == "layers" else {n: t.to(cpu) for n, t in v.items()})
               for k, v in sub.items()}
    rng = np.random.default_rng(seed + 1)
    c, prompt_len = 256, 200
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :prompt_len] = rng.integers(1, cfg.vocab_size, prompt_len)
    next_token = int(rng.integers(1, cfg.vocab_size))

    def both_logits(device, p):
        """(the chunk's last-position logits, the next decode step's)."""
        state = init_paged_kv(cfg2, 4, 128, device=device)
        t = torch.from_numpy(tokens).to(device)
        pos = torch.arange(c, dtype=torch.int32, device=device)[None]
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
        length = torch.tensor([prompt_len], dtype=torch.int32, device=device)
        pre, _ = forward_paged(p, cfg2, t, pos, state, table, length,
                               last_pos=length - 1)
        t = torch.tensor([[next_token]], dtype=torch.int32, device=device)
        dec, _ = forward_paged(p, cfg2, t, length[:, None], state, table,
                               length + 1)
        return pre[0, 0].float().cpu(), dec[0, 0].float().cpu()

    plain = both_logits(cpu, sub_cpu)
    card = both_logits(dev, sub)
    check(all(bool(torch.isfinite(x).all()) for x in card),
          "card logits not finite")

    def rel_err(xs):
        """(prefill, decode) max |card - cpu| / max |cpu|."""
        return [float((x - p).abs().max() / p.abs().max())
                for x, p in zip(xs, plain)]

    rel = rel_err(card)
    agree = [int(x.argmax()) == int(p.argmax()) for x, p in zip(card, plain)]
    print(f"cross-device (2 layers, full width, {prompt_len}-token prompt in "
          f"a {c}-token chunk, then one decode step): max |card - cpu| / "
          f"max |cpu| = {rel[0]:.3e} prefill, {rel[1]:.3e} decode "
          f"(tolerance {XDEV_TOL}); argmax agrees: {agree}", flush=True)
    check(max(rel) <= XDEV_TOL, f"card vs CPU logits differ: {rel} > "
          f"{XDEV_TOL}")

    # (fault, whether the tolerance must catch it, module, function). The
    # K8 mask fault is subtle on purpose: its reading says how small a
    # fault the check can see.
    k8, k2, k4 = pa.paged_prefill_attention, mm.mixed_matmul, wm.wo_matmul
    faults = [
        ("K8 output zeroed", True, pa, "paged_prefill_attention",
         lambda *a, **k: torch.zeros_like(k8(*a, **k))),
        ("K8 without the V scale", True, pa, "paged_prefill_attention",
         lambda q, kp, vp, ks, vs, *a, **k: k8(q, kp, vp, ks,
                                               torch.ones_like(vs), *a, **k)),
        ("K8 blind to the newest key (len - 1)", False, pa,
         "paged_prefill_attention",
         lambda q, kp, vp, ks, vs, tb, qs, ln, *a, **k: k8(
             q, kp, vp, ks, vs, tb, qs, ln - 1, *a, **k)),
        ("K2 without the outlier side GEMM", True, mm, "mixed_matmul",
         lambda q, sr, xo, qw, sc, fw, **k: k2(q, sr, xo, qw, sc,
                                               torch.zeros_like(fw), **k)),
        ("K4 without scale_col", True, wm, "wo_matmul",
         lambda x, qw, sc, **k: k4(x, qw, torch.ones_like(sc), **k)),
    ]
    for name, must_catch, module, attr, fault in faults:
        real = getattr(module, attr)
        setattr(module, attr, fault)
        try:
            r = max(rel_err(both_logits(dev, sub)))
        finally:
            setattr(module, attr, real)
        caught = not r <= XDEV_TOL
        print(f"negative control, {name}: {r:.3e} against tolerance "
              f"{XDEV_TOL}: {'caught' if caught else 'not caught'}",
              flush=True)
        if must_catch:
            check(caught, f"the cross-device check misses a fault ({name})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from mixq_tensorrt_llm_tpu_torch.ops import _build
        from mixq_tensorrt_llm_tpu_torch.models import llama
        from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. device
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(f"device: {kind} x{count}; {smi_line}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t = time.perf_counter()
    paths = _build.build()
    print(f"build: {len(paths)} libraries in {time.perf_counter() - t:.1f} s"
          f" -> {', '.join(p.name for p in paths.values())}", flush=True)
    for name, log in _build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    # 3. kernels against plain
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    results = {}
    check_writes(torch, gen, dev, results)
    check_attention(torch, gen, dev, results)
    check_linears(torch, gen, dev, results)

    # 4. main path
    cfg = sp.llama2_7b_config()
    t = time.perf_counter()
    params = llama.init_random_params(
        cfg, seed=args.seed, device=dev,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    torch.cuda.synchronize()
    print(f"model: {cfg.num_layers} layers at Llama-2-7B width, int8_mix "
          f"(128 outliers) / int8 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    launches = serve(torch, params, cfg, args.seed, dev)

    # 5. cross-device
    cross_device(torch, params, cfg, args.seed, dev)

    # 6. kernels line
    rows = []
    for name in REPLACES:
        r = results[name]
        bms, by = r["bound"]
        rows.append({"name": name, "route": "cuda",
                     "source": SRC + SOURCES[name],
                     "replaces": REPLACES[name],
                     "launches": launches.get(name, 0),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r.get("library_ms")})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
