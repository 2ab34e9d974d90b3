"""Device time of K2 and K7 at the main paths' shapes, for comparing two
trees of the port on one card.

    python3 mixq_tensorrt_llm_tpu_torch/tools/kernel_times.py [--root DIR]

Imports the port from ``--root`` (a checkout or a ``git archive`` of
another commit; by default the tree holding this file), so one call can
time a parent tree and a change in turns: parent, change, change,
parent. Both trees' wrappers take the same arguments, and the inputs come
from one seed, so both time the same work. Times are device time per
call from ``torch.profiler`` (every kernel a call launches; the wrapper
must count one launch a call), after a warm-up:

  K2 mixed_matmul at the three Llama-2-7B mix shapes (qkv, o_proj,
     gate_up) at 1024 rows (a prefill call) and 40 rows (the gamma = 4
     verify), 128 outlier channels;
  K7 paged_decode_attention on 8 lanes of 1-700 tokens (one inactive, one
     recycled table), 128-token pages, head_dim 128: int8 pages at 32
     heads (Llama-2-7B), bf16 pages at 40 (Llama-2-13B).

Prints one line a reading and a JSON line with all of them, after the
card's name and power limit. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def device_ms(torch, build, fn, iters: int, counter: str) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):          # the tracer now and then records nothing
        before = build.LAUNCHES.get(counter, 0)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        if evs:
            break
    launched = build.LAUNCHES.get(counter, 0) - before
    if not evs or launched != iters:
        raise RuntimeError(f"{counter}: {len(evs)} device events, "
                           f"{launched} launches for {iters} calls")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


def k2_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    h, ko, out = 4096, 128, []
    for m in (1024, 40):
        q_x = torch.randint(-127, 128, (m, h), generator=gen, device=dev,
                            dtype=torch.int8)
        srow = torch.rand((m,), generator=gen, device=dev) * 0.02 + 1e-3
        xo = torch.randn((m, ko), generator=gen, device=dev).bfloat16()
        for label, n in (("qkv", 12288), ("o_proj", 4096),
                         ("gate_up", 22016)):
            qw = torch.randint(-127, 128, (h, n), generator=gen, device=dev,
                               dtype=torch.int8)
            scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
            fpw = (torch.randn((ko, n), generator=gen, device=dev)
                   * 0.02).bfloat16()
            ms = device_ms(torch, build, lambda: mm.mixed_matmul(
                q_x, srow, xo, qw, scol, fpw), 50 if m == 40 else 20,
                "mixed_matmul")
            out.append(dict(kernel="K2", shape=label, M=m, K=h, N=n, ms=ms,
                            int8_tops=2.0 * m * n * h / ms / 1e9))
    return out


def k7_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    bs, d, np_, b, mb = 128, 128, 128, 8, 6
    lens = [700, 1, 256, 640, 129, 513, 384, 300]
    out = []
    for pages, hkv in (("int8", 32), ("bf16", 40)):
        shape = (np_, hkv, bs, d)
        if pages == "int8":
            kp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8)
            vp = torch.randint(-127, 128, shape, generator=gen, device=dev,
                               dtype=torch.int8)
            ks = torch.rand(shape[:3], generator=gen, device=dev) * 0.02
            vs = torch.rand(shape[:3], generator=gen, device=dev) * 0.02
            counter = "paged_decode_attention"
        else:
            kp = torch.randn(shape, generator=gen, device=dev).bfloat16()
            vp = torch.randn(shape, generator=gen, device=dev).bfloat16()
            ks = vs = None
            counter = "paged_decode_attention_fp"
        table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:b * mb]
                 + 1).int().reshape(b, mb)
        bpos = torch.full((b, mb), 1 << 30, dtype=torch.int32, device=dev)
        for i, ln in enumerate(lens):
            n = -(-ln // bs)
            bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) * bs
        bpos[3, :5] = torch.tensor([0, 3, 1, 4, 2], device=dev) * bs
        table[1], bpos[1] = 0, 1 << 30                 # inactive lane
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, hkv, d), generator=gen, device=dev).bfloat16()
        ms = device_ms(torch, build, lambda: pa.paged_decode_attention(
            q, kp, vp, ks, vs, table, lens_t, d ** -0.5, block_pos=bpos),
            200, counter)
        out.append(dict(kernel="K7", pages=pages, B=b, Hq=hkv, Hkv=hkv, D=d,
                        BS=bs, ms=ms))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="tree whose mixq_tensorrt_llm_tpu_torch to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{smi}; tree {root}", flush=True)
    _build.build(["mixed_matmul", "paged_attention"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = k2_times(torch, _build, dev, gen) + k7_times(torch, _build, dev,
                                                         gen)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"tree": root, "card": smi, "times": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
