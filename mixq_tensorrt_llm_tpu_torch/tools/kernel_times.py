"""Device time of K1, K2, K5, K6, K7, K8, K9, K10 and K11 at the main
paths' shapes, for comparing two trees of the port on one card.

    python3 mixq_tensorrt_llm_tpu_torch/tools/kernel_times.py [--root DIR]
        [--kernels K1,K2,K7,K9,K11,K8,K5]

Imports the port from ``--root`` (a checkout or a ``git archive`` of
another commit; by default the tree holding this file), so one call can
time a parent tree and a change in turns: parent, change, change,
parent. Both trees' wrappers take the same arguments, and the inputs come
from one seed, so both time the same work. Times are device time per
call from ``torch.profiler`` (every kernel a call launches; the wrapper
must count one launch a call), after a warm-up:

  K1 rmsnorm_quant_split on bf16 rows of Llama-2-7B width (4096, 128
     outlier channels) at 1024 rows (a prefill call) and 40 (the gamma = 4
     verify);
  K2 mixed_matmul at the three Llama-2-7B mix shapes (qkv, o_proj,
     gate_up) at 1024 rows (a prefill call) and 40 rows (the gamma = 4
     verify), 128 outlier channels;
  K7 paged_decode_attention on 8 lanes of 1-700 tokens (one inactive, one
     recycled table), 128-token pages, head_dim 128: int8 pages at 32
     heads (Llama-2-7B), bf16 pages at 40 (Llama-2-13B);
  K9 paged_verify_attention on the same lanes, S = 5 rows (gamma = 4)
     ending at each lane's last key: int8 pages at 32 heads (and at 8 KV
     heads of 4 query heads each), bf16 at 40;
  K10 paged_decode_attention(stats=True) on the same lanes, int8 pages at
     32 heads;
  K11 paged_decode_attention_split (kv_splits 4) on the same lanes, int8
     and bf16 pages at 32 heads, and on 1 lane of 4096 tokens beside K7
     there;
  K8 paged_prefill_attention on 4 lanes x a 256-token chunk (a 200-token
     prompt, two later chunks of a 512- and a 700-token prompt, an
     inactive lane): int8 pages at 32 heads, bf16 at 40;
  K5 / K6 (group "K5") runtime/kv_cache.paged_write as a layer calls it,
     on K8's lanes and tables, at S = 1 and S = 5 (each lane's last
     tokens) and S = 256 (the chunk): int8 pages at 32 heads, bf16 at 40,
     new V a strided view of a packed qkv row. A reading is every kernel
     the call queues, with the layer's valid mask where the tree's
     paged_write does not take kv_valid_len (on a tree whose write is a
     chain of torch ops and kernels, the whole chain), so both trees time
     the same work; it also gives the kernels traced and the wrapper
     launches counted a call.

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


def device_ms(torch, build, fn, iters: int, counter: str,
              per_call: dict = None) -> float:
    """Device time a call (every kernel it queues). The wrapper must count
    one launch a call, unless ``per_call`` (a dict) is given: it then gets
    the launches counted and the kernels traced a call instead."""
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
    if per_call is not None and evs:
        per_call.update(launches=launched / iters,
                        kernels=len(evs) / iters)
    elif not evs or launched != iters:
        raise RuntimeError(f"{counter}: {len(evs)} device events, "
                           f"{launched} launches for {iters} calls")
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


def k1_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
    h, ko, out = 4096, 128, []
    gamma = torch.rand((h,), generator=gen, device=dev) + 0.5
    ind = torch.randperm(h, generator=gen, device=dev)[:ko].sort().values
    ind = ind.int()
    for m in (1024, 40):
        x = (torch.randn((m, h), generator=gen, device=dev) * 2).bfloat16()
        ms = device_ms(torch, build, lambda: nq.rmsnorm_quant_split(
            x, gamma, ind), 200, "rmsnorm_quant_split")
        out.append(dict(kernel="K1", M=m, K=h, ko=ko, ms=ms))
    return out


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


def _pools(torch, gen, dev, pages, hkv, np_=128, bs=128, d=128):
    """(K, V, K scale, V scale, launch-count suffix): int8 pages with
    scales, or bf16 pages without."""
    shape = (np_, hkv, bs, d)
    if pages == "int8":
        return (torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8),
                torch.randint(-127, 128, shape, generator=gen, device=dev,
                              dtype=torch.int8),
                torch.rand(shape[:3], generator=gen, device=dev) * 0.02,
                torch.rand(shape[:3], generator=gen, device=dev) * 0.02, "")
    return (torch.randn(shape, generator=gen, device=dev).bfloat16(),
            torch.randn(shape, generator=gen, device=dev).bfloat16(),
            None, None, "_fp")


def _decode_lanes(torch, gen, dev, np_=128, bs=128, b=8, mb=6):
    """The smoke's 8 decode lanes: table, block_pos (lane 3 recycled, lane
    1 inactive) and lengths."""
    lens = [700, 1, 256, 640, 129, 513, 384, 300]
    table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:b * mb]
             + 1).int().reshape(b, mb)
    bpos = torch.full((b, mb), 1 << 30, dtype=torch.int32, device=dev)
    for i, ln in enumerate(lens):
        n = -(-ln // bs)
        bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) * bs
    bpos[3, :5] = torch.tensor([0, 3, 1, 4, 2], device=dev) * bs
    table[1], bpos[1] = 0, 1 << 30                 # inactive lane
    return table, bpos, torch.tensor(lens, dtype=torch.int32, device=dev)


def k7_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    d, b = 128, 8
    out = []
    for pages, hkv in (("int8", 32), ("bf16", 40)):
        kp, vp, ks, vs, sfx = _pools(torch, gen, dev, pages, hkv)
        table, bpos, lens_t = _decode_lanes(torch, gen, dev)
        q = torch.randn((b, hkv, d), generator=gen, device=dev).bfloat16()
        ms = device_ms(torch, build, lambda: pa.paged_decode_attention(
            q, kp, vp, ks, vs, table, lens_t, d ** -0.5, block_pos=bpos),
            200, "paged_decode_attention" + sfx)
        out.append(dict(kernel="K7", pages=pages, B=b, Hq=hkv, Hkv=hkv, D=d,
                        BS=128, ms=ms))
    return out


def k9_k10_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    d, b, s = 128, 8, 5
    out = []
    for pages, hq, hkv in (("int8", 32, 32), ("int8", 32, 8),
                           ("bf16", 40, 40)):
        kp, vp, ks, vs, sfx = _pools(torch, gen, dev, pages, hkv)
        table, bpos, lens_t = _decode_lanes(torch, gen, dev)
        q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
        qs = torch.clamp(lens_t - s, min=0)
        ms = device_ms(torch, build, lambda: pa.paged_verify_attention(
            q, kp, vp, ks, vs, table, lens_t, qs, d ** -0.5, block_pos=bpos),
            200, "paged_verify_attention" + sfx)
        out.append(dict(kernel="K9", pages=pages, B=b, S=s, Hq=hq, Hkv=hkv,
                        D=d, BS=128, ms=ms))
        if pages == "int8" and hkv == hq:
            q1 = torch.randn((b, hkv, d), generator=gen, device=dev
                             ).bfloat16()
            ms = device_ms(torch, build, lambda: pa.paged_decode_attention(
                q1, kp, vp, ks, vs, table, lens_t, d ** -0.5,
                block_pos=bpos, stats=True), 200,
                "paged_decode_attention_stats" + sfx)
            out.append(dict(kernel="K10", pages=pages, B=b, Hq=hkv,
                            Hkv=hkv, D=d, BS=128, ms=ms))
    return out


def k11_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    d, b, hkv, splits = 128, 8, 32, 4
    out = []
    for pages in ("int8", "bf16"):
        kp, vp, ks, vs, sfx = _pools(torch, gen, dev, pages, hkv)
        table, bpos, lens_t = _decode_lanes(torch, gen, dev)
        q = torch.randn((b, hkv, d), generator=gen, device=dev).bfloat16()
        ms = device_ms(torch, build, lambda: pa.paged_decode_attention_split(
            q, kp, vp, ks, vs, table, lens_t, d ** -0.5, block_pos=bpos,
            kv_splits=splits), 200, "paged_decode_attention_split" + sfx)
        out.append(dict(kernel="K11", pages=pages, B=b, Hq=hkv, Hkv=hkv,
                        D=d, BS=128, kv_splits=splits, ms=ms))
    # 1 lane x 4096 tokens, int8 pages: K11 beside K7
    kp, vp, ks, vs, _ = _pools(torch, gen, dev, "int8", hkv)
    table = torch.arange(1, 33, dtype=torch.int32, device=dev)[None]
    bpos = torch.arange(32, dtype=torch.int32, device=dev)[None] * 128
    lens_t = torch.tensor([4096], dtype=torch.int32, device=dev)
    q = torch.randn((1, hkv, d), generator=gen, device=dev).bfloat16()
    for name, fn in (("K7", lambda: pa.paged_decode_attention(
            q, kp, vp, ks, vs, table, lens_t, d ** -0.5, block_pos=bpos)),
                     ("K11", lambda: pa.paged_decode_attention_split(
            q, kp, vp, ks, vs, table, lens_t, d ** -0.5, block_pos=bpos,
            kv_splits=splits))):
        counter = ("paged_decode_attention" if name == "K7"
                   else "paged_decode_attention_split")
        out.append(dict(kernel=name, pages="int8", B=1, tokens=4096,
                        Hq=hkv, Hkv=hkv, D=d, BS=128,
                        kv_splits=splits if name == "K11" else None,
                        ms=device_ms(torch, build, fn, 200, counter)))
    return out


def k8_times(torch, build, dev, gen):
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    d, b, c, bs, mb = 128, 4, 256, 128, 6
    qstart, lens = [0, 256, 512, 0], [200, 512, 700, 0]
    out = []
    for pages, hkv in (("int8", 32), ("bf16", 40)):
        kp, vp, ks, vs, sfx = _pools(torch, gen, dev, pages, hkv)
        table = (torch.randperm(127, generator=gen, device=dev)[:b * mb]
                 + 1).int().reshape(b, mb)
        bpos = torch.full((b, mb), 1 << 30, dtype=torch.int32, device=dev)
        for i, ln in enumerate([200, 512, 700]):
            n = -(-ln // bs)
            bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) * bs
        bpos[1, :4] = torch.tensor([0, 2, 3, 1], device=dev) * bs
        table[3] = 0                                   # inactive lane
        qs_t = torch.tensor(qstart, dtype=torch.int32, device=dev)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, c, hkv, d), generator=gen, device=dev).bfloat16()
        ms = device_ms(torch, build, lambda: pa.paged_prefill_attention(
            q, kp, vp, ks, vs, table, qs_t, lens_t, d ** -0.5,
            block_pos=bpos), 50, "paged_prefill_attention" + sfx)
        pairs = sum(sum(p + 1 for p in range(qs, min(qs + c, ln)))
                    for qs, ln in zip(qstart, lens))
        out.append(dict(kernel="K8", pages=pages, B=b, C=c, Hq=hkv,
                        Hkv=hkv, D=d, BS=bs, ms=ms,
                        tflops=4.0 * hkv * d * pairs / ms / 1e9))
    return out


def k5_k6_times(torch, build, dev, gen):
    import inspect
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as kvc
    d, b, bs, mb = 128, 4, 128, 6
    qstart, lens = [0, 256, 512, 0], [200, 512, 700, 0]
    takes_len = "kv_valid_len" in inspect.signature(
        kvc.paged_write).parameters
    out = []
    for pages, hkv in (("int8", 32), ("bf16", 40)):
        kp, vp, ks, vs, sfx = _pools(torch, gen, dev, pages, hkv)
        pools = {"k": kp, "v": vp}
        if ks is not None:
            pools.update(k_scale=ks, v_scale=vs)
        table = (torch.randperm(127, generator=gen, device=dev)[:b * mb]
                 + 1).int().reshape(b, mb)
        bpos = torch.full((b, mb), 1 << 30, dtype=torch.int32, device=dev)
        for i, ln in enumerate([200, 512, 700]):
            n = -(-ln // bs)
            bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) * bs
        bpos[1, :4] = torch.tensor([0, 2, 3, 1], device=dev) * bs
        table[3] = 0                                   # inactive lane
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        for s in (1, 5, 256):
            first = (torch.tensor(qstart, dtype=torch.int32, device=dev)
                     if s == 256 else torch.clamp(lens_t - s, min=0))
            pos = first[:, None] + torch.arange(s, dtype=torch.int32,
                                                device=dev)
            qkv = torch.randn((b, s, 3 * hkv * d), generator=gen,
                              device=dev).bfloat16()
            nk = qkv[..., hkv * d:2 * hkv * d].reshape(b, s, hkv, d)
            nk = nk.contiguous()                       # as apply_rope's
            nv = qkv[..., 2 * hkv * d:].reshape(b, s, hkv, d)

            def write():
                if takes_len:
                    kvc.paged_write(pools, table, pos, nk, nv,
                                    block_pos=bpos, kv_valid_len=lens_t)
                else:
                    kvc.paged_write(pools, table, pos, nk, nv,
                                    valid=pos < lens_t[:, None],
                                    block_pos=bpos)
            per_call = {}
            counter = ("paged_write_chunk" if s == 256
                       else "paged_write_token") + sfx
            ms = device_ms(torch, build, write, 200 if s < 256 else 100,
                           counter, per_call)
            out.append(dict(kernel="K6" if s == 256 else "K5", pages=pages,
                            call="kv_cache.paged_write", B=b, S=s, H=hkv,
                            D=d, BS=bs, ms=ms, **per_call))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)),
                    help="tree whose mixq_tensorrt_llm_tpu_torch to time")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="K1,K2,K7,K9,K11,K8,K5",
                    help="comma-separated groups to time (K9 includes K10, "
                         "K5 the K6 chunk)")
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
    _build.build(["norm_quant", "mixed_matmul", "paged_attention",
                  "paged_write"])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    groups = {"K1": k1_times, "K2": k2_times, "K7": k7_times,
              "K9": k9_k10_times, "K11": k11_times, "K8": k8_times,
              "K5": k5_k6_times}
    rows = []
    for name in args.kernels.split(","):
        rows += groups[name](torch, _build, dev, gen)
    for r in rows:
        print(json.dumps(r), flush=True)
    print(json.dumps({"tree": root, "card": smi, "times": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
