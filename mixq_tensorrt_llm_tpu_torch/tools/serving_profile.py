"""Where the time of the port's main path goes, on the card.

    python -m mixq_tensorrt_llm_tpu_torch.tools.serving_profile \
        [--seed N] [--model 7b|13b] [--algo ALGO] [--kv int8|none] \
        [--gamma G [--draft-layers N]] [--dense] [--burst K]

Builds a Llama-geometry model with random weights and serves it through
the ``serve`` loop chip_smoke.py uses. ``--model`` picks the geometry
(7b: Llama-2-7B, 32 layers; 13b: Llama-2-13B, 40 layers), ``--algo`` the
weight quantization (default: int8_mix for 7b, w4a16 for 13b; int8_mix
and int4_mix take 128 outliers, w4a16_g groups of 128), ``--kv`` the KV
pool (default: int8 for 7b, none, i.e. bf16 pages, for 13b; fp8: e4m3
pages, written and attended by the gather route, no paged kernel). The defaults
are chip_smoke.py's two serving runs. One Executor serves every run:
``warmup(burst=K)`` first (the kernels built, the decode rungs captured as
CUDA graphs), then the 8 ragged requests ``run(burst=K)`` (``--burst``,
default 1: every decode step a replay of rung 1; K > 1: K-step rungs,
one host readback a call): to warm up, timed
(``TIMED_RUNS`` times, each run's walls printed and the median run's
reported: the host is shared and its speed varies), and under
``torch.profiler``. It
prints, for the prefill calls and the decode steps separately: wall time
(timed run), device busy time (the sum of kernel times, profiled run),
the device's idle share, and kernel time and launches by group (the
port's CUDA kernels K1-K14, the cuBLAS GEMMs, everything else), each also
a forward of the model in that phase (a prefill call; a decode step, or in
a speculative run a draft prefill, draft step or verify, and a round), with
the top kernels by name; the "other" group (elementwise, reductions,
copies) is split into the torch ops that launched its kernels, the top
ones by time and by launches. Each timed run also prints the decode
calls, the graph replays and the host readbacks a generated token. The
card's name and power limit come first. Needs a CUDA card.

``--gamma G`` serves the same requests through ``run_speculative`` with G
draft tokens a round; the draft is the target's first ``--draft-layers``
layers (default 4), sharing its tensors (as the JAX package's
tools/serving_bench.py builds its draft). It also prints the acceptance
rate (accepted / proposed draft tokens). ``MIXQ_KV_SPLITS=N`` in the
environment sends the decode steps through K11 (K7's kernel with its
splits inside N page ranges a lane).

``--dense`` serves the same 8 requests as one static batch through
``GenerationSession`` (``max_seq_len`` 768, so one 768-token prefill
bucket) over the dense KV cache: the prefill runs K14 (causal flash
attention) and the mix linears, the decode steps the weight-only linears
and the dense cache's masked attention in torch ops.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from ..models.common import ModelConfig
from ..quant import KVCacheQuantAlgo, QuantAlgo, QuantConfig

PORT_KERNELS = {"norm_quant_regs_kernel": "K1 rmsnorm_quant_split",
                "norm_quant_smem_kernel": "K1 rmsnorm_quant_split (wide)",
                "mixed_wgmma_kernel": "K2 mixed_matmul",
                "mixed_epilogue_kernel": "K3 mixed_matmul_hybrid",
                "wo_small_mma_kernel": "K4 wo_matmul (decode, mma)",
                "wo_mid_mma_kernel": "K4 wo_matmul (verify / mid M, mma)",
                "wo_wgmma_kernel": "K4 wo_matmul (prefill, wgmma)",
                "packed_mma_kernel": "K12 wo_matmul_packed",
                "packed_grouped_mma_kernel": "K13 wo_matmul_packed_grouped",
                "write_token_kernel": "K5 paged_write_token",
                "write_chunk_kernel": "K6 paged_write_chunk",
                "decode_split_kernel": "K7 paged_decode_attention (K11 "
                                       "under MIXQ_KV_SPLITS)",
                "verify_rows_kernel": "K9 paged_verify_attention",
                "stats_rows_kernel": "K10 paged_decode_attention(stats)",
                "prefill_wgmma_kernel": "K8 paged_prefill_attention",
                "prefill_kernel": "K8 paged_prefill_attention (f32 route)",
                "flash_causal_kernel": "K14 flash_causal_attention"}
# the paged-KV kernels are templated on the page type: int8 pages show as
# "signed char" in a kernel's name; any other page type is a bf16/f32 pool
FLOAT_PAGES = {"write_token_kernel": "K5p paged_write_token (float pool)",
               "write_chunk_kernel": "K6p paged_write_chunk (float pool)",
               "decode_split_kernel": "K7 / K11 paged_decode_attention "
                                      "(float pages)",
               "verify_rows_kernel": "K9 paged_verify_attention "
                                     "(float pages)",
               "stats_rows_kernel": "K10 paged_decode_attention(stats) "
                                    "(float pages)",
               "prefill_wgmma_kernel": "K8 paged_prefill_attention "
                                       "(float pages)",
               "prefill_kernel": "K8 paged_prefill_attention (f32 route)"}
GEMM_MARKS = ("gemm", "xmma", "cutlass", "gemv", "nvjet", "cublas")
OTHER = "other (elementwise, reductions, copies)"
TIMED_RUNS = 5
# model forwards by phase ("prefill", "decode") in the runs of serve and
# serve_dense since the last clear
FORWARDS = defaultdict(int)


def llama2_7b_config() -> ModelConfig:
    """Llama-2-7B geometry, int8_mix weights (128 outliers), int8 KV."""
    return ModelConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, num_kv_heads=32, head_dim=128,
        dtype=torch.bfloat16,
        quant=QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128,
                          kv_cache=KVCacheQuantAlgo.INT8))


def llama2_13b_config(algo: QuantAlgo = QuantAlgo.W4A16,
                      kv: KVCacheQuantAlgo = KVCacheQuantAlgo.NONE
                      ) -> ModelConfig:
    """Llama-2-13B geometry (vocab 32000, hidden 5120, intermediate 13824,
    40 layers, 40 heads, MHA, head_dim 128); 128 outliers for the mix
    algos, groups of 128 rows for w4a16_g. KV none = bf16 pages."""
    return ModelConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, num_kv_heads=40, head_dim=128,
        dtype=torch.bfloat16,
        quant=QuantConfig(algo=algo, num_outliers=128, group_size=128,
                          kv_cache=kv))


def model_config(model: str, algo=None, kv=None) -> ModelConfig:
    """The geometry of ``model`` ("7b" or "13b") with ``algo``/``kv``
    (QuantAlgo / KVCacheQuantAlgo values or None for the model's
    default)."""
    base = {"7b": llama2_7b_config, "13b": llama2_13b_config}[model]()
    quant = dataclasses.replace(
        base.quant,
        algo=QuantAlgo(algo) if algo else base.quant.algo,
        kv_cache=KVCacheQuantAlgo(kv) if kv else base.quant.kv_cache)
    return dataclasses.replace(base, quant=quant)


def distinct_act_scales(cfg: ModelConfig, gen: torch.Generator,
                        device) -> dict:
    """Distinct per-channel calibration absmaxes (a random permutation of
    1..in per module), so the top-k outlier choice has no ties."""
    out = {}
    for i in range(cfg.num_layers):
        for name, n_in in (("self_attn.q_proj", cfg.hidden_size),
                           ("self_attn.o_proj", cfg.q_size),
                           ("mlp.gate_proj", cfg.hidden_size),
                           ("mlp.down_proj", cfg.intermediate_size)):
            out[f"model.layers.{i}.{name}"] = (
                torch.randperm(n_in, generator=gen, device=device).float()
                + 1)
    return out


def ragged_prompts(seed: int, vocab: int, n: int = 8):
    """n prompts of 100-700 random tokens."""
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(m)).tolist()
            for m in rng.integers(100, 701, n)]


def make_executor(params, cfg, seed: int, device):
    from ..runtime.scheduler import Executor
    return Executor(params, cfg, max_batch=8, max_seq_len=768,
                    block_size=128, prefill_chunk=256, seed=seed,
                    device=device)


def dense_cache_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of the dense KV cache GenerationSession allocates: K and V
    values, and their f32 per-(token, head) scales in the int8 and fp8
    modes."""
    n = cfg.num_layers * batch * max_len * cfg.num_kv_heads
    if cfg.quant.kv_cache != KVCacheQuantAlgo.NONE:
        return 2 * n * (cfg.head_dim + 4)
    return 2 * n * cfg.head_dim * cfg.dtype.itemsize


def serve_dense(params, cfg, prompts, dev):
    """Serve the prompts once as one static batch through a fresh
    GenerationSession (max_seq_len 768), 32 greedy tokens each. The session
    marks its prefill with the "phase::prefill" profiler range itself.
    Returns (GenerationOutput, wall s)."""
    from ..models import common as mcommon
    from ..runtime.session import GenerationSession
    sess = GenerationSession(params, cfg, max_seq_len=768, device=dev)
    in_prefill = [False]
    inner = sess._prefill

    def prefill_flagged(*a, **k):
        in_prefill[0] = True
        try:
            return inner(*a, **k)
        finally:
            in_prefill[0] = False

    sess._prefill = prefill_flagged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _counting_forwards(mcommon, "forward", in_prefill):
        out = sess.generate(prompts, 32)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


class _counting_forwards:
    """Counts ``module.<name>`` calls into FORWARDS by phase while open
    (in_prefill[0] says which), restoring the function on exit. The calls
    are eager forwards: a replayed decode rung calls nothing (``serve``
    counts its steps from the Executor)."""

    def __init__(self, module, name: str, in_prefill):
        self.module, self.name, self.in_prefill = module, name, in_prefill

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def counted(*a, **k):
            FORWARDS["prefill" if self.in_prefill[0] else "decode"] += 1
            return fn(*a, **k)

        setattr(self.module, self.name, counted)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def _group(name: str) -> str:
    for mark, label in PORT_KERNELS.items():
        if mark in name:
            if mark in FLOAT_PAGES and "signed char" not in name:
                return FLOAT_PAGES[mark]
            return label
    low = name.lower()
    if any(m in low for m in GEMM_MARKS):
        return "cuBLAS GEMM"
    return OTHER


def _report(title: str, events, wall_s: float, steps: dict,
            other_ops: dict) -> None:
    """Print a phase: its wall, busy time and idle share; each group's
    time and launches, also a step for each of ``steps`` (unit -> count);
    the top kernels; the torch ops behind the "other" group's kernels
    (``other_ops``: op -> [ms, launches]) by time and by launches."""
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3   # ms
        by_name[e.name][1] += 1
    busy = sum(ms for ms, _ in by_name.values())
    if not busy:
        print(f"{title}: wall {wall_s * 1e3:.1f} ms, no device time traced")
        return
    groups = defaultdict(lambda: [0.0, 0])
    for name, (ms, n) in by_name.items():
        groups[_group(name)][0] += ms
        groups[_group(name)][1] += n
    per = ", ".join(f"{n} {unit}" for unit, n in steps.items())
    print(f"{title}: wall {wall_s * 1e3:.1f} ms (unprofiled run), device "
          f"busy {busy:.1f} ms (profiled run), idle share "
          f"{1 - busy / (wall_s * 1e3):.3f}; {per}")

    def a_step(n):
        return "".join(f", {n / k:.1f} a {unit[:-1]}"
                       for unit, k in steps.items() if k)

    for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g}: {ms:.1f} ms ({ms / busy:.3f} of busy), {n} "
              f"launches{a_step(n)}")
    for name, (ms, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:8.2f} ms {n:6d} x  {name[:100]}")
    by = "torch op"
    if not other_ops:            # no op links traced: the kernels' names
        by, other_ops = "kernel", {n: v for n, v in by_name.items()
                                   if _group(n) == OTHER}
    if other_ops:
        for key, label in ((0, "time"), (1, "launches")):
            print(f"  {OTHER} by {by}, top by {label}:")
            for op, (ms, n) in sorted(other_ops.items(),
                                      key=lambda kv: -kv[1][key])[:8]:
                print(f"    {ms:8.2f} ms {n:6d} x{a_step(n)}  {op[:80]}")


def _other_ops(events, ranges):
    """(prefill, decode) dicts of torch op -> [ms, launches] for the
    kernels of the "other" group, each kernel charged to the op that
    launched it (the profiler links them); an op launched inside a prefill
    range is prefill's."""
    pre, dec = defaultdict(lambda: [0.0, 0]), defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU or \
                not getattr(e, "kernels", None):
            continue
        t = e.time_range.start
        side = pre if any(r.start <= t <= r.end for r in ranges) else dec
        for k in e.kernels:
            if _group(k.name) == OTHER:
                side[e.name][0] += k.duration / 1e3
                side[e.name][1] += 1
    return pre, dec


def draft_model(params, cfg, layers: int):
    """The target's first ``layers`` layers as a draft model: the same
    tensors, no copy."""
    return (dict(params, layers=params["layers"][:layers]),
            dataclasses.replace(cfg, num_layers=layers))


def serve(params, cfg, prompts, seed, dev, spec=None, burst: int = 1,
          ex=None, lora_ids=None):
    """Serve the prompts once, 32 greedy tokens each, through ``ex`` (an
    idle Executor) or a fresh one: ``run(burst=burst)``, or with ``spec`` =
    (draft params, draft config, gamma[, paged_draft]) ``run_speculative``
    (a dense-cache draft where paged_draft is False). ``lora_ids``: each
    prompt's runtime LoRA adapter.

    Returns (finished requests by id, request ids, wall s, prefill s,
    executor). Each prefill call is bracketed by synchronizes and marked
    with a profiler range that closes after the closing synchronize, so
    every kernel the call queued starts inside it and its kernels can be
    told from decode's. FORWARDS["decode"] counts the decode steps the
    rungs ran and the eager forwards of the speculative rounds, not the
    forwards a rung's first use runs to capture it."""
    from ..models import common as mcommon
    ex = ex or make_executor(params, cfg, seed, dev)
    prefill_s, in_prefill = [0.0], [False]
    inner = ex._step_prefill

    def prefill_ranged():
        torch.cuda.synchronize()
        t = time.perf_counter()
        in_prefill[0] = True
        with torch.profiler.record_function("phase::prefill"):
            inner()
            torch.cuda.synchronize()
        in_prefill[0] = False
        prefill_s[0] += time.perf_counter() - t

    ex._step_prefill = prefill_ranged
    rungs, steps = set(ex._rungs), ex.decode_steps
    ids = [ex.submit(p, max_new_tokens=32,
                     lora_id=lora_ids[i] if lora_ids else 0)
           for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with _counting_forwards(mcommon, "forward_paged", in_prefill):
            done = ex.run(burst=burst) if spec is None else \
                ex.run_speculative(spec[0], spec[1], gamma=spec[2],
                                   paged_draft=spec[3] if len(spec) > 3
                                   else True)
        torch.cuda.synchronize()
    finally:
        del ex._step_prefill
    # a rung made here ran its k steps twice eagerly (warm pass, capture)
    FORWARDS["decode"] += ex.decode_steps - steps - sum(
        2 * k for k, *_ in set(ex._rungs) - rungs)
    return done, ids, time.perf_counter() - t0, prefill_s[0], ex


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model", choices=("7b", "13b"), default="7b")
    ap.add_argument("--algo", choices=("int8_mix", "w8a16", "w4a16",
                                       "w4a16_g", "int4_mix", "fp8",
                                       "int8_lr", "none"))
    ap.add_argument("--kv", choices=("int8", "fp8", "none"))
    ap.add_argument("--gamma", type=int, default=0,
                    help="serve speculatively with this many draft tokens "
                         "a round (0: plain decode)")
    ap.add_argument("--draft-layers", type=int, default=4)
    ap.add_argument("--dense", action="store_true",
                    help="serve through GenerationSession over the dense "
                         "KV cache (K14 at prefill)")
    ap.add_argument("--burst", type=int, default=1,
                    help="decode K steps a rung call (run(burst=K), after "
                         "warmup(burst=K))")
    args = ap.parse_args()
    if args.dense and args.gamma:
        ap.error("--dense serves plain decode; --gamma is the Executor's")
    if args.burst > 1 and (args.dense or args.gamma):
        ap.error("--burst is the Executor's plain decode")
    from ..device import resolve_device
    from ..models import llama
    dev = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"device: {smi}; torch {torch.__version__}")
    cfg = model_config(args.model, args.algo, args.kv)
    print(f"model: Llama-2-{args.model.upper()} geometry, {cfg.num_layers} "
          f"layers, {cfg.quant.algo.value} weights, "
          f"{cfg.quant.kv_cache.value} KV (none = {cfg.dtype} pages)")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = llama.init_random_params(
        cfg, seed=args.seed, device=dev,
        act_scales=distinct_act_scales(cfg, gen, dev))
    prompts = ragged_prompts(args.seed, cfg.vocab_size)
    spec = None
    if args.gamma:
        spec = (*draft_model(params, cfg, args.draft_layers), args.gamma)
        print(f"speculative: gamma {args.gamma}, draft = the first "
              f"{args.draft_layers} layers")

    rounds = [0]
    ex = None
    if not args.dense:
        ex = make_executor(params, cfg, args.seed, dev)
        t = time.perf_counter()
        ex.warmup(burst=args.burst)
        torch.cuda.synchronize()
        print(f"warmup(burst={args.burst}): {time.perf_counter() - t:.3f} s "
              f"(kernels built, rungs "
              f"{sorted(k for k, *_ in ex._rungs)} captured)")

    def run_once():
        """(wall s, prefill s, what else to print) of one serve."""
        FORWARDS.clear()
        if args.dense:
            out, wall = serve_dense(params, cfg, prompts, dev)
            return wall, out.prefill_time_s, (
                f"; dense cache "
                f"{dense_cache_bytes(cfg, len(prompts), 768) / 1e9:.3f} GB")
        counts = (ex.decode_calls, ex.graph_replays, ex.readbacks)
        done, ids, wall, pre_s, _ = serve(params, cfg, prompts, args.seed,
                                          dev, spec, args.burst, ex)
        calls, replays, reads = (a - b for a, b in zip(
            (ex.decode_calls, ex.graph_replays, ex.readbacks), counts))
        gen = sum(len(done[r].generated) for r in ids)
        rounds[0] = ex.spec_rounds if spec else 0
        extra = (f"; {calls} decode calls, {replays} graph replays, "
                 f"{reads} host readbacks = {reads / gen:.4f} a generated "
                 f"token; compiles since warmup {ex.compiles_since_warmup}")
        return wall, pre_s, extra + (
            f"; acceptance "
            f"{ex.spec_accepted / max(ex.spec_proposed, 1):.3f} "
            f"({ex.spec_accepted} / {ex.spec_proposed} draft tokens, "
            f"{ex.spec_rounds} rounds)" if spec else "")

    if args.dense:
        print("dense: GenerationSession, one static batch, max_seq_len 768")
    run_once()                                  # warm-up
    timed = []
    for _ in range(TIMED_RUNS):
        wall, pre_s, extra = run_once()
        timed.append((wall, pre_s))
        print(f"served {len(prompts)} requests x 32 tokens: wall {wall:.3f} "
              f"s = prefill {pre_s:.3f} s + decode {wall - pre_s:.3f} "
              f"s{extra}")
    wall, pre_s = sorted(timed)[len(timed) // 2]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # the profiler's host overhead stretches the wall clock several-fold,
    # so walls come from the run above and device times from this one
    with torch.profiler.profile(activities=acts) as prof:
        run_once()
    events = prof.events()
    ranges = [e.time_range for e in events if e.name == "phase::prefill"
              and e.device_type == torch.autograd.DeviceType.CPU]
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("phase::")]
    # each prefill call starts and ends with a synchronize, so a kernel
    # that starts inside a prefill range on the common clock is prefill's
    pre, dec = [], []
    for k in kernels:
        t = k.time_range.start
        (pre if any(r.start <= t <= r.end for r in ranges) else dec).append(k)
    other_pre, other_dec = _other_ops(events, ranges)
    _report("prefill calls", pre, pre_s, {"forwards": FORWARDS["prefill"]},
            other_pre)
    dec_steps = {"forwards": FORWARDS["decode"]}
    if spec:
        dec_steps["rounds"] = rounds[0]
    _report("speculative rounds (draft prefill, draft steps, verify)"
            if spec else "decode steps", dec, wall - pre_s, dec_steps,
            other_dec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
