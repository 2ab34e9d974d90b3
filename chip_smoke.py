#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (mixq_tensorrt_llm_tpu_torch).

    python3 chip_smoke.py [--seed N]

Needs one CUDA card; exits non-zero without one, or without the port
beside this script. Phases, each printing its own lines; any failed check
exits non-zero:

  1. device: name, count, power limit
  2. build: every CUDA kernel from csrc/ (one nvcc per source, in parallel)
  3. kernels against their plain PyTorch versions on the card at the main
     paths' shapes (Llama-2-7B: Hkv 32, D 128, BS 128, plus a GQA case
     Hq 32 / Hkv 8; linears at 1024 prefill rows and 8 decode rows; K4 in
     its three regimes: the four 7B decode linears at 1, 8 and 16 rows,
     7B down_proj at 17, 40 (the verify), 64, 128, 129 and 1024 rows and
     the four 13B linears at 1024, then both of its kernels at 16-128 rows
     for the crossover. Llama-2-13B: K12 and K13 (group size 128) at 1, 8
     and 16 decode rows and 64 at qkv, each no slower than
     torch._weight_int4pack_mm at qkv M = 8; K4, K12 and K13 bit-equal
     across two launches (their K splits sum in a fixed order); K5p/K6p
     and K7/K8 on bf16 pages at Hkv 40, plus Hq 40 / Hkv 8):
     K5/K6/K5p/K6p pages (and scales) bit-equal outside trash row 0, K7/K8
     within 2e-2, K7 and K8 bit-equal across two launches (K7's splits
     merge in a fixed order), K8 timed in TFLOP/s; K1 codes at most 1
     apart (> 99.9% equal), scales rtol 1e-5, at 1024 and 40 rows of 7B
     width and 40 rows of K 32768 (its two kernels), bit-equal across two
     launches, timed at 1024 and 40 rows; K2/K3/K4/K12/K13 within 1e-4 of
     the largest output (+ one bf16 step), K2 bit-equal on the
     int32-exact case and across two launches, timed at the three 7B
     mix shapes at 1024 and 40 rows; each kernel's device time per
     launch and its plain version's device time per call come from
     torch.profiler, the wrapper's time per call (host included) from
     CUDA events, and the library call's where one computes the same
     function (K4: torch._weight_int8pack_mm, at every shape; K12, K13:
     torch._weight_int4pack_mm)
  4. main path at full width: a Llama-2-7B-geometry int8_mix (128
     outliers) / int8-KV model with random weights serves 8 ragged
     requests (100-700 prompt tokens, 32 greedy tokens each) through the
     Executor (the serving loop of tools/serving_profile.py); K1, K2 and
     K4-K8 must launch in that run (K3 is not on the path). In phases 4,
     4b, 6 and 6b every decode step is a replay of the Executor's
     captured rung 1 (its first use captures it inside the run), and each
     replay adds the launches its capture recorded to the counts
  5. cross-device: the same weights at 2 layers, the first prefill chunk's
     last-position logits and one decode step's logits on the card
     (kernels) against the CPU (plain), plus negative controls: faults
     injected into K8's, K2's, K4's or K7's call (K7's merge leaving out
     the last split that saw a key) must land outside the tolerance
  4b. the int4 path at full width and depth: a Llama-2-13B-geometry
     (40 layers) w4a16 / bf16-KV model serves the same requests; K12, K4
     (its prefill regime, on the unpacked weight), K5p, K6p and K7/K8 on
     bf16 pages must launch, K1, K2 and K13 must not
  5b. cross-device at 13B width, 2 layers, as phase 5, for w4a16 + bf16
     KV, w4a16_g (groups of 128) + int8 KV and int4_mix (128 outliers) +
     bf16 KV, each with the kernels it must launch, and negative controls
     in K12's, K13's and K5p's calls
  6. speculative serving at full width: the phase-4 model (32 layers)
     serves the same requests through run_speculative, gamma 4, a draft of
     its first 4 layers, 8 rounds a call; K9 (verify), K7 (draft steps),
     K1 -> K2 and K4's mid regime (the 5-row verify's linears: 40 rows)
     must launch, the device-paced
     rounds must run with one host readback a call
  4d. decode bursts on the main path: the phase-4 model, through a new
     Executor, runs warmup(burst=16) (rungs 16, 8, 4, 2 and 1 captured as
     CUDA graphs), then serves the same 8 requests with run(burst=1) and
     run(burst=16), each once timed and once under torch.profiler: every
     request's tokens equal phase 4's, no program made after warmup,
     every decode call a graph replay, K4 (decode regime), K5 and K7
     launched and traced in the decode phase; decode wall, idle share and
     host readbacks a generated token printed beside phase 4's
  6b. split decode on the main path: the phase-4 model serves with
     MIXQ_KV_SPLITS=4; K11 must launch at decode (one launch of K7's
     kernel a step and layer), neither K7 nor K10
  7. cross-device, 2 layers at full width: one verify forward's logits at
     S = 4 and S = 5 over a short context, one decode step's with
     MIXQ_KV_SPLITS=4, card against CPU; and a fault in K9's row
     positions (every row at qstart) as a control
  4c. the dense path at full width and depth: the phase-4 model serves the
     same 8 requests as one static batch through GenerationSession
     (max_seq_len 768: one 768-token prefill bucket, 32 greedy tokens);
     K14, K1, K2 and K4 must launch, no paged kernel (K5-K11)
  5c. cross-device, 2 layers at full width: the session's prefill
     last-position logits (K14 at a 256-token bucket) and one decode
     step's logits, card against CPU, with faults in K14's call as
     controls; the 2-layer model saved with save_checkpoint and served
     once through LLM on the card
  4e. beam serving at full width: the phase-4 model serves 16 requests
     (400-512 random tokens each: one 512-token bucket, ragged, so
     copy-on-write runs) through a new Executor(max_batch=16, block_size
     128, max_seq_len 768): warmup_beams(num_beams=4, burst=16,
     prompt_bucket=512, max_new_tokens=64), then run_beams(burst=16)
     twice (once timed, once under torch.profiler): every burst a replay
     of its captured CUDA graph, no program made after warmup, both runs
     the same sequences of 64 tokens, K10 launched and traced in the burst
     decode once a layer a step, neither K7 nor K5; the wall, idle share,
     readbacks a generated token and peak pool blocks printed, and the
     share of requests whose best sequence equals a burst=1 run's (a
     reading: bf16 at random weights flips near-ties)
  4f. beam serving on bf16 pages: the phase-4b model (13B w4a16 / bf16
     KV) serves 8 requests of 200-256 tokens, 4 beams, 32 new tokens,
     through a new Executor, warmed and checked as phase 4e (K10 on bf16
     pages, K12 at the steps)
  5d. cross-device, 2 layers at full width: four steps of a beam burst's
     forward (_forward_with_tail: K10 on the pool prefix merged with the
     dense tail) over prefixes of 5 and 9 tokens, the last step's logits
     card against CPU; the merge leaving out the tail and K10's l doubled
     are the controls
  4g. the serving surface on the phase-4 model: Executor(block_size 128,
     prefill_chunk 256, max_batch 8, max_seq_len 768, one logits
     processor) after warmup(burst=16), without and then with
     enable_block_reuse: one request of 640 tokens, then 7 sharing its
     first 512 (64-200 more each), 32 greedy tokens each, the second wave
     profiled: 28 blocks adopted, 3584 fewer prefill tokens, K6 and K8
     traced in the prefill, every decode call a replay, no program after
     warmup, on_token's order equal to the tokens; TTFT and token
     agreement printed. At 2 layers, B's suffix over pages A's prefill
     wrote against B cold within 5e-2, pages of another prefix caught.
     Over the 7 prompts again, a free run, then lane 0 banning the
     two-token word its free run emits at a decode step j >= 2 and lanes
     1-6 with the processor (it bans even ids and the newest token): lane
     0 leaves the free run at j, each processor lane at the first token
     its free run emits that the processor bans, and emits none; only the
     bad-words bucket's rungs made (one a k).
     cancel mid-decode returns its blocks; a snapshot after 8 steps
     restored on a fresh Executor finishes every request. Then
     InferenceServer(burst=16, warmup=True), reuse off as `cli serve`
     runs it, on 127.0.0.1: 8 /generate and
     2 /generate_stream at once (streams equal their final tokens),
     /health with no program after warmup, and a max_queue_size=2 server
     answering 503
  4h. the quantization pipeline at Llama-2-7B: an HF-format F16 directory
     (the public Llama-2-7b-hf config cut to HF_LAYERS = 16 layers,
     random N(0, 0.02)
     weights from --seed in shards with an index, written by the port's
     own writer into a temporary directory the phase deletes; 128 planted
     outlier channels a layer, drawn from 128..4095, where both RMSNorm
     weights are 20) goes through quantize_hf_model on the card (4 x 512
     calibration tokens, int8_mix / int8 KV): the calibrated fp_ind of
     qkv and gate_up equal the planted set in every layer, K14 launched
     and traced in the calibration; LLM over the directory twice (the
     second loads and writes nothing; its checkpoint equals step 1's);
     perplexity over 32 blocks x 512 at batch 8 on the float model, the
     int8_mix model (fresh K/V: K1, K2, K4 prefill, K14 launched and
     traced; and through the int8 cache) and an uncalibrated control
     (requantize with all-ones scales), whose error against the float
     model must be at least 3x the calibrated model's in every layer's
     own update and in the logits at the first 2 layers, and above it at
     4, 8, 16 and 32 (random weights: the logits' errors compound with
     depth towards saturation); at 2 layers, the card's act_scales
     quantized on the CPU bit-equal to the card's int8 tensors, and the
     card's calibration against the CPU's in bf16 and an f32 CPU witness
     (relative RMS within 2e-2, the largest channel difference within the
     bf16 run's own spread from f32, o_proj's picks equal where they are
     unambiguous; the largest difference located). It needs 28 GB of free
     disk and fails without them
  4i. runtime-adaptive outliers, fp8 and int8_lr at Llama-2-7B width,
     each through a new Executor warmed at burst 16 serving the 8
     requests at burst 16 (walls, tokens/s, decode idle share, peak
     memory; every decode call a replay, no program after warmup):
     int8_mix with dynamic outliers (cap 256), 16 layers, 32 channels a
     layer planted outside the static sets (both RMSNorm weights 8):
     after serving every layer's qkv and gate_up selections hold them,
     K1 / K2 ran at ko 256, 2 layers card vs CPU (logits; chan_max per
     channel against an f32 CPU witness; selections; a decode step
     leaves the state as it is), a quiet control (no
     planted channel: the static sets, logits equal to the static
     path's) and each layer's update against a float model (static
     error above dynamic); fp8 weights and e4m3 pools, 32 layers: no
     paged kernel, the gather route counted, 2 layers card vs CPU, the
     casts card vs CPU byte for byte; int8_lr, 16 layers (one SVD a
     shape timed, a reading): K1 at ko 0 and K2 at ko 32 in prefill
     and in the decode replays, K4 for down_proj, 2 layers card vs CPU,
     and its logits error below plain W8A8's at 2 layers. Phase 3 also
     holds K1 over a 256-wide fp_ind with 100 entries -1 and an empty
     one, and K2 at ko 256 and 32, at 8 and 1024 rows
  4j. the decoding extras over the dense cache and runtime LoRA, on the
     phase-4 model: (a) LLM.generate_speculative with phase 6's 4-layer
     draft, gamma 4, the 8 requests (100-700 tokens, max_seq_len 768, 32
     new each), greedy and at temperature 1.0: 32 tokens a lane, each a
     valid id; K1 -> K2 launched exactly 3 a layer a verify (5 rows) and
     K4 16 a draft layer a round beside the prefills', the three traced;
     wall, tok/s, acceptance, rounds, idle share, and each lane's first
     token unlike the session's greedy run (a reading). (b) Medusa, the
     default 10-node tree (verify S = 11), 4 random f32 heads, one
     512-token prompt, 64 new tokens; on the 4-node chain tree a
     random-heads run and an oracle proposing its tokens (the verify
     rows then compute them bit for bit): 64 tokens each, the oracle >= 2
     a step, K14 once a layer at the prefill, K1 -> K2 3 a layer a
     verify; an oracle proposing the session's greedy tokens (W8A16
     steps) is a reading, with each run's first token unlike the
     session's.
     (c) ReDrafter, a random RNN drafter (exit 2H), 4 beams x 4 (verify
     S = 17), the same prompt, random and oracle (beam 0 the random run's
     tokens), checked alike. (d)
     run_speculative(paged_draft=False) on phase 6's requests beside
     paged_draft=True (both timed and profiled here): K14 at the dense
     draft's prefill, K9 in the verifies; acceptance, rounds, wall, idle
     share, each lane's first token unlike the paged run. (e) runtime
     LoRA: two random PEFT adapters (rank 16 on q/k/v/o, 8 on
     gate/up/down, alpha 2r) written with the port's writer into a
     temporary directory, attached; a new Executor after
     warmup(burst=16) serves the 8 requests with ids 0/1/2 at burst 16:
     every decode call a replay, no program after warmup, K1 only
     without its norm and K2 traced in the prefill, K4 and K7 in the
     replays; TPOT beside phase 4d's, each id-0 lane's first token unlike
     phase 4d's. (f) 2 layers card against CPU: a Medusa verify (mask,
     rope_pos, return_hidden; the hidden within 2e-2 of its largest
     value), an adapter lane's forward(lora_ids=[2]) and a 5-row
     speculative verify within the phases' 5e-2; RoPE by slot and a
     causal mask in place of the tree's are controls, enforced
  4k. the dense decoder families (models/families.py): (a) a
     Gemma-2-9B-geometry int8_mix / int8-KV model (google/gemma-2-9b's
     published widths, 22 of its 42 layers, random weights through
     families.init_random_params on the card; window 4096 on every other
     layer, softcaps 50 / 30, GeGLU, tied embeddings) serves phase 4's 8
     requests and one of 4,400 prompt tokens (the windowed layers
     truncate) through an Executor (block_size 128, max_seq_len 4864)
     after warmup(burst=16), 32 greedy tokens each at burst 16: every
     lane 32 finite tokens, every decode call a replay, no program after
     warmup, K1, K2, K6 and K8 traced in the prefill calls, K4, K5 and K7
     in the replays, K7 and K8 once a layer a step or call with the
     windowed layers' calls at 4096 and the global layers' at 0; walls,
     TPOT, idle shares, peak memory and launches printed; then LLM /
     GenerationSession over the same model on 2 prompts (the softcaps
     take the masked route: no K14). (b) 2 layers of full widths card
     against CPU, a prefill call and 4 decode steps each through the
     Executor (a logits processor records the raw logits on the device
     and forces the next token), logits within 2e-2 of the largest:
     Gemma-2-9B with its window cut to 256 under a 600-token prompt (every
     layer global as an enforced control), Falcon-7B (71 query heads on 1
     KV head of 64: K7's rows layout; K2 / K4 at N % 128 == 64), BLOOM-7B1
     (ALiBi: the gather route counted, K5 / K6 launched, no K7 / K8; its
     slopes at zero as an enforced control), and Phi-2 (head dim 80)
     through GenerationSession, its Executor refused on the card with a
     ValueError naming csrc/paged_attention.cu
  4l. the expert models (models/moe.py): (c) K4 alone at Mixtral's
     expert products (gate_up 4096 -> 28672, down 14336 -> 4096) at 9
     and 150 rows with f32 out, against its plain version, two launches
     bit-equal, timed beside its bound and torch._weight_int8pack_mm; (a)
     a Mixtral-8x7B-geometry int8_mix / int8-KV model
     (mistralai/Mixtral-8x7B-v0.1's published widths, 32 layers, 8
     experts top 2, random weights through llama.init_random_params on
     the card, a layer's f32 experts at a time; qkv / o mixed, the experts
     W8A16) serves phase 4's 8 requests through an Executor (block_size
     128) after warmup(burst=16), 32 greedy tokens each: every lane 32
     finite tokens, every decode call a replay, no program after warmup;
     each rung's graph holds 2 + 2 x 8 K4 launches a layer a step and the
     all-rows route only; the prefill calls' MoE layers sorted, one
     readback a layer a call, their K4 launches 2 a non-empty expert
     group; walls, TPOT beside the experts' byte bound, idle shares, pool
     and weight bytes, peak memory and route counts printed; then one
     run_beams burst (2 requests x 4 beams x 16 tokens) after
     warmup_beams, every burst a replay, K10 once a layer a step, all
     rows. (b) 2 layers of full widths card against CPU, a 256-token
     prefill call (sorted route) and 4 decode steps (all rows) each
     through forward_paged, the CPU run taking the card's expert choices
     (the tokens its own router sends elsewhere printed), logits within
     5e-2 (Mixtral: phase 5's limit for the same dense path) or 2e-2 (the
     Qwen models: phase 4k's) of the largest:
     Mixtral-8x7B, Qwen1.5-MoE-A2.7B (60 experts, top 4, the shared
     expert) and Qwen3-30B-A3B (128 experts, top 8, q/k norms); two
     controls each, which must move the logits by 3x the tolerance: the
     top-k renormalization flipped, the k-th expert replaced by the
     (k+1)-th
  4m. the recurrent-state models (models/mamba.py,
     models/recurrentgemma.py), int8_mix (128 outliers), random weights
     drawn on the card through registry.init_random_params (the
     recurrence's own parameters redrawn so the state carries signal:
     Mamba's x_proj N(0, 1); RecurrentGemma's gates and recurrent_param
     as HF's initializer draws them, conv taps U(+-1/sqrt(4))): (a) Mamba-2.8B
     (state-spaces/mamba-2.8b-hf's widths, all 64 layers) serves phase
     4's 8 prompts, 64 greedy tokens each, through GenerationSession:
     every lane its tokens, finite; K1 -> K2 exactly 2 a layer a forward
     (in_proj, out_proj), no other kernel; (b) RecurrentGemma-2B
     (google/recurrentgemma-2b's widths, 24 of its 26 layers: both
     packages refuse a depth off the 3-layer pattern) serves 7 of them
     and one of 2,300 tokens (the 2048 window masks prefill and decode):
     K1 -> K2 11 a 3-layer group a forward, K4 once a layer, K8 (the page
     view) once an attention layer at the prefill; for each, walls, TPOT
     beside the weights' byte bound, idle shares, traced K1 / K2 (/ K4)
     launches against the expected, weight bytes and peak memory. (c) the
     first layers at full widths card against CPU through
     models.common.forward (Mamba 2, prompts of 4 recurring tokens;
     RecurrentGemma 6, two pattern groups, its window cut to 8 under a
     640-token lane beside a 1-token one, after another prompt's
     prefill), a
     prefill and 4 decode steps within 2e-2 of the largest logit, and two
     controls each that must read 5x that: Mamba's SSM state zeroed
     between prefill and decode and its conv taps reversed;
     RecurrentGemma's window turned off and its LRU reset dropped. Phase
     3 holds K8 at RecurrentGemma-2B's prefill (8 x 2432, 10 query heads
     on 1 KV head of 256, window 2048; SDPA its library call), K1 -> K2
     at Mamba-2.8B's in_proj / out_proj and K4 at RecurrentGemma-2B's
     down_proj, at 8 and 1024 rows
  8. a `kernels` JSON line (K4 also at the expert shapes of 4l(c); K8,
     K2 and K4 at the shapes of phase 4m), the nvidia-smi line, then the
     result line.

Phase 3 also holds K9 (verify rows: 8 lanes at S = 4, 5 and (int8) 8,
and S = 8 at 8 query heads a KV head, 64 rows a block; at S = 1 bit-equal
to K10's output rounded to q's dtype; bit-equal across two launches;
timed in TB/s), K10 (out within 2e-2, m and l within 1e-3 relative of
the plain stats; bit-equal across two launches) and K11 (one launch of
K7's kernel a call and no other device work; splits 2 and 4 at 8 lanes
with 3 masks, bit-equal across two launches, and at 1 lane x 4096
tokens, against K7 and its plain version; its merge leaving out the last
split that saw a key as an enforced control) on int8 and bf16 pages at
Llama-2-7B heads; K7's rows layout (K9's kernel at S = 1, where a KV
head's query heads do not fit the split kernel's block) at Falcon-7B's 71
query heads on 1 KV head of 64 and the MQA coders' 48 of 128, timed beside
the split kernel at 8 heads; K2 and K4 at Falcon-7B's N % 128 == 64
(4672, 4544) in their regimes; and K1 -> K2 at
the 40 rows of a gamma = 4 verify,
and K14 (causal flash attention) at the dense serve's shape (8 x 768, 32
heads x 128, with SDPA timed as its library call), at D 64 and 256 with
S 128 and 2048, at S 1, 65 and 200, and causal_self_attention's GQA
route (K8 over a page view). And it holds the KV write as a layer calls
it: runtime/kv_cache.paged_write with the Executor's block_pos (a
recycled table, an inactive lane), a valid mask or kv_valid_len and new
V a strided view of the qkv output, at S = 1 and 5 (8 lanes: K5's
route) and 256 (4 lanes: K6's), on int8 pages at 32 heads and bf16 at
40: bit-equal to the plain route (_locate, then the plain scatter or the
chunk's drop rule) outside trash row 0, one kernel a call by the traced
names, timed a call on the device and through the wrapper; the plain
route with every slot shifted by one is the control, and must be seen.
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
ATTN_TOL = 2e-2       # K7-K11, K14 against their plain versions (bf16 output)
STATS_RTOL = 1e-3     # K10's m and l against the plain stats
GEMM_TOL = 1e-4       # K2-K4, K12, K13 vs plain: f32 sums in another order,
                      # of the largest |output|
XDEV_TOL = 5e-2       # phases 5, 5b, 5c, relative to the largest |logit|
HBM_BYTES_PER_MS = 3.35e9          # H100 SXM: 3.35 TB/s
BF16_FLOP_PER_MS = 989e9           # H100 SXM dense bf16 tensor-core peak
INT8_OP_PER_MS = 1979e9            # H100 SXM dense int8 tensor-core peak
SRC = "mixq_tensorrt_llm_tpu_torch/csrc/"
JOPS = "mixq_tensorrt_llm_tpu/ops/"
# launch-count name -> (the TPU kernel it replaces, source)
KERNELS = {
    "rmsnorm_quant_split": (JOPS + "norm_quant.py:30", "norm_quant.cu"),
    "mixed_matmul": (JOPS + "mixed_matmul.py:32", "mixed_matmul.cu"),
    "mixed_matmul_hybrid": (JOPS + "mixed_matmul.py:122", "mixed_matmul.cu"),
    "wo_matmul": (JOPS + "wo_matmul.py:26", "wo_matmul.cu"),
    "wo_matmul_packed": (JOPS + "wo_matmul.py:111", "wo_matmul.cu"),
    "wo_matmul_packed_grouped": (JOPS + "wo_matmul.py:203", "wo_matmul.cu"),
    "paged_write_token": (JOPS + "paged_write.py:42", "paged_write.cu"),
    "paged_write_token_fp": (JOPS + "paged_write.py:61", "paged_write.cu"),
    "paged_write_chunk": (JOPS + "paged_write.py:147", "paged_write.cu"),
    "paged_write_chunk_fp": (JOPS + "paged_write.py:161", "paged_write.cu"),
    "paged_decode_attention": (JOPS + "paged_attention.py:70",
                               "paged_attention.cu"),
    "paged_decode_attention_fp": (JOPS + "paged_attention.py:70",
                                  "paged_attention.cu"),
    "paged_prefill_attention": (JOPS + "paged_attention.py:307",
                                "paged_attention.cu"),
    "paged_prefill_attention_fp": (JOPS + "paged_attention.py:307",
                                   "paged_attention.cu"),
    "paged_verify_attention": (JOPS + "paged_attention.py:70",
                               "paged_attention.cu"),
    "paged_verify_attention_fp": (JOPS + "paged_attention.py:70",
                                  "paged_attention.cu"),
    "paged_decode_attention_stats": (JOPS + "paged_attention.py:70",
                                     "paged_attention.cu"),
    "paged_decode_attention_stats_fp": (JOPS + "paged_attention.py:70",
                                        "paged_attention.cu"),
    "paged_decode_attention_split": (JOPS + "paged_attention.py:483",
                                     "paged_attention.cu"),
    "paged_decode_attention_split_fp": (JOPS + "paged_attention.py:483",
                                        "paged_attention.cu"),
    # the stock Pallas flash_attention that causal_self_attention calls
    "flash_causal_attention": (JOPS + "attention.py:58",
                               "flash_attention.cu"),
}
PAGED = [n for n in KERNELS if n.startswith("paged_")]
# the kernels each main path must launch (K3, the hybrid schedule's
# epilogue, is on neither: as in the JAX package, where only its kernel
# test calls mixed_matmul_hybrid; K13 serves w4a16_g, phase 5b)
ON_PATH = {
    "7b": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
           "wo_matmul.decode", "wo_matmul.prefill",
           "paged_write_token", "paged_write_chunk", "paged_decode_attention",
           "paged_prefill_attention"],
    # K4 where a prefill call has more than 128 rows (on the unpacked
    # weight), K12 at decode and on smaller calls
    "13b": ["wo_matmul_packed", "wo_matmul", "wo_matmul.prefill",
            "paged_write_token_fp", "paged_write_chunk_fp",
            "paged_decode_attention_fp", "paged_prefill_attention_fp"],
    # phase 6: the verify (K9; gamma 4 = 5 rows, so K1 -> K2, and K4's mid
    # regime for down_proj's 8 x 5 = 40 rows), the draft's steps (K7, K4,
    # K5) and prefill, the target's prefill and steps
    "spec": ["paged_verify_attention", "paged_decode_attention",
             "rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
             "wo_matmul.mid", "wo_matmul.decode", "wo_matmul.prefill",
             "paged_write_token", "paged_write_chunk",
             "paged_prefill_attention"],
    # phase 6b: every decode step through K11 (one launch of K7's kernel
    # each), neither K7's nor K10's wrapper
    "split": ["paged_decode_attention_split",
              "rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
              "paged_write_token", "paged_write_chunk",
              "paged_prefill_attention"],
    # phase 4d: the decode rungs' replays (K4's decode regime, K5, K7);
    # the prefill chunks run eagerly between them
    "burst": ["wo_matmul", "wo_matmul.decode", "paged_write_token",
              "paged_decode_attention", "rmsnorm_quant_split",
              "mixed_matmul", "paged_write_chunk",
              "paged_prefill_attention"],
    # phase 4c: GenerationSession over the dense cache: K14 once a layer
    # at the prefill, the mix linears there, the weight-only ones decoding
    "dense": ["flash_causal_attention", "rmsnorm_quant_split",
              "mixed_matmul", "wo_matmul", "wo_matmul.prefill",
              "wo_matmul.decode"],
    # phase 4e: run_beams, every burst step K10 on the pool prefix and the
    # weight-only linears (64 lanes: K4's mid regime); the prefill's K1 ->
    # K2, K4, K6 and K8
    "beam": ["paged_decode_attention_stats", "wo_matmul", "wo_matmul.mid",
             "wo_matmul.prefill", "rmsnorm_quant_split", "mixed_matmul",
             "paged_write_chunk", "paged_prefill_attention"],
    # phase 4f: the same on bf16 pages (K10's _fp mode), K12 at the steps
    "beam_13b": ["paged_decode_attention_stats_fp", "wo_matmul_packed",
                 "wo_matmul.prefill", "paged_write_chunk_fp",
                 "paged_prefill_attention_fp"],
    # phase 4g: prefix reuse's second wave: chunks after adopted pages
    # (K1 -> K2, K4, K6, K8) and the decode rungs' replays (K4, K5, K7)
    "serving": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                "wo_matmul.decode", "wo_matmul.prefill", "paged_write_token",
                "paged_write_chunk", "paged_decode_attention",
                "paged_prefill_attention"],
    # phase 4h: the int8_mix perplexity forward (8 x 512 rows: K1 -> K2,
    # K4's prefill regime for down_proj, K14); its calibration's K14 is
    # checked apart
    "hf": ["flash_causal_attention", "rmsnorm_quant_split", "mixed_matmul",
           "wo_matmul", "wo_matmul.prefill"],
    # phase 4i: dynamic outliers (prefill's mix linears K1 -> K2 at ko
    # 256, decode weight-only), int8_lr (K1 at ko 0 -> K2 at ko 32 in
    # prefill and decode, K4 for down_proj), both on int8 pools; fp8
    # launches none of the port's kernels (cuBLAS after the e4m3
    # dequantization; e4m3 pools take the gather route)
    "dyn": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
            "wo_matmul.decode", "wo_matmul.prefill", "paged_write_token",
            "paged_write_chunk", "paged_decode_attention",
            "paged_prefill_attention"],
    "fp8": [],
    "lr": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
           "wo_matmul.decode", "wo_matmul.prefill", "paged_write_token",
           "paged_write_chunk", "paged_decode_attention",
           "paged_prefill_attention"],
}
# every int8 or bf16 pool stays off the e4m3 pools' gather route
NO_GATHER = ["paged_gather"]
OFF_PATH = {"7b": NO_GATHER,
            "13b": ["rmsnorm_quant_split", "mixed_matmul",
                    "wo_matmul_packed_grouped"] + NO_GATHER,
            "spec": NO_GATHER, "burst": NO_GATHER,
            "split": ["paged_decode_attention",
                      "paged_decode_attention_stats"] + NO_GATHER,
            "dense": PAGED + NO_GATHER,
            "beam": ["paged_decode_attention", "paged_write_token",
                     "paged_decode_attention_split",
                     "paged_verify_attention"] + NO_GATHER,
            "beam_13b": ["paged_decode_attention_fp", "paged_write_token_fp",
                         "rmsnorm_quant_split", "mixed_matmul"] + NO_GATHER,
            "serving": ["paged_decode_attention_split",
                        "paged_verify_attention",
                        "paged_decode_attention_stats"] + NO_GATHER,
            "hf": PAGED + NO_GATHER,
            "dyn": ["paged_decode_attention_split",
                    "paged_verify_attention"] + NO_GATHER,
            "fp8": PAGED + ["rmsnorm_quant_split", "mixed_matmul",
                            "wo_matmul", "flash_causal_attention"],
            "lr": ["paged_decode_attention_split",
                   "paged_verify_attention"] + NO_GATHER}
DRAFT_LAYERS, GAMMA = 4, 4          # phase 6
HF_LAYERS = 16                      # phase 4h: the directory's depth (of
#                                     Llama-2-7B's 32: the smoke's time)
BURST = 16                          # phase 4d
# phase 4d: the kernels of a decode step, by a mark of the traced name,
# and their launches a layer
DECODE_TRACED = {"wo_small_mma_kernel": ("K4", 4),
                 "write_token_kernel": ("K5", 1),
                 "decode_split_kernel": ("K7", 1)}
# serve(): per path, the numbers phase 4d prints phase 4's beside
SERVE_STATS = {}
BEAMS, BEAM_BURST = 4, 16                       # phases 4e, 4f
# beam path -> (requests, shortest and longest prompt, new tokens, prompt
# bucket): 4e on the phase-4 model, 4f on phase 4b's
BEAM_RUNS = {"beam": (16, 400, 512, 64, 512),
             "beam_13b": (8, 200, 256, 32, 256)}
# phase 4e: kernels of a burst step by a mark of the traced name, and
# their launches a layer a step
SHARED, SERVE_NEW = 512, 32          # phase 4g: shared prefix, new tokens
SERVE_KW = dict(block_size=128, prefill_chunk=256, max_batch=8,
                max_seq_len=768)
HTTP_WAIT = 300                      # s, every request and join of 4g
BEAM_TRACED = {"stats_rows_kernel": ("K10", 1),
               "decode_split_kernel": ("K7", 0),
               "write_token_kernel": ("K5", 0)}


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


def device_ms(torch, fn, iters: int, kernel: str = "",
              counter: str = "", names=None, only: str = "") -> float:
    """Device time per call of `fn`: the summed duration of the device
    activity (kernels, copies) that `iters` calls launch, traced by
    torch.profiler after a warm-up. With `counter` (a wrapper's
    launch-count name) the wrapper must count exactly one launch per call;
    with `kernel` only the kernels whose name holds it count, and the time
    is per traced launch: the tracer drops a few events now and then (3 of
    20 seen). ``names``, a list, receives the traced kernels' names.
    With ``only`` every traced device activity must be a kernel whose name
    holds it, at most one a call: the call queued that kernel and no other
    device work."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # now and then the tracer returns no device activity at all for a
    # window (three empty windows in a row were seen once in a smoke run):
    # trace it again, up to six times, a pause between the windows
    for attempt in range(6):
        if attempt:
            time.sleep(0.2)
        before = _build.LAUNCHES.get(counter, 0)
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and kernel in e.name]
        if evs:
            break
    check(len(evs) > 0, f"torch.profiler traced no device time ({kernel})")
    if names is not None:
        names.extend(sorted({e.name for e in evs}))
    if only:
        check(all(only in e.name for e in evs) and len(evs) <= iters,
              f"{len(evs)} device activities for {iters} calls, not one "
              f"{only} a call: {sorted({e.name for e in evs})}")
    if counter:
        launched = _build.LAUNCHES.get(counter, 0) - before
        check(launched == iters, f"{counter}: {launched} launches counted "
              f"for {iters} calls")
    if kernel:
        check(len(evs) <= iters, f"{kernel}: {len(evs)} launches traced "
              f"for {iters} calls")
        iters = len(evs)
    return sum(e.time_range.elapsed_us() for e in evs) / 1e3 / iters


def measure(torch, kernel_fn, plain_fn, kernel: str, counter: str,
            iters: int, plain_iters: int):
    """(kernel device ms per launch, plain device ms per call, wrapper ms
    per call); `kernel` marks the kernel's name, `counter` its wrapper's
    launch count."""
    return (device_ms(torch, kernel_fn, iters, kernel, counter),
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

def make_pools(torch, gen, dev, np_, hkv, bs, d, fp: bool = False):
    """int8 pages with f32 scales, or (fp) bf16 pages without scales."""
    shape = (np_, hkv, bs, d)
    if fp:
        return {n: (torch.randn(shape, generator=gen, device=dev)
                    * 0.5).bfloat16() for n in ("k", "v")}
    pools = {
        "k": torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8),
        "v": torch.randint(-127, 128, shape, generator=gen, device=dev,
                           dtype=torch.int8),
        "k_scale": torch.rand(shape[:-1], generator=gen, device=dev)
        * 0.02 + 0.002,
        "v_scale": torch.rand(shape[:-1], generator=gen, device=dev)
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


def check_writes(torch, gen, dev, results, fp: bool = False):
    """K5/K6 on int8 pools at Llama-2-7B heads (32), or (fp) K5p/K6p on
    bf16 pools at Llama-2-13B heads (40)."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_write as pw
    h, bs, d, np_ = (40 if fp else 32), 128, 128, 64
    sfx, tag = ("_fp", "p") if fp else ("", "")
    # bytes a page value and its scale take: written once, new read once
    val_b, scale_b = (2, 0) if fp else (1, 4)
    # K5: 8 lanes on distinct pages, the last masked to trash row 0
    b = 8
    pools = make_pools(torch, gen, dev, np_, h, bs, d, fp)
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
    check(err == 0.0, f"K5{tag} paged_write_token differs from plain ({err})")
    ms, pms, wms = measure(
        torch, lambda: pw.paged_write_token(ker, pg, off, nk, nv),
        lambda: pw.paged_write_token_plain(pln, pg, off, nk, nv),
        "write_token_kernel", "paged_write_token" + sfx, 200, 50)
    nbytes = 2 * b * h * (d * (2 + val_b) + scale_b) + 2 * b * 4
    results["paged_write_token" + sfx] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound=bound(nbytes))
    print(f"K5{tag} paged_write_token: bit-equal; device {ms:.5f} ms per "
          f"launch (plain {pms:.5f} ms; wrapper {wms:.5f} ms per call) "
          f"B={b} H={h} D={d}, {'bf16' if fp else 'int8'} pages", flush=True)

    # K6: 4 lanes x 256-token chunk (2 slabs): a short prompt (tail masked),
    # a full chunk, an inactive lane, and a lane whose offsets are shifted
    # (every token dropped)
    b, s = 4, 256
    pools = make_pools(torch, gen, dev, np_, h, bs, d, fp)
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
    check(err == 0.0, f"K6{tag} paged_write_chunk differs from plain ({err})")
    check(bool((ker["k"][pages[3]] == pools["k"][pages[3]]).all()),
          f"K6{tag} wrote tokens whose offsets do not match their slot")
    ms, pms, wms = measure(
        torch, lambda: pw.paged_write_chunk(ker, blk, off, nk, nv),
        lambda: pw.paged_write_chunk_plain(pln, blk, off, nk, nv),
        "write_chunk_kernel", "paged_write_chunk" + sfx, 100, 20)
    landed = int(pw.chunk_write_mask(blk, off, bs).sum())
    # every token's values read (the bound kept from the first design) and,
    # beside it, only the landed tokens' (the kernel reads no other)
    nbytes = (2 * b * s * h * d * 2 + 2 * b * s * 4
              + landed * h * (d * val_b + scale_b) * 2)
    moved = 2 * b * s * 4 + landed * h * (d * (2 + val_b) + scale_b) * 2
    results["paged_write_chunk" + sfx] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound=bound(nbytes),
        bound_landed_ms=bound(moved)[0])
    print(f"K6{tag} paged_write_chunk: bit-equal; device {ms:.5f} ms per "
          f"launch (plain {pms:.5f} ms; wrapper {wms:.5f} ms per call) "
          f"B={b} S={s} H={h} D={d}, {landed} tokens landed; bound "
          f"{bound(nbytes)[0]:.5f} ms (every token read), "
          f"{bound(moved)[0]:.5f} ms (the landed tokens')", flush=True)
    check_layer_writes(torch, gen, dev, results, fp)


def layer_write_cases(torch, gen, dev, h, bs, d, np_):
    """(label, S, write_pos, block_table, block_pos, valid, kv_valid_len)
    as the Executor hands them to a layer: 8 decode lanes of 1-700 tokens
    (one inactive, one recycled table) at S = 1 (kv_valid_len) and S = 5
    (a verify's valid mask), and K8's 4 lanes x a 256-token chunk (a
    200-token prompt, two later chunks, an inactive lane; kv_valid_len)
    and x the draft prefill's 64 tokens (positions arange(64) expanded
    over the lanes, a lane stride of 0; K5's route)."""
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import PAD_POS
    lens = [700, 1, 256, 640, 129, 513, 384, 300]
    table, bpos = _attn_tables(torch, gen, dev, 8, 6, bs, np_, lens, 3)
    table[1], bpos[1] = 0, int(PAD_POS)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    cases = []
    for s in (1, 5):
        pos = torch.clamp(lens_t - s, min=0)[:, None] + torch.arange(
            s, dtype=torch.int32, device=dev)
        valid = pos < lens_t[:, None] if s == 5 else None
        cases.append((f"S={s} x 8 lanes", s, pos, table, bpos, valid,
                      None if s == 5 else lens_t))
    qstart, lens = [0, 256, 512, 0], [200, 512, 700, 0]
    table, bpos = _attn_tables(torch, gen, dev, 4, 6, bs, np_, lens, 1)
    table[3] = 0
    pos = torch.tensor(qstart, dtype=torch.int32, device=dev)[:, None] + \
        torch.arange(256, dtype=torch.int32, device=dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    cases.append(("S=256 x 4 lanes", 256, pos, table, bpos, None, lens_t))
    pos = torch.arange(64, dtype=torch.int32, device=dev)[None].expand(4, 64)
    cases.append(("S=64 x 4 lanes, expanded pos", 64, pos, table, bpos,
                  None, lens_t))
    return cases


def check_layer_writes(torch, gen, dev, results, fp: bool = False):
    """kv_cache.paged_write as a layer calls it (the Executor's block_pos
    with a recycled table, a valid mask or kv_valid_len, new V a strided
    view of the qkv projection's output): pools and scales bit-equal to
    the plain route (_locate, then the plain scatter or the chunk's drop
    rule) outside trash row 0, one kernel a call by the traced names, the
    device time of the call and its wrapper time; the plain route with
    every slot shifted by one must be reported unequal (a control)."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_write as pw
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as kvc
    h, bs, d, np_ = (40 if fp else 32), 128, 128, 128
    sfx, tag = ("_fp", "p") if fp else ("", "")
    val_b, scale_b = (2, 0) if fp else (1, 4)
    pools = make_pools(torch, gen, dev, np_, h, bs, d, fp)
    calls = {}
    for label, s, pos, table, bpos, valid, lens in layer_write_cases(
            torch, gen, dev, h, bs, d, np_):
        b = pos.shape[0]
        qkv = (torch.randn((b, s, 3 * h * d), generator=gen, device=dev)
               * (torch.rand((b, s, 1), generator=gen, device=dev) * 4
                  + 0.01)).bfloat16()
        nk = qkv[..., h * d:2 * h * d].reshape(b, s, h, d).contiguous()
        nv = qkv[..., 2 * h * d:].reshape(b, s, h, d)       # strided
        kw = dict(valid=valid, block_pos=bpos, kv_valid_len=lens)
        chunk = pw.chunk_route(s, bs)
        name, kname = (("paged_write_chunk", "write_chunk_kernel") if chunk
                       else ("paged_write_token", "write_token_kernel"))
        ker, pln, ctl = clone_pools(pools), clone_pools(pools), \
            clone_pools(pools)
        kvc.paged_write(ker, table, pos, nk, nv, **kw)
        kvc.paged_write_plain(pln, table, pos, nk, nv, **kw)
        # the control: the plain scatter with every slot one further on
        mask = valid if lens is None else pos < lens[:, None]
        blk, off = kvc._locate(table, pos, bs, bpos, mask)
        if chunk:
            land = pw.chunk_write_mask(blk, off, bs)
        else:
            land = blk != 0
        pw.paged_write_token_plain(ctl, blk[land], (off[land] + 1) % bs,
                                   nk[land], nv[land])
        torch.cuda.synchronize()
        err = pools_equal_outside_trash(ker, pln)
        check(err == 0.0, f"K{'6' if chunk else '5'}{tag} "
              f"kv_cache.paged_write {label} differs from plain ({err})")
        ctl_err = pools_equal_outside_trash(ker, ctl)
        check(ctl_err > 0.0, f"K{'6' if chunk else '5'}{tag} {label}: the "
              f"shifted-slot control was not seen")
        fn = lambda: kvc.paged_write(ker, table, pos, nk, nv, **kw)
        names = []
        ms = device_ms(torch, fn, 200 if s < 256 else 100, "", name + sfx,
                       names, only=kname)
        pms = device_ms(torch, lambda: kvc.paged_write_plain(
            pln, table, pos, nk, nv, **kw), 20)
        wms = time_cuda(torch, fn, 200)
        landed = int(land.sum())
        # positions as held (the expanded case holds one row of them)
        idx_b = (table.numel() + bpos.numel()) * 4 + \
            pos.untyped_storage().nbytes() + (
                b * 4 if lens is not None else pos.numel())
        moved = landed * h * 2 * (d * (2 + val_b) + scale_b) + idx_b
        bms = bound(moved)[0]
        calls[label] = dict(ms=ms, wrapper_ms=wms, plain_ms=pms,
                            bound_ms=bms, tokens_landed=landed,
                            kernels=names)
        print(f"K{'6' if chunk else '5'}{tag} kv_cache.paged_write {label} "
              f"({'int8' if not fp else 'bf16'} pages, H={h}): bit-equal, "
              f"one {kname} a call; device {ms:.5f} ms a call (plain route "
              f"{pms:.5f} ms; wrapper {wms:.5f} ms a call; bound "
              f"{bms:.6f} ms for {landed} landed tokens); shifted-slot "
              f"control seen ({ctl_err:.3g})", flush=True)
    results["paged_write_token" + sfx]["layer_calls"] = {
        k: v for k, v in calls.items() if not k.startswith("S=256")}
    results["paged_write_chunk" + sfx]["layer_calls"] = {
        k: v for k, v in calls.items() if k.startswith("S=256")}


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


def check_attention(torch, gen, dev, results, fp: bool = False):
    """K7/K8 on int8 pages at Llama-2-7B heads (Hq 32: MHA and Hkv 8), or
    (fp) on bf16 pages at Llama-2-13B heads (Hq 40: MHA and Hkv 8)."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    bs, d, hq, np_ = 128, 128, (40 if fp else 32), 128
    scale = d ** -0.5
    sfx, pages = ("_fp", "bf16") if fp else ("", "int8")
    # bytes of one page token per KV head: K and V values, and scales
    tok_b = 2 * d * 2 if fp else 2 * d + 8
    worst = {"paged_decode_attention" + sfx: 0.0,
             "paged_prefill_attention" + sfx: 0.0}
    times = {}
    for hkv in (hq, 8):
        pools = make_pools(torch, gen, dev, np_, hkv, bs, d, fp)
        args = (pools["k"], pools["v"], pools.get("k_scale"),
                pools.get("v_scale"))
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
            again = pa.paged_decode_attention(q, *args, table, lens_t, scale,
                                              **kw)
            ref = pa.paged_attention_plain(q[:, None], *args, table,
                                           (lens_t - 1)[:, None], lens_t,
                                           scale, **kw)[:, 0]
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()), "K7 output not finite")
            check(bool((out[1] == 0).all()), "K7 inactive lane is not 0")
            check(torch.equal(out, again), f"K7 {pages} hkv={hkv}: two "
                  f"launches on the same inputs differ")
            err = float((out.float() - ref.float()).abs().max())
            check(err <= ATTN_TOL, f"K7 {pages} hkv={hkv} window={window} "
                  f"softcap={softcap}: max abs err {err} > {ATTN_TOL}")
            worst["paged_decode_attention" + sfx] = max(
                worst["paged_decode_attention" + sfx], err)
            print(f"K7 paged_decode_attention {pages} Hq={hq} Hkv={hkv} "
                  f"window={window} sink={sink} softcap={softcap}: "
                  f"max abs err {err:.3e}, repeat bit-equal", flush=True)
        kw = dict(block_pos=bpos)
        ms, pms, wms = measure(
            torch, lambda: pa.paged_decode_attention(
                q, *args, table, lens_t, scale, **kw),
            lambda: pa.paged_attention_plain(
                q[:, None], *args, table, (lens_t - 1)[:, None], lens_t,
                scale, **kw), "decode_split_kernel",
            "paged_decode_attention" + sfx, 200, 20)
        visited = int((bpos < lens_t[:, None]).sum())
        keys = sum(lens)
        nbytes = (visited * hkv * bs * tok_b
                  + 2 * b * hq * d * 2 + b * mb * 8 + b * 4)
        bnd = bound(nbytes, 4.0 * hq * d * keys)
        times[("paged_decode_attention" + sfx, hkv)] = (ms, pms, bnd)
        plan = pa.decode_plan(b, hkv, hq // hkv, d, mb,
                              wm.sm_count(dev.index or 0))
        print(f"K7 timing {pages} B={b} Hq={hq} Hkv={hkv} pages={visited} "
              f"({plan.splits} splits of {plan.pages_per_split} entries, "
              f"{hkv * b * plan.splits} blocks): device "
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
            again = pa.paged_prefill_attention(q, *args, table, qs_t,
                                               lens_t, scale, **kw)
            ref = pa.paged_attention_plain(q, *args, table, pos, lens_t,
                                           scale, **kw)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"K8 {pages} hkv={hkv}: two "
                  f"launches on the same inputs differ")
            diff = torch.where(valid, (out.float() - ref.float()).abs(), 0.0)
            check(bool(torch.isfinite(torch.where(valid, out.float(),
                                                  0.0)).all()),
                  "K8 output not finite")
            err = float(diff.max())
            check(err <= ATTN_TOL, f"K8 {pages} hkv={hkv} window={window} "
                  f"softcap={softcap}: max abs err {err} > {ATTN_TOL}")
            worst["paged_prefill_attention" + sfx] = max(
                worst["paged_prefill_attention" + sfx], err)
            print(f"K8 paged_prefill_attention {pages} Hq={hq} Hkv={hkv} "
                  f"window={window} sink={sink} softcap={softcap}: "
                  f"max abs err {err:.3e}, repeat bit-equal", flush=True)
        kw = dict(block_pos=bpos)
        ms, pms, wms = measure(
            torch, lambda: pa.paged_prefill_attention(
                q, *args, table, qs_t, lens_t, scale, **kw),
            lambda: pa.paged_attention_plain(
                q, *args, table, pos, lens_t, scale, **kw),
            "prefill_wgmma_kernel", "paged_prefill_attention" + sfx, 50,
            10)
        last = [min(qs + c, ln) - 1 for qs, ln in zip(qstart, lens)]
        visited = sum(int(((bpos[i] <= last[i])
                           & (bpos[i] < lens[i])).sum())
                      for i in range(b))
        pairs = sum(sum(p + 1 for p in range(qs, min(qs + c, ln)))
                    for qs, ln in zip(qstart, lens))
        # the bound reads each visited page once; K8's blocks hold 128 rows
        # (the Hq/Hkv query heads of a KV head x 128 / (Hq/Hkv) tokens), so
        # the kernel reads a page once for each of its lane's tiles that
        # reaches it
        nbytes = (visited * hkv * bs * tok_b
                  + 2 * b * c * hq * d * 2 + b * mb * 8 + b * 8)
        flops = 4.0 * hq * d * pairs
        bnd = bound(nbytes, flops)
        times[("paged_prefill_attention" + sfx, hkv)] = (ms, pms, bnd)
        tiles = -(-c // (128 // (hq // hkv)))
        print(f"K8 timing {pages} B={b} C={c} Hq={hq} Hkv={hkv} "
              f"pages={visited} ({tiles} tiles of "
              f"{128 // (hq // hkv)} tokens a lane and KV head): device "
              f"{ms:.5f} ms per launch, {flops / ms / 1e9:.2f} TFLOP/s "
              f"(plain {pms:.5f} ms; wrapper {wms:.5f} ms per call; bound "
              f"{bnd[0]:.5f} ms, by {bnd[1]})", flush=True)
    # the kernels line carries the main paths' geometry: MHA
    for name in worst:
        ms, pms, bnd = times[(name, hq)]
        results[name] = dict(max_abs_err=worst[name], ms=ms, plain_ms=pms,
                             bound=bnd)


def _rel(got, want) -> float:
    """max |got - want| relative to max |want|."""
    return float((got - want).abs().max() / want.abs().max())


def check_decode_modes(torch, gen, dev, results):
    """K9, K10 and K11 at Llama-2-7B heads (Hq 32: MHA and Hkv 8) on int8
    and bf16 pages, 8 lanes of lengths 1-700 as K7's check (lane 1
    inactive, lane 3 recycled); then K9 at S = 8 with 8 query heads a KV
    head (Hkv 4: 64 rows, the largest shared memory the main path's
    geometry asks for) and K7 against K11 on 1 lane of 4096 tokens. The
    kernels line carries MHA, S = 5 (gamma 4) for K9, splits 4 for K11."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    bs, d, hq, np_, b, mb = 128, 128, 32, 128, 8, 6
    scale = d ** -0.5
    lens = [700, 1, 256, 640, 129, 513, 384, 300]
    masks = ((0, 0, 0.0), (256, 128, 0.0), (0, 0, 30.0))
    for fp in (False, True):
        sfx, pages = ("_fp", "bf16") if fp else ("", "int8")
        tok_b = 2 * d * 2 if fp else 2 * d + 8
        worst = {n + sfx: 0.0 for n in ("paged_verify_attention",
                                        "paged_decode_attention_stats",
                                        "paged_decode_attention_split")}
        for hkv in (hq, 8):
            pools = make_pools(torch, gen, dev, np_, hkv, bs, d, fp)
            args = (pools["k"], pools["v"], pools.get("k_scale"),
                    pools.get("v_scale"))
            table, bpos = _attn_tables(torch, gen, dev, b, mb, bs, np_,
                                       lens, 3)
            table[1] = 0
            bpos[1] = 1 << 30
            lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
            visited = int((bpos < lens_t[:, None]).sum())
            tab_b = b * mb * 8 + b * 4
            pages_b = visited * hkv * bs * tok_b
            tag = f"{pages} Hq={hq} Hkv={hkv}"

            # K9: the rows of a gamma = 3 / gamma = 4 verify, ending at
            # each lane's last key
            for s_rows in ((4, 5) if fp else (4, 5, 8)):
                q = torch.randn((b, s_rows, hq, d), generator=gen,
                                device=dev).bfloat16()
                qs = torch.clamp(lens_t - s_rows, min=0)
                pos = qs[:, None] + torch.arange(s_rows, device=dev)
                for window, sink, softcap in masks:
                    kw = dict(block_pos=bpos, window=window, sink=sink,
                              softcap=softcap)
                    out = pa.paged_verify_attention(q, *args, table, lens_t,
                                                    qs, scale, **kw)
                    again = pa.paged_verify_attention(q, *args, table,
                                                      lens_t, qs, scale, **kw)
                    ref = pa.paged_attention_plain(q, *args, table, pos,
                                                   lens_t, scale, **kw)
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(out).all()),
                          "K9 output not finite")
                    check(torch.equal(out, again), f"K9 {tag} S={s_rows}: "
                          f"two launches on the same inputs differ")
                    check(bool((out[1] == 0).all()),
                          "K9 inactive lane is not 0")
                    err = float((out.float() - ref.float()).abs().max())
                    check(err <= ATTN_TOL, f"K9 {tag} S={s_rows} window="
                          f"{window} softcap={softcap}: max abs err {err}")
                    worst["paged_verify_attention" + sfx] = max(
                        worst["paged_verify_attention" + sfx], err)
                print(f"K9 paged_verify_attention {tag} S={s_rows} (3 "
                      f"masks): max abs err {err:.3e} (last), repeat "
                      f"bit-equal", flush=True)
                kw = dict(block_pos=bpos)
                ms, pms, wms = measure(
                    torch, lambda: pa.paged_verify_attention(
                        q, *args, table, lens_t, qs, scale, **kw),
                    lambda: pa.paged_attention_plain(
                        q, *args, table, pos, lens_t, scale, **kw),
                    "verify_rows_kernel", "paged_verify_attention" + sfx,
                    200, 20)
                keys = int(torch.minimum(pos + 1, lens_t[:, None]).sum())
                nbytes = (pages_b + 2 * b * s_rows * hq * d * 2 + tab_b
                          + b * 4)
                bnd = bound(nbytes, 4.0 * hq * d * keys)
                plan = pa.rows_plan(b, hkv, s_rows * (hq // hkv), d, mb,
                                    wm.sm_count(dev.index or 0))
                print(f"K9 timing {tag} S={s_rows} pages={visited} "
                      f"({plan.splits} splits, {hkv * b * plan.grid[2]} "
                      f"blocks): device {ms:.5f} ms per launch, "
                      f"{nbytes / ms / 1e9:.3f} TB/s (plain {pms:.5f} ms; "
                      f"wrapper {wms:.5f} ms per call; bound {bnd[0]:.5f} "
                      f"ms)", flush=True)
                if hkv == hq and s_rows == 5:
                    results["paged_verify_attention" + sfx] = dict(
                        ms=ms, plain_ms=pms, bound=bnd)

            # K9 at S = 1 is the decode kernel's K10 mode rounded to q's
            # dtype, bit for bit (K7 is the split-page kernel)
            q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
            for window, sink, softcap in masks:
                kw = dict(block_pos=bpos, window=window, sink=sink,
                          softcap=softcap)
                k10 = pa.paged_decode_attention(q, *args, table, lens_t,
                                                scale, stats=True,
                                                **kw)[0].to(q.dtype)
                k9 = pa.paged_verify_attention(q[:, None], *args, table,
                                               lens_t, lens_t - 1, scale,
                                               **kw)[:, 0]
                torch.cuda.synchronize()
                check(torch.equal(k10, k9), f"K9 at S=1 differs from K10 "
                      f"in q's dtype ({tag}, window={window}, "
                      f"softcap={softcap})")
            print(f"K9 at S=1 {tag}: bit-equal to K10's output in q's dtype "
                  f"(3 masks)", flush=True)

            # K10: out, and (m, l) against the plain stats
            for window, sink, softcap in masks:
                kw = dict(block_pos=bpos, window=window, sink=sink,
                          softcap=softcap)
                out, m, l = pa.paged_decode_attention(
                    q, *args, table, lens_t, scale, stats=True, **kw)
                again = pa.paged_decode_attention(
                    q, *args, table, lens_t, scale, stats=True, **kw)
                po, pm, pl = pa.paged_decode_attention_stats_plain(
                    q, *args, table, lens_t, scale, **kw)
                torch.cuda.synchronize()
                check(all(torch.equal(x, y) for x, y in zip((out, m, l),
                                                            again)),
                      f"K10 {tag}: two launches on the same inputs differ")
                live = lens_t > 1
                err = float((out - po).abs().max())
                mrel, lrel = _rel(m[live], pm[live]), _rel(l[live], pl[live])
                check(out.dtype == m.dtype == torch.float32,
                      "K10 outputs are not f32")
                check(err <= ATTN_TOL and mrel <= STATS_RTOL
                      and lrel <= STATS_RTOL,
                      f"K10 {tag} window={window} softcap={softcap}: out "
                      f"{err}, m {mrel}, l {lrel}")
                check(bool((out[1] == 0).all()) and bool((m[1] == -1e30)
                                                         .all())
                      and bool((l[1] == 0).all()),
                      "K10 inactive lane is not (0, -1e30, 0)")
                worst["paged_decode_attention_stats" + sfx] = max(
                    worst["paged_decode_attention_stats" + sfx], err)
            print(f"K10 paged_decode_attention(stats) {tag} (3 masks): out "
                  f"max abs err {err:.3e}, m max rel {mrel:.2e}, l max rel "
                  f"{lrel:.2e} (last), repeat bit-equal", flush=True)
            kw = dict(block_pos=bpos)
            ms, pms, wms = measure(
                torch, lambda: pa.paged_decode_attention(
                    q, *args, table, lens_t, scale, stats=True, **kw),
                lambda: pa.paged_decode_attention_stats_plain(
                    q, *args, table, lens_t, scale, **kw),
                "stats_rows_kernel", "paged_decode_attention_stats" + sfx,
                200, 20)
            keys = sum(lens)
            nbytes = pages_b + b * hq * d * (2 + 4) + 2 * b * hq * 4 + tab_b
            bnd = bound(nbytes, 4.0 * hq * d * keys)
            print(f"K10 timing {tag}: device {ms:.5f} ms per launch, "
                  f"{nbytes / ms / 1e9:.3f} TB/s (plain {pms:.5f} ms; "
                  f"wrapper {wms:.5f} ms per call; bound {bnd[0]:.5f} ms)",
                  flush=True)
            if hkv == hq:
                results["paged_decode_attention_stats" + sfx] = dict(
                    ms=ms, plain_ms=pms, bound=bnd)

            # K11: splits 2 and 4 against K7 and the plain split, 3 masks
            for splits in (2, 4):
                for window, sink, softcap in masks:
                    kw = dict(block_pos=bpos, window=window, sink=sink,
                              softcap=softcap)
                    k7 = pa.paged_decode_attention(q, *args, table, lens_t,
                                                   scale, **kw)
                    out, again = (pa.paged_decode_attention_split(
                        q, *args, table, lens_t, scale, kv_splits=splits,
                        **kw) for _ in range(2))
                    ref = pa.paged_decode_attention_split_plain(
                        q, *args, table, lens_t, scale, kv_splits=splits,
                        **kw)
                    torch.cuda.synchronize()
                    check(torch.equal(out, again), f"K11 {tag} splits="
                          f"{splits}: two launches on the same inputs differ")
                    err = max(float((out.float() - ref.float()).abs().max()),
                              float((out.float() - k7.float()).abs().max()))
                    check(err <= ATTN_TOL and bool((out[1] == 0).all()),
                          f"K11 {tag} splits={splits} window={window} "
                          f"softcap={softcap}: max abs err {err}")
                    worst["paged_decode_attention_split" + sfx] = max(
                        worst["paged_decode_attention_split" + sfx], err)
                print(f"K11 paged_decode_attention_split {tag} splits="
                      f"{splits} (3 masks): max abs err {err:.3e} (last) "
                      f"against plain and K7, repeat bit-equal", flush=True)
            if hkv == hq and not fp:
                k11_merge_control(torch, pa, pools, q, hq, bs, d, scale)
            # the whole call's device work must be K7's kernel, once
            kw = dict(block_pos=bpos, kv_splits=4)
            names = []
            ms = device_ms(torch, lambda: pa.paged_decode_attention_split(
                q, *args, table, lens_t, scale, **kw), 200, "",
                "paged_decode_attention_split" + sfx, names)
            check(all("decode_split_kernel" in n for n in names),
                  f"K11 {tag}: device work other than decode_split_kernel: "
                  f"{names}")
            pms = device_ms(
                torch, lambda: pa.paged_decode_attention_split_plain(
                    q, *args, table, lens_t, scale, **kw), 20)
            wms = time_cuda(torch, lambda: pa.paged_decode_attention_split(
                q, *args, table, lens_t, scale, **kw), 200)
            bnd = bound(pages_b + 2 * b * hq * d * 2 + tab_b,
                        4.0 * hq * d * keys)
            plan = pa.split_decode_plan(b, hkv, hq // hkv, d, mb, 4,
                                        wm.sm_count(dev.index or 0))
            print(f"K11 timing {tag} splits=4 ({plan.splits} kernel splits "
                  f"of {plan.pages_per_split} entries, {hkv * b * plan.splits}"
                  f" blocks, one launch): device {ms:.5f} ms per call "
                  f"(plain {pms:.5f} ms; wrapper {wms:.5f} ms per call; "
                  f"bound {bnd[0]:.5f} ms, K7's)", flush=True)
            if hkv == hq:
                results["paged_decode_attention_split" + sfx] = dict(
                    ms=ms, plain_ms=pms, bound=bnd)
        for name, err in worst.items():
            results[name]["max_abs_err"] = err

    # K9 at S = 8 and 8 query heads a KV head: 64 rows (4 m-tiles) a block
    hkv, s_rows = 4, 8
    pools = make_pools(torch, gen, dev, np_, hkv, bs, d)
    args = (pools["k"], pools["v"], pools["k_scale"], pools["v_scale"])
    table, bpos = _attn_tables(torch, gen, dev, b, mb, bs, np_, lens, 3)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    q = torch.randn((b, s_rows, hq, d), generator=gen, device=dev).bfloat16()
    qs = torch.clamp(lens_t - s_rows, min=0)
    pos = qs[:, None] + torch.arange(s_rows, device=dev)
    out = pa.paged_verify_attention(q, *args, table, lens_t, qs, scale,
                                    block_pos=bpos)
    ref = pa.paged_attention_plain(q, *args, table, pos, lens_t, scale,
                                   block_pos=bpos)
    torch.cuda.synchronize()
    err = float((out.float() - ref.float()).abs().max())
    check(err <= ATTN_TOL, f"K9 S=8 Hq=32 Hkv=4: max abs err {err}")
    smem = pa.rows_smem(64, d, bs, 1, True, True)
    print(f"K9 paged_verify_attention int8 S=8 Hq={hq} Hkv={hkv} (64 rows, "
          f"{smem} bytes of shared memory a block): max abs err {err:.3e}",
          flush=True)

    # 1 lane x 4096 tokens: K7 against K11, both one launch a call
    for fp in (False, True):
        pages = "bf16" if fp else "int8"
        sfx = "_fp" if fp else ""
        mb1 = 4096 // bs
        pools = make_pools(torch, gen, dev, np_, hq, bs, d, fp)
        args = (pools["k"], pools["v"], pools.get("k_scale"),
                pools.get("v_scale"))
        table, bpos = _attn_tables(torch, gen, dev, 1, mb1, bs, np_, [4096],
                                   None)
        lens_t = torch.tensor([4096], dtype=torch.int32, device=dev)
        q = torch.randn((1, hq, d), generator=gen, device=dev).bfloat16()
        k7 = pa.paged_decode_attention(q, *args, table, lens_t, scale,
                                       block_pos=bpos)
        k7_ms = device_ms(torch, lambda: pa.paged_decode_attention(
            q, *args, table, lens_t, scale, block_pos=bpos), 200,
            "decode_split_kernel", "paged_decode_attention" + sfx)
        line = []
        for splits in (2, 4):
            kw = dict(block_pos=bpos, kv_splits=splits)
            out = pa.paged_decode_attention_split(q, *args, table, lens_t,
                                                  scale, **kw)
            ref = pa.paged_decode_attention_split_plain(
                q, *args, table, lens_t, scale, **kw)
            torch.cuda.synchronize()
            err = max(float((out.float() - ref.float()).abs().max()),
                      float((out.float() - k7.float()).abs().max()))
            check(err <= ATTN_TOL, f"K11 1 x 4096 {pages} splits={splits}: "
                  f"max abs err {err}")
            call_ms = device_ms(torch, lambda: pa.paged_decode_attention_split(
                q, *args, table, lens_t, scale, **kw), 200,
                "decode_split_kernel", "paged_decode_attention_split" + sfx)
            plan = pa.split_decode_plan(1, hq, 1, d, mb1, splits,
                                        wm.sm_count(dev.index or 0))
            line.append(f"K11 splits={splits} ({hq * plan.splits} blocks) "
                        f"{call_ms:.5f} ms a call (err {err:.2e})")
        nbytes = mb1 * hq * bs * (2 * d * 2 if fp else 2 * d + 8)
        k7_blocks = hq * pa.decode_plan(1, hq, 1, d, mb1,
                                        wm.sm_count(dev.index or 0)).splits
        print(f"1 lane x 4096 tokens, {pages} pages, Hq=Hkv={hq}: K7 "
              f"({k7_blocks} blocks on 132 SMs) {k7_ms:.5f} ms; "
              f"{'; '.join(line)}; bound "
              f"{nbytes / HBM_BYTES_PER_MS:.5f} ms", flush=True)


def k11_merge_control(torch, pa, pools, q, hq, bs, d, scale):
    """K11's negative control, enforced: 1 lane of 6 pages whose last
    page's keys point along each head's query, so it takes nearly all the
    attention; with K7_MERGE_DROP the merge leaves that range out and the
    output must move by more than ATTN_TOL (splits 2 and 4)."""
    dev = q.device
    kp = pools["k"].clone()
    kp[6] = (torch.sign(q[0].float())[:, None, :] * 100).to(torch.int8)
    args = (kp, pools["v"], pools["k_scale"], pools["v_scale"])
    table = torch.arange(1, 7, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([6 * bs], dtype=torch.int32, device=dev)
    seen = []
    for splits in (2, 4):
        want = pa.paged_decode_attention_split_plain(
            q[:1], *args, table, lens, scale, kv_splits=splits)
        bad = drop_last_split(pa.paged_decode_attention_split)(
            q[:1], *args, table, lens, scale, kv_splits=splits)
        good = pa.paged_decode_attention_split(q[:1], *args, table, lens,
                                               scale, kv_splits=splits)
        torch.cuda.synchronize()
        err = float((bad.float() - want.float()).abs().max())
        ok = float((good.float() - want.float()).abs().max())
        check(err > ATTN_TOL and ok <= ATTN_TOL,
              f"K11 merge control splits={splits}: fault {err}, "
              f"unfaulted {ok} (tolerance {ATTN_TOL})")
        seen.append(f"splits={splits}: {err:.3e}")
    print(f"K11 control (merge without the last split that saw a key): "
          f"caught, {'; '.join(seen)} > {ATTN_TOL}", flush=True)


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
    # at a prefill call's 1024 rows and the gamma = 4 verify's 40, at 7B
    # width (the register kernel), and 40 rows of the widest row the
    # wrapper takes (the shared-memory kernel)
    x = (torch.randn((m, h), generator=gen, device=dev) * 2).to(bf)
    gamma = torch.rand((h,), generator=gen, device=dev) + 0.5
    ind = torch.randperm(h, generator=gen, device=dev)[:ko].sort().values
    ind = ind.int()
    sms = wm.sm_count(dev.index or 0)
    worst, k1_shapes = 0, []
    wide = 32768
    xw = (torch.randn((40, wide), generator=gen, device=dev) * 2).to(bf)
    gw = torch.rand((wide,), generator=gen, device=dev) + 0.5
    iw = torch.randperm(wide, generator=gen, device=dev)[:ko].sort().values
    for xk, gk, ik in ((x, gamma, ind), (x[:40].contiguous(), gamma, ind),
                       (xw, gw, iw.int())):
        rows, k = xk.shape
        plan = nq.norm_quant_plan(rows, k, sms)
        k1 = (lambda: nq.rmsnorm_quant_split(xk, gk, ik),
              lambda: nq.rmsnorm_quant_split_plain(xk, gk, ik))
        for label, (kfn, pfn) in (("norm", k1),
                                  ("no norm", (lambda: nq.quant_split(xk, ik),
                                               lambda: nq.quant_split_plain(
                                                   xk, ik)))):
            got, again, want = kfn(), kfn(), pfn()
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K1 ({label}) M={rows} K={k}: two launches on the same "
                  f"inputs differ")
            diff = (got[0].int() - want[0].int()).abs()
            dmax, same = int(diff.max()), float((diff == 0).float().mean())
            srel = float(((got[1] - want[1]).abs() / want[1]).max())
            oerr = float((got[2].float() - want[2].float()).abs().max())
            check(dmax <= 1 and same > 0.999 and srel <= 1e-5
                  and oerr <= 1e-2,
                  f"K1 ({label}) M={rows} K={k} differs from plain: codes "
                  f"{dmax} apart, {same:.5f} equal, scale rel {srel}, "
                  f"x_out {oerr}")
            worst = max(worst, dmax)
            print(f"K1 rmsnorm_quant_split ({label}) M={rows} K={k} ko={ko} "
                  f"({plan.variant} kernel, {plan.threads} threads x "
                  f"{plan.chunks_per_thread} chunks): codes at most {dmax} "
                  f"apart, {same:.6f} equal; scale_row max rel err "
                  f"{srel:.2e}; x_out max abs err {oerr:.2e}; repeat "
                  f"bit-equal", flush=True)
        if k != h:
            continue
        ms, pms, wms = measure(torch, *k1, "norm_quant_regs_kernel",
                               "rmsnorm_quant_split", 200, 20)
        bnd = bound(rows * k * 2 + k * 4 + ko * 4 + rows * k + rows * 4
                    + rows * ko * 2)
        print(f"K1 timing M={rows} K={k}: device {ms:.5f} ms per launch, "
              f"{bnd[0] / ms:.3f} of its bound (plain {pms:.5f} ms; wrapper "
              f"{wms:.5f} ms per call; bound {bnd[0]:.5f} ms)", flush=True)
        k1_shapes.append(dict(M=rows, K=k, ms=ms, plain_ms=pms,
                              wrapper_ms=wms, bound_ms=bnd[0],
                              bound_by=bnd[1], variant=plan.variant,
                              threads=plan.threads,
                              chunks_per_thread=plan.chunks_per_thread))
        if rows == m:
            results["rmsnorm_quant_split"] = dict(ms=ms, plain_ms=pms,
                                                  bound=bnd,
                                                  shapes=k1_shapes)
    results["rmsnorm_quant_split"]["max_abs_err"] = float(worst)
    del xw

    # K2 at the three mix shapes, K3 and the int32-exact case at qkv's
    q_x, srow, xo = nq.rmsnorm_quant_split(x, gamma, ind)
    k2_shapes = []

    def time_k2(label, args, rows, n, iters, plain_iters):
        """K2 against plain, two launches bit-equal, timed with its bound
        and int8 TOP/s: the row of the kernels line's `shapes`."""
        k2 = (lambda: mm.mixed_matmul(*args),
              lambda: mm.mixed_matmul_plain(*args))
        out, again, want = k2[0](), k2[0](), k2[1]()
        torch.cuda.synchronize()
        err = gemm_err(out, want)
        check(err <= gemm_tol(bf), f"K2 {label} M={rows}: rel err {err} > "
              f"{gemm_tol(bf)}")
        check(torch.equal(out, again), f"K2 {label} M={rows}: two launches "
              f"on the same inputs differ")
        ms, pms, wms = measure(torch, *k2, "mixed_wgmma_kernel",
                               "mixed_matmul", iters, plain_iters)
        nbytes = (rows * h + rows * 4 + rows * ko * 2 + h * n + n * 4
                  + ko * n * 2 + rows * n * 2)
        bnd = bound(nbytes, 2.0 * rows * n * ko, 2.0 * rows * n * h)
        p = mm.mixed_plan(rows, h, n, sms)
        tops = 2.0 * rows * n * h / ms / 1e9
        print(f"K2 mixed_matmul {label} M={rows} K={h} N={n} ko={ko}: max "
              f"rel err {err:.2e}, repeat bit-equal; device {ms:.5f} ms per "
              f"launch (plain {pms:.5f} ms; wrapper {wms:.5f} ms; bound "
              f"{bnd[0]:.5f} ms, by {bnd[1]}; {tops:.1f} int8 TOP/s, "
              f"{nbytes / ms / 1e9:.3f} TB/s; {p.nx}-row tiles, {p.splits} "
              f"splits, {p.grid[0] * p.grid[1] * p.grid[2]} blocks)",
              flush=True)
        k2_shapes.append(dict(label=label, M=rows, K=h, N=n, ms=ms,
                              plain_ms=pms, bound_ms=bnd[0],
                              bound_by=bnd[1], int8_tops=tops,
                              max_abs_err=err))
        return err, ms, pms, bnd

    for label, n in (("qkv", 12288), ("o_proj", 4096), ("gate_up", 22016)):
        qw = torch.randint(-127, 128, (h, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        fpw = (torch.randn((ko, n), generator=gen, device=dev) * 0.02).to(bf)
        args = (q_x, srow, xo, qw, scol, fpw)
        err, ms, pms, bnd = time_k2(label, args, m, n, 20, 5)
        if label != "qkv":
            continue
        results["mixed_matmul"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                       bound=bnd, shapes=k2_shapes)
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
        ms, pms, wms = measure(torch, *k3, "mixed_epilogue_kernel",
                               "mixed_matmul_hybrid", 20, 5)
        bnd = bound(m * n * 4 + m * 4 + m * ko * 2 + n * 4 + ko * n * 2
                    + m * n * 2, 2.0 * m * n * ko)
        results["mixed_matmul_hybrid"] = dict(max_abs_err=err3, ms=ms,
                                              plain_ms=pms, bound=bnd)
        print(f"K3 mixed_matmul_hybrid epilogue {label}: max rel err "
              f"{err3:.2e}; device {ms:.5f} ms per launch (plain {pms:.5f} "
              f"ms, int32 product included; wrapper {wms:.5f} ms with its "
              f"torch._int_mm; bound {bnd[0]:.5f} ms)", flush=True)
        del got, exact

    # the gamma = 4 verify: 8 lanes x 5 rows = 40 rows through K1 -> K2
    # (prefill chunks give K2 block-size multiples; these are not)
    m40 = 40
    got = nq.rmsnorm_quant_split(x[:m40].contiguous(), gamma, ind)
    for label, n in (("qkv", 12288), ("o_proj", 4096), ("gate_up", 22016)):
        qw = torch.randint(-127, 128, (h, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        fpw = (torch.randn((ko, n), generator=gen, device=dev) * 0.02).to(bf)
        time_k2(label, (*got, qw, scol, fpw), m40, n, 50, 10)

    check_k4(torch, gen, dev, results, m, h)


K4_MARKS = {"decode": "wo_small_mma_kernel", "mid": "wo_mid_mma_kernel",
            "prefill": "wo_wgmma_kernel"}
# K4's regime rows in the kernels line: (label, M, K, N)
K4_REGIMES = {"decode": ("qkv", 8, 4096, 12288),
              "verify": ("down_proj", 40, 11008, 4096),
              "prefill": ("13B qkv", 1024, 5120, 15360)}


def int8pack_library(torch, x, qw, scol, want, iters: int):
    """torch._weight_int8pack_mm, the library's W8A16 product ((N, K) int8
    weight, bf16 scales: the same function up to the scales' rounding):
    (device ms, max rel err against K4's plain output), or None where the
    card has no such kernel."""
    wt = qw.t().contiguous()
    sb = scol.to(torch.bfloat16)
    try:
        err = gemm_err(torch._weight_int8pack_mm(x, wt, sb), want)
    except (RuntimeError, NotImplementedError) as e:
        print(f"  torch._weight_int8pack_mm: none on this card "
              f"({str(e).splitlines()[0][:100]})", flush=True)
        return None
    return device_ms(torch, lambda: torch._weight_int8pack_mm(x, wt, sb),
                     iters), err


def check_k4(torch, gen, dev, results, m: int, h: int):
    """K4 in its three regimes, each against its plain version, two
    launches bit-equal, with its bound and torch._weight_int8pack_mm: the
    four 7B decode linears at 1, 8 and 16 rows (mma, decode), 7B down_proj
    at 17, 40 (the speculative verify), 64, 128 and 129 rows (mma, mid, and
    the edge to the GEMM), and prefill (wgmma) at `m` rows for 7B down_proj
    and the four 13B linears (the int4 prefill runs K4 on the unpacked
    weight), with cuBLAS over a dequantized copy as a reading beside them.
    Then both regimes at 16-128 rows: the crossover K4_MMA_MAX_ROWS
    follows."""
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    bf, sms = torch.bfloat16, wm.sm_count(dev.index or 0)
    h13, i13 = 5120, 13824
    seven = (("qkv", h, 3 * h), ("o_proj", h, h), ("gate_up", h, 22016),
             ("down_proj", 11008, h))
    cases = [(lb, k, n, mk) for mk in (1, 8, 16) for lb, k, n in seven]
    cases += [("down_proj", 11008, h, mk) for mk in (17, 40, 64, 128, 129, m)]
    cases += [("13B " + lb, k, n, m) for lb, k, n in (
        ("qkv", h13, 3 * h13), ("o_proj", h13, h13),
        ("gate_up", h13, 2 * i13), ("down_proj", i13, h13))]

    def operands(mk, k, n):
        return (torch.randn((mk, k), generator=gen, device=dev).to(bf),
                torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8),
                torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5)

    step_ms, regimes = 0.0, {}
    for label, k, n, mk in cases:
        xk, qw, scol = operands(mk, k, n)
        regime = wm.k4_regime(wm.wo_plan(mk, k, n, sms))
        k4 = (lambda: wm.wo_matmul(xk, qw, scol),
              lambda: wm.wo_matmul_plain(xk, qw, scol))
        out, again, want = k4[0](), k4[0](), k4[1]()
        torch.cuda.synchronize()
        err = gemm_err(out, want)
        check(err <= gemm_tol(bf), f"K4 {label} M={mk}: rel err {err}")
        check(torch.equal(out, again), f"K4 {label} M={mk}: two launches "
              f"on the same inputs differ")
        large = mk >= 1024
        ms, pms, wms = measure(torch, *k4, K4_MARKS[regime], "wo_matmul",
                               20 if large else 100, 3 if large else 10)
        flops = 2.0 * mk * n * k
        bnd = bound(mk * k * 2 + k * n + n * 4 + mk * n * 2, flops)
        lib = int8pack_library(torch, xk, qw, scol, want,
                               3 if large else 20 if mk > 16 else 50)
        rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if bnd[1] == "operations"
                else f"{k * n / ms / 1e9:.3f} TB/s of weight")
        lib_s = ("none" if lib is None
                 else f"{lib[0]:.5f} ms, rel err {lib[1]:.2e}")
        print(f"K4 wo_matmul ({regime}) {label} M={mk} K={k} N={n}: max rel "
              f"err {err:.2e}, repeat bit-equal; device {ms:.5f} ms per "
              f"launch (plain {pms:.5f} ms; wrapper {wms:.5f} ms; bound "
              f"{bnd[0]:.5f} ms, by {bnd[1]}; {rate}; "
              f"torch._weight_int8pack_mm {lib_s})", flush=True)
        if large:
            wd = qw.to(bf)
            cub = device_ms(torch, lambda: torch.matmul(xk, wd), 20)
            print(f"  reading: cuBLAS bf16 x @ a dequantized bf16 copy of the "
                  f"weight (not the same function: no int8 read, no scale) "
                  f"{cub:.5f} ms, {flops / cub / 1e9:.1f} TFLOP/s", flush=True)
            del wd
        row = dict(max_abs_err=err, ms=ms, plain_ms=pms, bound=bnd,
                   library_ms=None if lib is None else lib[0])
        for name, (lb, rm, rk, rn) in K4_REGIMES.items():
            if (label, mk, k, n) == (lb, rm, rk, rn):
                regimes[name] = dict(row, M=mk, K=k, N=n, kernel=regime,
                                     bound_ms=bnd[0], bound_by=bnd[1])
        if mk == 8:
            step_ms += ms
    check(len(regimes) == len(K4_REGIMES), f"K4 regimes measured: {regimes}")
    results["wo_matmul"] = dict(
        {key: regimes["decode"][key] for key in
         ("max_abs_err", "ms", "plain_ms", "bound", "library_ms")},
        regimes={name: {key: r[key] for key in (
            "M", "K", "N", "kernel", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err")}
            for name, r in regimes.items()})
    print(f"K4 one decode step's four linears at 8 rows: {step_ms:.5f} ms a "
          f"layer, {32 * step_ms:.3f} ms for 32 layers (bound: 202.4 MB of "
          f"int8 weights a layer, {32 * 202.4e6 / HBM_BYTES_PER_MS:.3f} ms)",
          flush=True)

    # the crossover: both regimes at 16-128 rows, 7B down_proj and 13B qkv
    threshold = wm.K4_MMA_MAX_ROWS
    for label, k, n in (("7B down_proj", 11008, h), ("13B qkv", h13, 3 * h13)):
        readings = []
        for mk in (16, 32, 40, 64, 96, 128):
            xk, qw, scol = operands(mk, k, n)
            times = {}
            try:
                for regime, rows in (("mma", 1 << 30), ("wgmma", 0)):
                    wm.K4_MMA_MAX_ROWS = rows
                    mark = K4_MARKS[wm.k4_regime(wm.wo_plan(mk, k, n, sms,
                                                            rows))]
                    times[regime] = device_ms(
                        torch, lambda: wm.wo_matmul(xk, qw, scol), 30, mark,
                        "wo_matmul")
            finally:
                wm.K4_MMA_MAX_ROWS = threshold
            readings.append(f"M={mk} mma {times['mma']:.5f} / wgmma "
                            f"{times['wgmma']:.5f}")
        print(f"K4 regimes at {label} (K={k} N={n}), device ms a launch: "
              f"{'; '.join(readings)}; K4_MMA_MAX_ROWS = {threshold}",
              flush=True)


def int4pack_library(torch, x, q, scale_g, want):
    """torch._weight_int4pack_mm set up to compute K12's or K13's function:
    the weight as unsigned nibbles q + 8 in the library's (N, K) tile layout
    (torch._convert_weight_to_int4pack), group g of K / G consecutive rows
    of q given scale_g[g] (G, N) (in bf16, as the library takes it) and a
    zero of 0, so w = (u - 8) * scale; K12's per-column scales are every
    group's. Returns (call, max rel err against the plain version's output
    `want`) or raises where the library has no such kernel."""
    k, n = q.shape
    u = (q.t().int() + 8).contiguous()                        # (N, K) 0..15
    packed = torch._convert_weight_to_int4pack(
        (u[:, ::2] << 4 | u[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([scale_g, torch.zeros_like(scale_g)],
                     dim=-1).to(torch.bfloat16).contiguous()
    gs = k // scale_g.shape[0]

    def call():
        return torch._weight_int4pack_mm(x, packed, gs, sz)
    return call, gemm_err(call(), want)


def check_packed(torch, gen, dev, results):
    """K12 and K13 (group size 128) at the four Llama-2-13B decode shapes
    at M = 1, 8 and 16 (and 64 at qkv), with two launches on the same
    inputs required bit-equal (their K splits are summed in a fixed order).
    Random packed bytes (every nibble value), f32 scales;
    torch._weight_int4pack_mm timed beside each, and each kernel at qkv M
    = 8 no slower than it."""
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    bf, gs, h = torch.bfloat16, 128, 5120
    step = {"wo_matmul_packed": 0.0, "wo_matmul_packed_grouped": 0.0}
    shapes = (("qkv", h, 3 * h), ("o_proj", h, h),
              ("gate_up", h, 2 * 13824), ("down_proj", 13824, h))
    cases = [(lb, k, n, mk, name)
             for name in ("wo_matmul_packed", "wo_matmul_packed_grouped")
             for mk in (1, 8, 16) for lb, k, n in shapes]
    cases += [("qkv", h, 3 * h, 64, name)
              for name in ("wo_matmul_packed", "wo_matmul_packed_grouped")]
    for label, k, n, mk, name in cases:
        x = torch.randn((mk, k), generator=gen, device=dev).to(bf)
        qp = torch.randint(-128, 128, (k // 2, n), generator=gen, device=dev,
                           dtype=torch.int8)
        if name == "wo_matmul_packed":
            tag, mark, scale_b = "K12", "packed_mma_kernel", n * 4
            sc = torch.rand((n,), generator=gen, device=dev) * 2e-3 + 1e-4
            lib_scales = sc[None].expand(k // gs, n)

            def kfn():
                return wm.wo_matmul_packed(x, qp, sc)

            def pfn():
                return wm.wo_matmul_packed_plain(x, qp, sc)
        else:
            tag, mark = "K13", "packed_grouped_mma_kernel"
            sc = torch.rand((k // gs, n), generator=gen, device=dev) * 2e-3 \
                + 1e-4
            scale_b, lib_scales = (k // gs) * n * 4, sc

            def kfn():
                return wm.wo_matmul_packed_grouped(x, qp, sc, gs)

            def pfn():
                return wm.wo_matmul_packed_grouped_plain(x, qp, sc, gs)
        out, want = kfn(), pfn()
        err = gemm_err(out, want)
        check(err <= gemm_tol(bf), f"{name} {label} M={mk}: rel err {err} > "
              f"{gemm_tol(bf)}")
        again = kfn()
        torch.cuda.synchronize()
        check(torch.equal(out, again), f"{name} {label} M={mk}: two "
              f"launches on the same inputs differ")
        sms = wm.sm_count(dev.index or 0)
        p = (wm.packed_plan(mk, k, n, sms) if tag == "K12"
             else wm.grouped_plan(mk, k, n, gs, sms))
        plan = (f"; {p.splits} splits x {p.chunks_per_split} chunks, "
                f"{p.grid[0] * p.grid[1] * p.grid[2]} blocks, repeat "
                f"bit-equal")
        ms, pms, wms = measure(torch, kfn, pfn, mark, name, 100, 5)
        bnd = bound(mk * k * 2 + (k // 2) * n + scale_b + mk * n * 2,
                    2.0 * mk * n * k)
        lib = None
        try:
            call, lerr = int4pack_library(
                torch, x, qcore.unpack_int4(qp), lib_scales, want)
            lib = device_ms(torch, call, 50)
            print(f"  torch._weight_int4pack_mm (bf16 scales): rel err "
                  f"{lerr:.2e} against {tag}'s plain version", flush=True)
        except (RuntimeError, NotImplementedError, TypeError,
                ValueError) as e:
            print(f"  torch._weight_int4pack_mm: none on this card "
                  f"({str(e).splitlines()[0][:100]})", flush=True)
        if mk == 8:
            step[name] += ms
        print(f"{tag} {name} {label} M={mk} K={k} N={n}: max rel err "
              f"{err:.2e}; device {ms:.5f} ms per launch (plain {pms:.5f} "
              f"ms; wrapper {wms:.5f} ms; bound {bnd[0]:.5f} ms, by "
              f"{bnd[1]}; {(k // 2) * n / ms / 1e9:.3f} TB/s of packed "
              f"weight; library "
              f"{'none' if lib is None else f'{lib:.5f} ms'}){plan}",
              flush=True)
        if label == "qkv" and mk == 8:
            results[name] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound=bnd, library_ms=lib)
    weights = 40 * (h * 3 * h + h * h + h * 2 * 13824 + 13824 * h) / 2
    for name, ms in step.items():
        print(f"{name}: one decode step's four linears {ms:.5f} ms a layer, "
              f"{40 * ms:.3f} ms for 40 layers (bound: "
              f"{weights / 1e9:.3f} GB of packed weights, "
              f"{weights / HBM_BYTES_PER_MS:.3f} ms)", flush=True)
    for tag, name in (("K12", "wo_matmul_packed"),
                      ("K13", "wo_matmul_packed_grouped")):
        r = results[name]
        if r["library_ms"] is not None:
            check(r["ms"] <= r["library_ms"],
                  f"{tag} at qkv M=8: {r['ms']:.5f} ms, slower than "
                  f"torch._weight_int4pack_mm's {r['library_ms']:.5f} ms")


def check_flash(torch, gen, dev, results):
    """K14 against its plain version (ref.flash_causal_attention): at the
    dense serve's shape (8 x 768, 32 heads x 128; v a strided view of a
    fused qkv, as the model hands it over), at D 64 and 256 with S 128 and
    2048 (B 1), and at ragged S (200; 1 and 65 at every D). Timings at the serve's shape, with SDPA
    (torch's scaled_dot_product_attention, causal, on (B, H, S, D)) as the
    library call. Then causal_self_attention's GQA route (Hq 32 / Hkv 8, S
    768): K8 over the page view against the plain masked attention."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    from mixq_tensorrt_llm_tpu_torch.ops import ref

    def run(b, s, h, d, fused: bool):
        if fused:                       # q, k, v views of one (B, S, 3HD)
            qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                              device=dev).bfloat16()
            q, k, v = (x.reshape(b, s, h, d)
                       for x in qkv.split(h * d, dim=-1))
        else:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device=dev).bfloat16() for _ in range(3))
        before = _build.LAUNCHES.get("flash_causal_attention", 0)
        out = fa.flash_causal_attention(q, k, v, d ** -0.5)
        want = ref.flash_causal_attention(q, k, v, d ** -0.5)
        torch.cuda.synchronize()
        check(_build.LAUNCHES.get("flash_causal_attention", 0) == before + 1,
              "K14: the wrapper did not count one launch")
        check(bool(torch.isfinite(out.float()).all()),
              "K14 output not finite")
        err = float((out.float() - want.float()).abs().max())
        check(err <= ATTN_TOL, f"K14 B={b} S={s} H={h} D={d}: max abs err "
              f"{err} > {ATTN_TOL}")
        print(f"K14 flash_causal_attention B={b} S={s} H={h} D={d}"
              f"{' (strided q/k/v views)' if fused else ''}: max abs err "
              f"{err:.3e}", flush=True)
        return q, k, v, err

    worst = 0.0
    for b, s, h, d in ((1, 128, 8, 64), (1, 2048, 8, 64), (1, 128, 4, 256),
                       (1, 2048, 4, 256), (1, 2048, 8, 128),
                       (2, 200, 4, 128), (2, 1, 4, 128), (2, 65, 4, 128),
                       (2, 65, 4, 64), (2, 65, 4, 256)):
        worst = max(worst, run(b, s, h, d, False)[3])
    b, s, h, d = 8, 768, 32, 128
    q, k, v, err = run(b, s, h, d, True)
    worst = max(worst, err)
    scale = d ** -0.5
    ms, pms, wms = measure(
        torch, lambda: fa.flash_causal_attention(q, k, v, scale),
        lambda: ref.flash_causal_attention(q, k, v, scale),
        "flash_causal_kernel", "flash_causal_attention", 50, 5)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    names = []
    lib = device_ms(torch, lambda: sdpa(qt, kt, vt, is_causal=True,
                                        scale=scale), 50, names=names)
    lib_err = float((sdpa(qt, kt, vt, is_causal=True, scale=scale)
                     .transpose(1, 2).float()
                     - ref.flash_causal_attention(q, k, v, scale).float())
                    .abs().max())
    backend = ", ".join(n[:80] for n in names) or "none traced"
    bnd = bound(4 * b * s * h * d * 2, 4.0 * b * h * d * s * (s + 1) / 2)
    results["flash_causal_attention"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=pms, bound=bnd, library_ms=lib,
        library=f"scaled_dot_product_attention: {backend}")
    print(f"K14 timing B={b} S={s} H={h} D={d}: device {ms:.5f} ms per "
          f"launch (plain {pms:.5f} ms; wrapper {wms:.5f} ms per call; "
          f"bound {bnd[0]:.5f} ms, by {bnd[1]}; "
          f"{4.0 * b * h * d * s * (s + 1) / 2 / ms / 1e9:.1f} TFLOP/s); "
          f"SDPA {lib:.5f} ms (within {lib_err:.3e} of plain; kernels: "
          f"{backend})", flush=True)
    del q, k, v, qt, kt, vt

    # the GQA route of causal_self_attention: K8 on a page view
    hq, hkv, b = 32, 8, 2
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev).bfloat16()
            for _ in range(2))
    before = _build.LAUNCHES.get("paged_prefill_attention_fp", 0)
    out = fa.causal_self_attention(q, k, v, scale)
    idx = torch.arange(s, device=dev)
    want = ref.attention(q.float(), k.float(), v.float(),
                         mask=(idx[None, :] <= idx[:, None])[None, None],
                         scale=scale)
    torch.cuda.synchronize()
    check(_build.LAUNCHES.get("paged_prefill_attention_fp", 0) == before + 1,
          "causal_self_attention GQA: K8 was not launched once")
    err = float((out.float() - want).abs().max())
    check(err <= ATTN_TOL, f"causal_self_attention GQA (K8 page view): max "
          f"abs err {err} > {ATTN_TOL}")
    print(f"causal_self_attention GQA B={b} S={s} Hq={hq} Hkv={hkv} D={d}: "
          f"K8 over the page view, max abs err {err:.3e} against the plain "
          f"masked attention", flush=True)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path
# ---------------------------------------------------------------------------

class kv_splits:
    """MIXQ_KV_SPLITS set to ``n`` inside the block, restored after."""

    def __init__(self, n: int):
        self.n, self.old = n, None

    def __enter__(self):
        self.old = os.environ.get("MIXQ_KV_SPLITS")
        os.environ["MIXQ_KV_SPLITS"] = str(self.n)

    def __exit__(self, *exc):
        if self.old is None:
            os.environ.pop("MIXQ_KV_SPLITS", None)
        else:
            os.environ["MIXQ_KV_SPLITS"] = self.old


def serve(torch, params, cfg, seed: int, dev, path: str):
    """Serve the 8 requests through the Executor with every launch count
    at 0 just before and read just after; check the kernels of ``path``
    ("7b", "13b", "spec": run_speculative with a draft of the first
    DRAFT_LAYERS layers, or "split": MIXQ_KV_SPLITS=4) launched and those
    it must not use did not. Returns (launches, finished requests by id,
    request ids)."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    spec = ((*sp.draft_model(params, cfg, DRAFT_LAYERS), GAMMA)
            if path == "spec" else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    with kv_splits(4 if path == "split" else 0):
        done, ids, wall, prefill_s, ex = sp.serve(params, cfg, prompts, seed,
                                                  dev, spec)
    launches = dict(_build.LAUNCHES)
    gen_total = sum(len(done[r].generated) for r in ids)
    SERVE_STATS[path] = dict(wall=wall, decode_s=wall - prefill_s,
                             readbacks=ex.readbacks, gen=gen_total,
                             calls=ex.decode_calls,
                             replays=ex.graph_replays)
    if spec is None:
        check(ex.graph_replays == ex.decode_calls > 0,
              f"{path}: {ex.graph_replays} graph replays for "
              f"{ex.decode_calls} decode calls")
    check(all(done[r].done and len(done[r].generated) == 32 for r in ids),
          f"{path}: not every request finished with 32 tokens")
    check(all(len(done[r].logprobs) == 32 for r in ids)
          and all(math.isfinite(lp) for r in ids for lp in done[r].logprobs),
          f"{path}: not every token has a finite log-probability")
    print(f"main path {path}: 8 requests, prompts "
          f"{[len(p) for p in prompts]} tokens, 32 generated each; wall "
          f"{wall:.3f} s = prefill {prefill_s:.3f} s + "
          f"{'speculative rounds' if spec else 'decode'} "
          f"{wall - prefill_s:.3f} s; {gen_total / wall:.1f} generated "
          f"tok/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"main path {path} launches: {json.dumps(launches)}", flush=True)
    # per layer: a prefill call writes its chunk once (K6) and runs three
    # mix linears (K1 -> K2) and down_proj (K4); a decode step writes one
    # token (K5) and runs four weight-only linears (K4, or K12 packed)
    fp = "_fp" if path == "13b" else ""
    chunk = launches.get("paged_write_chunk" + fp, 0)
    token = launches.get("paged_write_token" + fp, 0)
    if path == "7b":
        print(f"main path launches against the per-layer counts: K1 "
              f"{launches.get('rmsnorm_quant_split', 0)} (3 x K6 = "
              f"{3 * chunk}), K2 {launches.get('mixed_matmul', 0)} (3 x K6 "
              f"= {3 * chunk}), K4 {launches.get('wo_matmul', 0)} (4 x K5 + "
              f"K6 = {4 * token + chunk}), K3 "
              f"{launches.get('mixed_matmul_hybrid', 0)} (not on the path)",
              flush=True)
    elif path == "13b":
        print(f"main path launches against the per-layer counts: K12 "
              f"{launches.get('wo_matmul_packed', 0)} + K4 "
              f"{launches.get('wo_matmul', 0)} (4 x (K5p + K6p) = "
              f"{4 * (token + chunk)}: K12 where a call has <= 128 rows)",
              flush=True)
    elif path == "spec":
        check(ex.spec_rounds > 0 and ex.spec_calls > 0,
              "phase 6: no speculative round ran")
        check(ex.spec_readbacks <= ex.spec_calls,
              f"phase 6: {ex.spec_readbacks} host readbacks for "
              f"{ex.spec_calls} calls")
        print(f"speculative: gamma {GAMMA}, draft = the first {DRAFT_LAYERS} "
              f"of {cfg.num_layers} layers; {ex.spec_rounds} rounds in "
              f"{ex.spec_calls} calls with {ex.spec_readbacks} host "
              f"readbacks; acceptance "
              f"{ex.spec_accepted / max(ex.spec_proposed, 1):.3f} "
              f"({ex.spec_accepted} / {ex.spec_proposed} draft tokens); "
              f"K9 {launches.get('paged_verify_attention', 0)} launches "
              f"(one a layer a verify), K7 "
              f"{launches.get('paged_decode_attention', 0)}", flush=True)
    for name in ON_PATH[path]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path {path}")
    for name in OFF_PATH[path]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path {path}")
    return launches, done, ids


def decode_run(torch, sp, params, cfg, prompts, seed: int, dev, ex,
               burst: int, marks=None, same_tokens: bool = True,
               lora_ids=None) -> dict:
    """Serve the prompts through the warmed Executor ``ex`` with
    run(burst=burst), once timed with every launch count at 0 just before
    and read just after, once under torch.profiler (kernels that start
    outside the prefill calls' ranges are decode's; ``marks``, by default
    DECODE_TRACED, are counted there). The profiled run must give the
    timed run's tokens unless ``same_tokens`` is False (a dynamic outlier
    state moves between the runs). ``lora_ids``: each prompt's adapter.
    Returns the run's numbers, with the names of the kernels traced in
    the prefill calls."""
    marks = DECODE_TRACED if marks is None else marks
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    counters = (ex.decode_calls, ex.graph_replays, ex.readbacks,
                ex.decode_steps)
    torch.cuda.synchronize()
    _build.reset_launches()
    done, ids, wall, prefill_s, _ = sp.serve(params, cfg, prompts, seed,
                                             dev, None, burst, ex, lora_ids)
    launches = dict(_build.LAUNCHES)
    calls, replays, reads, steps = (a - b for a, b in zip(
        (ex.decode_calls, ex.graph_replays, ex.readbacks, ex.decode_steps),
        counters))
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        done2, ids2, *_ = sp.serve(params, cfg, prompts, seed, dev, None,
                                   burst, ex, lora_ids)
    events = prof.events()
    ranges = [e.time_range for e in events if e.name == "phase::prefill"
              and e.device_type == torch.autograd.DeviceType.CPU]
    dec = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.name.startswith("phase::")
           and not any(r.start <= e.time_range.start <= r.end
                       for r in ranges)]
    toks = [done[r].generated for r in ids]
    check(not same_tokens or [done2[r].generated for r in ids2] == toks,
          f"burst {burst}: the profiled run's tokens differ")
    pre = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and any(r.start <= e.time_range.start <= r.end for r in ranges)]
    return dict(toks=toks, logprobs=[done[r].logprobs for r in ids],
                wall=wall, decode_s=wall - prefill_s, prefill_s=prefill_s,
                launches=launches, calls=calls, replays=replays,
                readbacks=reads, steps=steps,
                gen=sum(len(t) for t in toks),
                busy_ms=sum(e.time_range.elapsed_us() for e in dec) / 1e3,
                traced={m: sum(m in e.name for e in dec) for m in marks},
                prefill_names={e.name for e in pre},
                prefill_busy_ms=busy_union_ms(pre),
                prefill_profiled_ms=sum(r.elapsed_us() for r in ranges)
                / 1e3)


def busy_union_ms(events) -> float:
    """The device's busy time over ``events``: the union of their time
    ranges, so device work that overlaps (a library call's kernels on
    streams of its own) counts once."""
    total, end = 0.0, -math.inf
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total / 1e3


def serve_burst(torch, params, cfg, seed: int, dev, ref) -> dict:
    """Phase 4d: a new Executor over the phase-4 model runs
    warmup(burst=BURST), then serves the 8 requests with run(burst=1) and
    run(burst=BURST) (``decode_run``). ``ref`` = (finished requests, ids)
    of phase 4. Returns the launches of the BURST run."""
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    ex = sp.make_executor(params, cfg, seed, dev)
    t = time.perf_counter()
    ex.warmup(burst=BURST)
    torch.cuda.synchronize()
    rungs = sorted(k for k, *_ in ex._rungs)
    print(f"phase 4d: warmup(burst={BURST}) {time.perf_counter() - t:.1f} s"
          f", rungs {rungs} captured", flush=True)
    check(rungs == [1, 2, 4, 8, BURST], f"phase 4d: rungs {rungs}")
    want = [ref[0][r].generated for r in ref[1]]
    p4 = SERVE_STATS["7b"]
    print(f"phase 4 (a fresh Executor, rung 1 captured in the run): decode "
          f"wall {p4['decode_s'] * 1e3:.1f} ms, {p4['calls']} decode calls, "
          f"{p4['replays']} replays, {p4['readbacks']} host readbacks = "
          f"{p4['readbacks'] / p4['gen']:.4f} a generated token",
          flush=True)
    runs = {}
    for burst in (1, BURST):
        r = runs[burst] = decode_run(torch, sp, params, cfg, prompts, seed,
                                     dev, ex, burst)
        check(r["toks"] == want, f"phase 4d: burst {burst}: tokens differ "
              "from phase 4's")
        check(all(math.isfinite(x) for lps in r["logprobs"] for x in lps),
              f"phase 4d: burst {burst}: a log-probability is not finite")
        check(r["replays"] == r["calls"] > 0,
              f"phase 4d: burst {burst}: {r['replays']} replays for "
              f"{r['calls']} decode calls")
        expect = {m: n * cfg.num_layers * r["steps"]
                  for m, (_, n) in DECODE_TRACED.items()}
        for m, (label, _) in DECODE_TRACED.items():
            check(0 < r["traced"][m] <= expect[m],
                  f"phase 4d: burst {burst}: {label} ({m}) traced "
                  f"{r['traced'][m]} times in the decode phase "
                  f"(expected {expect[m]})")
        dec_ms = r["decode_s"] * 1e3
        print(f"phase 4d burst {burst}: wall {r['wall'] * 1e3:.1f} ms, "
              f"decode wall {dec_ms:.1f} ms for {r['steps']} steps in "
              f"{r['calls']} calls ({r['replays']} graph replays), device "
              f"busy {r['busy_ms']:.1f} ms (profiled run), idle share "
              f"{1 - r['busy_ms'] / dec_ms:.3f}; {r['readbacks']} host "
              f"readbacks = {r['readbacks'] / r['gen']:.4f} a generated "
              f"token; traced in decode "
              + ", ".join(f"{DECODE_TRACED[m][0]} {n} of {expect[m]}"
                          for m, n in r["traced"].items()), flush=True)
    check(ex.compiles_since_warmup == 0,
          f"phase 4d: {ex.compiles_since_warmup} programs made after warmup")
    launches = runs[BURST]["launches"]
    SERVE_STATS["burst"] = runs[BURST]
    print(f"main path burst launches: {json.dumps(launches)}", flush=True)
    for name in ON_PATH["burst"]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path burst")
    return launches


def serve_dense(torch, params, cfg, seed: int, dev):
    """Phase 4c: the same 8 requests as one static batch through
    GenerationSession (max_seq_len 768: one 768-token prefill bucket, 32
    greedy tokens each), every launch count at 0 just before and read just
    after; K14, K1, K2 and K4 must launch, no paged kernel. Returns the
    launches."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    out, wall = sp.serve_dense(params, cfg, prompts, dev)
    launches = dict(_build.LAUNCHES)
    check(out.num_generated == [32] * len(prompts),
          f"dense: not every request got 32 tokens ({out.num_generated})")
    check(all(math.isfinite(lp) for lps in out.logprobs for lp in lps),
          "dense: not every token has a finite log-probability")
    gen_total = sum(out.num_generated)
    cache_b = sp.dense_cache_bytes(cfg, len(prompts), 768)
    print(f"main path dense: 8 requests, prompts {[len(p) for p in prompts]} "
          f"tokens in one 768-token bucket, 32 generated each; wall "
          f"{wall:.3f} s = prefill {out.prefill_time_s:.3f} s + decode "
          f"{out.decode_time_s:.3f} s; {gen_total / wall:.1f} generated "
          f"tok/s ({out.decode_tokens_per_s:.1f} in decode); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; dense cache "
          f"{cache_b / 1e9:.3f} GB", flush=True)
    print(f"main path dense launches: {json.dumps(launches)}", flush=True)
    layers = cfg.num_layers
    print(f"main path dense launches against the per-layer counts: K14 "
          f"{launches.get('flash_causal_attention', 0)} (1 a layer at the "
          f"prefill = {layers}), K1 {launches.get('rmsnorm_quant_split', 0)} "
          f"and K2 {launches.get('mixed_matmul', 0)} (3 a layer at the "
          f"prefill = {3 * layers}), K4 {launches.get('wo_matmul', 0)} (1 a "
          f"layer at the prefill + 4 a layer for each of 31 decode steps = "
          f"{layers + 4 * layers * 31})", flush=True)
    for name in ON_PATH["dense"]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path dense")
    for name in OFF_PATH["dense"]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path dense")
    return launches


def cpu_copy(torch, params):
    """The params tree (an expert layer's ``moe`` entry nested one level
    deeper) on the CPU."""
    cpu = torch.device("cpu")

    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, list):
            return [copy(x) for x in v]
        return v.to(cpu)
    return copy(params)


def two_layers(torch, params, cfg):
    """(the model cut to its first 2 layers: config, params on the card,
    their CPU copy)."""
    return first_layers(torch, params, cfg, 2)


def first_layers(torch, params, cfg, n: int, **cfg_kw):
    """(the model cut to its first ``n`` layers (``cfg_kw`` replacing
    config fields too): config, params on the card, their CPU copy)."""
    import dataclasses
    sub = dict(params, layers=params["layers"][:n])
    return (dataclasses.replace(cfg, num_layers=n, **cfg_kw), sub,
            cpu_copy(torch, sub))


def compare_devices(torch, label, dev, run, sub, sub_cpu, phases,
                    faults=()) -> dict:
    """Card (kernels) against CPU (plain versions) within XDEV_TOL.
    ``run(device, params)`` gives one (logits, launches) pair for each
    entry of ``phases``: (phase, kernels that must launch there, kernels
    that must not[, its own tolerance]). Then negative controls: the card run again with a
    fault injected into one kernel's call, to show where such faults land
    against the tolerance; ``faults`` holds (name, whether the tolerance
    must catch it, module, function, fault). Returns the card run's
    launches, summed over its phases."""
    plain = run(torch.device("cpu"), sub_cpu)
    # the MoE routes count on both devices (models/moe.py): not kernels
    check(not any(not n.startswith("moe.") for _, seen in plain
                  for n in seen), "the CPU run launched a kernel")
    plain = [x for x, _ in plain]
    total = {}
    tols = [p[3] if len(p) > 3 else XDEV_TOL for p in phases]
    for (x, seen), want, (phase, must, never, *_), tol in zip(
            run(dev, sub), plain, phases, tols):
        check(bool(torch.isfinite(x).all()),
              f"cross-device {label}, {phase}: card output not finite")
        for name in must:
            check(seen.get(name, 0) > 0, f"cross-device {label}: {name} was "
                  f"not launched at {phase}")
        for name in never:
            check(seen.get(name, 0) == 0, f"cross-device {label}: {name} was "
                  f"launched at {phase}")
        for n, c in seen.items():
            total[n] = total.get(n, 0) + c
        rel = _rel(x, want)
        agree = bool((x.argmax(-1) == want.argmax(-1)).all())
        print(f"cross-device {label}, {phase}: max |card - cpu| / max |cpu| "
              f"= {rel:.3e} (tolerance {tol}); argmax agrees: {agree}; "
              f"launches {json.dumps(seen)}", flush=True)
        check(rel <= tol, f"card vs CPU differ ({label}, {phase}): "
              f"{rel} > {tol}")

    for name, must_catch, module, attr, fault in faults:
        real = getattr(module, attr)
        setattr(module, attr, fault(real))
        try:
            r = max(_rel(x, want) / tol for (x, _), want, tol in
                    zip(run(dev, sub), plain, tols)) * XDEV_TOL
        finally:
            setattr(module, attr, real)
        caught = not r <= XDEV_TOL
        print(f"negative control, {name}: {r:.3e} against tolerance "
              f"{XDEV_TOL} (scaled to each phase's own): "
              f"{'caught' if caught else 'not caught'}"
              f"{'' if must_catch else ' (a reading)'}", flush=True)
        if must_catch:
            check(caught, f"the cross-device check misses a fault ({name})")
    return total


def cross_device(torch, params, cfg, seed: int, dev, label: str,
                 faults=(), must_launch=((), ())) -> dict:
    """Phases 5 and 5b, 2 layers at full width: the first prefill chunk's
    last-position logits (a 200-token prompt in a 256-token chunk) and one
    decode step's logits through forward_paged, card against CPU; the card
    run must launch the kernels of ``must_launch`` (prefill's, decode's).
    Returns the card run's launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models.common import forward_paged
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    cfg2, sub, sub_cpu = two_layers(torch, params, cfg)
    rng = np.random.default_rng(seed + 1)
    c, prompt_len = 256, 200
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :prompt_len] = rng.integers(1, cfg.vocab_size, prompt_len)
    next_token = int(rng.integers(1, cfg.vocab_size))

    def run(device, p):
        state = init_paged_kv(cfg2, 4, 128, device=device)
        t = torch.from_numpy(tokens).to(device)
        pos = torch.arange(c, dtype=torch.int32, device=device)[None]
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
        length = torch.tensor([prompt_len], dtype=torch.int32, device=device)
        _build.reset_launches()
        pre, _ = forward_paged(p, cfg2, t, pos, state, table, length,
                               last_pos=length - 1)
        out = [(pre[0, 0].float().cpu(), dict(_build.LAUNCHES))]
        _build.reset_launches()
        t = torch.tensor([[next_token]], dtype=torch.int32, device=device)
        dec, _ = forward_paged(p, cfg2, t, length[:, None], state, table,
                               length + 1)
        return out + [(dec[0, 0].float().cpu(), dict(_build.LAUNCHES))]

    return compare_devices(
        torch, label, dev, run, sub, sub_cpu,
        [(f"prefill ({prompt_len} tokens)", must_launch[0], ()),
         ("decode step", must_launch[1], ())], faults)


def k14_faults(torch):
    """Phase 5c's controls, both enforced: K14 with the logits scale
    doubled; K14 with every row also seeing the next 16 keys (k and v moved
    16 positions earlier, so row r sees keys 16 .. r + 16 and loses keys
    0 .. 15)."""
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa

    def shifted(f):
        def faulty(q, k, v, scale):
            return f(q, k.roll(-16, dims=1).contiguous(),
                     v.roll(-16, dims=1).contiguous(), scale)
        return faulty

    return [
        ("K14 with the logits scale doubled", True, fa,
         "flash_causal_attention",
         lambda f: lambda q, k, v, scale: f(q, k, v, 2.0 * scale)),
        ("K14 with every row seeing the next 16 keys", True, fa,
         "flash_causal_attention", shifted),
    ]


def cross_device_dense(torch, params, cfg, seed: int, dev):
    """Phase 5c, 2 layers at full width, through GenerationSession.generate
    as users call it: 2 prompts of 200 and 256 tokens in one 256-token
    bucket (K14 at every layer), 2 tokens each. A logits processor reads
    the raw logits the session hands it at the prefill and at the decode
    step and forces the next token, the same on both devices, so that the
    decode step's inputs agree. Those logits and the session's logprobs of
    the forced tokens are held card against CPU, then the K14 controls run.
    Then the 2-layer model is saved with save_checkpoint and served once
    through LLM on the card. Returns the card run's launches."""
    import tempfile
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.api import LLM
    from mixq_tensorrt_llm_tpu_torch.convert import save_checkpoint
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    cfg2, sub, sub_cpu = two_layers(torch, params, cfg)
    rng = np.random.default_rng(seed + 2)
    lens_l, bucket = [200, 256], 256
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens_l]
    nxt = rng.integers(1, cfg.vocab_size, 2)

    def run(device, p):
        sess = GenerationSession(p, cfg2, max_seq_len=512, device=device)
        force = torch.from_numpy(nxt).to(device)[:, None]
        read = []

        def processor(logits, history):
            read.append((logits.float().cpu(), dict(_build.LAUNCHES)))
            _build.reset_launches()
            cols = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(cols[None] == force, 0.0, -torch.inf)

        _build.reset_launches()
        out = sess.generate(prompts, 2, logits_processors=(processor,))
        check(out.sequences == [q + [int(t)] * 2
                                for q, t in zip(prompts, nxt)],
              "cross-device dense: the forced tokens were not generated")
        return read + [(torch.tensor(out.logprobs), {})]

    paged = tuple(PAGED)
    launches = compare_devices(
        torch, "dense", dev, run, sub, sub_cpu,
        [(f"prefill (prompts of {lens_l} tokens in a {bucket}-token "
          f"bucket)", ("flash_causal_attention", "rmsnorm_quant_split",
                       "mixed_matmul", "wo_matmul"), paged),
         ("decode step", ("wo_matmul",), paged),
         ("logprobs of the 2 forced tokens", (), ())],
        k14_faults(torch))

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        save_checkpoint(tmp, sub, cfg2)
        llm = LLM(tmp, max_seq_len=512, device=dev)
        _build.reset_launches()
        out = llm.generate_tokens([prompts[0]], 8)
        torch.cuda.synchronize()
        check(out.num_generated == [8] and bool(np.isfinite(
            out.logprobs[0]).all()), "LLM over the saved checkpoint failed")
        check(_build.LAUNCHES.get("flash_causal_attention", 0) == 2,
              "LLM: K14 did not launch at each layer of its prefill")
        print(f"LLM over a checkpoint saved by save_checkpoint (2 layers): 8 "
              f"tokens on the card, K14 launched "
              f"{_build.LAUNCHES.get('flash_causal_attention', 0)} times; "
              f"save, load and generate {time.perf_counter() - t:.1f} s",
              flush=True)
        del llm
    return launches


def beam_run(torch, ex, prompts, new: int, profile: bool) -> dict:
    """run_beams(burst=BEAM_BURST) over ``prompts`` (``new`` tokens each)
    on the warmed Executor ``ex``, every launch count at 0 just before and
    read just after; with
    ``profile`` under torch.profiler (device work that starts outside the
    prefill's ranges is the burst decode's). Returns the run's numbers."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    eng = ex.beam_engine
    keys = ("bursts", "burst_steps", "graph_replays", "readbacks",
            "prefill_s")
    marks = {k: getattr(eng, k) for k in keys}
    torch.cuda.synchronize()
    _build.reset_launches()
    ids = [ex.submit(p, max_new_tokens=new) for p in prompts]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts) if profile else None
    t = time.perf_counter()
    if prof is not None:
        prof.__enter__()
    try:
        done = ex.run_beams(num_beams=BEAMS, burst=BEAM_BURST)
        torch.cuda.synchronize()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t
    r = {k: getattr(eng, k) - marks[k] for k in keys}
    r.update(wall=wall, launches=dict(_build.LAUNCHES),
             toks=[done[i].generated for i in ids])
    r["gen"] = sum(len(g) for g in r["toks"])
    if prof is not None:
        events = prof.events()
        ranges = [e.time_range for e in events
                  if e.name == "phase::prefill"
                  and e.device_type == torch.autograd.DeviceType.CPU]
        dec = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("phase::")
               and not any(q.start <= e.time_range.start <= q.end
                           for q in ranges)]
        r["busy_ms"] = sum(e.time_range.elapsed_us() for e in dec) / 1e3
        r["traced"] = {m: sum(m in e.name for e in dec)
                       for m in BEAM_TRACED}
        r["decode_events"] = dec
    return r


def serve_beams(torch, params, cfg, seed: int, dev, path: str) -> dict:
    """Phases 4e ("beam") and 4f ("beam_13b"): the requests of
    BEAM_RUNS[path] (random tokens, one prompt bucket, ragged) through a
    new Executor: warmup_beams, then run_beams(burst=BEAM_BURST) timed and
    profiled (``beam_run``), then a burst=1 run for the agreement
    reading. Returns the timed run's launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    n_req, lo, hi, new, bucket = BEAM_RUNS[path]
    phase = "phase 4e" if path == "beam" else "phase 4f"
    fp = "" if cfg.quant.kv_cache.name == "INT8" else "_fp"
    rng = np.random.default_rng(seed + 3)
    prompts = [rng.integers(1, cfg.vocab_size, int(m)).tolist()
               for m in rng.integers(lo, hi + 1, n_req)]
    ex = Executor(params, cfg, max_batch=n_req, block_size=128,
                  max_seq_len=768, device=dev)
    t = time.perf_counter()
    ex.warmup_beams(num_beams=BEAMS, burst=BEAM_BURST, prompt_bucket=bucket,
                    max_new_tokens=new)
    torch.cuda.synchronize()
    eng = ex.beam_engine
    print(f"{phase}: warmup_beams(num_beams={BEAMS}, burst={BEAM_BURST}, "
          f"prompt_bucket={bucket}, max_new_tokens={new}) "
          f"{time.perf_counter() - t:.1f} s, {len(eng._bursts)} burst graphs "
          f"captured; pool {eng.state.num_pages // cfg.num_layers} blocks a "
          f"layer", flush=True)
    timed = beam_run(torch, ex, prompts, new, False)
    traced = beam_run(torch, ex, prompts, new, True)
    check(ex.compiles_since_warmup == 0,
          f"{phase}: {ex.compiles_since_warmup} programs made after warmup")
    check(traced["toks"] == timed["toks"],
          f"{phase}: the two run_beams runs gave different sequences")
    for name, r in (("timed", timed), ("profiled", traced)):
        check(r["graph_replays"] == r["bursts"] > 0,
              f"{phase} ({name}): {r['graph_replays']} graph replays for "
              f"{r['bursts']} bursts")
        check(all(len(g) == new and all(0 <= x < cfg.vocab_size for x in g)
                  for g in r["toks"]),
              f"{phase} ({name}): not every request got {new} tokens in "
              "the vocabulary")
    launches = timed["launches"]
    k10 = cfg.num_layers * timed["burst_steps"]
    got = launches.get("paged_decode_attention_stats" + fp, 0)
    check(got == k10, f"{phase}: K10 launched {got} times for "
          f"{timed['burst_steps']} burst steps x {cfg.num_layers} layers")
    expect = {m: n * cfg.num_layers * traced["burst_steps"]
              for m, (_, n) in BEAM_TRACED.items()}
    for m, (label, n) in BEAM_TRACED.items():
        got = traced["traced"][m]
        check((0 < got <= expect[m]) if n else got == 0,
              f"{phase}: {label} ({m}) traced {got} times in the burst "
              f"decode (expected {expect[m]})")
    dec_ms = (timed["wall"] - timed["prefill_s"]) * 1e3
    print(f"{phase} run_beams(burst={BEAM_BURST}): {n_req} requests x "
          f"{BEAMS} beams, prompts {min(map(len, prompts))}-"
          f"{max(map(len, prompts))} tokens, {new} generated each; "
          f"wall {timed['wall'] * 1e3:.1f} ms = prefill "
          f"{timed['prefill_s'] * 1e3:.1f} ms + decode {dec_ms:.1f} ms for "
          f"{timed['burst_steps']} steps in {timed['bursts']} bursts "
          f"({timed['graph_replays']} graph replays); "
          f"{timed['gen'] / timed['wall']:.1f} generated tok/s; device busy "
          f"in decode {traced['busy_ms']:.1f} ms (profiled run), idle share "
          f"{1 - traced['busy_ms'] / dec_ms:.3f}; {timed['readbacks']} host "
          f"readbacks = {timed['readbacks'] / timed['gen']:.4f} a generated "
          f"token; peak pool blocks {eng.peak_blocks}; traced in decode "
          + ", ".join(f"{BEAM_TRACED[m][0]} {n} of {expect[m]}"
                      for m, n in traced["traced"].items()), flush=True)
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    sp._report(f"{phase} burst decode (the timed run's wall)",
               traced["decode_events"], dec_ms / 1e3,
               {"steps": traced["burst_steps"]}, {})
    print(f"main path {path} launches: {json.dumps(launches)}", flush=True)
    for name in ON_PATH[path]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path {path}")
    for name in OFF_PATH[path]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path {path}")
    t = time.perf_counter()
    ids = [ex.submit(p, max_new_tokens=new) for p in prompts]
    done = ex.run_beams(num_beams=BEAMS, burst=1)
    torch.cuda.synchronize()
    same = sum(done[i].generated == g for i, g in zip(ids, timed["toks"]))
    print(f"{phase} run_beams(burst=1) (K5 and K7 every step, eager): "
          f"wall {(time.perf_counter() - t) * 1e3:.1f} ms; {same} of "
          f"{n_req} best sequences equal to the burst run's (a reading: "
          f"the burst's K10 + merge rounds unlike K7)", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 4g: the Executor's serving surface and the HTTP server over it
# ---------------------------------------------------------------------------

def odd_fresh(logits, history):
    """Phase 4g's logits processor: bans every even token id (so a free
    run meets it within a few tokens) and each lane's newest token (so it
    reads the history)."""
    import torch
    even = torch.arange(logits.shape[1], device=logits.device) % 2 == 0
    out = logits.masked_fill(even, -1e9)
    return out.scatter(1, history[:, -1:].clamp(min=0).long(), -1e9)


def serving_prompts(seed: int, vocab: int):
    """Random token prompts: (the first request: the SHARED system-prompt
    tokens and 128 of its own, the 7 others: the SHARED tokens and 64-200
    distinct ones each, a prompt with another prefix of the same
    length)."""
    import numpy as np
    rng = np.random.default_rng(seed + 14)
    shared = rng.integers(1, vocab, SHARED).tolist()
    first = shared + rng.integers(1, vocab, 128).tolist()
    others = [shared + rng.integers(1, vocab, int(n)).tolist()
              for n in rng.integers(64, 201, 7)]
    foreign = rng.integers(1, vocab, SHARED + 128).tolist()
    return first, others, foreign


def serving_executor(params, cfg, seed: int, dev, reuse: bool = True,
                     **kw):
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    return Executor(params, cfg, enable_block_reuse=reuse, seed=seed,
                    device=dev, logits_processors={"odd_fresh": odd_fresh},
                    **dict(SERVE_KW, **kw))


def reuse_run(torch, ex, first, others) -> dict:
    """On the warmed Executor ``ex``: the first request alone, then the 7
    others together, run(burst=BURST), timed, every launch count at 0 just
    before the second wave and read just after. Returns the second wave's
    numbers."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    rid = ex.submit(first, max_new_tokens=SERVE_NEW)
    first_toks = ex.run(burst=BURST)[rid].generated
    keys = ("prefill_tokens", "reused_blocks", "decode_calls",
            "graph_replays")
    marks = {k: getattr(ex, k) for k in keys}
    streamed = {}
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    ids = [ex.submit(p, max_new_tokens=SERVE_NEW,
                     on_token=lambda r, tok: streamed.setdefault(
                         r.req_id, []).append(tok))
           for p in others]
    done = ex.run(burst=BURST)
    torch.cuda.synchronize()
    out = {k: getattr(ex, k) - marks[k] for k in keys}
    reqs = [done[i] for i in ids]
    out.update(
        wall=time.perf_counter() - t, launches=dict(_build.LAUNCHES),
        first=first_toks, toks=[r.generated for r in reqs],
        ttft=[r.first_token_time - r.submit_time for r in reqs],
        req_wall=[r.finish_time - r.submit_time for r in reqs],
        streamed=all(streamed.get(r.req_id) == r.generated for r in reqs))
    return out


def traced_suffix(torch, ex, first, seed: int) -> dict:
    """Two more requests over the shared prefix (100 new tokens each)
    through ``ex`` under torch.profiler, each prefill call in a range (its
    kernels start inside it): the kernels traced in the prefill by marks
    of K6's and K8's names."""
    import numpy as np
    rng = np.random.default_rng(seed + 16)
    inner = ex._step_prefill

    def ranged():
        with torch.profiler.record_function("phase::prefill"):
            inner()
            torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    reused = ex.reused_blocks
    ex._step_prefill = ranged
    try:
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                ex.submit(first[:SHARED] + rng.integers(
                    1, ex.cfg.vocab_size, 100).tolist(), max_new_tokens=4)
            ex.run(burst=BURST)
            torch.cuda.synchronize()
    finally:
        del ex._step_prefill
    events = prof.events()
    ranges = [e.time_range for e in events if e.name == "phase::prefill"
              and e.device_type == torch.autograd.DeviceType.CPU]
    pre = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and any(q.start <= e.time_range.start <= q.end for q in ranges)]
    traced = {m: sum(m in e.name for e in pre)
              for m in ("write_chunk_kernel", "prefill_wgmma_kernel")}
    traced["adopted"] = ex.reused_blocks - reused
    return traced


def adopted_pages_check(torch, params, cfg, seed: int, dev) -> dict:
    """2 layers at full width: B's last-position logits prefilled cold
    against B's suffix prefilled over the 4 pages that A's prefill wrote
    (their shared 512 tokens), within XDEV_TOL of the largest |logit|;
    the control: the suffix over pages of another 512-token prefix must
    land outside it. K6 and K8 must launch on the suffix. Returns the
    launches of the suffix's call."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import (PAD_POS,
                                                              init_paged_kv)
    sub = dict(params, layers=params["layers"][:2])
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    bs = SERVE_KW["block_size"]
    mb = SERVE_KW["max_seq_len"] // bs
    first, others, foreign = serving_prompts(seed, cfg.vocab_size)
    b = others[0]
    state = [init_paged_kv(cfg2, 24, bs, device=dev)]

    def prefill(tokens, blocks, start):
        """tokens[start:] through forward_paged in the Executor's chunks
        over the table ``blocks``; the last chunk's last-position
        logits."""
        table = torch.tensor([blocks + [blocks[-1]] * (mb - len(blocks))],
                             dtype=torch.int32, device=dev)
        bpos = torch.tensor([[i * bs for i in range(len(blocks))]
                             + [int(PAD_POS)] * (mb - len(blocks))],
                            dtype=torch.int32, device=dev)
        pos = start
        while pos < len(tokens):
            rem = len(tokens) - pos
            c = bs if rem <= bs else 2 * bs
            chunk = tokens[pos:pos + c]
            tok = torch.tensor([chunk + [0] * (c - len(chunk))],
                               dtype=torch.int32, device=dev)
            p = pos + torch.arange(c, dtype=torch.int32, device=dev)[None]
            n = min(len(tokens), pos + c)
            logits, state[0] = mcommon.forward_paged(
                sub, cfg2, tok, p, state[0], table,
                torch.tensor([n], dtype=torch.int32, device=dev),
                block_pos=bpos,
                last_pos=torch.tensor([n - pos - 1], dtype=torch.int32,
                                      device=dev))
            pos += c
        torch.cuda.synchronize()
        return logits[:, 0].float()

    prefill(first, [1, 2, 3, 4, 5], 0)
    prefill(foreign, [14, 15, 16, 17, 18], 0)
    cold = prefill(b, [6, 7, 8, 9, 10, 11], 0)
    _build.reset_launches()
    reused = prefill(b, [1, 2, 3, 4, 12, 13], SHARED)
    launches = dict(_build.LAUNCHES)
    wrong = prefill(b, [14, 15, 16, 17, 19, 20], SHARED)
    check(bool(torch.isfinite(reused).all()),
          "phase 4g: logits over adopted pages not finite")
    err, bad = _rel(reused, cold), _rel(wrong, cold)
    print(f"phase 4g adopted pages (2 layers): B's suffix over A's pages "
          f"against B cold: {err:.3e} (tolerance {XDEV_TOL}); argmax agrees: "
          f"{bool((reused.argmax(-1) == cold.argmax(-1)).all())}; negative "
          f"control, pages of another prefix: {bad:.3e}: "
          f"{'caught' if bad > XDEV_TOL else 'not caught'}; the suffix's "
          f"launches {json.dumps(launches)}", flush=True)
    check(err <= XDEV_TOL, f"phase 4g: logits over adopted pages differ from "
          f"a cold prefill: {err} > {XDEV_TOL}")
    check(bad > XDEV_TOL, "phase 4g: pages adopted from another prefix "
          "were not caught")
    for name in ("paged_write_chunk", "paged_prefill_attention"):
        check(launches.get(name, 0) > 0,
              f"phase 4g: {name} was not launched on the adopted suffix")
    del state[0]
    return launches


def _first_banned(prompt, toks):
    """The first index i of ``toks`` that ``odd_fresh`` bans (an even id,
    or the token before it: the prompt's last one for i = 0), or None."""
    seq = prompt[-1:] + list(toks)
    return next((i for i in range(len(toks))
                 if seq[i + 1] % 2 == 0 or seq[i + 1] == seq[i]), None)


def controls_run(torch, ex, others) -> None:
    """On the warmed reuse Executor, over the 7 prompts the reuse run
    cached (so each run below adopts the same blocks and decodes the same
    bits up to its first control): a free run, the reference; then lane 0
    banning the two-token word its reference emits at a decode step j >= 2
    inside the first burst, and lanes 1-6 with the processor; then the
    processor alone. Lane 0 equals its reference before j and differs at
    j; each processor lane equals its reference before the first token
    the processor bans there and differs at it; no controlled lane emits
    what it bans (31 decode tokens a lane, all odd). Every
    decode call is a replay, and the only programs made after warmup are
    the bad-words bucket's rungs, one per k."""
    c0, calls0, rep0 = (ex.compiles_since_warmup, ex.decode_calls,
                        ex.graph_replays)
    rungs0 = set(ex._rungs)
    ids = [ex.submit(p, max_new_tokens=SERVE_NEW) for p in others]
    done = ex.run(burst=BURST)
    ref = [done[i].generated for i in ids]
    check(ex.compiles_since_warmup == c0,
          "phase 4g: the free run made a program after warmup")
    seq0 = others[0][-1:] + ref[0]
    pairs = list(zip(seq0, seq0[1:]))          # pairs[j]: (before j, j)
    j = next((j for j in range(2, BURST) if pairs[j] not in pairs[:j]),
             None)
    check(j is not None, "phase 4g: no fresh token pair in lane 0's "
          "first burst to ban")
    word = list(pairs[j])
    ids = [ex.submit(others[0], max_new_tokens=SERVE_NEW,
                     bad_words=[word])] + [
        ex.submit(p, max_new_tokens=SERVE_NEW, logits_processor="odd_fresh")
        for p in others[1:]]
    done = ex.run(burst=BURST)
    got = [done[i].generated for i in ids]
    new = set(ex._rungs) - rungs0
    made = ex.compiles_since_warmup - c0
    rid = ex.submit(others[2], max_new_tokens=SERVE_NEW,
                    logits_processor="odd_fresh")
    z = ex.run(burst=BURST)[rid].generated
    calls, replays = ex.decode_calls - calls0, ex.graph_replays - rep0
    x = others[0][-1:] + got[0]
    hits = [_first_banned(p, r) for p, r in zip(others[1:], ref[1:])]
    diff = [next((i for i, (a, b) in enumerate(zip(g, r)) if a != b), None)
            for g, r in zip(got, ref)]
    print(f"phase 4g controls: lane 0 bans {word}, its reference's tokens "
          f"{j - 1} and {j} (decode steps): first difference from the "
          f"reference at {diff[0]}; the processor lanes' first banned "
          f"tokens in their reference at {hits}, first differences "
          f"{diff[1:]}; {replays} graph replays for {calls} decode calls; "
          f"rungs made after warmup {sorted(new, key=str)} ({made} "
          f"programs)", flush=True)
    check(all(len(g) == SERVE_NEW for g in got + [z]),
          "phase 4g controls: a request did not get its tokens")
    check(got[0][:j] == ref[0][:j] and got[0][j] != ref[0][j],
          f"phase 4g: the banned lane does not leave its reference at {j}")
    check(tuple(word) not in zip(x, x[1:]),
          "phase 4g: a banned word was emitted")
    for p, g, r, at in zip(others[1:], got[1:], ref[1:], hits):
        check(at is not None and g[:at] == r[:at] and g[at] != r[at],
              f"phase 4g: a processor lane does not leave its reference "
              f"at the first token banned there ({at})")
        check(_first_banned(p, g) is None,
              "phase 4g: a processor lane emitted a token it bans")
    check(_first_banned(others[2], z) is None,
          "phase 4g: the processor-only lane emitted a token it bans")
    check(replays == calls > 0, f"phase 4g controls: {replays} replays for "
          f"{calls} decode calls")
    check(new and all(key[2] == (1, 2) for key in new)
          and len({key[0] for key in new}) == len(new) == made,
          f"phase 4g controls: programs made after warmup {made}, rungs "
          f"{sorted(new, key=str)}: not one bad-words rung a k")
    check(ex.compiles_since_warmup - c0 == made,
          "phase 4g: the processor alone made a program after warmup")


def surface_run(torch, params, cfg, seed: int, dev, ex, others) -> None:
    """cancel mid-decode (every block the request took back, free or
    cached), then 4 requests snapshotted after 8 steps: the uninterrupted
    run on ``ex``, the snapshot (through JSON) restored on a fresh
    Executor that finishes every request to its length."""
    import numpy as np
    free0, cache0 = ex.bm.num_free, ex.bm.prefix_cache_size
    rng = np.random.default_rng(seed + 15)
    rid = ex.submit(rng.integers(1, cfg.vocab_size, 300).tolist(),
                    max_new_tokens=64)
    while not ex.finished.get(rid) and not any(
            r is not None and r.req_id == rid and len(r.generated) >= 4
            for r in ex.slots):
        ex.step()
    req = next(r for r in ex.slots if r is not None and r.req_id == rid)
    check(ex.cancel(rid) and ex.finished[rid].done and not ex.has_work,
          "phase 4g: cancel mid-decode failed")
    cached = ex.bm.prefix_cache_size - cache0
    print(f"phase 4g cancel mid-decode after {len(req.generated)} tokens: "
          f"free blocks {free0} before, {ex.bm.num_free} after, {cached} "
          f"newly cached", flush=True)
    check(ex.bm.num_free == free0 - cached,
          f"phase 4g: cancel left {ex.bm.num_free} free blocks, not "
          f"{free0} - {cached}")
    jobs = others[3:7]
    ids = [ex.submit(p, max_new_tokens=SERVE_NEW) for p in jobs]
    for _ in range(8):
        ex.step()
    snap = json.loads(json.dumps(ex.snapshot()))
    gen = sum(len(d["generated"]) for d in snap["pending"])
    done = ex.run(burst=BURST)
    want = [done[i].generated for i in ids]
    fresh = serving_executor(params, cfg, seed, dev)
    fresh.restore(snap)
    got = fresh.run(burst=BURST)
    check(all(got[i].done and len(got[i].generated) == SERVE_NEW
              and got[i].prompt == p for i, p in zip(ids, jobs)),
          "phase 4g: the restored run did not finish every request")
    same = sum(a == b for i, w in zip(ids, want)
               for a, b in zip(got[i].generated, w))
    print(f"phase 4g snapshot after 8 steps ({len(snap['pending'])} pending, "
          f"{gen} tokens generated), restored on a fresh Executor: every "
          f"request finished with {SERVE_NEW} tokens; {same} of "
          f"{SERVE_NEW * len(ids)} equal to the uninterrupted run's (a "
          f"reading: the replayed prefill runs other shapes in bf16)",
          flush=True)
    del fresh


class SmokeLLM:
    """What the server takes of an LLM: make_executor and tokenizer. Its
    Executors leave prefix reuse off, as `cli serve` runs them."""
    tokenizer = None

    def __init__(self, params, cfg, seed: int, dev):
        self.params, self.cfg, self.seed, self.dev = params, cfg, seed, dev

    def make_executor(self, **kw):
        from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
        return Executor(self.params, self.cfg,
                        max_seq_len=SERVE_KW["max_seq_len"], seed=self.seed,
                        device=self.dev, **kw)


def _http(url: str, path: str, body=None):
    import urllib.request
    req = urllib.request.Request(
        url + path, None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=HTTP_WAIT) as r:
        text = r.read().decode()
    if path == "/generate_stream":
        return [json.loads(line) for line in text.splitlines() if line]
    return json.loads(text)


def serve_http(torch, params, cfg, seed: int, dev, exec_wall) -> None:
    """InferenceServer(burst=BURST, warmup=True) over the phase-4 model on
    127.0.0.1, port 0: 8 concurrent /generate and 2 /generate_stream; then
    /health; then a max_queue_size=2 server (its stepper stopped, two
    requests queued) answering 503."""
    import threading
    import urllib.error
    from http.server import ThreadingHTTPServer
    from mixq_tensorrt_llm_tpu_torch.serve import (InferenceServer,
                                                   make_handler)
    first, others, _ = serving_prompts(seed, cfg.vocab_size)
    llm = SmokeLLM(params, cfg, seed, dev)
    geo = dict(max_batch=SERVE_KW["max_batch"],
               block_size=SERVE_KW["block_size"],
               prefill_chunk=SERVE_KW["prefill_chunk"])
    t = time.perf_counter()
    srv = InferenceServer(llm, burst=BURST, warmup=True, **geo)
    print(f"phase 4g server: warmup(burst={BURST}) "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    out, errors = {}, []
    jobs = [("/generate", p) for p in [first] + others] + \
        [("/generate_stream", p) for p in others[:2]]

    def go(i, path, prompt):
        try:
            out[i] = _http(url, path, {"prompt": prompt, "eos": False,
                                       "max_new_tokens": SERVE_NEW})
        except Exception as e:   # reported below
            errors.append(f"{path}: {e!r}")

    try:
        t = time.perf_counter()
        threads = [threading.Thread(target=go, args=(i, path, p))
                   for i, (path, p) in enumerate(jobs)]
        for x in threads:
            x.start()
        for x in threads:
            x.join(timeout=HTTP_WAIT)
        wall = time.perf_counter() - t
        health = _http(url, "/health")
    finally:
        httpd.shutdown()
        srv.shutdown()
        th.join(timeout=HTTP_WAIT)
    check(not errors and len(out) == len(jobs),
          f"phase 4g server: {len(out)} of {len(jobs)} answered; {errors}")
    gens = [out[i] for i, (path, _) in enumerate(jobs) if path == "/generate"]
    streams = [out[i] for i, (path, _) in enumerate(jobs)
               if path != "/generate"]
    check(all(len(g["tokens"]) == SERVE_NEW for g in gens),
          "phase 4g server: a /generate answer lacks its tokens")
    check(all([x["token"] for x in s if "token" in x] == s[-1]["tokens"]
              and len(s[-1]["tokens"]) == SERVE_NEW for s in streams),
          "phase 4g server: a stream's lines differ from its final tokens")
    check(health["status"] == "ok" and health["compiles_since_warmup"] == 0,
          f"phase 4g server: /health {health}")
    totals = [g["stats"]["total_s"] for g in gens]
    print(f"phase 4g server: {len(gens)} /generate and {len(streams)} "
          f"/generate_stream answered in {wall:.3f} s, streams equal their "
          f"final tokens; wall a request {sum(totals) / len(totals):.3f} s "
          f"(server, ttft {sum(g['stats']['ttft_s'] for g in gens) / len(gens):.3f} s)"
          f" against {exec_wall:.3f} s (the Executor's 7 requests without "
          f"reuse); /health compiles_since_warmup "
          f"{health['compiles_since_warmup']}, kv {json.dumps(health['kv'])}",
          flush=True)
    full = InferenceServer(llm, max_queue_size=2, **geo)
    full.shutdown()
    for p in others[:2]:
        full.executor.submit(p, max_new_tokens=SERVE_NEW)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(full))
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    code = None
    try:
        _http(f"http://127.0.0.1:{httpd.server_address[1]}", "/generate",
              {"prompt": first, "max_new_tokens": 4})
    except urllib.error.HTTPError as e:
        code = e.code
    finally:
        httpd.shutdown()
        th.join(timeout=HTTP_WAIT)
    print(f"phase 4g server with max_queue_size=2 and 2 queued: HTTP {code}",
          flush=True)
    check(code == 503, f"phase 4g: a full queue answered {code}, not 503")
    del srv, full


def serve_serving(torch, params, cfg, seed: int, dev):
    """Phase 4g: the 8 requests (7 sharing the first one's 512-token
    prefix) through a warmed Executor without reuse, then through one with
    it (``reuse_run``); the adopted pages card against a cold prefill at 2
    layers (``adopted_pages_check``); per-request controls
    (``controls_run``); cancel and snapshot/restore (``surface_run``);
    the HTTP server (``serve_http``). Returns (the launches of the reuse
    run's second wave, those of the 2-layer suffix)."""
    first, others, _ = serving_prompts(seed, cfg.vocab_size)
    runs = {}
    for reuse in (False, True):
        ex = serving_executor(params, cfg, seed, dev, reuse)
        t = time.perf_counter()
        ex.warmup(burst=BURST)
        torch.cuda.synchronize()
        w = time.perf_counter() - t
        runs[reuse] = r = reuse_run(torch, ex, first, others)
        r.update(warmup=w, compiles=ex.compiles_since_warmup)
        if not reuse:
            del ex
            torch.cuda.empty_cache()
    cold, warm = runs[False], runs[True]
    for name, r in (("cold", cold), ("reuse", warm)):
        check(all(len(g) == SERVE_NEW for g in r["toks"] + [r["first"]]),
              f"phase 4g ({name}): not every request got {SERVE_NEW} tokens")
        check(r["graph_replays"] == r["decode_calls"] > 0,
              f"phase 4g ({name}): {r['graph_replays']} replays for "
              f"{r['decode_calls']} decode calls")
        check(r["compiles"] == 0, f"phase 4g ({name}): {r['compiles']} "
              "programs made after warmup")
        check(r["streamed"], f"phase 4g ({name}): on_token's tokens differ "
              "from generated")
    saved = cold["prefill_tokens"] - warm["prefill_tokens"]
    same = sum(a == b for g, w in zip(warm["toks"], cold["toks"])
               for a, b in zip(g, w))
    ttft = {n: sum(r["ttft"]) / len(r["ttft"]) for n, r in
            (("cold", cold), ("reuse", warm))}
    print(f"phase 4g reuse: warmup {warm['warmup']:.1f} s; the first request "
          f"({len(first)} tokens) then 7 sharing its first {SHARED} "
          f"({min(map(len, others))}-{max(map(len, others))} tokens): "
          f"{warm['reused_blocks']} blocks adopted, prefill tokens "
          f"{cold['prefill_tokens']} cold -> {warm['prefill_tokens']} "
          f"(saved {saved}); mean TTFT of the 7 {ttft['cold'] * 1e3:.1f} -> "
          f"{ttft['reuse'] * 1e3:.1f} ms, wall {cold['wall'] * 1e3:.1f} -> "
          f"{warm['wall'] * 1e3:.1f} ms; {same} of "
          f"{SERVE_NEW * len(others)} tokens equal to the cold run's (a "
          f"reading: the suffix prefill runs K2 at other row counts)",
          flush=True)
    traced = traced_suffix(torch, ex, first, seed)
    print(f"phase 4g traced: 2 more requests over the shared prefix "
          f"({traced['adopted']} blocks adopted), traced in their prefill: "
          f"K6 {traced['write_chunk_kernel']}, K8 "
          f"{traced['prefill_wgmma_kernel']}", flush=True)
    check(warm["reused_blocks"] == 7 * SHARED // SERVE_KW["block_size"],
          f"phase 4g: {warm['reused_blocks']} blocks adopted, not "
          f"{7 * SHARED // SERVE_KW['block_size']}")
    check(saved == 7 * SHARED, f"phase 4g: prefill tokens fell by {saved}, "
          f"not {7 * SHARED}")
    check(traced["adopted"] == 2 * SHARED // SERVE_KW["block_size"]
          and traced["write_chunk_kernel"] > 0
          and traced["prefill_wgmma_kernel"] > 0,
          f"phase 4g: K6 or K8 not traced in a prefill after adopted pages "
          f"({traced})")
    launches = warm["launches"]
    print(f"main path serving launches: {json.dumps(launches)}", flush=True)
    for name in ON_PATH["serving"]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path serving")
    for name in OFF_PATH["serving"]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path serving")
    adopted = adopted_pages_check(torch, params, cfg, seed, dev)
    controls_run(torch, ex, others)
    surface_run(torch, params, cfg, seed, dev, ex, others)
    exec_wall = sum(cold["req_wall"]) / len(cold["req_wall"])
    del ex
    torch.cuda.empty_cache()
    serve_http(torch, params, cfg, seed, dev, exec_wall)
    torch.cuda.empty_cache()
    return launches, adopted


# ---------------------------------------------------------------------------
# phase 4h: the quantization pipeline at Llama-2-7B (HF directory ->
# calibrated act_scales -> checkpoint -> LLM -> perplexity)
# ---------------------------------------------------------------------------

HF_OUTLIERS = 128              # planted channels a layer, from 128..4095
CALIB_BATCHES, CALIB_ROWS, CALIB_LEN = 4, 1, 512
PPL_BLOCKS, PPL_LEN, PPL_BATCH = 32, 512, 8     # the reference's headline
HF_DISK_BYTES = 28e9           # the F16 directory and two checkpoints
ERR_RATIO = 3.0                # control's error / calibrated's, least
# depths of the logits-error reading; ERR_RATIO is enforced at the first
# and at every layer's own update (layer_errors). At random N(0, 0.02)
# weights with the planted gain every error compounds with depth until
# both models' logits are far from the float model's, so the logits' ratio
# shrinks with depth: past the first the check is that the control stays
# the worse
ERR_DEPTHS = (2, 4, 8, 16, 32)
QUANT_XDEV_LAYERS = 2
# the card's act_scales distance from an f32 calibration, over the CPU bf16
# run's, most (a module's largest channel difference over its largest value)
XDEV_F32_RATIO = 2.0
# kernels of the pipeline's forwards, by a mark of their traced names
CALIB_TRACED = {"flash_causal_kernel": "K14"}
PPL_TRACED = {"norm_quant": "K1", "mixed_wgmma_kernel": "K2",
              "wo_wgmma_kernel": "K4", "flash_causal_kernel": "K14"}


def traced_names(torch, fn) -> set:
    """The names of the device kernels one call of ``fn`` runs, under
    torch.profiler (traced again, up to 3 times, when a window comes back
    without device activity, as in device_ms)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    names = set()
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return names


class StepWalls:
    """Wraps module functions so that each call's wall (to a synchronize)
    is recorded under its label, in call order."""

    def __init__(self, torch):
        self.torch, self.walls, self._undo = torch, {}, []

    def wrap(self, module, name: str, label: str = "") -> None:
        real = getattr(module, name)

        def timed(*a, **kw):
            t = time.perf_counter()
            out = real(*a, **kw)
            self.torch.cuda.synchronize()
            self.walls.setdefault(label or name, []).append(
                time.perf_counter() - t)
            return out
        setattr(module, name, timed)
        self._undo.append((module, name, real))

    def restore(self) -> None:
        for module, name, real in reversed(self._undo):
            setattr(module, name, real)
        self._undo.clear()


def _check_traced(names: set, marks: dict, where: str) -> None:
    for mark, k in marks.items():
        check(any(mark in n for n in names),
              f"phase 4h: {k} ({mark}) not traced in {where}: "
              f"{sorted(names)}")


def _rel_rms(got, want) -> float:
    d = (got.double() - want.double())
    return float(d.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt())


def _two_layer_view(hf_dir: str, path: str) -> str:
    """The HF directory at its first QUANT_XDEV_LAYERS layers: the same
    shard files (links), a config.json with fewer layers."""
    os.makedirs(path)
    for f in os.listdir(hf_dir):
        if f != "config.json":
            os.symlink(os.path.join(hf_dir, f), os.path.join(path, f))
    with open(os.path.join(hf_dir, "config.json")) as f:
        cfg = json.load(f)
    cfg["num_hidden_layers"] = QUANT_XDEV_LAYERS
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    return path


# decoder_layer's stats, in the order it reads them, and each one's key
# in an act_scales artifact
STAT_KEYS = {"qkv_proj": "self_attn.q_proj", "o_proj": "self_attn.o_proj",
             "gate_up_proj": "mlp.gate_proj", "down_proj": "mlp.down_proj"}


def captured_calibration(torch, params, cfg, batches):
    """calibrate_act_scales over ``batches``, recording what each forward
    reads: every linear's input {(layer, module): [(tokens, in) f32 a
    batch]} and each layer's attention q, k {layer: [((B, S, H, D) f32,
    ...) a batch]}, on the CPU."""
    from mixq_tensorrt_llm_tpu_torch.convert import calibrate as calib
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.ops import attention as oa
    ins, qks = [], []
    real_abs, real_attn = mc._absmax_in, oa.causal_self_attention

    def absmax(x):
        ins.append(x.detach().float().reshape(-1, x.shape[-1]).cpu())
        return real_abs(x)

    def attention(q, k, v, *a, **kw):
        qks.append((q.detach().float().cpu(), k.detach().float().cpu()))
        return real_attn(q, k, v, *a, **kw)

    mc._absmax_in, oa.causal_self_attention = absmax, attention
    try:
        scales = calib.calibrate_act_scales(params, cfg, batches)
    finally:
        mc._absmax_in, oa.causal_self_attention = real_abs, real_attn
    n, nb = cfg.num_layers, len(batches)
    acts = {(i, m): [ins[(b * n + i) * len(STAT_KEYS) + j] for b in range(nb)]
            for i in range(n) for j, m in enumerate(STAT_KEYS)}
    return scales, acts, {i: [qks[b * n + i] for b in range(nb)]
                          for i in range(n)}


def locate_difference(torch, runs: dict, layer: int, mod: str, ch: int,
                 cfg) -> str:
    """Where each run's largest |value| of input channel ``ch`` of
    ``mod`` at ``layer`` lies (batch, token), every run's value at the
    token of the largest, and, for o_proj (its input is the attention
    output, channel ``ch`` in head ch // head_dim), that head's attention
    row at the token in every run: its two heaviest keys, their logit gap
    and their softmax weights. ``runs``: {name: (acts, qks)} of
    captured_calibration, one row a batch."""
    at = {}
    for name, (acts, _) in runs.items():
        col = torch.stack([a[:, ch].abs() for a in acts[(layer, mod)]])
        b, t = divmod(int(col.argmax()), col.shape[1])
        at[name] = (b, t, float(col[b, t]))
    out = ["largest |x| " + ", ".join(f"{n} {v:.5g} at ({b}, {t})"
                                      for n, (b, t, v) in at.items())]
    b, t, _ = max(at.values(), key=lambda x: x[2])
    out.append(f"at ({b}, {t}) " + ", ".join(
        f"{n} {float(acts[(layer, mod)][b][t, ch]):.5g}"
        for n, (acts, _) in runs.items()))
    if mod == "o_proj":
        h = ch // cfg.head_dim
        hk = h * cfg.num_kv_heads // cfg.num_heads
        for name, (_, qks) in runs.items():
            q, k = qks[layer][b]
            logit = (k[0, :t + 1, hk].double() @ q[0, t, h].double()
                     ) * cfg.attention_scale
            top = torch.topk(logit, 2)
            w = torch.softmax(logit, 0)[top.indices]
            out.append(f"{name}: head {h} keys {top.indices.tolist()} "
                       f"logits {top.values[0]:.4f} / {top.values[1]:.4f} "
                       f"(gap {float(top.values[0] - top.values[1]):.4f}) "
                       f"weights {w[0]:.4f} / {w[1]:.4f}")
        # the first two runs' q and k there: how far apart, against a bf16
        # step (2^-8 of a value)
        (q0, k0), (q1, k1) = (qks[layer][b] for _, qks in
                              list(runs.values())[:2])
        keys = top.indices
        for what, x0, x1 in (("q at the token", q0[0, t, h], q1[0, t, h]),
                             ("k of the two keys", k0[0, keys, hk],
                              k1[0, keys, hk])):
            rel = float((x0 - x1).abs().max() / x0.abs().max())
            out.append(f"{what} differs between "
                       f"{' and '.join(list(runs)[:2])} in "
                       f"{int((x0 != x1).sum())} of {x0.numel()} values, by "
                       f"{rel:.2e} of its largest at most")
    return "; ".join(out)


def quant_cross_device(torch, hf_dir, tmp, card_flat, card_scales, quant,
                       calib_batches, dev) -> None:
    """Phase 4h at QUANT_XDEV_LAYERS layers of the same directory, the card
    against the CPU: the card's act_scales quantized on the CPU give
    bit-equal int8 weights, fp_ind, fp_weight (and embeddings, norms, head),
    scale_col within 1e-6 relative. Then the same batches calibrate three
    times, their inputs recorded: on the card (bf16, as the pipeline), on
    the CPU in bf16 and on the CPU in f32 (the witness: hidden states, q,
    k and attention in f32; linear inputs rounded to bf16 as everywhere).
    For each module, readings of the largest channel difference over the
    largest value: card - CPU bf16 (printed beside a 2e-2 target), card
    - f32 and CPU bf16 - f32. Held: card - CPU bf16 within 2e-2 relative
    RMS and, at its largest channel, within the CPU bf16 run's own
    distance from f32; the card within XDEV_F32_RATIO x that distance of
    f32. The largest card - CPU difference is located
    (locate_difference). The CPU's bf16 calibration picks the card's
    outliers for qkv and gate_up; o_proj's picks differ only at channels
    whose top-k membership the bf16 spread makes ambiguous."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as ckpt
    from mixq_tensorrt_llm_tpu_torch.convert import hf
    from mixq_tensorrt_llm_tpu_torch.models import registry
    from mixq_tensorrt_llm_tpu_torch.quant import QuantConfig
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    two = _two_layer_view(hf_dir, os.path.join(tmp, "hf2"))
    n, k_out = QUANT_XDEV_LAYERS, quant.num_outliers
    scales = {k: v for k, v in card_scales.items()
              if int(k.split(".")[2]) < n}
    t = time.perf_counter()
    hf.quantize_hf_model(two, os.path.join(tmp, "cpu2"), quant,
                         act_scales=scales, device="cpu")
    wall_q = time.perf_counter() - t
    cpu = ckpt.read_safetensors(os.path.join(tmp, "cpu2",
                                             "model.safetensors"))
    check(sorted(cpu) == sorted(card_flat),
          "phase 4h cross-device: the CPU checkpoint has other tensors")
    worst_col = 0.0
    for name, want in cpu.items():
        got = card_flat[name]
        if name.startswith("layers."):
            got = got[:n]
        if name.endswith("scale_col"):
            rel = float(((got - want).abs() / want.abs()).max())
            worst_col = max(worst_col, rel)
            check(rel <= 1e-6, f"phase 4h cross-device: {name} {rel:.3e} "
                  "relative from the CPU's")
        else:
            check(torch.equal(got, want), f"phase 4h cross-device: {name} "
                  "differs from the CPU's")
    print(f"phase 4h cross-device ({n} layers of the same directory): "
          f"quantized on the CPU from the card's act_scales in {wall_q:.1f} "
          f"s: int8 qweight, fp_ind, fp_weight, embeddings, norms and head "
          f"bit-equal, scale_col within {worst_col:.3e} relative (limit "
          f"1e-6)", flush=True)

    cfg = dataclasses.replace(registry.config_from_hf(hf.load_hf_config(two)),
                              quant=QuantConfig())
    sd = hf.load_hf_state_dict(two)
    runs, got, walls = {}, {}, {}
    for name, device, dtype in (("card", dev, cfg.dtype),
                                ("cpu", torch.device("cpu"), cfg.dtype),
                                ("f32", torch.device("cpu"), torch.float32)):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = registry.params_from_hf(c, sd, device=device)
        t = time.perf_counter()
        got[name], *runs[name] = captured_calibration(torch, params, c,
                                                      calib_batches)
        walls[name] = time.perf_counter() - t
        del params
    check(all(torch.equal(got["card"][k], v) for k, v in scales.items()),
          "phase 4h cross-device: the card's 2-layer calibration is not the "
          "pipeline's bit for bit")

    def rel_max(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rows = {}
    for i in range(n):
        for mod, ref_key in STAT_KEYS.items():
            key = f"model.layers.{i}.{ref_key}"
            card, cpu_, f32 = (got[r][key] for r in ("card", "cpu", "f32"))
            rows[(i, mod)] = dict(
                xdev=rel_max(card, cpu_), rms=_rel_rms(card, cpu_),
                card_f32=rel_max(card, f32), cpu_f32=rel_max(cpu_, f32),
                ch=int((card - cpu_).abs().argmax()))
    print(f"phase 4h act_scales, {len(calib_batches)} x "
          f"{calib_batches[0].shape[1]} tokens (walls: card "
          f"{walls['card']:.1f} s, CPU bf16 {walls['cpu']:.1f} s, CPU f32 "
          f"{walls['f32']:.1f} s); a module's max |a - b| / max |b| for "
          f"card - CPU bf16 [relative RMS], card - f32, CPU bf16 - f32: "
          + "; ".join(f"{i}.{m} {r['xdev']:.3e} [{r['rms']:.2e}] "
                      f"{r['card_f32']:.3e} {r['cpu_f32']:.3e}"
                      for (i, m), r in rows.items()), flush=True)
    worst = max(rows, key=lambda key: rows[key]["xdev"])
    print(f"phase 4h act_scales: the largest card - CPU difference, "
          f"{rows[worst]['xdev']:.3e} (target 2e-2), is layer "
          f"{worst[0]}'s {worst[1]} input channel {rows[worst]['ch']}: "
          + locate_difference(torch, runs, *worst, rows[worst]['ch'], cfg),
          flush=True)
    for (i, mod), r in rows.items():
        where = f"phase 4h cross-device: act_scales of layer {i}'s {mod}"
        check(r["rms"] <= 2e-2, f"{where}: {r['rms']} relative RMS from "
              "the CPU's, above 2e-2")
        check(r["xdev"] <= r["cpu_f32"], f"{where}: the card's largest "
              f"channel difference from the CPU's bf16 run, {r['xdev']}, "
              f"is above that run's own from f32, {r['cpu_f32']}")
        check(r["card_f32"] <= XDEV_F32_RATIO * r["cpu_f32"], f"{where}: "
              f"the card is {r['card_f32']} from f32, above "
              f"{XDEV_F32_RATIO} x the CPU bf16 run's {r['cpu_f32']}")

    picks = []
    for i in range(n):
        for mod in ("qkv_proj", "gate_up_proj"):
            check(torch.equal(qcore.select_outliers(
                got["cpu"][f"model.layers.{i}.{STAT_KEYS[mod]}"], k_out),
                card_flat[f"layers.{mod}.fp_ind"][i]),
                f"phase 4h cross-device: the CPU calibration picks other "
                f"outliers for layer {i}'s {mod}")
        key = f"model.layers.{i}.self_attn.o_proj"
        v = {r: got[r][key] for r in ("card", "cpu", "f32")}
        sel = {r: set(qcore.select_outliers(x, k_out).tolist())
               for r, x in v.items()}
        kth = {r: float(torch.sort(x, descending=True).values[k_out - 1])
               for r, x in v.items()}
        # a channel is ambiguous where its distance from the CPU's k-th
        # value is within what two bf16 runs can move both: twice its own
        # and the k-th value's distance from f32 in the CPU bf16 run
        spread = (v["cpu"] - v["f32"]).abs() + abs(kth["cpu"] - kth["f32"])
        ambiguous = (v["cpu"] - kth["cpu"]).abs() <= 2 * spread
        sure = [c for c in sel["card"] ^ sel["cpu"] if not ambiguous[c]]
        check(not sure, f"phase 4h cross-device: layer {i}'s o_proj picks "
              f"differ at channels {sure}, outside their bf16 band")
        picks.append(f"layer {i}: {int(ambiguous.sum())} ambiguous "
                     f"channels; picked by one of card / CPU bf16 "
                     f"{len(sel['card'] ^ sel['cpu'])}, of CPU bf16 / f32 "
                     f"{len(sel['cpu'] ^ sel['f32'])}, of card / f32 "
                     f"{len(sel['card'] ^ sel['f32'])}")
    print(f"phase 4h cross-device: the CPU's bf16 calibration picks the "
          f"card's outliers for qkv and gate_up; o_proj's {k_out} picks "
          f"differ only at ambiguous channels (within twice the CPU bf16 "
          f"run's distance from f32, the channel's and the k-th value's, "
          f"of the k-th value): " + "; ".join(picks), flush=True)


def layer_errors(torch, float_params, cfg_f, models, tokens) -> list:
    """Each layer's residual update (its output less its input), given the
    float model's input to that layer, for each of ``models`` ([(params,
    cfg)], or (params, cfg, dynamic outlier state), whose layers then take
    the adaptive path and update the state) against the float layer's:
    [(relative RMS a model, ...) a layer]. Errors do not compound across
    layers here, as they do in the logits."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.ops import attention as oa
    b, s = tokens.shape
    pos = torch.arange(s, dtype=torch.int32, device=tokens.device)[None]
    sin, cos, _ = mc._positional_arrays(cfg_f, pos.expand(b, s))

    def layer(cfg, lp, x, ostate=(), i=None):
        def attend(q, k, v):        # full_prefill's attention, no cache
            return oa.causal_self_attention(q, k, v, scale=cfg.attention_scale,
                                            window=cfg.sliding_window)
        st = None
        if ostate:
            st = {m: v[i] for m, v in ostate[0].items()}
        out = mc.decoder_layer(cfg, lp, x, sin, cos, attend, ostate=st)
        for m, v in (st or {}).items():
            ostate[0][m][i] = v
        return out

    x = mc._embed(float_params, cfg_f, tokens)
    out = []
    for i, lp in enumerate(float_params["layers"]):
        y = layer(cfg_f, lp, x)
        want = y.float() - x.float()
        out.append(tuple(
            _rel_rms(layer(m[1], m[0]["layers"][i], x, m[2:], i).float()
                     - x.float(), want) for m in models))
        x = y
    return out


def quantize_pipeline(torch, seed: int, dev, config=None) -> dict:
    """Phase 4h: an F16 HF Llama-2-7B directory (random N(0, 0.02) weights
    from ``seed``, 128 planted outlier channels a layer) through the
    port's pipeline on the card: calibrate, quantize and save
    (quantize_hf_model), LLM over the directory twice (the second loads
    from its cache and writes nothing), perplexity over 32 blocks of 512
    tokens at batch 8 on the float model, the calibrated int8_mix model
    (fresh K/V and through the int8 cache) and an uncalibrated control
    (requantize, all-ones act_scales), the logits error of both quantized
    models against the float one, and each layer's own error
    (layer_errors). Returns the launches of the calibration and of the
    int8_mix perplexity run."""
    import dataclasses
    import resource
    import shutil
    import tempfile
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch import api
    from mixq_tensorrt_llm_tpu_torch.convert import calibrate as calib
    from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as ckpt
    from mixq_tensorrt_llm_tpu_torch.convert import hf
    from mixq_tensorrt_llm_tpu_torch.convert.from_float import requantize
    from mixq_tensorrt_llm_tpu_torch.eval import ppl
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import registry
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo,
                                                   QuantAlgo, QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    config = config or random_hf.LLAMA2_7B_HF
    layers = config["num_hidden_layers"]
    quant = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=HF_OUTLIERS,
                        kv_cache=KVCacheQuantAlgo.INT8)
    rng = np.random.default_rng(seed + 4)
    vocab = config["vocab_size"]
    calib_batches = [rng.integers(1, vocab, (CALIB_ROWS, CALIB_LEN)).astype(
        np.int32) for _ in range(CALIB_BATCHES)]
    stream = rng.integers(1, vocab, PPL_BLOCKS * PPL_LEN).tolist()
    walls, launches, traced = {}, {}, {}
    tmp = tempfile.mkdtemp(prefix="mixq-phase4h-")
    try:
        free = shutil.disk_usage(tmp).free
        check(free >= HF_DISK_BYTES, f"phase 4h: {free / 1e9:.1f} GB free "
              f"under {tmp}; the phase needs {HF_DISK_BYTES / 1e9:.0f} GB "
              "(an F16 Llama-2-7B directory and two int8_mix checkpoints)")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        hf_dir = os.path.join(tmp, "hf")
        t = time.perf_counter()
        planted = random_hf.write_random_llama(hf_dir, config, seed=seed,
                                               device=dev,
                                               outliers=HF_OUTLIERS)
        walls["write"] = time.perf_counter() - t
        files = sorted(os.listdir(hf_dir))
        size = sum(os.path.getsize(os.path.join(hf_dir, f)) for f in files)
        print(f"phase 4h: wrote an HF Llama-2-7B directory ({layers} "
              f"layers, F16, {sum(f.endswith('.safetensors') for f in files)}"
              f" shards with model.safetensors.index.json, {size / 1e9:.2f} "
              f"GB; {free / 1e9:.1f} GB were free) in {walls['write']:.1f} s",
              flush=True)

        # 1. calibrate, quantize and save on the card
        ck1 = os.path.join(tmp, "ckpt")
        real_cal = calib.calibrate_act_scales

        def calibrate(params, cfg, batches, **kw):
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = real_cal(params, cfg, batches, **kw)
            torch.cuda.synchronize()
            walls["calibrate"] = time.perf_counter() - t0
            launches["calibrate"] = dict(_build.LAUNCHES)
            traced["calibrate"] = traced_names(
                torch, lambda: real_cal(params, cfg, batches[:1]))
            return out

        steps = StepWalls(torch)
        steps.wrap(registry, "params_from_hf")
        steps.wrap(hf, "save_checkpoint")
        calib.calibrate_act_scales = calibrate
        try:
            t = time.perf_counter()
            hf.quantize_hf_model(hf_dir, ck1, quant,
                                 calib_batches=calib_batches, device=dev)
            walls["quantize_hf_model"] = time.perf_counter() - t
        finally:
            calib.calibrate_act_scales = real_cal
            steps.restore()
        (build_float, build_q), (save,) = (steps.walls["params_from_hf"],
                                           steps.walls["save_checkpoint"])
        print(f"phase 4h quantize_hf_model: {walls['quantize_hf_model']:.1f}"
              f" s = float model from the files {build_float:.1f} s + "
              f"calibrate ({CALIB_BATCHES} x {CALIB_ROWS} x {CALIB_LEN} "
              f"tokens) {walls['calibrate']:.2f} s + quantize from the files "
              f"{build_q:.1f} s + save {save:.1f} s (+ a traced calibration "
              f"batch); calibration launches "
              f"{json.dumps(launches['calibrate'])}", flush=True)
        _check_traced(traced["calibrate"], CALIB_TRACED, "the calibration")
        check(launches["calibrate"].get("flash_causal_attention", 0)
              == CALIB_BATCHES * layers, "phase 4h: K14 did not launch "
              "once a layer a calibration batch")
        flat = ckpt.read_safetensors(os.path.join(ck1, "model.safetensors"))
        for mod in ("qkv_proj", "gate_up_proj"):
            fp = flat[f"layers.{mod}.fp_ind"].long()
            bad = [i for i in range(layers)
                   if not torch.equal(fp[i], planted[i])]
            check(not bad, f"phase 4h: calibrated {mod} fp_ind is not the "
                  f"planted set at layers {bad}")
        card_scales = calib.load_act_scales(os.path.join(ck1,
                                                         "act_scales.npz"))
        print(f"phase 4h: calibrated fp_ind of qkv_proj and gate_up_proj "
              f"equal the planted channels in all {layers} layers (none "
              f"below {HF_OUTLIERS}: all-ones scales pick 0.."
              f"{HF_OUTLIERS - 1})",
              flush=True)

        # 2. LLM over the HF directory, twice: the second only loads
        kw = dict(quant="int8_mix", kv_cache_quant="int8",
                  act_scales_path=os.path.join(ck1, "act_scales.npz"),
                  cache_dir=os.path.join(tmp, "cache"), max_seq_len=PPL_LEN,
                  device=dev)
        t = time.perf_counter()
        llm = api.LLM(hf_dir, **kw)
        torch.cuda.synchronize()
        walls["llm_quantize"] = time.perf_counter() - t
        ck2 = llm._ckpt_dir
        stamps = {f: os.stat(os.path.join(ck2, f)).st_mtime_ns
                  for f in os.listdir(ck2)}
        del llm
        torch.cuda.empty_cache()
        real_q, calls = hf.quantize_hf_model, []

        def quantize(*a, **k):
            calls.append(a)
            return real_q(*a, **k)

        hf.quantize_hf_model = quantize
        try:
            t = time.perf_counter()
            llm = api.LLM(hf_dir, **kw)
            torch.cuda.synchronize()
            walls["load"] = time.perf_counter() - t
        finally:
            hf.quantize_hf_model = real_q
        check(llm._ckpt_dir == ck2 and not calls and stamps == {
            f: os.stat(os.path.join(ck2, f)).st_mtime_ns
            for f in os.listdir(ck2)}, "phase 4h: the second LLM over the "
              "directory quantized or wrote its cache again")
        other = ckpt.read_safetensors(os.path.join(ck2, "model.safetensors"))
        diff = sorted(set(flat) ^ set(other)) + [
            n for n in flat if n in other and not torch.equal(flat[n],
                                                              other[n])]
        check(not diff, f"phase 4h: the LLM's checkpoint differs from "
              f"quantize_hf_model's: {diff[:5]}")
        print(f"phase 4h LLM(hf_dir, quant=int8_mix, kv_cache_quant=int8, "
              f"act_scales_path=...): first {walls['llm_quantize']:.1f} s "
              f"(quantize, save, load), second {walls['load']:.1f} s (load "
              f"only: no quantize_hf_model call, every file's mtime "
              f"unchanged); its checkpoint equals step 1's tensor for tensor "
              f"({len(flat)} tensors)", flush=True)
        del other

        # the float model and the uncalibrated control (all-ones scales)
        cfg_q = llm.cfg
        cfg_f = dataclasses.replace(cfg_q, quant=QuantConfig())
        t = time.perf_counter()
        float_params = registry.params_from_hf(
            cfg_f, hf.load_hf_state_dict(hf_dir), device=dev)
        control, _ = requantize(float_params, cfg_f, quant)
        torch.cuda.synchronize()
        walls["float_and_control"] = time.perf_counter() - t

        # 3. perplexity: 32 blocks x 512 tokens at batch 8
        runs = [("float", float_params, cfg_f, True),
                ("int8_mix", llm.params, cfg_q, True),
                ("int8_mix through the int8 KV cache", llm.params, cfg_q,
                 False),
                ("uncalibrated control", control, cfg_q, True)]
        ppls = {}
        for name, params, cfg, full in runs:
            torch.cuda.synchronize()
            _build.reset_launches()
            res = ppl.evaluate_ppl(params, cfg, stream, seq_len=PPL_LEN,
                                   batch_size=PPL_BATCH, full_prefill=full)
            seen = dict(_build.LAUNCHES)
            if name == "int8_mix":
                launches["ppl"] = seen
            ppls[name] = res
            check(math.isfinite(res.ppl) and res.blocks == PPL_BLOCKS,
                  f"phase 4h: {name} ppl {res.ppl} over {res.blocks} blocks")
            print(f"phase 4h ppl, {name}: {res.ppl:.2f} over {res.blocks} "
                  f"blocks x {PPL_LEN} (batch {PPL_BATCH}); wall "
                  f"{res.elapsed_s:.3f} s, {res.blocks_per_s:.2f} blocks/s, "
                  f"{res.tokens_per_s:.1f} tokens/s; launches "
                  f"{json.dumps(seen)}", flush=True)
        blocks = torch.tensor(stream, device=dev).view(PPL_BLOCKS, PPL_LEN)
        traced["ppl"] = traced_names(torch, lambda: ppl.block_nll(
            llm.params, cfg_q, blocks[:PPL_BATCH]))
        _check_traced(traced["ppl"], PPL_TRACED, "the int8_mix ppl forward")
        for name in ON_PATH["hf"]:
            check(launches["ppl"].get(name, 0) > 0,
                  f"phase 4h: {name} was not launched in the int8_mix ppl "
                  "run")
        for name in OFF_PATH["hf"]:
            check(launches["ppl"].get(name, 0) == 0,
                  f"phase 4h: {name} was launched in the int8_mix ppl run")

        # the logits error of both quantized models on one batch, the
        # models cut to their first n layers
        def logits(params, cfg, n):
            b, s = PPL_BATCH, PPL_LEN
            cfg = dataclasses.replace(cfg, num_layers=n)
            out, _ = mc.forward(
                dict(params, layers=params["layers"][:n]), cfg, blocks[:b],
                torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
                    b, s), mc.init_kv_cache(cfg, b, s, device=dev),
                torch.full((b,), s, dtype=torch.int32, device=dev),
                full_prefill=True)
            return out

        errs = {}
        for n in (d for d in ERR_DEPTHS if d <= layers):
            want = logits(float_params, cfg_f, n)
            errs[n] = (_rel_rms(logits(llm.params, cfg_q, n), want),
                       _rel_rms(logits(control, cfg_q, n), want))
            del want
        print(f"phase 4h logits against the float model ({PPL_BATCH} x "
              f"{PPL_LEN}), relative RMS error at the first n layers, "
              f"calibrated int8_mix / uncalibrated control: " + "; ".join(
                  f"n = {n}: {q:.4e} / {c:.4e} ({c / q:.2f}x)"
                  for n, (q, c) in errs.items()), flush=True)
        first = min(errs)
        err_q, err_c = errs[first]
        check(err_c >= ERR_RATIO * err_q, f"phase 4h: at {first} layers the "
              f"uncalibrated control's logits error {err_c} is not "
              f"{ERR_RATIO}x the calibrated model's {err_q}")
        check(all(c > q for q, c in errs.values()), "phase 4h: the "
              "uncalibrated control is not the worse at every depth")
        per_layer = layer_errors(torch, float_params, cfg_f,
                                 [(llm.params, cfg_q), (control, cfg_q)],
                                 blocks[:PPL_BATCH])
        ratios = [c / q for q, c in per_layer]
        print(f"phase 4h each layer's update against the float layer's, "
              f"given the float model's input ({PPL_BATCH} x {PPL_LEN}), "
              f"relative RMS, calibrated / control (ratio), layers 0.."
              f"{len(per_layer) - 1}: " + "; ".join(
                  f"{q:.3e} / {c:.3e} ({c / q:.2f}x)" for q, c in per_layer)
              + f"; ratio least {min(ratios):.2f}x at layer "
              f"{ratios.index(min(ratios))}", flush=True)
        check(min(ratios) >= ERR_RATIO, f"phase 4h: at layer "
              f"{ratios.index(min(ratios))} the uncalibrated control's "
              f"update error is {min(ratios)}x the calibrated model's, not "
              f"{ERR_RATIO}x")
        del float_params, control, llm
        torch.cuda.empty_cache()

        quant_cross_device(torch, hf_dir, tmp, flat, card_scales, quant,
                           calib_batches, dev)
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
        print(f"phase 4h walls: write {walls['write']:.1f} s, calibrate "
              f"{walls['calibrate']:.2f} s, quantize and save "
              f"{build_q + save:.1f} s, LLM load {walls['load']:.1f} s, ppl "
              f"(int8_mix) {ppls['int8_mix'].elapsed_s:.3f} s; peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"host max RSS {rss:.2f} GiB", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    total = dict(launches["calibrate"])
    for n, c in launches["ppl"].items():
        total[n] = total.get(n, 0) + c
    return total


def drop_tail(f):
    """A beam-burst fault: the merge leaves out the dense tail's part."""
    return lambda parts: f(list(parts)[:1])


def double_l(f):
    """A K10 fault: its softmax denominator doubled."""
    def faulty(*a, **k):
        r = f(*a, **k)
        return (r[0], r[1], 2 * r[2]) if k.get("stats") else r
    return faulty


def cross_device_beam(torch, params, cfg, seed: int, dev) -> dict:
    """Phase 5d, 2 layers at full width: 2 lanes whose prompts of 5 and 9
    tokens are prefilled into the pool, then 4 steps of a beam burst's
    forward (runtime/beam._forward_with_tail, fixed tokens: tail slots 0
    to 3), the last step's logits card against CPU; the card must launch
    K10 and neither K7 nor K5 in the steps. Controls, enforced: the merge
    leaving out the tail, K10's l doubled. Returns the card run's
    launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models.common import forward_paged
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import ref
    from mixq_tensorrt_llm_tpu_torch.runtime import beam
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    cfg2, sub, sub_cpu = two_layers(torch, params, cfg)
    rng = np.random.default_rng(seed + 4)
    lens, steps = [5, 9], 4
    tokens = np.zeros((2, 16), np.int64)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(1, cfg.vocab_size, n)
    cur = rng.integers(1, cfg.vocab_size, (steps, 2))

    def run(device, p):
        def t_(a, dtype=torch.int32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)
        state = init_paged_kv(cfg2, 3, 128, device=device)
        table, bpos, plen = t_([[1], [2]]), t_([[0], [0]]), t_(lens)
        pos = torch.arange(16, dtype=torch.int32, device=device)[None]
        forward_paged(p, cfg2, t_(tokens), pos.expand(2, 16), state, table,
                      plen, last_pos=plen - 1)
        tails = beam._init_tail(cfg2, 2, steps, state.quantized, device, 2)
        _build.reset_launches()
        for t in range(steps):
            logits = beam._forward_with_tail(p, cfg2, t_(cur[t]),
                                             state.pools(), table, bpos,
                                             plen, tails, t)
        return [(logits[:, 0].float().cpu(), dict(_build.LAUNCHES))]

    return compare_devices(
        torch, "beam burst step", dev, run, sub, sub_cpu,
        [(f"burst step {steps} (tail slot {steps - 1}) over prefixes of "
          f"{lens} tokens", ("paged_decode_attention_stats", "wo_matmul"),
          ("paged_decode_attention", "paged_write_token"))],
        [("the merge leaving out the tail", True, ref,
          "merge_attention_stats", drop_tail),
         ("K10's l doubled", True, pa, "paged_decode_attention", double_l)])


def rows_at_qstart(f):
    """A K9 fault: every query row at position qstart (row 0's), so rows
    1.. lose their own key and the draft keys before it."""
    def faulty(q, kp, vp, ks, vs, tb, ln, qs, *a, **k):
        import torch
        return torch.cat([f(q[:, j:j + 1], kp, vp, ks, vs, tb, ln, qs, *a,
                            **k) for j in range(q.shape[1])], dim=1)
    return faulty


def cross_device_verify(torch, params, cfg, seed: int, dev) -> dict:
    """Phase 7, 2 layers at full width, card against CPU: one verify
    forward's logits at S = 4 (weight-only linears) and S = 5 (K1 -> K2)
    over a 24-token context, where one key carries weight; one decode
    step's logits with MIXQ_KV_SPLITS=4 after a 200-token prompt (a
    2-entry table in 4 ranges, two of them past it). Then the control,
    enforced: K9 with every row at qstart. Returns the card run's
    launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models.common import forward_paged
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    cfg2, sub, sub_cpu = two_layers(torch, params, cfg)
    rng = np.random.default_rng(seed + 2)
    ctx = 24
    context = rng.integers(1, cfg.vocab_size, ctx)
    rows = {s: rng.integers(1, cfg.vocab_size, s) for s in (4, 5)}
    prompt = rng.integers(1, cfg.vocab_size, 200)
    nxt = int(rng.integers(1, cfg.vocab_size))

    def step(device, p, t, start, state, table, length):
        t = torch.tensor(t, dtype=torch.int32, device=device)[None]
        pos = start + torch.arange(t.shape[1], dtype=torch.int32,
                                   device=device)[None]
        return forward_paged(p, cfg2, t, pos, state,
                             torch.tensor([table], dtype=torch.int32,
                                          device=device),
                             torch.tensor([length], dtype=torch.int32,
                                          device=device))[0]

    def run(device, p):
        out = []
        for s in (4, 5):
            state = init_paged_kv(cfg2, 4, 128, device=device)
            step(device, p, context, 0, state, [1], ctx)
            _build.reset_launches()
            x = step(device, p, rows[s], ctx, state, [1], ctx + s)
            out.append((x[0].float().cpu(), dict(_build.LAUNCHES)))
        state = init_paged_kv(cfg2, 4, 128, device=device)
        chunk = np.zeros(256, np.int64)
        chunk[:200] = prompt
        step(device, p, chunk, 0, state, [1, 2], 200)
        _build.reset_launches()
        with kv_splits(4):
            x = step(device, p, [nxt], 200, state, [1, 2], 201)
        return out + [(x[0, 0].float().cpu(), dict(_build.LAUNCHES))]

    return compare_devices(
        torch, "verify and split decode", dev, run, sub, sub_cpu,
        [(f"verify S=4 ({ctx}-token context)",
          ("paged_verify_attention", "wo_matmul"), ()),
         (f"verify S=5 ({ctx}-token context)",
          ("paged_verify_attention", "rmsnorm_quant_split", "mixed_matmul"),
          ()),
         ("split decode (MIXQ_KV_SPLITS=4, 200-token prompt)",
          ("paged_decode_attention_split",),
          ("paged_decode_attention", "paged_decode_attention_stats"))],
        [("K9 with every row at qstart", True, pa, "paged_verify_attention",
          rows_at_qstart)])


def drop_last_split(f):
    """A K7 fault: its in-kernel merge leaves out the last split that saw a
    key (through the wrapper's test hook, reset after the call)."""
    def faulty(*a, **k):
        from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
        pa.K7_MERGE_DROP = 1
        try:
            return f(*a, **k)
        finally:
            pa.K7_MERGE_DROP = 0
    return faulty


def faults_7b(torch):
    """Phase 5's controls. The K8 mask fault is subtle on purpose: its
    reading says how small a fault the check can see."""
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    k8 = (pa, "paged_prefill_attention")
    return [
        ("K8 output zeroed", True, *k8,
         lambda f: lambda *a, **k: torch.zeros_like(f(*a, **k))),
        ("K8 without the V scale", True, *k8,
         lambda f: lambda q, kp, vp, ks, vs, *a, **k: f(
             q, kp, vp, ks, torch.ones_like(vs), *a, **k)),
        ("K8 blind to the newest key (len - 1)", False, *k8,
         lambda f: lambda q, kp, vp, ks, vs, tb, qs, ln, *a, **k: f(
             q, kp, vp, ks, vs, tb, qs, ln - 1, *a, **k)),
        ("K2 without the outlier side GEMM", True, mm, "mixed_matmul",
         lambda f: lambda q, sr, xo, qw, sc, fw, **k: f(
             q, sr, xo, qw, sc, torch.zeros_like(fw), **k)),
        ("K4 without scale_col", True, wm, "wo_matmul",
         lambda f: lambda x, qw, sc, **k: f(x, qw, torch.ones_like(sc),
                                            **k)),
        ("K7's merge without the last split that saw a key", True, pa,
         "paged_decode_attention", drop_last_split),
    ]


def cross_device_13b(torch, seed: int, dev):
    """Phase 5b: three 2-layer models at Llama-2-13B width, random weights
    from ``seed``, each with the kernels it must launch and its controls,
    all enforced (the K5p control leaves the decode token's slot stale, so
    K7 reads one wrong key and value of 201). Returns the card runs'
    launches, summed."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.ops import paged_write as pw
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    from mixq_tensorrt_llm_tpu_torch.quant import KVCacheQuantAlgo, QuantAlgo
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp

    def swap_halves(f):
        def faulty(x, qp, sc, **k):
            h = x.shape[1] // 2
            return f(torch.cat([x[:, h:], x[:, :h]], dim=1), qp, sc, **k)
        return faulty

    k12 = ("K12 with the two nibble halves of x swapped", True, wm,
           "wo_matmul_packed", swap_halves)
    k13 = ("K13 given every group the scale of group 0", True, wm,
           "wo_matmul_packed_grouped",
           lambda f: lambda x, qp, sg, gs, **k: f(
               x, qp, sg[:1].expand_as(sg).contiguous(), gs, **k))
    k5p = ("K5p skipping the decode token's write in every layer", True,
           pw, "paged_write_located",
           lambda f: lambda pools, table, pos, nk, *a, **k: (
               pools if nk.shape[1] == 1 else f(pools, table, pos, nk, *a,
                                                **k)))
    fp = ("paged_write_chunk_fp", "paged_prefill_attention_fp")
    fd = ("paged_write_token_fp", "paged_decode_attention_fp")
    configs = [
        ("w4a16 + bf16 KV", QuantAlgo.W4A16, KVCacheQuantAlgo.NONE,
         [k12, k5p], (("wo_matmul",) + fp, ("wo_matmul_packed",) + fd)),
        ("w4a16_g + int8 KV", QuantAlgo.W4A16_G, KVCacheQuantAlgo.INT8,
         [k13], (("paged_write_chunk", "paged_prefill_attention"),
                 ("wo_matmul_packed_grouped", "paged_write_token",
                  "paged_decode_attention"))),
        ("int4_mix + bf16 KV", QuantAlgo.INT4_MIX, KVCacheQuantAlgo.NONE,
         [k12], (("rmsnorm_quant_split", "mixed_matmul", "wo_matmul") + fp,
                 ("wo_matmul_packed",) + fd)),
    ]
    total = {}
    for label, algo, kv, faults, must in configs:
        cfg = dataclasses.replace(sp.llama2_13b_config(algo, kv),
                                  num_layers=2)
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = llama.init_random_params(
            cfg, seed=seed, device=dev,
            act_scales=sp.distinct_act_scales(cfg, gen, dev))
        for n, c in cross_device(torch, params, cfg, seed, dev, label,
                                 faults, must).items():
            total[n] = total.get(n, 0) + c
        del params
    return total


# ---------------------------------------------------------------------------
# phase 4i: runtime-adaptive outliers, fp8 and int8_lr at Llama-2-7B width
# ---------------------------------------------------------------------------

DYN_PLANTED, DYN_GAIN = 32, 8.0    # planted channels a layer, their norms
WITNESS_BATCH, WITNESS_LEN = 4, 512
BF16_REL = 2.0 ** -7               # one bf16 step of a value
# the int8_lr model's depth: half of Llama-2-7B's 32, since its rank-32
# SVDs (3.5 s a layer on the card) are the smoke's largest single wall
LR_LAYERS = 16
DYN_LAYERS = 16      # phase 4i dyn's depth (the smoke's time)
# phase 4i: kernels each run must show in its traced decode, by mark
FORMAT_TRACED = {
    "dyn": {"wo_small_mma_kernel": "K4", "write_token_kernel": "K5",
            "decode_split_kernel": "K7"},
    "fp8": {},
    "lr": {"norm_quant": "K1", "mixed_wgmma_kernel": "K2",
           "wo_small_mma_kernel": "K4", "write_token_kernel": "K5",
           "decode_split_kernel": "K7"}}


def format_config(algo: str, kv: str, layers: int = 32,
                  dynamic: bool = False):
    """The phase-4 geometry (Llama-2-7B, 128 outliers, cap 256) with
    ``algo`` weights, ``kv`` pools, ``layers`` layers."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = sp.model_config("7b", algo, kv)
    return dataclasses.replace(cfg, num_layers=layers, quant=dataclasses.replace(
        cfg.quant, dynamic_outliers=dynamic, max_outliers=256))


def plant_channels(torch, params, statics, gen, dev) -> list:
    """In every layer, DYN_PLANTED channels outside ``statics[layer]``
    (its static qkv and gate_up sets), both RMSNorm weights DYN_GAIN
    there. Returns the planted channels a layer."""
    out = []
    for lp, static in zip(params["layers"], statics):
        h = lp["input_norm"]["w"].shape[0]
        free = torch.ones((h,), dtype=torch.bool, device=dev)
        free[torch.tensor(sorted(static), device=dev)] = False
        free = free.nonzero()[:, 0]
        pick = free[torch.randperm(free.numel(), generator=gen,
                                   device=dev)[:DYN_PLANTED]]
        for norm in ("input_norm", "post_norm"):
            lp[norm]["w"][pick] = DYN_GAIN
        out.append(set(pick.tolist()))
    return out


def static_sets(params) -> list:
    return [set(lp["qkv_proj"]["fp_ind"].tolist())
            | set(lp["gate_up_proj"]["fp_ind"].tolist())
            for lp in params["layers"]]


def selections(ostate, cfg) -> dict:
    """{module: [the selected channels a layer]} of a dynamic state."""
    from mixq_tensorrt_llm_tpu_torch.quant import dynamic as qdyn
    out = {}
    for m, v in ostate.items():
        cap = min(cfg.quant.max_outliers, v.shape[1])
        base = min(cfg.quant.num_outliers, cap)
        out[m] = [{c for c in qdyn.dynamic_fp_ind(
            v[i], cap, cfg.quant.outlier_sigma, base).tolist() if c >= 0}
            for i in range(v.shape[0])]
    return out


class KoRecorder:
    """Records the outlier widths K1 and K2 are launched with (the
    x_outliers width of each K2 call, the fp_ind width of each K1 call)
    while installed."""

    def __init__(self):
        from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
        from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
        self.k1, self.k2 = set(), set()
        self._undo = []
        for mod, name, rec, arg in ((nq, "_launch", self.k1, 2),
                                    (mm, "mixed_matmul", self.k2, 2)):
            real = getattr(mod, name)

            def wrapped(*a, _real=real, _rec=rec, _arg=arg, **kw):
                if a[0].is_cuda:
                    _rec.add(int(a[_arg].shape[-1]))
                return _real(*a, **kw)
            setattr(mod, name, wrapped)
            self._undo.append((mod, name, real))

    def restore(self):
        for mod, name, real in self._undo:
            setattr(mod, name, real)


def format_serve(torch, params, cfg, seed: int, dev, path: str) -> dict:
    """One of phase 4i's serving runs: a new Executor (the smoke's usual
    one) warmed at burst BURST, then the 8 requests with run(burst=BURST)
    timed and profiled (``decode_run``), every launch count at 0 just
    before. Checks: 32 finite tokens a request, every decode call a graph
    replay, no program after warmup, the run's kernels (ON_PATH /
    OFF_PATH[path]) and decode marks (FORMAT_TRACED[path]). Returns the
    run's numbers."""
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    rec = KoRecorder()
    ex = sp.make_executor(params, cfg, seed, dev)
    t = time.perf_counter()
    ex.warmup(burst=BURST)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats()
    try:
        r = decode_run(torch, sp, params, cfg, prompts, seed, dev, ex, BURST,
                       marks=FORMAT_TRACED[path], same_tokens=path != "dyn")
    finally:
        rec.restore()
    r.update(peak_gib=torch.cuda.max_memory_allocated() / 2**30,
             warm_s=warm_s, k1_ko=sorted(rec.k1), k2_ko=sorted(rec.k2),
             rung_launches={name: c for g in ex._rungs.values()
                            for name, c in g.launches.items()},
             ex=ex)
    launches = r["launches"]
    check(all(len(t) == 32 for t in r["toks"]),
          f"phase 4i {path}: not every request got 32 tokens")
    check(all(math.isfinite(x) for lps in r["logprobs"] for x in lps),
          f"phase 4i {path}: a log-probability is not finite")
    check(r["replays"] == r["calls"] > 0, f"phase 4i {path}: "
          f"{r['replays']} graph replays for {r['calls']} decode calls")
    check(ex.compiles_since_warmup == 0, f"phase 4i {path}: "
          f"{ex.compiles_since_warmup} programs made after warmup")
    for name in ON_PATH[path]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path {path}")
    for name in OFF_PATH[path]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path {path}")
    for m, label in FORMAT_TRACED[path].items():
        check(r["traced"][m] > 0, f"phase 4i {path}: {label} ({m}) not "
              "traced in the decode phase")
    dec_ms, pre_ms = r["decode_s"] * 1e3, r["prefill_s"] * 1e3
    prof_ms = r["prefill_profiled_ms"]
    print(f"phase 4i {path}: warmup(burst={BURST}) {warm_s:.1f} s; 8 "
          f"requests, 32 generated each: wall {r['wall'] * 1e3:.1f} ms = "
          f"prefill {pre_ms:.1f} (profiled run {prof_ms:.1f}: device busy "
          f"{r['prefill_busy_ms']:.1f}, idle share "
          f"{1 - r['prefill_busy_ms'] / prof_ms:.3f}) + decode "
          f"{dec_ms:.1f} ms "
          f"({r['steps']} steps in {r['calls']} calls, {r['replays']} graph "
          f"replays); {r['gen'] / r['wall']:.1f} generated tok/s; decode "
          f"device busy {r['busy_ms']:.1f} ms (profiled run), idle share "
          f"{1 - r['busy_ms'] / dec_ms:.3f}; peak memory "
          f"{r['peak_gib']:.2f} GiB; K1 launched at ko {r['k1_ko']}, K2 at "
          f"ko {r['k2_ko']}; traced in decode {json.dumps(r['traced'])}",
          flush=True)
    print(f"main path {path} launches: {json.dumps(launches)}; the decode "
          f"rungs' launches a replay: {json.dumps(r['rung_launches'])}",
          flush=True)
    return r


def _chan_rel(a, b) -> float:
    """The largest per-channel relative difference |a - b| / |b|."""
    a, b = a.float().cpu(), b.float().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1e-6)).max())


def xdev_states(torch, card: dict, cpu: dict, f32: dict, cfg) -> None:
    """The dynamic state card against CPU after the same prefill, channel
    by channel, beside an f32 CPU witness (the same weights, hidden
    states and attention in f32). In every module the card's chan_max
    lies within XDEV_F32_RATIO x the CPU bf16 run's own largest
    per-channel distance from f32, and so does its gap from the CPU bf16
    run's; layer 0's qkv input is the same embeddings normed on both
    devices, so there that gap is held to one bf16 step (2^-7) in every
    channel instead. A channel selected on one device only must lie
    within the module's card - CPU limit of sigma or of the cap's
    boundary value."""
    sel_card, sel_cpu = selections(card, cfg), selections(cpu, cfg)
    sigma = cfg.quant.outlier_sigma
    rows, diffs = [], 0
    for m in cpu:
        cap = min(cfg.quant.max_outliers, cpu[m].shape[1])
        for i in range(cpu[m].shape[0]):
            a, b, w = card[m][i], cpu[m][i], f32[m][i]
            xdev, cpu_f32 = _chan_rel(a, b), _chan_rel(b, w)
            card_f32 = _chan_rel(a, w)
            same_input = i == 0 and m == "qkv_proj"
            tol = BF16_REL if same_input else XDEV_F32_RATIO * cpu_f32
            rows.append(f"{i}.{m} {xdev:.3e} {card_f32:.3e} {cpu_f32:.3e}")
            where = f"phase 4i dyn: layer {i} {m} chan_max"
            check(xdev <= tol, f"{where} card vs CPU {xdev} > {tol}")
            check(card_f32 <= XDEV_F32_RATIO * cpu_f32, f"{where}: the card "
                  f"is {card_f32} from f32, above {XDEV_F32_RATIO} x the "
                  f"CPU bf16 run's {cpu_f32}")
            odd = sel_card[m][i] ^ sel_cpu[m][i]
            b = b.float().cpu()
            edge = float(b.sort(descending=True).values[cap - 1])
            for c in odd:
                v = float(b[c])
                near = min(abs(v - sigma) / sigma,
                           abs(v - edge) / max(edge, 1e-6))
                check(near <= tol, f"phase 4i dyn: layer {i} {m}: channel "
                      f"{c} (chan_max {v}) selected on one device only, "
                      f"{near:.3e} from a boundary")
            diffs += len(odd)
    print(f"phase 4i dyn cross-device state: a module's largest per-channel "
          f"relative chan_max difference, card - CPU bf16, card - f32, CPU "
          f"bf16 - f32 (limits: the first two within {XDEV_F32_RATIO} x the "
          f"third; layer 0's qkv card - CPU within {BF16_REL:.3e} instead): "
          + "; ".join(rows) + f"; {diffs} channels selected on one device "
          "only, each at a boundary", flush=True)


def f32_copy(torch, params):
    """The CPU params with every bf16 tensor in f32 (the same values)."""
    def up(t):
        return t.float() if t.dtype == torch.bfloat16 else t
    return {k: ([{m: {n: up(t) for n, t in p.items()}
                  for m, p in layer.items()} for layer in v]
                if k == "layers" else {n: up(t) for n, t in v.items()})
            for k, v in params.items()}


def cross_device_dyn(torch, params, cfg, seed: int, dev) -> dict:
    """2 layers, card against CPU, as phase 5 does (one 200-token prompt
    in a 256-token chunk, then a decode step) with the dynamic state
    threaded: logits within XDEV_TOL; the decode step leaves the state as
    it is; the states after the prefill (``xdev_states``), beside the same
    run on the CPU in f32."""
    import dataclasses
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models.common import forward_paged
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.quant import dynamic as qdyn
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    cfg2, sub, sub_cpu = two_layers(torch, params, cfg)
    rng = np.random.default_rng(seed + 1)
    c, n = 256, 200
    tokens = np.zeros((1, c), np.int32)
    tokens[0, :n] = rng.integers(1, cfg.vocab_size, n)
    nxt = int(rng.integers(1, cfg.vocab_size))
    states = []             # the CPU run's, the card's, the f32 run's

    def run(device, p, cfg2=cfg2):
        state = init_paged_kv(cfg2, 4, 128, device=device)
        ost = qdyn.init_model_state(p, cfg2)
        t = torch.from_numpy(tokens).to(device)
        pos = torch.arange(c, dtype=torch.int32, device=device)[None]
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=device)
        length = torch.tensor([n], dtype=torch.int32, device=device)
        _build.reset_launches()
        pre, _, ost = forward_paged(p, cfg2, t, pos, state, table, length,
                                    last_pos=length - 1, outlier_state=ost)
        states.append(ost)
        out = [(pre[0, 0].float().cpu(), dict(_build.LAUNCHES))]
        _build.reset_launches()
        t = torch.tensor([[nxt]], dtype=torch.int32, device=device)
        dec, _, ost2 = forward_paged(p, cfg2, t, length[:, None], state,
                                     table, length + 1, outlier_state=ost)
        check(all(torch.equal(ost2[m], ost[m]) for m in ost),
              "phase 4i dyn: a decode step changed the state")
        return out + [(dec[0, 0].float().cpu(), dict(_build.LAUNCHES))]

    total = compare_devices(
        torch, "dyn int8_mix + dynamic outliers", dev, run, sub, sub_cpu,
        [(f"prefill ({n} tokens)", ["rmsnorm_quant_split", "mixed_matmul"],
          ()), ("decode step", ["wo_matmul"], ["mixed_matmul"])])
    t = time.perf_counter()
    run(torch.device("cpu"), f32_copy(torch, sub_cpu),
        dataclasses.replace(cfg2, dtype=torch.float32))
    print(f"phase 4i dyn: the f32 CPU witness run in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    xdev_states(torch, states[1], states[0], states[-1], cfg2)
    return total


def quiet_control(torch, seed: int, dev, gen) -> None:
    """2 layers at full width with no planted channel, one 200-token
    prompt through the dense forward (fresh K/V): after it the selection
    is each layer's static set, and the logits equal the static path's
    where that computes the same function, within one bf16 step more than
    GEMM_TOL: the static model with the dynamic path's outlier rows
    (dequantized int8 rows as its fp_weight) and its norm apart from the
    linear (``collect_stats``, as the adaptive path takes it). The static
    serving path (the norm fused into K1, bf16 rows) is a reading."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    from mixq_tensorrt_llm_tpu_torch.quant import dynamic as qdyn
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = format_config("int8_mix", "int8", layers=2, dynamic=True)
    params = llama.init_random_params(
        cfg, seed=seed + 7, device=dev,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    n = 200
    rng = np.random.default_rng(seed + 2)
    tokens = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, n))).to(
        dev)
    pos = torch.arange(n, dtype=torch.int32, device=dev)[None]
    lens = torch.tensor([n], dtype=torch.int32, device=dev)

    def prefill(p, **kw):
        cache = mc.init_kv_cache(cfg, 1, n, device=dev)
        return mc.forward(p, cfg, tokens, pos, cache, lens,
                          full_prefill=True, **kw)

    dyn, _, ost, _ = prefill(params, collect_stats=True,
                             outlier_state=qdyn.init_model_state(params,
                                                                 cfg))
    for m, per in selections(ost, cfg).items():
        for i, got in enumerate(per):
            check(got == set(params["layers"][i][m]["fp_ind"].tolist()),
                  f"phase 4i quiet control: layer {i} {m} selects "
                  f"{len(got)} channels, not its static set")
    deq = dict(params, layers=[
        {m: (dict(p, fp_weight=qcore.dequantize_weight(
            p["qweight"][p["fp_ind"].long()], p["scale_col"]))
             if "fp_ind" in p else p) for m, p in lp.items()}
        for lp in params["layers"]])
    same = prefill(deq, collect_stats=True)[0]
    served = prefill(params)[0]
    rel, rel_served = _rel(dyn, same), _rel(dyn, served)
    tol = gemm_tol(torch.bfloat16)
    print(f"phase 4i quiet control (2 layers, no planted channel, {n} "
          f"tokens): every selection is its static set; logits against the "
          f"static path over the same rows, norm apart {rel:.3e} (limit "
          f"{tol:.3e}); against the static serving path (norm in K1, bf16 "
          f"rows) {rel_served:.3e} (a reading)", flush=True)
    check(rel <= tol, f"phase 4i quiet control: {rel} > {tol}")


def dyn_witness(torch, seed: int, dev, gen) -> None:
    """The accuracy witness at 2 layers: a float (bf16) model with the
    planted channels, requantized to int8_mix (its static sets from
    distinct act_scales, the planted channels outside them); each layer's
    residual update given the float model's input (``layer_errors``),
    static and dynamic against the float layer's. The static path's error
    must exceed the dynamic path's in both layers."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.convert.from_float import requantize
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    from mixq_tensorrt_llm_tpu_torch.quant import dynamic as qdyn
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    qcfg = format_config("int8_mix", "int8", layers=2)
    cfg_f = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, algo=type(qcfg.quant.algo)("none")))
    acts = sp.distinct_act_scales(qcfg, gen, dev)
    fl = llama.init_random_params(cfg_f, seed=seed + 11, device=dev)
    k = qcfg.quant.num_outliers
    statics = [set(qcore.select_outliers(
        acts[f"model.layers.{i}.self_attn.q_proj"], k).tolist())
        | set(qcore.select_outliers(
            acts[f"model.layers.{i}.mlp.gate_proj"], k).tolist())
        for i in range(2)]
    plant_channels(torch, fl, statics, gen, dev)
    qp, cfg_s = requantize(fl, cfg_f, qcfg.quant, acts)
    cfg_d = dataclasses.replace(cfg_s, quant=dataclasses.replace(
        cfg_s.quant, dynamic_outliers=True))
    tokens = torch.randint(1, cfg_f.vocab_size, (WITNESS_BATCH, WITNESS_LEN),
                           generator=gen, device=dev)
    errs = layer_errors(torch, fl, cfg_f,
                        [(qp, cfg_s), (qp, cfg_d,
                                       qdyn.init_model_state(qp, cfg_d))],
                        tokens)
    print(f"phase 4i dyn accuracy witness ({WITNESS_BATCH} x {WITNESS_LEN} "
          f"tokens): each layer's update against the float layer's, "
          f"relative RMS, static / dynamic (ratio): "
          + "; ".join(f"layer {i}: {s:.4e} / {d:.4e} ({s / d:.2f}x)"
                      for i, (s, d) in enumerate(errs)), flush=True)
    for i, (s, d) in enumerate(errs):
        check(s > d, f"phase 4i dyn witness: layer {i}: static {s} not above "
              f"dynamic {d}")


def serve_dynamic(torch, seed: int, dev, gen) -> dict:
    """Phase 4i, dynamic outliers: the 32-layer int8_mix / int8-KV model
    (128 static outliers from distinct act_scales, cap 256) with
    DYN_PLANTED channels planted a layer, served (``format_serve``); after
    the run every layer's qkv and gate_up selections hold their planted
    channels and K1 / K2 ran at ko 256; the cross-device check, the quiet
    control and the accuracy witness. Returns the run's launches."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = format_config("int8_mix", "int8", layers=DYN_LAYERS, dynamic=True)
    t = time.perf_counter()
    params = llama.init_random_params(
        cfg, seed=seed, device=dev,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    planted = plant_channels(torch, params, static_sets(params), gen, dev)
    torch.cuda.synchronize()
    print(f"phase 4i dyn: {cfg.num_layers} layers at Llama-2-7B width, "
          f"int8_mix (128 static outliers, cap {cfg.quant.max_outliers}, "
          f"sigma {cfg.quant.outlier_sigma}) / int8 KV, {DYN_PLANTED} "
          f"channels a layer planted (norm weights {DYN_GAIN}); random "
          f"weights in {time.perf_counter() - t:.1f} s", flush=True)
    r = format_serve(torch, params, cfg, seed, dev, "dyn")
    ex = r.pop("ex")
    sel = selections(ex.ostate, cfg)
    for m in ("qkv_proj", "gate_up_proj"):
        missing = [i for i, got in enumerate(sel[m]) if not planted[i] <= got]
        check(not missing, f"phase 4i dyn: {m} misses planted channels in "
              f"layers {missing}")
    sizes = {m: (min(len(x) for x in v), max(len(x) for x in v))
             for m, v in sel.items()}
    print(f"phase 4i dyn: after serving, every layer's qkv and gate_up "
          f"selections hold their {DYN_PLANTED} planted channels; selected "
          f"channels a layer (least, most): {json.dumps(sizes)}", flush=True)
    check(r["k1_ko"] == [256] and r["k2_ko"] == [256],
          f"phase 4i dyn: K1 at ko {r['k1_ko']}, K2 at ko {r['k2_ko']}, "
          "not 256")
    for mark in ("norm_quant", "mixed_wgmma_kernel"):
        check(any(mark in n for n in r["prefill_names"]),
              f"phase 4i dyn: {mark} not traced in the prefill calls")
    del ex
    launches = r["launches"]
    xdev = cross_device_dyn(torch, params, cfg, seed, dev)
    del params
    torch.cuda.empty_cache()
    quiet_control(torch, seed, dev, gen)
    dyn_witness(torch, seed, dev, gen)
    torch.cuda.empty_cache()
    return launches, xdev


def fp8_casts(torch, gen, dev) -> None:
    """The e4m3 casts card against CPU, byte for byte: a 4096 x 4096
    weight (with 448 after scaling, subnormals, a zero column and row, a
    floored scale) and an (8, 32, 128) K/V block."""
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    w = torch.randn((4096, 4096), generator=gen, device=dev) * 0.02
    w[:, 1] = 2.0 ** -torch.arange(4096, device=dev).clamp(max=120).float()
    w[:, 2] = 0.0
    w[:, 3] *= 1e-12
    w[7] = 0.0
    kv = torch.randn((8, 32, 128), generator=gen, device=dev) * 3
    kv[0, 0] = 0.0
    for label, got, want in (
            ("weight 4096 x 4096", qcore.quantize_weight_fp8(w),
             qcore.quantize_weight_fp8(w.cpu())),
            ("K/V (8, 32, 128)", qcore.quantize_kv(kv, dtype=qcore.FP8),
             qcore.quantize_kv(kv.cpu(), dtype=qcore.FP8))):
        same = torch.equal(got[0].view(torch.uint8).cpu(),
                           want[0].view(torch.uint8))
        same_s = torch.equal(got[1].cpu(), want[1])
        print(f"phase 4i fp8 cast, {label}: card bytes equal the CPU's "
              f"{same}, scales equal {same_s}", flush=True)
        check(same and same_s, f"phase 4i fp8: the {label} cast differs "
              "card vs CPU")


def serve_fp8(torch, seed: int, dev, gen) -> tuple:
    """Phase 4i, fp8: the 32-layer model with e4m3 weights (dequantized to
    bf16, then cuBLAS) and e4m3 pools (the JAX package's route: cast and
    scatter, gather and masked attention, never K5-K8), served
    (``format_serve``); the gather route counted every layer of every
    prefill call and decode step; 2 layers card against CPU; the casts.
    Returns (the run's launches, the cross-device launches)."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    cfg = format_config("fp8", "fp8")
    t = time.perf_counter()
    params = llama.init_random_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"phase 4i fp8: {cfg.num_layers} layers at Llama-2-7B width, fp8 "
          f"weights / fp8 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    r = format_serve(torch, params, cfg, seed, dev, "fp8")
    r.pop("ex")
    gathers = r["launches"].get("paged_gather", 0)
    check(gathers >= cfg.num_layers * r["steps"],
          f"phase 4i fp8: the gather route counted {gathers} times for "
          f"{r['steps']} decode steps of {cfg.num_layers} layers")
    base = SERVE_STATS.get("burst")
    if base:
        print(f"phase 4i fp8 decode against int8_mix's (phase 4d, burst "
              f"{BURST}): {r['decode_s'] * 1e3:.1f} ms vs "
              f"{base['decode_s'] * 1e3:.1f} ms for {r['steps']} / "
              f"{base['steps']} steps (the fp8 linears write a bf16 copy of "
              f"each weight a call)", flush=True)
    xdev = cross_device(torch, params, cfg, seed, dev, "fp8 + fp8 KV",
                        must_launch=((), ()))
    check(xdev.get("paged_gather", 0) > 0, "phase 4i fp8: the cross-device "
          "run did not take the gather route")
    del params
    torch.cuda.empty_cache()
    fp8_casts(torch, gen, dev)
    return r["launches"], xdev


def lr_svd_walls(torch, gen, dev) -> None:
    """Prints one make_lr_artifact wall (int8 weight + rank-32 SVD of the
    residual) at qkv's, o_proj's and gate_up's shape: a reading."""
    from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
    walls = {}
    for label, shape in (("qkv", (4096, 12288)), ("o_proj", (4096, 4096)),
                         ("gate_up", (4096, 22016))):
        w = torch.randn(shape, generator=gen, device=dev) * 0.02
        torch.cuda.synchronize()
        t = time.perf_counter()
        qcore.make_lr_artifact(w)
        torch.cuda.synchronize()
        walls[label] = time.perf_counter() - t
    print(f"phase 4i lr: make_lr_artifact (int8 weight + rank-32 SVD of the "
          f"residual, f32) walls "
          + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; {sum(walls.values()):.2f} s a layer", flush=True)


def lr_witness(torch, seed: int, dev, gen) -> None:
    """int8_lr against plain W8A8 at 2 layers (the JAX package's
    test_lr_linear_closer_than_w8a8 on the card): a float (bf16) model
    requantized to int8_lr, and the same params with the correction cut
    to rank 0 (K2 at ko 0: W8A8); logits over the same tokens against the
    float model's, relative RMS: int8_lr's must be below W8A8's. Each
    layer's update (``layer_errors``) is a reading."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.convert.from_float import requantize
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import llama
    qcfg = format_config("int8_lr", "int8", layers=2)
    cfg_f = dataclasses.replace(qcfg, quant=dataclasses.replace(
        qcfg.quant, algo=type(qcfg.quant.algo)("none")))
    fl = llama.init_random_params(cfg_f, seed=seed + 13, device=dev)
    lr, cfg_lr = requantize(fl, cfg_f, qcfg.quant)
    w8a8 = dict(lr, layers=[
        {m: (dict(p, lr_u=p["lr_u"][:, :0].contiguous(),
                  lr_v=p["lr_v"][:0].contiguous()) if "lr_u" in p else p)
         for m, p in lp.items()} for lp in lr["layers"]])
    tokens = torch.randint(1, cfg_f.vocab_size, (WITNESS_BATCH, WITNESS_LEN),
                           generator=gen, device=dev)
    pos = torch.arange(WITNESS_LEN, dtype=torch.int32, device=dev)[None]
    pos = pos.expand(WITNESS_BATCH, -1)
    lens = torch.full((WITNESS_BATCH,), WITNESS_LEN, dtype=torch.int32,
                      device=dev)

    def logits(p, c):
        cache = mc.init_kv_cache(c, WITNESS_BATCH, WITNESS_LEN, device=dev)
        return mc.forward(p, c, tokens, pos, cache, lens,
                          full_prefill=True)[0]

    want = logits(fl, cfg_f)
    e_lr = _rel_rms(logits(lr, cfg_lr), want)
    e_8 = _rel_rms(logits(w8a8, cfg_lr), want)
    errs = layer_errors(torch, fl, cfg_f, [(lr, cfg_lr), (w8a8, cfg_lr)],
                        tokens)
    print(f"phase 4i lr accuracy witness ({WITNESS_BATCH} x {WITNESS_LEN} "
          f"tokens, 2 layers): logits against the float model, relative "
          f"RMS, int8_lr {e_lr:.5e} / W8A8 {e_8:.5e} (ratio "
          f"{e_lr / e_8:.4f}); each layer's update, int8_lr / W8A8: "
          + "; ".join(f"layer {i}: {a:.4e} / {b:.4e}"
                      for i, (a, b) in enumerate(errs)), flush=True)
    check(e_lr < e_8, f"phase 4i lr: int8_lr's logits error {e_lr} is not "
          f"below W8A8's {e_8}")


def serve_lr(torch, seed: int, dev, gen) -> tuple:
    """Phase 4i, int8_lr: the model at LR_LAYERS layers, int8_lr weights /
    int8 KV, served (``format_serve``): K1 at ko 0 and
    K2 at ko 32 in prefill and in the decode replays (int8_lr is not a
    mix algo: no weight-only route at S <= 4), K4 for down_proj; 2 layers
    card against CPU; the witness against W8A8. Returns (the run's
    launches, the cross-device launches)."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    lr_svd_walls(torch, gen, dev)
    cfg = format_config("int8_lr", "int8", layers=LR_LAYERS)
    t = time.perf_counter()
    params = llama.init_random_params(cfg, seed=seed, device=dev)
    torch.cuda.synchronize()
    print(f"phase 4i lr: {LR_LAYERS} layers at Llama-2-7B width, int8_lr "
          f"(rank 32) / int8 KV; quantize wall (random weights, SVDs "
          f"included) {time.perf_counter() - t:.1f} s", flush=True)
    r = format_serve(torch, params, cfg, seed, dev, "lr")
    r.pop("ex")
    check(r["k1_ko"] == [0] and r["k2_ko"] == [32],
          f"phase 4i lr: K1 at ko {r['k1_ko']}, K2 at ko {r['k2_ko']}, not "
          "0 and 32")
    for name in ("rmsnorm_quant_split", "mixed_matmul", "wo_matmul"):
        check(r["rung_launches"].get(name, 0) > 0,
              f"phase 4i lr: {name} not launched in the decode replays")
    for mark in ("norm_quant", "mixed_wgmma_kernel"):
        check(any(mark in n for n in r["prefill_names"]),
              f"phase 4i lr: {mark} not traced in the prefill calls")
    xdev = cross_device(torch, params, cfg, seed, dev, "int8_lr + int8 KV",
                        must_launch=(("rmsnorm_quant_split", "mixed_matmul",
                                      "wo_matmul"),
                                     ("rmsnorm_quant_split", "mixed_matmul",
                                      "wo_matmul")))
    del params
    torch.cuda.empty_cache()
    lr_witness(torch, seed, dev, gen)
    return r["launches"], xdev


def check_outlier_widths(torch, gen, dev, results):
    """Phase 3, the slice's K1 and K2 widths at Llama-2-7B: K1 without the
    norm over a 256-wide fp_ind with 100 entries of -1 (the dynamic
    padding: gathers 0, zeroes nothing) and over an empty one (int8_lr),
    at 1024 and 8 rows; K2 at ko 256 and 32 (qkv's N), at 8 and 1024
    rows. Each against its plain version, two launches bit-equal, timed;
    rows of the kernels line's ``shapes``."""
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
    h, n = 4096, 12288
    bf = torch.bfloat16
    x = (torch.randn((1024, h), generator=gen, device=dev) * 2).to(bf)
    padded = torch.randperm(h, generator=gen, device=dev)[:256].int()
    padded[156:] = -1
    empty = torch.empty((0,), dtype=torch.int32, device=dev)
    for ind, label in ((padded, "256 wide, 100 of them -1"),
                       (empty, "empty")):
        for rows in (1024, 8):
            xk = x[:rows].contiguous()
            kfn = (lambda: nq.quant_split(xk, ind))
            got, again, want = kfn(), kfn(), nq.quant_split_plain(xk, ind)
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in zip(got, again)),
                  f"K1 fp_ind {label} M={rows}: two launches differ")
            diff = (got[0].int() - want[0].int()).abs()
            dmax, same = int(diff.max()), float((diff == 0).float().mean())
            srel = float(((got[1] - want[1]).abs() / want[1]).max())
            oerr = float((got[2].float() - want[2].float()).abs().max()) \
                if ind.numel() else 0.0
            check(dmax <= 1 and same > 0.999 and srel <= 1e-5
                  and oerr <= 1e-2, f"K1 fp_ind {label} M={rows} differs "
                  f"from plain: codes {dmax} apart, {same} equal, scale "
                  f"{srel}, x_out {oerr}")
            if ind.numel():
                check(bool((got[2][:, 156:] == 0).all()),
                      f"K1 fp_ind {label}: a -1 entry gathered non-zero")
            ms, pms, wms = measure(torch, kfn,
                                   lambda: nq.quant_split_plain(xk, ind),
                                   "norm_quant", "rmsnorm_quant_split", 100,
                                   10)
            ko = ind.numel()
            bnd = bound(rows * h * 2 + ko * 4 + rows * h + rows * 4
                        + rows * ko * 2)
            print(f"K1 quant_split M={rows} K={h}, fp_ind {label}: codes at "
                  f"most {dmax} apart, {same:.6f} equal, scale rel "
                  f"{srel:.2e}, x_out {oerr:.2e}, repeat bit-equal; device "
                  f"{ms:.5f} ms (plain {pms:.5f}; wrapper {wms:.5f}; bound "
                  f"{bnd[0]:.5f})", flush=True)
            results["rmsnorm_quant_split"]["shapes"].append(dict(
                M=rows, K=h, ko=ko, pad=100 if ko else 0, ms=ms,
                plain_ms=pms, wrapper_ms=wms, bound_ms=bnd[0],
                bound_by=bnd[1]))
    qw = torch.randint(-127, 128, (h, n), generator=gen, device=dev,
                       dtype=torch.int8)
    scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
    for ko, ind in ((256, padded), (32, empty)):
        fpw = (torch.randn((ko, n), generator=gen, device=dev) * 0.02).to(bf)
        for rows in (8, 1024):
            q_x, srow, xo = nq.quant_split(x[:rows].contiguous(), ind)
            if ko == 32:            # int8_lr: x_outliers = bf16(x @ u)
                xo = (torch.randn((rows, ko), generator=gen, device=dev)
                      * 0.1).to(bf)
            args = (q_x, srow, xo, qw, scol, fpw)
            k2 = (lambda: mm.mixed_matmul(*args),
                  lambda: mm.mixed_matmul_plain(*args))
            out, again, want = k2[0](), k2[0](), k2[1]()
            torch.cuda.synchronize()
            err = gemm_err(out, want)
            check(err <= gemm_tol(bf), f"K2 ko={ko} M={rows}: rel err {err}")
            check(torch.equal(out, again), f"K2 ko={ko} M={rows}: two "
                  "launches differ")
            ms, pms, wms = measure(torch, *k2, "mixed_wgmma_kernel",
                                   "mixed_matmul", 20, 5)
            nbytes = (rows * h + rows * 4 + rows * ko * 2 + h * n + n * 4
                      + ko * n * 2 + rows * n * 2)
            bnd = bound(nbytes, 2.0 * rows * n * ko, 2.0 * rows * n * h)
            print(f"K2 mixed_matmul qkv M={rows} ko={ko}: max rel err "
                  f"{err:.2e}, repeat bit-equal; device {ms:.5f} ms (plain "
                  f"{pms:.5f}; wrapper {wms:.5f}; bound {bnd[0]:.5f}, by "
                  f"{bnd[1]})", flush=True)
            results["mixed_matmul"]["shapes"].append(dict(
                label=f"qkv ko {ko}", M=rows, K=h, N=n, ko=ko, ms=ms,
                plain_ms=pms, bound_ms=bnd[0], bound_by=bnd[1],
                max_abs_err=err))


# ---------------------------------------------------------------------------
# phase 4j: the decoding extras over the dense cache and runtime LoRA
# ---------------------------------------------------------------------------

EXTRA_MAX_LEN = 768                  # 4j: the LLM's max_seq_len (phase 4's)
SPEC_NEW = 32                        # 4j(a): new tokens a request
EXTRA_PROMPT, EXTRA_NEW = 512, 64    # 4j(b), (c): one prompt, new tokens
REDRAFT_BEAMS, REDRAFT_LEN = 4, 4    # 4j(c): the verify's 1 + 16 rows
# 4j(e): PEFT target -> rank (alpha = 2 x rank); each request's adapter
LORA_RANKS = {"q_proj": 16, "k_proj": 16, "v_proj": 16, "o_proj": 16,
              "gate_proj": 8, "up_proj": 8, "down_proj": 8}
LORA_IDS = [0, 1, 2, 0, 1, 2, 1, 0]
HIDDEN_TOL = 2e-2                    # 4j(f): relative to the largest value
# the kernels of phase 4j's paths (K14 where a prefill runs full_prefill,
# K1 -> K2 at the verifies' 5, 11 and 17 rows, K4 in the draft's steps)
ON_PATH.update({
    "spec_session": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                     "wo_matmul.decode"],
    "medusa": ["flash_causal_attention", "rmsnorm_quant_split",
               "mixed_matmul", "wo_matmul"],
    "redrafter": ["flash_causal_attention", "rmsnorm_quant_split",
                  "mixed_matmul", "wo_matmul"],
    "dense_draft": ["flash_causal_attention", "paged_verify_attention",
                    "rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                    "wo_matmul.decode", "paged_write_chunk",
                    "paged_prefill_attention"],
    "lora": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
             "wo_matmul.decode", "paged_write_token", "paged_write_chunk",
             "paged_decode_attention", "paged_prefill_attention"]})
OFF_PATH.update({"spec_session": PAGED + NO_GATHER,
                 "medusa": PAGED + NO_GATHER,
                 "redrafter": PAGED + NO_GATHER,
                 "dense_draft": NO_GATHER,
                 "lora": ["paged_decode_attention_split",
                          "paged_verify_attention"] + NO_GATHER})


def _first_flip(a, b) -> int:
    """The first index where two token lists differ (their common length
    where one is a prefix of the other)."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def _on_path(launches: dict, path: str) -> None:
    print(f"main path {path} launches: {json.dumps(launches)}", flush=True)
    for name in ON_PATH[path]:
        check(launches.get(name, 0) > 0,
              f"{name} was not launched on the main path {path}")
    for name in OFF_PATH[path]:
        check(launches.get(name, 0) == 0,
              f"{name} was launched on the main path {path}")


def _timed(torch, fn):
    """(fn(), wall s, launches) with every launch count at 0 just before
    and read just after."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, dict(_build.LAUNCHES)


def _profiled(torch, fn):
    """(device busy ms: the union of the kernels' ranges, the kernels'
    names) of one more call of ``fn`` under torch.profiler, tracing the
    device alone (an eager run's host ops would make the trace's
    processing take minutes)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return busy_union_ms(ev), {e.name for e in ev}


class _count_forwards:
    """Counts models.common.forward calls of ``rows`` rows on a model of
    ``layers`` layers while open (the speculative verifies)."""

    def __init__(self, rows: int, layers: int):
        from mixq_tensorrt_llm_tpu_torch.models import common
        self.m, self.rows, self.layers, self.n = common, rows, layers, 0

    def __enter__(self):
        real = self.real = self.m.forward

        def counted(params, cfg, tokens, *a, **k):
            self.n += (tokens.shape[1] == self.rows
                       and cfg.num_layers == self.layers)
            return real(params, cfg, tokens, *a, **k)
        self.m.forward = counted
        return self

    def __exit__(self, *exc):
        self.m.forward = self.real


def _llm(params, cfg, dev):
    """An LLM over params already on the card (a 7B checkpoint directory
    would take the phase's time to write and read)."""
    from mixq_tensorrt_llm_tpu_torch.api import LLM
    llm = LLM.__new__(LLM)
    llm.params, llm.cfg, llm.device = params, cfg, dev
    llm.max_seq_len = EXTRA_MAX_LEN
    return llm


def session_speculative(torch, params, cfg, seed: int, dev) -> dict:
    """Phase 4j(a): LLM.generate_speculative over the 8 requests, greedy
    and at temperature 1.0. Returns the launches of both runs."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    llm = _llm(params, cfg, dev)
    draft = _llm(*sp.draft_model(params, cfg, DRAFT_LAYERS), dev)
    sess = GenerationSession(params, cfg, max_seq_len=EXTRA_MAX_LEN,
                             device=dev)
    want = [s[len(p):] for s, p in
            zip(sess.generate(prompts, SPEC_NEW).sequences, prompts)]
    big, small = cfg.num_layers, DRAFT_LAYERS
    total = {}
    for temp in (0.0, 1.0):
        def run():
            return llm.generate_speculative(draft, prompts, SPEC_NEW,
                                            gamma=GAMMA, temperature=temp,
                                            seed=seed)
        with _count_forwards(GAMMA + 1, big) as verifies:
            (seqs, stats), wall, seen = _timed(torch, run)
        rounds = verifies.n
        busy, names = _profiled(torch, run)
        gen = [s[len(p):] for s, p in zip(seqs, prompts)]
        label = "greedy" if temp <= 0 else f"temperature {temp}"
        check(all(len(g) == SPEC_NEW for g in gen),
              f"4j(a) {label}: not every lane got {SPEC_NEW} tokens")
        check(all(0 <= t < cfg.vocab_size for g in gen for t in g),
              f"4j(a) {label}: a token outside the vocabulary")
        # per verify: 3 mix linears a layer (K1 -> K2) and down_proj (K4);
        # per round the draft's 2-token catch-up and gamma - 1 steps, all
        # weight-only (K4, 4 a layer); the prefills' beside them
        k12 = 3 * (big + small) + 3 * big * rounds
        k4 = (big + small) + (big + 4 * small * GAMMA) * rounds
        for name, n in (("rmsnorm_quant_split", k12), ("mixed_matmul", k12),
                        ("wo_matmul", k4)):
            check(seen.get(name, 0) == n, f"4j(a) {label}: {name} launched "
                  f"{seen.get(name, 0)} times, {n} expected for {rounds} "
                  f"rounds")
        for mark, k in (("norm_quant", "K1"), ("mixed_wgmma_kernel", "K2"),
                        ("wo_small_mma_kernel", "K4 (decode regime)")):
            check(any(mark in n for n in names),
                  f"4j(a) {label}: {k} ({mark}) not traced")
        print(f"phase 4j(a) LLM.generate_speculative, {label}: 8 requests, "
              f"gamma {GAMMA}, draft = the first {small} layers; wall "
              f"{wall:.3f} s, {sum(map(len, gen)) / wall:.1f} generated "
              f"tok/s; acceptance {stats.acceptance_rate:.3f} "
              f"({stats.accepted} / {stats.proposed}); {rounds} rounds "
              f"(verifies of {GAMMA + 1} rows); device busy {busy:.1f} ms "
              f"(profiled run), idle share {1 - busy / (wall * 1e3):.3f}; "
              f"K1 {seen.get('rmsnorm_quant_split', 0)}, K2 "
              f"{seen.get('mixed_matmul', 0)} (3 x ({big} + {small}) + 3 x "
              f"{big} x rounds), K4 {seen.get('wo_matmul', 0)} (({big} + "
              f"{small}) + ({big} + 4 x {small} x {GAMMA}) x rounds)",
              flush=True)
        if temp <= 0:
            print(f"phase 4j(a) greedy: each lane's first token unlike the "
                  f"session's greedy run (of {SPEC_NEW}; a reading: a "
                  f"5-row verify runs W8A8, a session step W8A16): "
                  f"{[_first_flip(g, w) for g, w in zip(gen, want)]}",
                  flush=True)
        for n, c in seen.items():
            total[n] = total.get(n, 0) + c
    _on_path(total, "spec_session")
    return total


CHAIN = [(0,), (0, 0), (0, 0, 0), (0, 0, 0, 0)]    # 4j(b): Medusa's oracle


def tree_decoding(torch, params, cfg, seed: int, dev) -> dict:
    """Phases 4j(b) and (c): Medusa and ReDrafter over one prompt.

    Each runs with random heads / drafter (Medusa on the default tree),
    then with an oracle proposing a reference run's own tokens, which
    must commit at least 2 tokens a step, then (a reading) with an oracle
    proposing the session's greedy tokens (W8A16 steps, which flip
    against the W8A8 verify at random weights). The oracle's rows must
    compute what its reference's did bit for bit, so each proposed token
    sits at the slot the reference computed it at: ReDrafter's beam 0
    (consecutive rows) against the random run; Medusa's chain tree
    against a random-heads run on the chain (the default tree spreads a
    path over slots t+1, t+4, t+7, t+10, and the masked attention's sums
    group by slot). Returns the launches by path (all but the reading's
    runs)."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.runtime import medusa, redrafter
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    rng = np.random.default_rng(seed + 5)
    prompt = rng.integers(1, cfg.vocab_size, EXTRA_PROMPT).tolist()
    sess = GenerationSession(params, cfg, max_seq_len=EXTRA_MAX_LEN,
                             device=dev)
    session = sess.generate([prompt],
                            EXTRA_NEW + 8).sequences[0][EXTRA_PROMPT:]
    llm = _llm(params, cfg, dev)
    cpu_gen = torch.Generator().manual_seed(seed)
    heads = medusa.init_random_heads(cfg, cpu_gen, 4, device=dev)
    drafter = redrafter.init_random_drafter(cfg, cpu_gen, device=dev)
    layers = cfg.num_layers
    out = {}
    gen = []      # the continuation the oracles propose
    state = {"t": 0}

    def done_tokens():
        return state["t"] - EXTRA_PROMPT if state["t"] else 0

    def heads_oracle(hidden, step):
        x = torch.zeros((4, 1, cfg.vocab_size), device=dev)
        for h in range(4):
            i = done_tokens() + 1 + h
            x[h, 0, gen[i] if i < len(gen) else 0] = 100.0
        return x

    def beams_oracle(hidden, next_tok, step):
        i = done_tokens() + 1
        beams = np.zeros((REDRAFT_BEAMS, REDRAFT_LEN), np.int32)
        beams[0] = (gen[i:i + REDRAFT_LEN] + [0] * REDRAFT_LEN)[:REDRAFT_LEN]
        return beams

    def medusa_run(choices, fn):
        return lambda: medusa.medusa_generate(
            params, cfg, heads if fn is None else None, prompt, EXTRA_NEW,
            choices=choices, max_seq_len=EXTRA_MAX_LEN, head_logits_fn=fn,
            device=dev)

    def redrafter_run(fn):
        return lambda: redrafter.redrafter_generate(
            params, cfg, None, prompt, EXTRA_NEW, num_beams=REDRAFT_BEAMS,
            draft_len=REDRAFT_LEN, max_seq_len=EXTRA_MAX_LEN, draft_fn=fn,
            device=dev)

    tree_rows = medusa.build_tree(medusa.DEFAULT_CHOICES).num_nodes + 1
    beam_rows = 1 + REDRAFT_BEAMS * REDRAFT_LEN
    # (kind, run, its verify rows, what the run's tokens become)
    runs = {"medusa": [
        ("random", lambda: llm.generate_medusa(heads, prompt, EXTRA_NEW),
         tree_rows, None),
        ("random on the chain", medusa_run(CHAIN, None), len(CHAIN) + 1,
         "reference"),
        ("oracle on the chain", medusa_run(CHAIN, heads_oracle),
         len(CHAIN) + 1, None),
        ("session oracle", medusa_run(None, heads_oracle), tree_rows,
         None)],
        "redrafter": [
        ("random", lambda: llm.generate_redrafter(
            drafter, prompt, EXTRA_NEW, num_beams=REDRAFT_BEAMS,
            draft_len=REDRAFT_LEN), beam_rows, "reference"),
        ("oracle", redrafter_run(beams_oracle), beam_rows, None),
        ("session oracle", redrafter_run(beams_oracle), beam_rows, None)]}

    for path, module in (("medusa", medusa), ("redrafter", redrafter)):
        real = module.compact

        def tracked(cache, slot_path, t, width):
            state["t"] = t + len(slot_path)
            return real(cache, slot_path, t, width)
        module.compact = tracked
        total = {}
        try:
            for kind, fn, rows, role in runs[path]:
                state["t"] = 0
                if kind == "session oracle":
                    gen[:] = session
                (seq, stats), wall, seen = _timed(torch, fn)
                mine = seq[EXTRA_PROMPT:]
                check(stats.tokens == EXTRA_NEW and len(mine) == EXTRA_NEW,
                      f"4j {path} {kind}: {stats.tokens} tokens")
                if role == "reference":
                    gen[:] = mine
                if kind.startswith("oracle"):
                    check(stats.tokens_per_step >= 2, f"4j {path} {kind}: "
                          f"{stats.tokens_per_step:.2f} tokens a step")
                # the prefill (K14 once a layer; 3 mix linears and
                # down_proj's K4 a layer) and one verify a step
                want = {"flash_causal_attention": layers,
                        "rmsnorm_quant_split": 3 * layers * (1 + stats.steps),
                        "mixed_matmul": 3 * layers * (1 + stats.steps),
                        "wo_matmul": layers * (1 + stats.steps)}
                for name, n in want.items():
                    check(seen.get(name, 0) == n, f"4j {path} {kind}: {name}"
                          f" launched {seen.get(name, 0)} times, {n} "
                          f"expected")
                print(f"phase 4j {path} {kind}: {stats.tokens} tokens in "
                      f"{stats.steps} steps ({stats.tokens_per_step:.2f} a "
                      f"step; verifies of {rows} rows), wall {wall:.3f} s, "
                      f"{stats.tokens / wall:.1f} tok/s; first token unlike "
                      f"the session's greedy run {_first_flip(mine, session)}"
                      f" of {EXTRA_NEW} (a reading); launches "
                      f"{json.dumps(seen)}", flush=True)
                if kind != "session oracle":
                    for n, c in seen.items():
                        total[n] = total.get(n, 0) + c
        finally:
            module.compact = real
        _on_path(total, path)
        out[path] = total
    del heads, drafter
    torch.cuda.empty_cache()
    return out


def dense_draft(torch, params, cfg, seed: int, dev) -> dict:
    """Phase 4j(d): run_speculative with the draft over a dense cache
    beside the paged draft, each timed and profiled in this call. Returns
    the dense run's launches."""
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    dp, dcfg = sp.draft_model(params, cfg, DRAFT_LAYERS)
    res = {}
    for paged in (True, False):
        def run():
            return sp.serve(params, cfg, prompts, seed, dev,
                            (dp, dcfg, GAMMA, paged))
        (done, ids, wall, prefill_s, ex), _, seen = _timed(torch, run)
        busy, _ = _profiled(torch, run)
        label = "paged" if paged else "dense"
        toks = [done[r].generated for r in ids]
        check(all(len(t) == 32 for t in toks),
              f"4j(d) {label} draft: not every request got 32 tokens")
        res[label] = toks
        print(f"phase 4j(d) run_speculative(paged_draft={paged}): rounds "
              f"{ex.spec_rounds} in {ex.spec_calls} calls, acceptance "
              f"{ex.spec_accepted / max(ex.spec_proposed, 1):.3f} "
              f"({ex.spec_accepted} / {ex.spec_proposed}); wall {wall:.3f} s"
              f" = prefill {prefill_s:.3f} s + rounds {wall - prefill_s:.3f}"
              f" s; device busy {busy:.1f} ms (profiled run), idle share "
              f"{1 - busy / (wall * 1e3):.3f}", flush=True)
        if not paged:
            launches = seen
    print(f"phase 4j(d) each lane's first token unlike the paged draft's "
          f"run (of 32; a reading: the dense draft attends in torch over "
          f"its cache, the paged one through K7): "
          f"{[_first_flip(a, b) for a, b in zip(res['dense'], res['paged'])]}",
          flush=True)
    _on_path(launches, "dense_draft")
    return launches


def lora_adapters(torch, cfg, tmp: str, seed: int):
    """Two random PEFT adapter directories under ``tmp`` (ranks of
    LORA_RANKS, alpha = 2 x rank, N(0, 0.02) factors from a CPU generator),
    written with the port's safetensors writer. Returns their paths."""
    from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import \
        write_safetensors
    gen = torch.Generator().manual_seed(seed)
    shapes = {"q_proj": (cfg.q_size, cfg.hidden_size),
              "k_proj": (cfg.kv_size, cfg.hidden_size),
              "v_proj": (cfg.kv_size, cfg.hidden_size),
              "o_proj": (cfg.hidden_size, cfg.q_size),
              "gate_proj": (cfg.intermediate_size, cfg.hidden_size),
              "up_proj": (cfg.intermediate_size, cfg.hidden_size),
              "down_proj": (cfg.hidden_size, cfg.intermediate_size)}
    dirs = []
    for a in range(2):
        d = os.path.join(tmp, f"adapter{a + 1}")
        os.makedirs(d)
        # PEFT's r / lora_alpha and the per-target rank_pattern /
        # alpha_pattern: alpha / r is 2 on every target
        pattern = {t: r for t, r in LORA_RANKS.items() if r != 16}
        with open(os.path.join(d, "adapter_config.json"), "w") as f:
            json.dump({"r": 16, "lora_alpha": 32,
                       "rank_pattern": pattern,
                       "alpha_pattern": {t: 2 * r
                                         for t, r in pattern.items()},
                       "target_modules": sorted(LORA_RANKS)}, f)
        tensors = {}
        for i in range(cfg.num_layers):
            for tgt, r in LORA_RANKS.items():
                grp = "mlp" if tgt in ("gate_proj", "up_proj",
                                       "down_proj") else "self_attn"
                out_f, in_f = shapes[tgt]
                key = f"base_model.model.model.layers.{i}.{grp}.{tgt}"
                tensors[key + ".lora_A.weight"] = torch.randn(
                    (r, in_f), generator=gen) * 0.02
                tensors[key + ".lora_B.weight"] = torch.randn(
                    (out_f, r), generator=gen) * 0.02
        write_safetensors(os.path.join(d, "adapter_model.safetensors"),
                          tensors)
        dirs.append(d)
    return dirs


def with_adapters(torch, params, cfg, seed: int, dev):
    """The phase-4 model with the two adapters attached (the layers' dicts
    copied, so the phase-4 params stay as they are)."""
    import shutil
    import tempfile
    from mixq_tensorrt_llm_tpu_torch.convert.lora import (attach_lora,
                                                          build_lora_stack)
    tmp = tempfile.mkdtemp(prefix="mixq-phase4j-")
    try:
        t = time.perf_counter()
        dirs = lora_adapters(torch, cfg, tmp, seed)
        stack = build_lora_stack(cfg, dirs, device=dev)
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    lp = dict(params, layers=[{m: dict(v) for m, v in lay.items()}
                              for lay in params["layers"]])
    attach_lora(lp, stack)
    print(f"phase 4j(e): 2 adapters (rank {sorted(set(LORA_RANKS.values()))}"
          f", alpha 2r, {cfg.num_layers} layers) written, read and stacked "
          f"in {time.perf_counter() - t:.1f} s; stacked ranks "
          f"{ {m: int(ab['A'].shape[-1]) for m, ab in stack.items()} }",
          flush=True)
    return lp


def serve_lora(torch, lp, cfg, seed: int, dev) -> dict:
    """Phase 4j(e): a new Executor over the adapted model, warmed at burst
    16, serves the 8 requests with ids LORA_IDS at burst 16 (decode_run:
    timed, then profiled). Returns the timed run's launches."""
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    ex = sp.make_executor(lp, cfg, seed, dev)
    t = time.perf_counter()
    ex.warmup(burst=BURST)
    torch.cuda.synchronize()
    print(f"phase 4j(e): warmup(burst={BURST}) {time.perf_counter() - t:.1f}"
          f" s, rungs {sorted(k for k, *_ in ex._rungs)}", flush=True)
    r = decode_run(torch, sp, lp, cfg, prompts, seed, dev, ex, BURST,
                   lora_ids=LORA_IDS)
    check(all(len(t) == 32 for t in r["toks"]) and all(
        math.isfinite(x) for lps in r["logprobs"] for x in lps),
        "4j(e): not every request got 32 tokens with finite log-probs")
    check(r["replays"] == r["calls"] > 0, f"4j(e): {r['replays']} replays "
          f"for {r['calls']} decode calls")
    check(ex.compiles_since_warmup == 0,
          f"4j(e): {ex.compiles_since_warmup} programs made after warmup")
    k1 = sorted(n for n in r["prefill_names"] if "norm_quant" in n)
    check(bool(k1) and all("false" in n and "true" not in n for n in k1),
          f"4j(e): K1 in the prefill must run without its norm: {k1}")
    check(any("mixed_wgmma_kernel" in n for n in r["prefill_names"]),
          "4j(e): K2 not traced in the prefill")
    for m in ("wo_small_mma_kernel", "decode_split_kernel"):
        check(r["traced"][m] > 0, f"4j(e): {DECODE_TRACED[m][0]} ({m}) not "
              f"traced in the replays")
    base = SERVE_STATS["burst"]
    tpot, tpot0 = (x["decode_s"] / x["steps"] * 1e3 for x in (r, base))
    dec_ms = r["decode_s"] * 1e3
    print(f"phase 4j(e) runtime LoRA, ids {LORA_IDS}, burst {BURST}: wall "
          f"{r['wall'] * 1e3:.1f} ms, decode {dec_ms:.1f} ms for "
          f"{r['steps']} steps in {r['calls']} calls ({r['replays']} "
          f"replays); TPOT {tpot:.2f} ms against phase 4d's {tpot0:.2f} ms "
          f"without adapters (x{tpot / tpot0:.3f}); device busy "
          f"{r['busy_ms']:.1f} ms, idle share {1 - r['busy_ms'] / dec_ms:.3f}"
          f"; K1 in the prefill: {k1}; traced in decode "
          + ", ".join(f"{DECODE_TRACED[m][0]} {n}"
                      for m, n in r["traced"].items()), flush=True)
    flips = [_first_flip(a, b) for a, b, i in
             zip(r["toks"], base["toks"], LORA_IDS) if i == 0]
    print(f"phase 4j(e) id-0 lanes' first token unlike phase 4d's (no "
          f"adapters; a reading: the adapted modules run the norm apart): "
          f"{flips}", flush=True)
    _on_path(r["launches"], "lora")
    return r["launches"]


def drop_kwarg(name: str):
    """A models.common.forward fault: the keyword ``name`` dropped."""
    def fault(f):
        def faulty(*a, **k):
            k.pop(name, None)
            return f(*a, **k)
        return faulty
    return fault


def cross_device_extras(torch, lp, cfg, seed: int, dev) -> dict:
    """Phase 4j(f), 2 layers at full width with the adapters, card against
    CPU: a Medusa verify of the default tree over a 24-token context
    (logits and the returned hidden), an adapter lane's
    forward(lora_ids=[2]) over the context, and a 5-row speculative verify
    after it. Controls, enforced: rope_pos dropped (RoPE by slot) and the
    tree mask dropped (causal by slot). Returns the card run's launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime import medusa
    cfg2, sub, sub_cpu = two_layers(torch, lp, cfg)
    rng = np.random.default_rng(seed + 6)
    ctx = 24
    context = rng.integers(1, cfg.vocab_size, ctx)
    tree = medusa.build_tree(medusa.DEFAULT_CHOICES)
    rows = rng.integers(1, cfg.vocab_size, (1, tree.num_nodes + 1)).astype(
        np.int32)
    anc, depths = medusa.verify_layout(tree)
    spec_rows = rng.integers(1, cfg.vocab_size, (1, GAMMA + 1))

    def run(device, p):
        def i32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                   device=device)

        def prefilled(**kw):
            cache = mcommon.init_kv_cache(cfg2, 1, 64, device=device)
            _build.reset_launches()
            x = mcommon.forward(p, cfg2, i32(context)[None],
                                i32(np.arange(ctx))[None], cache, i32([ctx]),
                                full_prefill=True, **kw)[0]
            return cache, x, dict(_build.LAUNCHES)

        cache, _, _ = prefilled()
        _build.reset_launches()
        logits, hidden = medusa.tree_verify(
            p, cfg2, cache, rows, depths,
            torch.as_tensor(anc, device=device), ctx)
        seen = dict(_build.LAUNCHES)
        out = [(logits[0].float().cpu(), seen), (hidden[0].float().cpu(), {})]
        _, x, seen = prefilled(lora_ids=i32([2]))
        out.append((x[0].float().cpu(), seen))
        cache, _, _ = prefilled()
        _build.reset_launches()
        x = mcommon.forward(p, cfg2, i32(spec_rows),
                            ctx + i32(np.arange(GAMMA + 1))[None], cache,
                            i32([ctx + GAMMA + 1]))[0]
        return out + [(x[0].float().cpu(), dict(_build.LAUNCHES))]

    mix = ("rmsnorm_quant_split", "mixed_matmul")
    return compare_devices(
        torch, "decoding extras and LoRA", dev, run, sub, sub_cpu,
        [(f"Medusa verify ({tree.num_nodes + 1} rows, {ctx}-token context)",
          mix, PAGED),
         ("Medusa verify's pre-norm hidden", (), (), HIDDEN_TOL),
         (f"forward(lora_ids=[2]) over the {ctx}-token context",
          mix, PAGED),
         (f"speculative verify ({GAMMA + 1} rows)", mix, PAGED)],
        [("rope_pos dropped (RoPE by slot)", True, mcommon, "forward",
          drop_kwarg("rope_pos")),
         ("the tree mask dropped (causal by slot)", True, mcommon,
          "forward", drop_kwarg("attn_mask"))])


# ---------------------------------------------------------------------------
# phase 4k: the dense decoder families (Gemma-2-9B at full width and depth;
# Falcon-7B, BLOOM-7B1 and Phi-2 widths at 2 layers card against CPU)
# ---------------------------------------------------------------------------

FAM_LONG, FAM_MAX_LEN = 4400, 4864   # 4k(a): the long request, max_seq_len
FAM_LAYERS = 22                      # 4k(a): Gemma-2-9B's depth served (of
#                                      42: the smoke's time)
FAM_SESSION_LEN = 768                # 4k(a): the session's max_seq_len
FAM_TOL = 2e-2                       # 4k(b): card vs CPU, of max |logit|
WITNESS_WINDOW, WITNESS_PROMPT = 256, 600   # 4k(b)'s Gemma-2 witness
WITNESS_STEPS = 4                    # 4k(b): decode steps after the prefill
# 4k(a): kernels of the prefill calls, by a mark of the traced name
FAM_PREFILL_TRACED = {"norm_quant": "K1", "mixed_wgmma_kernel": "K2",
                      "write_chunk_kernel": "K6",
                      "prefill_wgmma_kernel": "K8"}
KERNELS["paged_decode_attention_rows"] = (JOPS + "paged_attention.py:70",
                                          "paged_attention.cu")
PAGED.append("paged_decode_attention_rows")
ON_PATH.update({
    # Gemma-2-9B through the Executor: K1 (the RMSNorm fused) -> K2 at the
    # prefill chunks, K4 in the decode replays and for down_proj, K5 / K6,
    # K7 and K8 with each layer's window
    "gemma2": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
               "wo_matmul.decode", "wo_matmul.prefill", "paged_write_token",
               "paged_write_chunk", "paged_decode_attention",
               "paged_prefill_attention"],
    # its GenerationSession: the softcaps take the masked route (no K14)
    "gemma2_session": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                       "wo_matmul.decode"]})
OFF_PATH.update({
    "gemma2": ["paged_decode_attention_split", "paged_verify_attention",
               "paged_decode_attention_rows"] + NO_GATHER,
    "gemma2_session": PAGED + NO_GATHER + ["flash_causal_attention"]})


def gemma2_9b_config(torch, layers: int = 42, window: int = 4096):
    """google/gemma-2-9b's published config.json: vocab 256000, hidden
    3584, intermediate 14336, 42 layers, 16 query heads and 8 KV heads of
    256, query_pre_attn_scalar 256, sliding window 4096 on every other
    layer, attention softcap 50, final softcap 30, GeGLU
    (gelu_pytorch_tanh), tied embeddings, RMSNorm eps 1e-6, rope theta
    10000; int8_mix (128 outliers) with int8 KV."""
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    return ModelConfig(
        arch="gemma2", vocab_size=256000, hidden_size=3584,
        intermediate_size=14336, num_layers=layers, num_heads=16,
        num_kv_heads=8, head_dim=256, rope_theta=10000.0, rms_norm_eps=1e-6,
        max_position_embeddings=8192, attn_scale=256 ** -0.5,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_block_norms=True, sliding_window=window,
        sliding_window_pattern=2, hidden_act="gelu_pytorch_tanh",
        embed_scale=3584 ** 0.5, tie_word_embeddings=True,
        dtype=torch.bfloat16,
        quant=QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128,
                          kv_cache=KVCacheQuantAlgo.INT8))


def witness_configs(torch) -> dict:
    """The 2-layer witnesses of phase 4k(b), each an HF config written out
    from its published config.json and read by the port's families
    reader: tiiuae/falcon-7b (hidden 4544, 71 query heads on 1 KV head of
    64, parallel attention with one shared LayerNorm, intermediate 18176,
    vocab 65024), bigscience/bloom-7b1 (hidden 4096, 32 heads, ALiBi, the
    embedding LayerNorm, vocab 250880), microsoft/phi-2 (hidden 2560, 32
    heads of 80, partial rotary 0.4 = 32 dims, intermediate 10240, vocab
    51200, lm_head bias); int8_mix (128 outliers) with int8 KV."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import families
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    quant = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128,
                        kv_cache=KVCacheQuantAlgo.INT8)
    hf = {
        "falcon-7b": dict(model_type="falcon", vocab_size=65024,
                          hidden_size=4544, num_hidden_layers=2,
                          num_attention_heads=71, multi_query=True,
                          new_decoder_architecture=False, parallel_attn=True,
                          bias=False, alibi=False, layer_norm_epsilon=1e-5,
                          max_position_embeddings=2048, rope_theta=10000.0),
        "bloom-7b1": dict(model_type="bloom", vocab_size=250880,
                          hidden_size=4096, n_layer=2, n_head=32,
                          layer_norm_epsilon=1e-5),
        "phi-2": dict(model_type="phi", vocab_size=51200, hidden_size=2560,
                      intermediate_size=10240, num_hidden_layers=2,
                      num_attention_heads=32, num_key_value_heads=32,
                      max_position_embeddings=2048, rope_theta=10000.0,
                      layer_norm_eps=1e-5, hidden_act="gelu_new",
                      partial_rotary_factor=0.4)}
    return {name: families.config_from_hf(types.SimpleNamespace(**c), quant)
            for name, c in hf.items()}


def check_family_kernels(torch, gen, dev, results):
    """Phase 3 for the families' geometry: K7's rows layout at Falcon-7B's
    decode (8 lanes, 71 query heads on 1 KV head of 64, int8 pages of 128
    tokens, lengths 1-700, three masks) and at the MQA coders' 48 heads of
    128, against the plain version, two launches bit-equal, timed beside
    its bound and beside K7's split kernel at 8 query heads on the same
    pages; K2 and K4 at Falcon-7B's N % 128 == 64 shapes (qkv 4544 ->
    4672, o_proj 4544 -> 4544, fc2 18176 -> 4544) in their regimes,
    against plain, timed with their bounds (K4: and
    torch._weight_int8pack_mm)."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    bs, np_, b, mb = 128, 64, 8, 6
    lens = [700, 1, 256, 640, 129, 513, 384, 300]
    worst, timing = 0.0, None
    for hq, d in ((71, 64), (48, 128)):
        scale, hkv, tok_b = d ** -0.5, 1, 2 * d + 8
        pools = make_pools(torch, gen, dev, np_, hkv, bs, d)
        args = (pools["k"], pools["v"], pools["k_scale"], pools["v_scale"])
        table, bpos = _attn_tables(torch, gen, dev, b, mb, bs, np_, lens, 3)
        table[1] = 0
        bpos[1] = 1 << 30
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
        check(pa.decode_route(hq, d, bs, 1, True, True) == "rows",
              f"K7 at {hq} query heads a KV head does not take the rows "
              "layout")
        for window, sink, softcap in ((0, 0, 0.0), (256, 128, 0.0),
                                      (0, 0, 30.0)):
            kw = dict(block_pos=bpos, window=window, sink=sink,
                      softcap=softcap)
            before = _build.LAUNCHES.get("paged_decode_attention_rows", 0)
            out = pa.paged_decode_attention(q, *args, table, lens_t, scale,
                                            **kw)
            again = pa.paged_decode_attention(q, *args, table, lens_t, scale,
                                              **kw)
            ref = pa.paged_attention_plain(q[:, None], *args, table,
                                           (lens_t - 1)[:, None], lens_t,
                                           scale, **kw)[:, 0]
            torch.cuda.synchronize()
            check(_build.LAUNCHES.get("paged_decode_attention_rows", 0)
                  - before == 2, "K7's rows layout: not one launch a call")
            check(bool(torch.isfinite(out).all()), "K7 rows: not finite")
            check(bool((out[1] == 0).all()), "K7 rows: inactive lane not 0")
            check(torch.equal(out, again), f"K7 rows Hq={hq}: two launches "
                  "on the same inputs differ")
            err = float((out.float() - ref.float()).abs().max())
            check(err <= ATTN_TOL, f"K7 rows Hq={hq} window={window} "
                  f"softcap={softcap}: max abs err {err} > {ATTN_TOL}")
            worst = max(worst, err)
            print(f"K7 rows layout (paged_decode_attention_rows) int8 "
                  f"Hq={hq} Hkv=1 D={d} window={window} sink={sink} "
                  f"softcap={softcap}: max abs err {err:.3e}, repeat "
                  f"bit-equal", flush=True)
        kw = dict(block_pos=bpos)
        ms, pms, wms = measure(
            torch, lambda: pa.paged_decode_attention(
                q, *args, table, lens_t, scale, **kw),
            lambda: pa.paged_attention_plain(
                q[:, None], *args, table, (lens_t - 1)[:, None], lens_t,
                scale, **kw), "verify_rows_kernel",
            "paged_decode_attention_rows", 200, 20)
        visited = int((bpos < lens_t[:, None]).sum())
        nbytes = (visited * hkv * bs * tok_b + 2 * b * hq * d * 2
                  + b * mb * 8 + b * 4)
        bnd = bound(nbytes, 4.0 * hq * d * sum(lens))
        q8 = q[:, :8].contiguous()
        k7 = device_ms(torch, lambda: pa.paged_decode_attention(
            q8, *args, table, lens_t, scale, **kw), 200,
            "decode_split_kernel", "paged_decode_attention")
        print(f"K7 rows layout timing int8 B={b} Hq={hq} Hkv=1 D={d} "
              f"pages={visited}: device {ms:.5f} ms per launch (plain "
              f"{pms:.5f} ms; wrapper {wms:.5f} ms; bound {bnd[0]:.5f} ms, "
              f"by {bnd[1]}; {nbytes / ms / 1e9:.3f} TB/s); K7's split "
              f"kernel at 8 query heads on the same pages {k7:.5f} ms",
              flush=True)
        if hq == 71:
            timing = dict(ms=ms, plain_ms=pms, bound=bnd,
                          split_g8_ms=k7)
    results["paged_decode_attention_rows"] = dict(max_abs_err=worst,
                                                  **timing)

    # K2 / K4 at Falcon-7B's N: 4672 = 36.5 x 128 (qkv), 4544 = 35.5 x 128
    h, ko, bf = 4544, 128, torch.bfloat16
    sms = wm.sm_count(dev.index or 0)
    x = torch.randn((1024, h), generator=gen, device=dev).to(bf)
    ind = torch.randperm(h, generator=gen, device=dev)[:ko].int()
    tails = {"mixed_matmul": [], "wo_matmul": []}
    for label, k, n in (("qkv", h, 4672), ("o_proj", h, h),
                        ("fc2", 18176, h)):
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        if label != "fc2":             # the mix linears: K2 at prefill
            fpw = (torch.randn((ko, n), generator=gen, device=dev)
                   * 0.02).to(bf)
            for rows in (1024, 40):
                q_x, srow, xo = nq.quant_split(x[:rows].contiguous(), ind)
                k2 = (lambda: mm.mixed_matmul(q_x, srow, xo, qw, scol, fpw),
                      lambda: mm.mixed_matmul_plain(q_x, srow, xo, qw, scol,
                                                    fpw))
                before = _build.LAUNCHES.get("mixed_matmul.n_tail", 0)
                out, again, want = k2[0](), k2[0](), k2[1]()
                torch.cuda.synchronize()
                check(_build.LAUNCHES.get("mixed_matmul.n_tail", 0) - before
                      == 2, "K2's N tail launches not counted")
                err = gemm_err(out, want)
                check(err <= gemm_tol(bf), f"K2 Falcon {label} M={rows}: "
                      f"rel err {err}")
                check(torch.equal(out, again), f"K2 Falcon {label}: two "
                      "launches differ")
                ms, pms, _ = measure(torch, *k2, "mixed_wgmma_kernel",
                                     "mixed_matmul", 20, 5)
                nbytes = (rows * k + rows * 4 + rows * ko * 2 + k * n + n * 4
                          + ko * n * 2 + rows * n * 2)
                bnd = bound(nbytes, 2.0 * rows * n * ko, 2.0 * rows * n * k)
                print(f"K2 N tail (Falcon-7B {label}) M={rows} K={k} N={n}: "
                      f"max rel err {err:.2e}, repeat bit-equal; device "
                      f"{ms:.5f} ms (plain {pms:.5f} ms; bound {bnd[0]:.5f} "
                      f"ms, by {bnd[1]})", flush=True)
                tails["mixed_matmul"].append(dict(
                    label=label, M=rows, K=k, N=n, ms=ms, plain_ms=pms,
                    bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=err))
        for rows in (1, 8, 40, 1024):   # K4: decode, mid, prefill
            xk = x[:rows] if k == h else torch.randn(
                (rows, k), generator=gen, device=dev).to(bf)
            regime = wm.k4_regime(wm.wo_plan(rows, k, n, sms))
            k4 = (lambda: wm.wo_matmul(xk, qw, scol),
                  lambda: wm.wo_matmul_plain(xk, qw, scol))
            before = _build.LAUNCHES.get("wo_matmul.n_tail", 0)
            out, again, want = k4[0](), k4[0](), k4[1]()
            torch.cuda.synchronize()
            check(_build.LAUNCHES.get("wo_matmul.n_tail", 0) - before == 2,
                  "K4's N tail launches not counted")
            err = gemm_err(out, want)
            check(err <= gemm_tol(bf), f"K4 Falcon {label} M={rows}: rel "
                  f"err {err}")
            check(torch.equal(out, again), f"K4 Falcon {label} M={rows}: "
                  "two launches differ")
            big = rows >= 1024
            ms, pms, _ = measure(torch, *k4, K4_MARKS[regime], "wo_matmul",
                                 20 if big else 100, 3 if big else 10)
            bnd = bound(rows * k * 2 + k * n + n * 4 + rows * n * 2,
                        2.0 * rows * n * k)
            lib = int8pack_library(torch, xk, qw, scol, want,
                                   3 if big else 20)
            print(f"K4 N tail ({regime}, Falcon-7B {label}) M={rows} K={k} "
                  f"N={n}: max rel err {err:.2e}, repeat bit-equal; device "
                  f"{ms:.5f} ms (plain {pms:.5f} ms; bound {bnd[0]:.5f} ms, "
                  f"by {bnd[1]}; torch._weight_int8pack_mm "
                  f"{'none' if lib is None else f'{lib[0]:.5f} ms'})",
                  flush=True)
            tails["wo_matmul"].append(dict(
                label=label, M=rows, K=k, N=n, kernel=regime, ms=ms,
                plain_ms=pms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None if lib is None else lib[0],
                max_abs_err=err))
    for name, rows in tails.items():
        results[name]["n_tail"] = rows


def _windows_recorder(pa):
    """Wrap K7's and K8's wrappers to record each call's window; returns
    (records by wrapper name, undo)."""
    rec, real = {}, {}
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        real[name] = fn = getattr(pa, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            rec.setdefault(_name, []).append(int(k.get("window", 0)))
            return _fn(*a, **k)
        setattr(pa, name, wrapped)

    def undo():
        for name, fn in real.items():
            setattr(pa, name, fn)
    return rec, undo


def serve_gemma2(torch, seed: int, dev, gen) -> tuple:
    """Phase 4k(a): Gemma-2-9B (``gemma2_9b_config``, 42 layers, random
    weights from ``seed`` through models/families.init_random_params on
    the card) serves phase 4's 8 requests and one of FAM_LONG prompt
    tokens (the windowed layers truncate) through an Executor
    (block_size 128, max_seq_len FAM_MAX_LEN) after warmup(burst=16), 32
    greedy tokens each at burst 16 (``decode_run``: once timed, once
    profiled). Then LLM over the same params serves 2 of the prompts
    through GenerationSession. Returns {path: launches}."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import families
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = gemma2_9b_config(torch, layers=FAM_LAYERS)
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = families.init_random_params(
        cfg, seed=seed, device=dev,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    torch.cuda.synchronize()
    print(f"model: Gemma-2-9B geometry, {cfg.num_layers} layers, int8_mix "
          f"(128 outliers) / int8 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    rng = np.random.default_rng(seed + 18)
    prompts = sp.ragged_prompts(seed, cfg.vocab_size) + [
        rng.integers(1, cfg.vocab_size, FAM_LONG).tolist()]
    ex = Executor(params, cfg, max_batch=len(prompts),
                  max_seq_len=FAM_MAX_LEN, block_size=128,
                  prefill_chunk=256, seed=seed, device=dev)
    pool_b = 2 * (ex.state.k.numel() + ex.state.k_scale.numel() * 4)
    print(f"phase 4k: pool {ex.state.k.shape[0]} pages x 2 of "
          f"{tuple(ex.state.k.shape[1:])} int8 ({pool_b / 1e9:.2f} GB with "
          f"scales)", flush=True)
    rec, undo = _windows_recorder(pa)
    try:
        t = time.perf_counter()
        ex.warmup(burst=BURST)
        torch.cuda.synchronize()
        print(f"phase 4k: warmup(burst={BURST}) {time.perf_counter() - t:.1f}"
              f" s, rungs {sorted(k for k, *_ in ex._rungs)}", flush=True)
        r = decode_run(torch, sp, params, cfg, prompts, seed, dev, ex, BURST)
    finally:
        undo()
    launches = r["launches"]
    toks = r["toks"]
    check(all(len(t) == 32 for t in toks),
          f"phase 4k: not every lane got 32 tokens "
          f"({[len(t) for t in toks]})")
    check(all(math.isfinite(x) for lps in r["logprobs"] for x in lps),
          "phase 4k: a log-probability is not finite")
    check(r["replays"] == r["calls"] > 0, f"phase 4k: {r['replays']} "
          f"replays for {r['calls']} decode calls")
    check(ex.compiles_since_warmup == 0,
          f"phase 4k: {ex.compiles_since_warmup} programs after warmup")
    for mark, label in FAM_PREFILL_TRACED.items():
        check(any(mark in n for n in r["prefill_names"]),
              f"phase 4k: {label} ({mark}) not traced in the prefill calls")
    expect = {m: n * cfg.num_layers * r["steps"]
              for m, (_, n) in DECODE_TRACED.items()}
    for m, (label, _) in DECODE_TRACED.items():
        check(0 < r["traced"][m] <= expect[m],
              f"phase 4k: {label} ({m}) traced {r['traced'][m]} times in "
              f"the decode replays (expected {expect[m]})")
    layers = cfg.num_layers
    pattern = [cfg.layer_window(i) for i in range(layers)]
    for name, windows in rec.items():
        check(len(windows) % layers == 0 and windows == pattern * (
            len(windows) // layers), f"phase 4k: {name}'s windows by layer "
            f"are not {pattern[:4]}...")
    check(launches.get("paged_decode_attention", 0) == layers * r["steps"],
          f"phase 4k: K7 launched {launches.get('paged_decode_attention')} "
          f"times for {r['steps']} steps of {layers} layers")
    k8 = launches.get("paged_prefill_attention", 0)
    check(k8 > 0 and k8 % layers == 0, f"phase 4k: K8 launched {k8} times, "
          f"not once a layer a prefill call")
    _on_path(launches, "gemma2")
    dec_ms = r["decode_s"] * 1e3
    pre_ms = max(r["prefill_profiled_ms"], 1e-9)
    print(f"phase 4k(a) Gemma-2-9B: 9 requests, prompts "
          f"{[len(p) for p in prompts]} tokens, 32 generated each at burst "
          f"{BURST}; wall {r['wall']:.3f} s = prefill {r['prefill_s']:.3f} s"
          f" + decode {r['decode_s']:.3f} s ({r['steps']} steps in "
          f"{r['calls']} calls, {r['replays']} graph replays); TPOT "
          f"{dec_ms / r['steps']:.2f} ms a step for {len(prompts)} lanes; "
          f"{r['gen'] / r['wall']:.1f} generated tok/s; decode idle share "
          f"{1 - r['busy_ms'] / dec_ms:.3f}; prefill idle share "
          f"{1 - r['prefill_busy_ms'] / pre_ms:.3f} (profiled run); peak "
          f"memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K7 windows "
          f"by layer {pattern[:4]}..., K8 {k8 // layers} prefill calls",
          flush=True)
    print(f"phase 4k(a) traced in decode: "
          + ", ".join(f"{DECODE_TRACED[m][0]} {n} of {expect[m]}"
                      for m, n in r["traced"].items()), flush=True)
    del ex
    torch.cuda.empty_cache()

    out, wall, seen = _timed(torch, lambda: _llm_len(
        params, cfg, dev, FAM_SESSION_LEN).generate_tokens(prompts[:2], 32))
    check(out.num_generated == [32, 32] and all(
        math.isfinite(x) for lps in out.logprobs for x in lps),
          "phase 4k: the session did not give 32 finite tokens a prompt")
    _on_path(seen, "gemma2_session")
    print(f"phase 4k(a) LLM / GenerationSession: 2 prompts "
          f"{[len(p) for p in prompts[:2]]} tokens, 32 generated each; wall "
          f"{wall:.3f} s = prefill {out.prefill_time_s:.3f} s + decode "
          f"{out.decode_time_s:.3f} s (the softcaps take the masked route: "
          f"K14 {seen.get('flash_causal_attention', 0)} launches)",
          flush=True)
    del params
    torch.cuda.empty_cache()
    return {"gemma2": launches, "gemma2_session": seen}


def _llm_len(params, cfg, dev, max_seq_len: int):
    """``_llm`` with its GenerationSession, as LLM's constructor makes it,
    at ``max_seq_len``."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    llm = _llm(params, cfg, dev)
    llm.max_seq_len = max_seq_len
    llm.session = GenerationSession(params, cfg, max_seq_len=max_seq_len,
                                    device=dev)
    return llm


def executor_witness(torch, cfg, prompt, forced):
    """compare_devices' run(device, params) for a 2-layer witness through
    the Executor (one lane, block_size 128, the prompt in one prefill
    call): a logits processor copies each sampled position's raw logits
    into a device buffer at a device counter and forces the next token
    (``forced``, the same on both devices), all in device ops, so it runs
    inside the decode rungs' graphs on the card. warmup(burst=1) captures
    rung 1 first; the counter is reset after it. Returns the prefill's
    logits and WITNESS_STEPS decode steps', the launches with the
    first."""
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    n = WITNESS_STEPS + 1

    def run(device, p):
        buf = torch.zeros((n, cfg.vocab_size), dtype=torch.float32,
                          device=device)
        ctr = torch.zeros((), dtype=torch.long, device=device)
        force = torch.tensor(forced[:n], device=device)

        def record(logits, history):
            i = ctr.clamp(max=n - 1).view(1)
            buf.index_copy_(0, i, logits[:1].float())
            out = torch.full_like(logits, -1e30)
            out.index_fill_(1, force.index_select(0, i), 0.0)
            ctr.add_(1)
            return out

        ex = Executor(p, cfg, max_batch=1,
                      max_seq_len=len(prompt) + 2 * n + 16, block_size=128,
                      prefill_chunk=len(prompt), seed=0, device=device,
                      logits_processors={"record": record})
        ex.warmup(burst=1)
        ctr.zero_()
        _build.reset_launches()
        rid = ex.submit(prompt, max_new_tokens=n, logits_processor="record")
        done = ex.run()
        launches = dict(_build.LAUNCHES)
        check(done[rid].generated == list(forced[:n]),
              "witness: the forced tokens were not generated")
        out = buf.cpu()
        return [(out[i], launches if i == 0 else {}) for i in range(n)]
    return run


def cross_device_families(torch, seed: int, dev) -> dict:
    """Phase 4k(b): card against CPU at 2 layers of full widths, each
    witness a prefill call and WITNESS_STEPS decode steps through the
    Executor (``executor_witness``), logits within FAM_TOL: Gemma-2-9B
    (the window cut to WITNESS_WINDOW and a WITNESS_PROMPT-token prompt,
    so it truncates; every layer global as an enforced control),
    Falcon-7B (K2 / K4 at N % 128 == 64, K7's rows layout), BLOOM-7B1
    (ALiBi: the gather route counted, K5 / K6 launched, no K7 / K8; its
    slopes at zero as an enforced control); Phi-2 (head dim 80) through
    GenerationSession card against CPU, its Executor refused on the card.
    Returns the card runs' launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import families
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    gen = torch.Generator(device=dev)
    rng = np.random.default_rng(seed + 19)
    total = {}
    wit = witness_configs(torch)
    runs = {
        "Gemma-2-9B widths": (
            gemma2_9b_config(torch, layers=2, window=WITNESS_WINDOW),
            [("prefill", ("rmsnorm_quant_split", "mixed_matmul",
                          "paged_write_chunk", "paged_prefill_attention",
                          "paged_decode_attention", "paged_write_token",
                          "wo_matmul"), ("paged_gather",))],
            [("every layer global (windows off)", True, mc, "_layer_window",
              lambda real: lambda cfg, li: 0)]),
        "Falcon-7B widths": (
            wit["falcon-7b"],
            [("prefill", ("rmsnorm_quant_split", "mixed_matmul",
                          "mixed_matmul.n_tail", "wo_matmul",
                          "wo_matmul.n_tail", "paged_decode_attention_rows",
                          "paged_prefill_attention"),
              ("paged_decode_attention", "paged_gather"))], ()),
        "BLOOM-7B1 widths": (
            wit["bloom-7b1"],
            [("prefill", ("rmsnorm_quant_split", "mixed_matmul",
                          "paged_write_chunk", "paged_write_token",
                          "paged_gather"),
              ("paged_decode_attention", "paged_prefill_attention",
               "paged_verify_attention", "paged_decode_attention_rows"))],
            [("ALiBi slopes at zero", True, mc, "alibi_slopes",
              lambda real: lambda n, device=None: torch.zeros(
                  n, device=device))])}
    for label, (cfg, first, faults) in runs.items():
        gen.manual_seed(seed)
        params = families.init_random_params(
            cfg, device=dev, generator=gen,
            act_scales=sp.distinct_act_scales(cfg, gen, dev))
        prompt = rng.integers(1, cfg.vocab_size, WITNESS_PROMPT).tolist()
        forced = rng.integers(1, cfg.vocab_size, WITNESS_STEPS + 1).tolist()
        phases = [(*first[0], FAM_TOL)] + [
            (f"decode step {i + 1}", (), (), FAM_TOL)
            for i in range(WITNESS_STEPS)]
        t = time.perf_counter()
        seen = compare_devices(torch, label, dev,
                               executor_witness(torch, cfg, prompt, forced),
                               params, cpu_copy(torch, params), phases,
                               faults)
        for n, c in seen.items():
            total[n] = total.get(n, 0) + c
        print(f"phase 4k(b) {label}: {time.perf_counter() - t:.1f} s; the "
              f"gather route {seen.get('paged_gather', 0)} calls, K7 rows "
              f"{seen.get('paged_decode_attention_rows', 0)}, K2 N tail "
              f"{seen.get('mixed_matmul.n_tail', 0)}, K4 N tail "
              f"{seen.get('wo_matmul.n_tail', 0)}", flush=True)
        del params
        torch.cuda.empty_cache()

    cfg = wit["phi-2"]
    gen.manual_seed(seed)
    params = families.init_random_params(
        cfg, device=dev, generator=gen,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    try:
        Executor(params, cfg, max_batch=1, max_seq_len=256, block_size=128,
                 device=dev)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("head_dim 80" in refused and "csrc/paged_attention.cu" in refused,
          f"phase 4k: the Executor took Phi-2's head dim 80 ({refused!r})")
    print(f"phase 4k(b) Phi-2: the Executor refuses on the card: {refused}",
          flush=True)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in (200,
                                                                      256)]
    nxt = rng.integers(1, cfg.vocab_size, 2)

    def run(device, p):
        sess = GenerationSession(p, cfg, max_seq_len=512, device=device)
        force = torch.from_numpy(nxt).to(device)[:, None]
        read = []

        def processor(logits, history):
            read.append((logits.float().cpu(), dict(_build.LAUNCHES)))
            _build.reset_launches()
            cols = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(cols[None] == force, 0.0, -torch.inf)

        _build.reset_launches()
        sess.generate(prompts, 2, logits_processors=(processor,))
        return read

    seen = compare_devices(
        torch, "Phi-2 widths (session)", dev, run, params,
        cpu_copy(torch, params),
        [("prefill (head dim 80: the masked route)",
          ("rmsnorm_quant_split", "mixed_matmul", "wo_matmul"),
          tuple(PAGED) + ("flash_causal_attention",), FAM_TOL),
         ("decode step", ("wo_matmul",), tuple(PAGED), FAM_TOL)])
    for n, c in seen.items():
        total[n] = total.get(n, 0) + c
    del params
    torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 4l: the expert models (Mixtral-8x7B at full width and depth;
# Mixtral-8x7B, Qwen1.5-MoE-A2.7B and Qwen3-30B-A3B widths at 2 layers card
# against CPU; K4 alone at Mixtral's expert shapes)
# ---------------------------------------------------------------------------

MOE_NEW, MOE_BEAM_NEW, MOE_BEAM_REQS = 32, 16, 2     # 4l(a)
# 4l(b): card vs CPU, of max |logit|, each witness at the limit of the
# phase that holds its dense path: Mixtral's attention, linears, vocab and
# head are Llama-2-7B's (phase 5, whose prefill reads 2-3e-2), the Qwen
# models' those of the families (phase 4k)
MOE_TOL = {"Mixtral-8x7B": XDEV_TOL, "Qwen1.5-MoE-A2.7B": FAM_TOL,
           "Qwen3-30B-A3B": FAM_TOL}
MOE_CONTROL_X = 3.0                  # 4l(b): a control's least multiple
MOE_PROMPT = 256                     # 4l(b): the witnesses' prompt
# 4l(c): K4 at Mixtral's expert products, (label, K, N, M): 9 rows (the
# all-rows route at 9 lanes) and ~150 (a sorted prefill group)
MOE_K4_CASES = [(lb, k, n, m) for m in (9, 150) for lb, k, n in (
    ("gate_up", 4096, 2 * 14336), ("down", 14336, 4096))]
# the MoE routes' counts (a moe.sorted call is one host readback)
MOE_ROUTES = ("moe.sorted", "moe.all_rows", "moe.groups")
ON_PATH.update({
    # Mixtral-8x7B through the Executor: K1 -> K2 for qkv / o at the
    # prefill chunks, every expert product K4 (its prefill regime on a
    # sorted group, decode in the replays), K4 for qkv / o in the
    # replays, K5-K8; the prefill's MoE layers sorted, the rungs' all rows
    "mixtral": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                "wo_matmul.decode", "wo_matmul.prefill", "paged_write_token",
                "paged_write_chunk", "paged_decode_attention",
                "paged_prefill_attention", "moe.sorted", "moe.all_rows"],
    # its beam bursts: K10 on the pool prefix, every expert K4
    "mixtral_beam": ["paged_decode_attention_stats", "wo_matmul",
                     "moe.all_rows", "rmsnorm_quant_split", "mixed_matmul",
                     "paged_write_chunk", "paged_prefill_attention"]})
OFF_PATH.update({
    "mixtral": ["paged_decode_attention_split", "paged_verify_attention",
                "paged_decode_attention_rows", "wo_matmul_packed",
                "moe.dense"] + NO_GATHER,
    "mixtral_beam": ["paged_decode_attention", "paged_write_token",
                     "moe.dense"] + NO_GATHER})


def mixtral_8x7b_config(torch, layers: int = 32):
    """mistralai/Mixtral-8x7B-v0.1's published config.json: vocab 32000,
    hidden 4096, intermediate 14336, 32 layers, 32 query heads and 8 KV
    heads of 128, 8 experts, top 2 (renormalized), rope theta 1e6, no
    sliding window, untied head, RMSNorm eps 1e-5; int8_mix (128
    outliers: qkv / o mixed, the experts W8A16) with int8 KV."""
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    return ModelConfig(
        arch="mixtral", vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=layers, num_heads=32,
        num_kv_heads=8, head_dim=128, rope_theta=1e6, rms_norm_eps=1e-5,
        max_position_embeddings=32768, num_experts=8, top_k_experts=2,
        tie_word_embeddings=False, dtype=torch.bfloat16,
        quant=QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128,
                          kv_cache=KVCacheQuantAlgo.INT8))


def moe_witness_configs(torch) -> dict:
    """4l(b)'s 2-layer witnesses, HF configs written from the published
    config.json and read by the port's readers: Mixtral-8x7B
    (``mixtral_8x7b_config``), Qwen/Qwen1.5-MoE-A2.7B (hidden 2048, 16
    heads of 128, 60 experts of 1408, top 4 not renormalized, a shared
    expert of 5632 behind a sigmoid gate, qkv biases, vocab 151936) and
    Qwen/Qwen3-30B-A3B (hidden 2048, 32 query heads and 4 KV heads of 128,
    q/k norms, 128 experts of 768, top 8 renormalized, vocab 151936);
    int8_mix (128 outliers) with int8 KV."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import families
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    quant = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128,
                        kv_cache=KVCacheQuantAlgo.INT8)
    common = dict(vocab_size=151936, hidden_size=2048, num_hidden_layers=2,
                  max_position_embeddings=32768, rope_theta=1e6,
                  rms_norm_eps=1e-6, use_sliding_window=False,
                  tie_word_embeddings=False, decoder_sparse_step=1,
                  mlp_only_layers=[])
    hf = {"Qwen1.5-MoE-A2.7B": dict(
              common, model_type="qwen2_moe", intermediate_size=5632,
              num_attention_heads=16, num_key_value_heads=16,
              num_experts=60, num_experts_per_tok=4, norm_topk_prob=False,
              moe_intermediate_size=1408,
              shared_expert_intermediate_size=5632),
          "Qwen3-30B-A3B": dict(
              common, model_type="qwen3_moe", intermediate_size=6144,
              num_attention_heads=32, num_key_value_heads=4, head_dim=128,
              num_experts=128, num_experts_per_tok=8, norm_topk_prob=True,
              moe_intermediate_size=768)}
    out = {"Mixtral-8x7B": mixtral_8x7b_config(torch, layers=2)}
    out.update({name: families.config_from_hf(types.SimpleNamespace(**c),
                                              quant)
                for name, c in hf.items()})
    return out


def check_expert_k4(torch, gen, dev) -> list:
    """4l(c): K4 alone at Mixtral's expert products (MOE_K4_CASES) against
    its plain version, two launches bit-equal, timed beside its bound and
    torch._weight_int8pack_mm, f32 out as the MoE layer asks. Returns the
    kernels-line rows."""
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    bf, sms = torch.bfloat16, wm.sm_count(dev.index or 0)
    f32 = torch.float32
    rows = []
    for label, k, n, m in MOE_K4_CASES:
        xk = torch.randn((m, k), generator=gen, device=dev).to(bf)
        qw = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        regime = wm.k4_regime(wm.wo_plan(m, k, n, sms))
        k4 = (lambda: wm.wo_matmul(xk, qw, scol, out_dtype=f32),
              lambda: wm.wo_matmul_plain(xk, qw, scol, out_dtype=f32))
        out, again, want = k4[0](), k4[0](), k4[1]()
        torch.cuda.synchronize()
        err = gemm_err(out, want)
        check(err <= gemm_tol(f32), f"4l(c) K4 {label} M={m}: rel err {err}")
        check(torch.equal(out, again), f"4l(c) K4 {label} M={m}: two "
              "launches on the same inputs differ")
        ms, pms, wms = measure(torch, *k4, K4_MARKS[regime], "wo_matmul",
                               30, 5)
        flops = 2.0 * m * n * k
        bnd = bound(m * k * 2 + k * n + n * 4 + m * n * 4, flops)
        lib = int8pack_library(torch, xk, qw, scol, want, 20)
        lib_s = ("none" if lib is None
                 else f"{lib[0]:.5f} ms, rel err {lib[1]:.2e}")
        print(f"4l(c) K4 wo_matmul ({regime}) Mixtral expert {label} M={m} "
              f"K={k} N={n} f32 out: max rel err {err:.2e}, repeat "
              f"bit-equal; device {ms:.5f} ms per launch (plain {pms:.5f} "
              f"ms; wrapper {wms:.5f} ms; bound {bnd[0]:.5f} ms, by "
              f"{bnd[1]}, {bnd[0] / ms:.2f} of it; "
              f"torch._weight_int8pack_mm {lib_s})", flush=True)
        rows.append(dict(name=f"wo_matmul[Mixtral expert {label} M={m}]",
                         M=m, K=k, N=n, kernel=regime, max_abs_err=err,
                         ms=ms, plain_ms=pms, bound_ms=bnd[0],
                         bound_by=bnd[1],
                         library_ms=None if lib is None else lib[0]))
        del xk, qw, scol, out, again, want
    return rows


def _param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_param_bytes(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _routes(launches: dict) -> str:
    return ", ".join(f"{n} {launches.get(n, 0)}" for n in MOE_ROUTES)


def serve_mixtral(torch, seed: int, dev, gen) -> dict:
    """4l(a): Mixtral-8x7B (``mixtral_8x7b_config``, 32 layers, random
    weights from ``seed`` through models/llama.init_random_params on the
    card, a layer's f32 experts at a time) serves phase 4's 8 requests, 32
    greedy tokens each, through an Executor (block_size 128) after
    warmup(burst=16): every lane its tokens, finite; every decode call a
    replay, no program after warmup; each rung's graph holds 2 + 2 x 8 K4
    launches a layer a step and the all-rows route only; the prefill
    calls' K4 launches are 2 a non-empty expert group, one MoE readback a
    layer a prefill call. Then one run_beams burst (2 requests x 4 beams x
    16 tokens) after warmup_beams, every burst a replay with K10 on the
    pool prefix. Returns {path: launches}."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = mixtral_8x7b_config(torch)
    layers = cfg.num_layers
    t = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    gen.manual_seed(seed)
    params = llama.init_random_params(
        cfg, device=dev, generator=gen,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    torch.cuda.synchronize()
    wbytes = _param_bytes(params)
    experts = sum(_param_bytes({k: lp["moe"][k] for k in ("gate_up", "down")})
                  for lp in params["layers"])
    print(f"model: Mixtral-8x7B geometry, {layers} layers, int8_mix (128 "
          f"outliers; the experts W8A16) / int8 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s; weights {wbytes / 1e9:.2f} GB "
          f"({experts / 1e9:.2f} GB of int8 experts); peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while "
          f"drawing", flush=True)
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    ex = Executor(params, cfg, max_batch=len(prompts), max_seq_len=768,
                  block_size=128, prefill_chunk=256, seed=seed, device=dev)
    pool_b = 2 * (ex.state.k.numel() + ex.state.k_scale.numel() * 4)
    t = time.perf_counter()
    ex.warmup(burst=BURST)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t
    for key, rung in ex._rungs.items():
        k = rung.k
        check(rung.launches.get("wo_matmul", 0)
              == k * layers * (2 + 2 * cfg.num_experts)
              and rung.launches.get("moe.all_rows", 0) == k * layers
              and not any(rung.launches.get(n) for n in
                          ("moe.sorted", "moe.groups")),
              f"phase 4l: rung {key}'s graph holds {_routes(rung.launches)}"
              f", K4 {rung.launches.get('wo_matmul', 0)} (expected "
              f"{k * layers * (2 + 2 * cfg.num_experts)})")
    reads = ex.readbacks
    r = decode_run(torch, sp, params, cfg, prompts, seed, dev, ex, BURST)
    launches = r["launches"]
    toks = r["toks"]
    check(all(len(t) == MOE_NEW for t in toks),
          f"phase 4l: not every lane got {MOE_NEW} tokens "
          f"({[len(t) for t in toks]})")
    check(all(math.isfinite(x) for lps in r["logprobs"] for x in lps),
          "phase 4l: a log-probability is not finite")
    check(r["replays"] == r["calls"] > 0, f"phase 4l: {r['replays']} "
          f"replays for {r['calls']} decode calls")
    check(ex.compiles_since_warmup == 0,
          f"phase 4l: {ex.compiles_since_warmup} programs after warmup")
    k8 = launches.get("paged_prefill_attention", 0)
    check(k8 > 0 and k8 % layers == 0, f"phase 4l: K8 launched {k8} times, "
          "not once a layer a prefill call")
    check(launches.get("moe.sorted", 0) == k8, f"phase 4l: "
          f"{_routes(launches)} for {k8 // layers} prefill calls of "
          f"{layers} layers (one sorted route and readback a layer a call)")
    decode_k4 = r["steps"] * layers * (2 + 2 * cfg.num_experts)
    prefill_k4 = 2 * launches.get("moe.groups", 0)
    check(launches.get("wo_matmul", 0) == decode_k4 + prefill_k4,
          f"phase 4l: K4 launched {launches.get('wo_matmul', 0)} times, not "
          f"{decode_k4} in the replays ({r['steps']} steps x {layers} layers"
          f" x 18) + {prefill_k4} in the prefill calls (2 a non-empty "
          f"expert group)")
    check(launches.get("moe.all_rows", 0) == r["steps"] * layers,
          f"phase 4l: the all-rows route ran {launches.get('moe.all_rows')}"
          f" times for {r['steps']} steps x {layers} layers")
    for name in ("paged_write_token", "paged_write_chunk",
                 "paged_decode_attention", "paged_prefill_attention"):
        check(launches.get(name, 0) > 0, f"phase 4l: {name} not launched")
    _on_path(launches, "mixtral")
    dec_ms = r["decode_s"] * 1e3
    pre_ms = max(r["prefill_profiled_ms"], 1e-9)
    print(f"phase 4l(a) Mixtral-8x7B: 8 requests, prompts "
          f"{[len(p) for p in prompts]} tokens, {MOE_NEW} generated each at "
          f"burst {BURST}; warmup {warm_s:.1f} s; wall {r['wall']:.3f} s = "
          f"prefill {r['prefill_s']:.3f} s + decode {r['decode_s']:.3f} s "
          f"({r['steps']} steps in {r['calls']} calls, {r['replays']} graph "
          f"replays); TPOT {dec_ms / r['steps']:.2f} ms a step for "
          f"{len(prompts)} lanes (bound: {experts / 1e9:.2f} GB of experts "
          f"read once a step, {experts / HBM_BYTES_PER_MS:.2f} ms); "
          f"{r['gen'] / r['wall']:.1f} generated tok/s; decode idle share "
          f"{1 - r['busy_ms'] / dec_ms:.3f}; prefill idle share "
          f"{1 - r['prefill_busy_ms'] / pre_ms:.3f} (profiled run); token "
          f"readbacks {ex.readbacks - reads} (both runs), MoE readbacks "
          f"{launches.get('moe.sorted', 0)} = {layers} a prefill call "
          f"(timed run); routes: {_routes(launches)}; K4 {decode_k4} in the "
          f"replays + {prefill_k4} in the prefill calls; pools "
          f"{pool_b / 1e9:.2f} GB; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del ex
    torch.cuda.empty_cache()

    import numpy as np
    rng = np.random.default_rng(seed + 20)
    bprompts = [rng.integers(1, cfg.vocab_size, int(m)).tolist()
                for m in rng.integers(200, 257, MOE_BEAM_REQS)]
    ex = Executor(params, cfg, max_batch=MOE_BEAM_REQS, block_size=128,
                  max_seq_len=512, device=dev)
    t = time.perf_counter()
    ex.warmup_beams(num_beams=BEAMS, burst=BEAM_BURST, prompt_bucket=256,
                    max_new_tokens=MOE_BEAM_NEW)
    torch.cuda.synchronize()
    bwarm = time.perf_counter() - t
    b = beam_run(torch, ex, bprompts, MOE_BEAM_NEW, False)
    blaunch = b["launches"]
    check(ex.compiles_since_warmup == 0, f"phase 4l: "
          f"{ex.compiles_since_warmup} beam programs after warmup_beams")
    check(b["graph_replays"] == b["bursts"] > 0, f"phase 4l: "
          f"{b['graph_replays']} replays for {b['bursts']} beam bursts")
    check(all(len(g) == MOE_BEAM_NEW for g in b["toks"]),
          "phase 4l: a beam request did not get its tokens")
    k10 = blaunch.get("paged_decode_attention_stats", 0)
    check(k10 == layers * b["burst_steps"], f"phase 4l: K10 launched {k10} "
          f"times for {b['burst_steps']} burst steps x {layers} layers")
    check(blaunch.get("moe.all_rows", 0) == layers * b["burst_steps"],
          f"phase 4l: beam bursts' routes {_routes(blaunch)}")
    _on_path(blaunch, "mixtral_beam")
    print(f"phase 4l(a) run_beams(burst={BEAM_BURST}): {MOE_BEAM_REQS} "
          f"requests x {BEAMS} beams x {MOE_BEAM_NEW} tokens after "
          f"warmup_beams ({bwarm:.1f} s); wall {b['wall'] * 1e3:.1f} ms = "
          f"prefill {b['prefill_s'] * 1e3:.1f} ms + bursts "
          f"{(b['wall'] - b['prefill_s']) * 1e3:.1f} ms ({b['burst_steps']} "
          f"steps, {b['bursts']} bursts, {b['graph_replays']} replays); "
          f"routes: {_routes(blaunch)}; K10 {k10}", flush=True)
    del ex, params
    torch.cuda.empty_cache()
    return {"mixtral": launches, "mixtral_beam": blaunch}


def swap_kth(real):
    """A control: each token's k-th expert replaced by its (k+1)-th, the
    weights renormalized as the config says."""
    import torch

    def top_k(probs, k, norm):
        vals, ids = real(probs, k + 1, False)
        # slices only: an index list would be copied to the card, which a
        # graph's capture refuses
        vals = torch.cat([vals[:, :k - 1], vals[:, k:]], dim=1)
        ids = torch.cat([ids[:, :k - 1], ids[:, k:]], dim=1)
        if norm:
            vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
        return vals, ids
    return top_k


def flip_renorm(real):
    """A control: the top-k renormalization flipped."""
    return lambda probs, k, norm: real(probs, k, not norm)


def moe_witness(torch, cfg, prompt, forced):
    """compare_devices' run(device, params) for a 2-layer expert witness,
    eager through forward_paged on int8 pages of 128: the prompt in one
    prefill call (the sorted route), then WITNESS_STEPS decode steps of
    the ``forced`` tokens (all rows). Returns the run, the card's expert
    choices of every MoE call (``routes``, filled by a card run) and, for
    the CPU run, how many tokens its own router sent to another expert
    set (``flips``). A CPU run after a card run takes the card's choices,
    weighted by its own probabilities at them: where the two devices'
    activations round a near-tie apart, a token would otherwise go to
    other experts, which is the router's arithmetic, not a kernel's."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import moe
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import init_paged_kv
    n = len(prompt)
    routes, flips = [], []

    def run(device, p):
        real, calls = moe.top_k, [0]

        def top_k(probs, k, norm):
            vals, ids = real(probs, k, norm)
            if device.type != "cpu":
                if calls[0] >= len(routes):
                    routes.append(ids.cpu())
            elif routes:
                card = routes[calls[0]]
                flips.append(int((ids.sort(-1).values != card.sort(-1)
                                  .values).any(-1).sum()))
                ids = card
                vals = torch.gather(probs, 1, ids)
                if norm:
                    vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
            calls[0] += 1
            return vals, ids
        moe.top_k = top_k
        try:
            state = init_paged_kv(cfg, 4, 128, device=device)
            table = torch.tensor([[1, 2, 3]], dtype=torch.int32,
                                 device=device)
            length = torch.tensor([n], dtype=torch.int32, device=device)
            _build.reset_launches()
            lg, _ = mc.forward_paged(
                p, cfg, torch.tensor([prompt], device=device),
                torch.arange(n, dtype=torch.int32, device=device)[None],
                state, table, length, last_pos=length - 1)
            out = [(lg[0, 0].float().cpu(), dict(_build.LAUNCHES))]
            for i, tok in enumerate(forced):
                _build.reset_launches()
                lg, _ = mc.forward_paged(
                    p, cfg, torch.tensor([[tok]], device=device),
                    length[:, None] + i, state, table, length + i + 1)
                out.append((lg[0, 0].float().cpu(), dict(_build.LAUNCHES)))
        finally:
            moe.top_k = real
        return out
    return run, routes, flips


def cross_device_moe(torch, seed: int, dev) -> dict:
    """4l(b): card against CPU at 2 layers of full widths
    (``moe_witness_configs``), each a MOE_PROMPT-token prefill call (the
    sorted route on both devices) and WITNESS_STEPS decode steps (all
    rows) through forward_paged (``moe_witness``: the CPU takes the card's
    expert choices; how many of its own differ is printed), logits within
    the witness's MOE_TOL of the largest; then two controls on the card,
    each of which must move the logits by at least MOE_CONTROL_X times
    that limit: the top-k renormalization flipped, and each token's k-th
    expert replaced by its (k+1)-th. Returns the card runs' launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import families, moe
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    gen = torch.Generator(device=dev)
    rng = np.random.default_rng(seed + 21)
    total = {}
    for label, cfg in moe_witness_configs(torch).items():
        gen.manual_seed(seed)
        params = families.init_random_params(
            cfg, device=dev, generator=gen,
            act_scales=sp.distinct_act_scales(cfg, gen, dev))
        prompt = rng.integers(1, cfg.vocab_size, MOE_PROMPT).tolist()
        forced = rng.integers(1, cfg.vocab_size, WITNESS_STEPS).tolist()
        run, routes, flips = moe_witness(torch, cfg, prompt, forced)
        tol = MOE_TOL[label]
        t = time.perf_counter()
        card = [x for x, _ in run(dev, params)]       # records its routes
        phases = [("prefill", ("rmsnorm_quant_split", "mixed_matmul",
                               "wo_matmul", "moe.sorted",
                               "paged_write_chunk",
                               "paged_prefill_attention"),
                   ("moe.all_rows", "moe.dense", "paged_gather"), tol)
                  ] + [(f"decode step {i + 1}", (
                      "wo_matmul", "moe.all_rows", "paged_write_token",
                      "paged_decode_attention"), ("moe.sorted",), tol)
                      for i in range(WITNESS_STEPS)]
        seen = compare_devices(torch, f"4l(b) {label} widths", dev, run,
                               params, cpu_copy(torch, params), phases)
        calls = len(routes)
        print(f"4l(b) {label}: tokens the CPU's own router sent to another "
              f"expert set than the card's, by MoE call (prefill's layers, "
              f"then each step's): {flips[:calls]}", flush=True)
        for n, c in seen.items():
            total[n] = total.get(n, 0) + c
        for name, fault in (("top-k renormalization flipped", flip_renorm),
                            ("k-th expert replaced by the (k+1)-th",
                             swap_kth)):
            real = moe.top_k
            moe.top_k = fault(real)
            try:
                r = max(_rel(x, w) for (x, _), w in
                        zip(run(dev, params), card))
            finally:
                moe.top_k = real
            print(f"4l(b) {label} control, {name}: {r:.3e} = "
                  f"{r / tol:.1f}x the tolerance {tol}", flush=True)
            check(r >= MOE_CONTROL_X * tol, f"phase 4l: the control "
                  f"({name}) at {label} moved the logits by {r:.3e}, under "
                  f"{MOE_CONTROL_X}x the tolerance")
        print(f"phase 4l(b) {label}: {time.perf_counter() - t:.1f} s; "
              f"card routes {_routes(seen)}", flush=True)
        del params
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------------------
# phase 4m: the recurrent-state models (Mamba-2.8B at its 64 layers and
# RecurrentGemma-2B at 24 of its 26 layers through GenerationSession;
# their first layers at full widths card against CPU)
# ---------------------------------------------------------------------------

REC_NEW = 64                         # 4m(a), (b): tokens generated a lane
REC_PROFILE_NEW = 16                 # 4m(a), (b): tokens of a profiled run
MAMBA_MAX_LEN = 832                  # 4m(a): prompts of 100-700 + 64
# 4m(b): RecurrentGemma-2B's 26 layers cut to the 3-layer pattern's
# multiple (both packages refuse 26); the long lane's prompt and
# max_seq_len (a multiple of 128: the prefill bucket K8's page view takes)
RG_LAYERS, RG_LONG, RG_MAX_LEN = 24, 2300, 2432
REC_TOL = FAM_TOL                    # 4m(c): card vs CPU, of max |logit|
REC_CONTROL_X = 5.0                  # 4m(c): a control's least multiple
# 4m(c): the witnesses' prompts (RecurrentGemma's a 1-token lane, read at
# the position whose state the reset clears, and a long one), its window
# cut to RG_WITNESS_WINDOW under the long lane, and its depth: two
# pattern groups, so that the window and the reset each move the logits
# by 7x the limit (at 3 layers 4-5x, where the tied embedding's own
# logit sets the scale: CPU rehearsal at full widths)
MAMBA_WITNESS_LENS, RG_WITNESS_LENS = (24, 256), (1, 640)
# 4m(c): Mamba's prompts are drawn from this many distinct tokens, as
# text repeats its words: the state then accumulates what a decode step
# reads (its zeroing moves the logits 0.22, 0.10 at 8 words, 0.07 over
# distinct random tokens; CPU rehearsal at full widths)
MAMBA_WITNESS_WORDS = 4
RG_WITNESS_WINDOW, RG_WITNESS_LAYERS = 8, 6
# 4m(a), (b): kernels of a forward by a mark of their traced names, and
# their launches a forward (Mamba: in_proj and out_proj a layer;
# RecurrentGemma a 3-layer group: x / y / out and the MLP's gate_up in
# each recurrent layer, qkv / o and gate_up in the attention layer, K4
# for every layer's down_proj)
REC_TRACED = {"mamba": {"norm_quant": ("K1", 2), "mixed_wgmma": ("K2", 2)},
              "recurrentgemma": {"norm_quant": ("K1", 11 / 3),
                                 "mixed_wgmma": ("K2", 11 / 3),
                                 "wo_": ("K4", 1)}}
ON_PATH.update({
    "mamba": ["rmsnorm_quant_split", "mixed_matmul"],
    "recurrentgemma": ["rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                       "paged_prefill_attention_fp"]})
OFF_PATH.update({
    "mamba": PAGED + ["wo_matmul", "flash_causal_attention"] + NO_GATHER,
    "recurrentgemma": [n for n in PAGED if n != "paged_prefill_attention_fp"]
    + ["flash_causal_attention"] + NO_GATHER})


def mamba_2_8b_config(torch, layers: int = 64):
    """state-spaces/mamba-2.8b-hf's published config.json read by the
    port's reader: vocab 50280, hidden 2560, d_inner 5120, d_state 16,
    dt_rank 160, conv 4, tied head; int8_mix (128 outliers: in_proj /
    out_proj K1 -> K2), bf16."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import mamba
    from mixq_tensorrt_llm_tpu_torch.quant.config import QuantAlgo, QuantConfig
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    return mamba.config_from_hf(types.SimpleNamespace(**dict(
        random_hf.MAMBA_2_8B_HF, num_hidden_layers=layers)),
        QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128))


def recurrentgemma_2b_config(torch, layers: int = RG_LAYERS):
    """google/recurrentgemma-2b's published config.json read by the port's
    reader, cut to ``layers``: vocab 256000, hidden 2560, intermediate
    15360 (7680 a branch), 10 query heads on 1 KV head of 256 (half
    rotary), lru_width 2560, window 2048, conv 4, logit softcap 30;
    int8_mix (128 outliers: the mix linears K1 -> K2, down_proj W8A16 on
    K4), bf16."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import recurrentgemma as rg
    from mixq_tensorrt_llm_tpu_torch.quant.config import QuantAlgo, QuantConfig
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    return rg.config_from_hf(types.SimpleNamespace(**dict(
        random_hf.RECURRENTGEMMA_2B_HF, num_hidden_layers=layers)),
        QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=128))


def recurrent_act_scales(torch, cfg, gen, dev) -> dict:
    """Distinct per-channel calibration absmaxes (a random permutation of
    1..in) under the reference's keys, at each route's input width: the
    o_proj route reads d_inner in Mamba (out_proj), the lru width in
    RecurrentGemma (linear_out, o_proj)."""
    o_in = cfg.intermediate_size if cfg.arch == "mamba" else cfg.q_size
    out = {}
    for i in range(cfg.num_layers):
        for name, n_in in (("self_attn.q_proj", cfg.hidden_size),
                           ("self_attn.o_proj", o_in),
                           ("mlp.gate_proj", cfg.hidden_size),
                           ("mlp.down_proj", cfg.intermediate_size)):
            out[f"model.layers.{i}.{name}"] = (
                torch.randperm(n_in, generator=gen, device=dev).float() + 1)
    return out


def live_recurrence(torch, params, cfg, gen) -> None:
    """Redraw the recurrence's own (unquantized) parameters in place so
    that at random weights the state carries signal to the logits: the
    JAX package's N(0, 0.02) draws (dt bias -4, recurrent_param 1, conv
    N(0, 0.02)) leave the SSM state moving Mamba's logits by 2.3e-3 and
    RecurrentGemma's recurrent branch ~2% of its residual, which no check
    of the recurrence could see. Mamba: x_proj N(0, 1), so B and C are of
    order 1 (the state then moves the logits by 0.48, and a half-ulp
    perturbation of the embedding by 1.0e-2; conv taps as large as
    PyTorch's default init, U(+-1/sqrt(K)), raise that noise past the
    2e-2 limit). RecurrentGemma: HF RecurrentGemmaPreTrainedModel's draws
    of the gates (N(0, sqrt(0.01 / block width)), biases 0) and of
    recurrent_param (a^c uniform in [0.9^2, 0.999^2]), its conv taps
    U(+-1/sqrt(K)), bias 0. (Readings: CPU rehearsal at full widths.)"""
    def uniform(t, lo, hi):
        return t.copy_(torch.rand(t.shape, generator=gen, device=t.device)
                       * (hi - lo) + lo)

    def normal(t, std):
        return t.copy_(torch.randn(t.shape, generator=gen, device=t.device)
                       * std)

    k = cfg.conv_kernel
    for lp in params["layers"]:
        if cfg.arch == "mamba":
            normal(lp["x_proj"]["w"], 1.0)
        elif "recurrent_param" in lp:
            uniform(lp["conv_w"], -k ** -0.5, k ** -0.5)
            lp["conv_b"].zero_()
            bw = lp["input_gate_w"].shape[-1]
            for g in ("input_gate", "recurrent_gate"):
                normal(lp[g + "_w"], (0.01 / bw) ** 0.5)
                lp[g + "_b"].zero_()
            p = lp["recurrent_param"]
            u = uniform(torch.empty_like(p), 0.9 ** 2 + 1e-8,
                        0.999 ** 2 + 1e-8)
            p.copy_(torch.log(torch.exp(-0.5 * torch.log(u)) - 1.0))


def recurrent_model(torch, which: str, dev, gen, seed: int):
    """(cfg, params on the card) of 4m(a) / (b), random weights from
    ``seed`` through the arch's init_random_params on the card, one layer
    at a time, the recurrence redrawn (``live_recurrence``)."""
    from mixq_tensorrt_llm_tpu_torch.models import registry
    cfg = (mamba_2_8b_config(torch) if which == "mamba"
           else recurrentgemma_2b_config(torch))
    gen.manual_seed(seed)
    params = registry.init_random_params(
        cfg, device=dev, generator=gen,
        act_scales=recurrent_act_scales(torch, cfg, gen, dev))
    live_recurrence(torch, params, cfg, gen)
    return cfg, params


def _traced_counts(torch, fn, marks) -> tuple:
    """(device busy ms, {mark: kernels traced whose names hold it}, fn's
    result) of one more call of ``fn`` under torch.profiler, tracing the
    device alone."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return busy_union_ms(ev), {m: sum(m in e.name for e in ev)
                               for m in marks}, out


def serve_recurrent(torch, which: str, cfg, params, seed: int, dev) -> dict:
    """4m(a) / (b): the model serves 8 requests through GenerationSession
    (one static batch, REC_NEW greedy tokens each; Mamba: phase 4's 8
    prompts of 100-700 tokens; RecurrentGemma: 7 of them and one of
    RG_LONG tokens, so its window masks prefill and decode), every launch
    count at 0 just before and read just after: each lane its tokens,
    finite; K1 -> K2 (and RecurrentGemma's K4 and K8) launched as a
    forward's layers ask; walls, TPOT beside the weights' byte bound, the
    idle share of each phase (profiled runs), traced K1 / K2 (/ K4)
    launches against the expected, weight bytes and peak memory
    printed. Returns the launches."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    prompts = sp.ragged_prompts(seed, cfg.vocab_size)
    max_len = MAMBA_MAX_LEN
    label = "4m(a) Mamba-2.8B"
    if which == "recurrentgemma":
        import numpy as np
        prompts[-1] = np.random.default_rng(seed + 22).integers(
            1, cfg.vocab_size, RG_LONG).tolist()
        max_len, label = RG_MAX_LEN, "4m(b) RecurrentGemma-2B"
    layers = cfg.num_layers
    wbytes = _param_bytes(params)
    sess = GenerationSession(params, cfg, max_seq_len=max_len, device=dev)
    sess.generate([prompts[0][:16]], 2)                 # first-use warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out, wall, launches = _timed(torch, lambda: sess.generate(prompts,
                                                              REC_NEW))
    peak = torch.cuda.max_memory_allocated()
    check(out.num_generated == [REC_NEW] * len(prompts),
          f"phase 4m: {label}: not every lane got {REC_NEW} tokens "
          f"({out.num_generated})")
    check(all(math.isfinite(x) for lps in out.logprobs for x in lps),
          f"phase 4m: {label}: a log-probability is not finite")
    forwards = REC_NEW      # the prefill and REC_NEW - 1 decode steps
    traced = REC_TRACED[which]
    expect = {m: round(n * layers) * forwards
              for m, (_, n) in traced.items()}
    for name, m in (("rmsnorm_quant_split", "norm_quant"),
                    ("mixed_matmul", "mixed_wgmma"), ("wo_matmul", "wo_")):
        if m in expect:
            check(launches.get(name, 0) == expect[m],
                  f"phase 4m: {label}: {name} launched "
                  f"{launches.get(name, 0)} times, not {expect[m]} "
                  f"({expect[m] // forwards} a forward x {forwards})")
    attn = layers // 3 if which == "recurrentgemma" else 0
    check(launches.get("paged_prefill_attention_fp", 0) == attn,
          f"phase 4m: {label}: K8 launched "
          f"{launches.get('paged_prefill_attention_fp', 0)} times, not once "
          f"an attention layer at the prefill ({attn})")
    _on_path(launches, which)
    # the idle shares from profiled runs of their own: the prefill alone,
    # then REC_PROFILE_NEW tokens (walls from each run's output)
    pre_busy, _, pre = _traced_counts(
        torch, lambda: sess.generate(prompts, 1), ())
    all_busy, seen, prof = _traced_counts(
        torch, lambda: sess.generate(prompts, REC_PROFILE_NEW), traced)
    prof_expect = {m: n // forwards * REC_PROFILE_NEW
                   for m, n in expect.items()}
    for m, (k, _) in traced.items():
        check(0 < seen[m] <= prof_expect[m], f"phase 4m: {label}: {k} "
              f"({m}) traced {seen[m]} times, expected {prof_expect[m]}")
    steps = REC_NEW - 1
    dec_ms = out.decode_time_s * 1e3
    pre_idle = 1 - pre_busy / (pre.prefill_time_s * 1e3)
    dec_idle = 1 - (all_busy - pre_busy) / (prof.decode_time_s * 1e3)
    bucket = min(b for b in sess.prefill_buckets
                 if b >= max(len(p) for p in prompts))
    print(f"phase {label}: 8 requests, prompts {[len(p) for p in prompts]} "
          f"tokens in one {bucket}-token bucket, {REC_NEW} generated each; wall {wall:.3f} s = prefill "
          f"{out.prefill_time_s:.3f} s + decode {out.decode_time_s:.3f} s; "
          f"TPOT {dec_ms / steps:.2f} ms a step for 8 lanes (bound: "
          f"{wbytes / 1e9:.3f} GB of weights read once a step, "
          f"{wbytes / HBM_BYTES_PER_MS:.3f} ms); "
          f"{sum(out.num_generated) / wall:.1f} generated tok/s; prefill "
          f"idle share {pre_idle:.3f} (device busy {pre_busy:.1f} ms), "
          f"decode idle share {dec_idle:.3f} (busy "
          f"{all_busy - pre_busy:.1f} ms over {REC_PROFILE_NEW - 1} steps; "
          f"profiled runs); weights {wbytes / 1e9:.3f} GB; peak memory "
          f"{peak / 2**30:.2f} GiB; launches counted "
          + ", ".join(f"{k} {expect[m]} ({expect[m] // forwards} a forward)"
                      for m, (k, _) in traced.items())
          + f"; traced over {REC_PROFILE_NEW} forwards "
          + ", ".join(f"{k} {seen[m]} of {prof_expect[m]}"
                      for m, (k, _) in traced.items()),
          flush=True)
    del sess
    torch.cuda.empty_cache()
    return launches


def recurrent_witness(torch, cfg, prompts, forced, dirty=None):
    """compare_devices' run(device, params) over models.common.forward and
    the model's state: (``dirty`` given) first a prefill of other tokens,
    whose state the reset at position 0 must clear; the prompts' prefill
    (right-padded, full_prefill as the session's) read at each lane's
    last position; then one decode step a ``forced`` token."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.ops import _build
    b, s = len(prompts), max(len(p) for p in prompts)

    def run(device, p):
        state = mc.init_kv_cache(cfg, b, s + len(forced), device=device)
        pos = torch.arange(s, dtype=torch.int32, device=device)[None].expand(
            b, s)
        lens = torch.tensor([len(q) for q in prompts], dtype=torch.int32,
                            device=device)
        if dirty is not None:
            mc.forward(p, cfg, torch.tensor(dirty, device=device), pos,
                       state, torch.full_like(lens, s), full_prefill=True,
                       last_pos=lens - 1)
        toks = torch.zeros((b, s), dtype=torch.int64, device=device)
        for i, q in enumerate(prompts):
            toks[i, :len(q)] = torch.tensor(q, device=device)
        _build.reset_launches()
        lg, _ = mc.forward(p, cfg, toks, pos, state, lens,
                           full_prefill=True, last_pos=lens - 1)
        out = [(lg[:, 0].float().cpu(), dict(_build.LAUNCHES))]
        for i, tok in enumerate(forced):
            _build.reset_launches()
            t = torch.tensor([[tok]] * b, device=device)
            lg, _ = mc.forward(p, cfg, t, (lens + i)[:, None], state,
                               lens + i + 1)
            out.append((lg[:, 0].float().cpu(), dict(_build.LAUNCHES)))
        return out
    return run


def zero_ssm_at_decode(real):
    """A control: models/mamba.forward with the SSM state zeroed before
    the first decode step of each state (the conv carry kept)."""
    done = set()

    def forward(params, cfg, tokens, write_pos, cache, *a, **kw):
        if tokens.shape[1] == 1 and id(cache.v) not in done:
            done.add(id(cache.v))
            cache.v.zero_()
        return real(params, cfg, tokens, write_pos, cache, *a, **kw)
    return forward


def cross_device_recurrent(torch, which: str, cfg, params, seed: int,
                           dev) -> dict:
    """4m(c): the served model's first layers at full widths card against
    CPU (Mamba 2 layers, prompts of MAMBA_WITNESS_WORDS recurring tokens;
    RecurrentGemma RG_WITNESS_LAYERS, the window cut
    to RG_WITNESS_WINDOW under a RG_WITNESS_LENS[1]-token lane, the
    prefill after another prompt's so the reset has a state to clear)
    through ``recurrent_witness``: the prefill's and WITNESS_STEPS decode
    steps' logits within REC_TOL of the largest; then two controls on the
    card, each of which must move the logits by REC_CONTROL_X times that
    limit: Mamba's SSM state zeroed between prefill and decode and its
    conv taps reversed; RecurrentGemma's window turned off and its LRU
    reset at position 0 dropped. Returns the card run's launches."""
    import numpy as np
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import mamba
    from mixq_tensorrt_llm_tpu_torch.models import recurrentgemma as rg
    rng = np.random.default_rng(seed + 23)
    never = tuple(n for n in PAGED if n != "paged_prefill_attention_fp") + (
        "flash_causal_attention", "paged_gather")
    if which == "mamba":
        lens, dirty, label = MAMBA_WITNESS_LENS, None, "Mamba-2.8B widths"
        cfg2, sub, sub_cpu = first_layers(torch, params, cfg, 2)
        must = pre_must = ("rmsnorm_quant_split", "mixed_matmul")
        never += ("wo_matmul", "paged_prefill_attention_fp")
        faults = [("the SSM state zeroed between prefill and decode", mamba,
                   "forward", zero_ssm_at_decode),
                  ("the conv taps reversed", mamba, "causal_conv",
                   lambda real: lambda c, st, x, w, b, lv: real(
                       c, st, x, w.flip(0), b, lv))]
    else:
        lens, label = RG_WITNESS_LENS, "RecurrentGemma-2B widths"
        cfg2, sub, sub_cpu = first_layers(
            torch, params, cfg, RG_WITNESS_LAYERS,
            sliding_window=RG_WITNESS_WINDOW)
        dirty = rng.integers(1, cfg.vocab_size, (2, max(lens))).tolist()
        must = ("rmsnorm_quant_split", "mixed_matmul", "wo_matmul")
        pre_must = must + ("paged_prefill_attention_fp",)
        faults = [("the window turned off", mc, "_attention_with_cache",
                   lambda real: lambda *a, **k: real(*a, **dict(k,
                                                                window=0))),
                  ("the LRU reset at position 0 dropped", rg, "_rg_lru",
                   lambda real: lambda lp, x, st, pos, m: real(
                       lp, x, st, pos + 1, m))]
    words = rng.integers(1, cfg.vocab_size, MAMBA_WITNESS_WORDS)
    prompts = [(rng.choice(words, n) if which == "mamba" else
                rng.integers(1, cfg.vocab_size, n)).tolist() for n in lens]
    forced = rng.integers(1, cfg.vocab_size, WITNESS_STEPS).tolist()
    run = recurrent_witness(torch, cfg2, prompts, forced, dirty)
    phases = [(f"prefill (prompts of {list(lens)} tokens)", pre_must,
               never, REC_TOL)] + [
        (f"decode step {i + 1}", must, never + (
            "paged_prefill_attention_fp",), REC_TOL)
        for i in range(WITNESS_STEPS)]
    t = time.perf_counter()
    card = [x for x, _ in run(dev, sub)]
    seen = compare_devices(torch, f"4m(c) {label}, {cfg2.num_layers} "
                           "layers", dev, run, sub, sub_cpu, phases)
    for name, module, attr, fault in faults:
        real = getattr(module, attr)
        setattr(module, attr, fault(real))
        try:
            r = max(_rel(x, w) for (x, _), w in zip(run(dev, sub), card))
        finally:
            setattr(module, attr, real)
        print(f"4m(c) {label} control, {name}: {r:.3e} = "
              f"{r / REC_TOL:.1f}x the tolerance {REC_TOL}", flush=True)
        check(r >= REC_CONTROL_X * REC_TOL, f"phase 4m: the control ({name})"
              f" at {label} moved the logits by {r:.3e}, under "
              f"{REC_CONTROL_X}x the tolerance")
    print(f"phase 4m(c) {label}: {time.perf_counter() - t:.1f} s",
          flush=True)
    del sub, sub_cpu
    return seen


def serve_recurrent_models(torch, seed: int, dev, gen) -> tuple:
    """Phase 4m: for Mamba-2.8B (a) and RecurrentGemma-2B (b), the model
    drawn on the card (``recurrent_model``), served through the session
    (``serve_recurrent``), then its first layers card against CPU
    (``cross_device_recurrent``). Returns ({path: launches}, the
    cross-device card runs' launches)."""
    launches, xdev = {}, {}
    for which in ("mamba", "recurrentgemma"):
        t = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        cfg, params = recurrent_model(torch, which, dev, gen, seed)
        torch.cuda.synchronize()
        print(f"model: {which} {cfg.num_layers} layers at published widths, "
              f"int8_mix (128 outliers), random weights in "
              f"{time.perf_counter() - t:.1f} s; weights "
              f"{_param_bytes(params) / 1e9:.3f} GB; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while "
              f"drawing", flush=True)
        launches[which] = serve_recurrent(torch, which, cfg, params, seed,
                                          dev)
        for n, c in cross_device_recurrent(torch, which, cfg, params, seed,
                                           dev).items():
            xdev[n] = xdev.get(n, 0) + c
        del params
        torch.cuda.empty_cache()
        print(f"phase 4m {which}: {time.perf_counter() - t:.1f} s",
              flush=True)
    return launches, xdev


def check_recurrent_kernels(torch, gen, dev) -> list:
    """Phase 3 at the recurrent-state models' shapes: K8 through
    causal_self_attention's page view at RecurrentGemma-2B's prefill (8
    lanes x RG_MAX_LEN, 10 query heads on 1 KV head of 256, window 2048)
    against the plain masked attention, two launches bit-equal, timed
    beside its bound and SDPA (a boolean window mask, the KV head
    expanded); K1 -> K2 at Mamba-2.8B's in_proj (2560 -> 10240) and
    out_proj (5120 -> 2560) and K4 at RecurrentGemma-2B's down_proj (7680
    -> 2560), at 8 decode rows and 1024 prefill rows, against their plain
    versions, two launches bit-equal, timed beside their bounds. Returns
    the kernels-line rows."""
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
    from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
    from mixq_tensorrt_llm_tpu_torch.ops import ref
    from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
    rows_out = []
    b, s, hq, hkv, d, win = 8, RG_MAX_LEN, 10, 1, 256, 2048
    scale = d ** -0.5
    q = torch.randn((b, s, hq, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    idx = torch.arange(s, device=dev)
    mask = (idx[None, :] <= idx[:, None]) & (idx[None, :] > idx[:, None]
                                             - win)
    k8 = (lambda: fa.causal_self_attention(q, k, v, scale, window=win),
          lambda: ref.attention(q.float(), k.float(), v.float(),
                                mask=mask[None, None], scale=scale))
    out, again, want = k8[0](), k8[0](), k8[1]()
    torch.cuda.synchronize()
    err = float((out.float() - want.float()).abs().max())
    check(err <= ATTN_TOL, f"K8 page view at RecurrentGemma-2B's heads: max "
          f"abs err {err} > {ATTN_TOL}")
    check(torch.equal(out, again), "K8 page view at RecurrentGemma-2B's "
          "heads: two launches differ")
    ms, pms, wms = measure(torch, *k8, "prefill_wgmma_kernel",
                           "paged_prefill_attention_fp", 10, 3)
    pairs = sum(min(i + 1, win) for i in range(s))
    bnd = bound(2 * b * s * hq * d * 2 + 2 * b * s * hkv * d * 2,
                4.0 * b * hq * d * pairs)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).expand(b, hq, s, d) for x in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = device_ms(torch, lambda: sdpa(qt, kt, vt, attn_mask=mask,
                                        scale=scale), 5)
    print(f"K8 (causal_self_attention's page view) RecurrentGemma-2B B={b} "
          f"S={s} Hq={hq} Hkv={hkv} D={d} window={win}: max abs err "
          f"{err:.3e}, repeat bit-equal; device {ms:.5f} ms per launch "
          f"(plain {pms:.5f} ms; wrapper, the page-view copy included, "
          f"{wms:.5f} ms; bound {bnd[0]:.5f} ms, by {bnd[1]}, "
          f"{bnd[0] / ms:.2f} of it); SDPA with the window mask {lib:.5f} "
          f"ms", flush=True)
    rows_out.append(dict(
        name="paged_prefill_attention_fp[RecurrentGemma-2B prefill, 10 q "
        "heads on 1 KV head of 256, window 2048]",
        B=b, S=s, Hq=hq, Hkv=hkv, D=d, max_abs_err=err, ms=ms, plain_ms=pms,
        bound_ms=bnd[0], bound_by=bnd[1], library_ms=lib,
        library="scaled_dot_product_attention, boolean window mask"))
    del q, k, v, out, again, want, qt, kt, vt, mask

    ko, bf = 128, torch.bfloat16
    sms = wm.sm_count(dev.index or 0)
    for label, kk, n, mix in (("Mamba-2.8B in_proj", 2560, 10240, True),
                              ("Mamba-2.8B out_proj", 5120, 2560, True),
                              ("RecurrentGemma-2B down_proj", 7680, 2560,
                               False)):
        qw = torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                           dtype=torch.int8)
        scol = torch.rand((n,), generator=gen, device=dev) * 2e-4 + 1e-5
        ind = torch.randperm(kk, generator=gen, device=dev)[:ko].int()
        fpw = (torch.randn((ko, n), generator=gen, device=dev) * 0.02).to(bf)
        for m in (8, 1024):
            x = torch.randn((m, kk), generator=gen, device=dev).to(bf)
            if mix:
                q_x, srow, xo = nq.quant_split(x, ind)
                fns = (lambda: mm.mixed_matmul(q_x, srow, xo, qw, scol, fpw),
                       lambda: mm.mixed_matmul_plain(q_x, srow, xo, qw, scol,
                                                     fpw))
                name, mark = "mixed_matmul", "mixed_wgmma_kernel"
                nbytes = (m * kk + m * 4 + m * ko * 2 + kk * n + n * 4
                          + ko * n * 2 + m * n * 2)
                bnd = bound(nbytes, 2.0 * m * n * ko, 2.0 * m * n * kk)
            else:
                fns = (lambda: wm.wo_matmul(x, qw, scol),
                       lambda: wm.wo_matmul_plain(x, qw, scol))
                name = "wo_matmul"
                mark = K4_MARKS[wm.k4_regime(wm.wo_plan(m, kk, n, sms))]
                bnd = bound(m * kk * 2 + kk * n + n * 4 + m * n * 2,
                            2.0 * m * n * kk)
            out, again, want = fns[0](), fns[0](), fns[1]()
            torch.cuda.synchronize()
            err = gemm_err(out, want)
            check(err <= gemm_tol(bf), f"{name} {label} M={m}: rel err {err}")
            check(torch.equal(out, again), f"{name} {label} M={m}: two "
                  "launches differ")
            ms, pms, _ = measure(torch, *fns, mark, name, 30, 5)
            lib = (None if mix else
                   int8pack_library(torch, x, qw, scol, want, 20))
            print(f"{name} {label} M={m} K={kk} N={n}: max rel err "
                  f"{err:.2e}, repeat bit-equal; device {ms:.5f} ms (plain "
                  f"{pms:.5f} ms; bound {bnd[0]:.5f} ms, by {bnd[1]}, "
                  f"{bnd[0] / ms:.2f} of it; torch._weight_int8pack_mm "
                  f"{'none' if lib is None else f'{lib[0]:.5f} ms'})",
                  flush=True)
            rows_out.append(dict(name=f"{name}[{label} M={m}]", M=m, K=kk,
                                 N=n, max_abs_err=err, ms=ms, plain_ms=pms,
                                 bound_ms=bnd[0], bound_by=bnd[1],
                                 library_ms=None if lib is None
                                 else lib[0]))
    return rows_out


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
    t = time.perf_counter()
    check_writes(torch, gen, dev, results)
    check_attention(torch, gen, dev, results)
    check_decode_modes(torch, gen, dev, results)
    check_linears(torch, gen, dev, results)
    check_outlier_widths(torch, gen, dev, results)
    check_writes(torch, gen, dev, results, fp=True)
    check_attention(torch, gen, dev, results, fp=True)
    check_packed(torch, gen, dev, results)
    check_flash(torch, gen, dev, results)
    check_family_kernels(torch, gen, dev, results)
    expert_rows = check_expert_k4(torch, gen, dev)      # phase 4l(c)
    recurrent_rows = check_recurrent_kernels(torch, gen, dev)   # 4m
    print(f"phase 3: {time.perf_counter() - t:.1f} s", flush=True)

    # 4. main path: Llama-2-7B int8_mix / int8 KV
    cfg = sp.llama2_7b_config()
    t = time.perf_counter()
    params = llama.init_random_params(
        cfg, seed=args.seed, device=dev,
        act_scales=sp.distinct_act_scales(cfg, gen, dev))
    torch.cuda.synchronize()
    print(f"model: {cfg.num_layers} layers at Llama-2-7B width, int8_mix "
          f"(128 outliers) / int8 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    launches, done, ids = {}, {}, {}
    launches["7b"], done["7b"], ids["7b"] = serve(torch, params, cfg,
                                                  args.seed, dev, "7b")

    # 5. cross-device
    xdev = cross_device(torch, params, cfg, args.seed, dev,
                        "7b int8_mix + int8 KV", faults_7b(torch))
    print(f"phases 4-5: {time.perf_counter() - t:.1f} s", flush=True)

    # 4d. decode bursts: warmup, then the rungs' replays
    t = time.perf_counter()
    launches["burst"] = serve_burst(torch, params, cfg, args.seed, dev,
                                    (done["7b"], ids["7b"]))
    print(f"phase 4d: {time.perf_counter() - t:.1f} s", flush=True)

    # 6. speculative serving, 6b. split decode, on the phase-4 model
    t = time.perf_counter()
    for path in ("spec", "split"):
        launches[path], done[path], ids[path] = serve(
            torch, params, cfg, args.seed, dev, path)
        same = sum(a == b for r, q in zip(ids["7b"], ids[path])
                   for a, b in zip(done["7b"][r].generated,
                                   done[path][q].generated))
        print(f"main path {path}: {same} of {32 * len(ids[path])} tokens "
              f"equal to phase 4's at the same position (a reading: other "
              f"kernels round bf16 differently)", flush=True)

    # 7. cross-device: verify rows and split decode
    for n, c in cross_device_verify(torch, params, cfg, args.seed,
                                    dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phases 6-7: {time.perf_counter() - t:.1f} s", flush=True)

    # 4c. the dense GenerationSession path, 5c. its cross-device check
    t = time.perf_counter()
    launches["dense"] = serve_dense(torch, params, cfg, args.seed, dev)
    for n, c in cross_device_dense(torch, params, cfg, args.seed,
                                   dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phases 4c-5c: {time.perf_counter() - t:.1f} s", flush=True)

    # 4e. beam serving, 5d. a beam burst step card against CPU
    t = time.perf_counter()
    launches["beam"] = serve_beams(torch, params, cfg, args.seed, dev,
                                   "beam")
    for n, c in cross_device_beam(torch, params, cfg, args.seed,
                                  dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phases 4e-5d: {time.perf_counter() - t:.1f} s", flush=True)

    # 4g. the serving surface: prefix reuse, controls, cancel, snapshot,
    # and the HTTP server
    t = time.perf_counter()
    launches["serving"], adopted = serve_serving(torch, params, cfg,
                                                 args.seed, dev)
    for n, c in adopted.items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phase 4g: {time.perf_counter() - t:.1f} s", flush=True)

    # 4j. the decoding extras over the dense cache and runtime LoRA
    t = time.perf_counter()
    launches["spec_session"] = session_speculative(torch, params, cfg,
                                                   args.seed, dev)
    launches.update(tree_decoding(torch, params, cfg, args.seed, dev))
    launches["dense_draft"] = dense_draft(torch, params, cfg, args.seed, dev)
    lp = with_adapters(torch, params, cfg, args.seed, dev)
    launches["lora"] = serve_lora(torch, lp, cfg, args.seed, dev)
    for n, c in cross_device_extras(torch, lp, cfg, args.seed,
                                    dev).items():
        xdev[n] = xdev.get(n, 0) + c
    del lp
    print(f"phase 4j: {time.perf_counter() - t:.1f} s", flush=True)
    del params
    torch.cuda.empty_cache()

    # 4h. the quantization pipeline: HF directory -> calibrated act_scales
    # -> checkpoint -> LLM -> perplexity
    t = time.perf_counter()
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    launches["hf"] = quantize_pipeline(torch, args.seed, dev, config=dict(
        random_hf.LLAMA2_7B_HF, num_hidden_layers=HF_LAYERS))
    print(f"phase 4h: {time.perf_counter() - t:.1f} s", flush=True)

    # 4i. dynamic outliers, fp8 and int8_lr at Llama-2-7B width
    t = time.perf_counter()
    for path, run in (("dyn", serve_dynamic), ("fp8", serve_fp8),
                      ("lr", serve_lr)):
        launches[path], seen = run(torch, args.seed, dev, gen)
        for n, c in seen.items():
            xdev[n] = xdev.get(n, 0) + c
    print(f"phase 4i: {time.perf_counter() - t:.1f} s", flush=True)

    # 4k. the dense decoder families: Gemma-2-9B served at full width and
    # depth, then 2-layer witnesses card against CPU
    t = time.perf_counter()
    launches.update(serve_gemma2(torch, args.seed, dev, gen))
    for n, c in cross_device_families(torch, args.seed, dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phase 4k: {time.perf_counter() - t:.1f} s", flush=True)

    # 4l. the expert models (K4 at Mixtral's expert shapes ran in phase
    # 3): Mixtral-8x7B served at full width and depth, then 2-layer
    # witnesses card against CPU
    t = time.perf_counter()
    launches.update(serve_mixtral(torch, args.seed, dev, gen))
    for n, c in cross_device_moe(torch, args.seed, dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phase 4l: {time.perf_counter() - t:.1f} s", flush=True)

    # 4m. the recurrent-state models (their kernels at their shapes ran in
    # phase 3): Mamba-2.8B and RecurrentGemma-2B served through the
    # session, then their first layers card against CPU
    t = time.perf_counter()
    seen, rec_xdev = serve_recurrent_models(torch, args.seed, dev, gen)
    launches.update(seen)
    for n, c in rec_xdev.items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phase 4m: {time.perf_counter() - t:.1f} s", flush=True)

    # 4b. the int4 path: Llama-2-13B w4a16 / bf16 KV, 40 layers
    cfg = sp.llama2_13b_config()
    t = time.perf_counter()
    params = llama.init_random_params(cfg, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    print(f"model: {cfg.num_layers} layers at Llama-2-13B width, w4a16 "
          f"(packed) / bf16 KV, random weights in "
          f"{time.perf_counter() - t:.1f} s; weights "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    launches["13b"] = serve(torch, params, cfg, args.seed, dev, "13b")[0]
    # 4f. beam serving on bf16 pages
    launches["beam_13b"] = serve_beams(torch, params, cfg, args.seed, dev,
                                       "beam_13b")
    del params
    torch.cuda.empty_cache()

    # 5b. cross-device at 13B width, three configurations
    for n, c in cross_device_13b(torch, args.seed, dev).items():
        xdev[n] = xdev.get(n, 0) + c
    print(f"phases 4b-5b: {time.perf_counter() - t:.1f} s", flush=True)

    # 8. kernels line: launches summed over the main paths' runs (phases
    # 4, 4b, 4c, 4d (its burst-16 run), 4e and 4f (their timed runs), 4g
    # (the reuse run's second wave), 4h (its calibration and int8_mix
    # perplexity runs), 4j (its timed runs), 6 and 6b; the cross-device
    # runs'
    # beside them (with 4g's 2-layer suffix): K13 launches there only)
    rows = []
    for name, (replaces, src) in KERNELS.items():
        r = results[name]
        bms, by = r["bound"]
        by_path = {p: n.get(name, 0) for p, n in launches.items()}
        extra = {"shapes": r["shapes"]} if "shapes" in r else {}
        for key in ("layer_calls", "bound_landed_ms"):
            if key in r:
                extra[key] = r[key]
        if name == "wo_matmul":
            extra = {"launches_by_regime": {
                rg: sum(n.get(f"{name}.{rg}", 0) for n in launches.values())
                for rg in ("decode", "mid", "prefill")},
                "regimes": r["regimes"]}
        if "n_tail" in r:           # N % 128 == 64 (phase 4k's Falcon)
            extra.update(n_tail=r["n_tail"], launches_n_tail=sum(
                n.get(f"{name}.n_tail", 0) for n in launches.values()),
                launches_n_tail_cross_device=xdev.get(f"{name}.n_tail", 0))
        if "split_g8_ms" in r:
            extra["split_kernel_at_8_heads_ms"] = r["split_g8_ms"]
        rows.append({"name": name, "route": "cuda", "source": SRC + src,
                     "replaces": replaces,
                     "launches": sum(by_path.values()),
                     "launches_by_path": by_path, **extra,
                     "launches_cross_device": xdev.get(name, 0),
                     "pages": ("bf16" if name.endswith("_fp") else
                               "int8" if name.startswith("paged") else None),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bms,
                     "bound_by": by, "library_ms": r.get("library_ms"),
                     "library": r.get("library")})
    # K4 at Mixtral's expert products (phase 4l(c)); its launches are the
    # Mixtral paths' (every expert product a K4 launch)
    moe_k4 = sum(launches[p].get("wo_matmul", 0)
                 for p in ("mixtral", "mixtral_beam"))
    for r in expert_rows:
        rows.append({"route": "cuda", "source": SRC + "wo_matmul.cu",
                     "replaces": KERNELS["wo_matmul"][0],
                     "launches": moe_k4, **r})
    # K8, K2 and K4 at the recurrent-state models' shapes (phase 3); their
    # launches are the phase-4m paths'
    for r in recurrent_rows:
        name = r["name"].split("[")[0]
        rows.append({"route": "cuda", "source": SRC + KERNELS[name][1],
                     "replaces": KERNELS[name][0],
                     "launches": sum(launches[p].get(name, 0) for p in
                                     ("mamba", "recurrentgemma")), **r})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
