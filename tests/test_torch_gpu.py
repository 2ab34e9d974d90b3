"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: they skip with a reason where there is no CUDA card
(run them on one with `python -m pytest -m gpu tests/test_torch_gpu.py`).
Whether a card is present is decided inside the fixture, never at import,
so every pytest-xdist worker collects the same tests.

K5/K6 must be bit-equal to the plain quantize-and-scatter outside the
trash row 0, K5p/K6p to the plain cast-and-scatter, and so must
kv_cache.paged_write, one launch a call that locates its tokens itself
(S 1, 5, 8, 11, 40, 64, 256; int8, bf16, f32 pools; with and without
block_pos, a valid mask or kv_valid_len; strided and unaligned rows,
expanded positions and a strided mask; one traced kernel a call);
K7/K8 within 2e-2 of the plain f32 attention (bf16 q/out) on int8,
bf16 and f32 pages.
K1: int8 codes at most 1 apart and > 99.9% equal (the norm's f32 sum runs
in another order), scales rtol 1e-5, x_out 1e-2, in both of its kernels
(registers, shared memory), two launches bit-equal. K2/K3/K4 differ from
their plain versions only in the order of f32 sums: 1e-4 of the largest
|output| in f32, one bf16 step more in bf16; K2 with unit scales and no
outliers is the int32 product, bit for bit. K12/K13 (packed int4) as K4,
against the unpack-then-plain versions. K9 (verify rows) within 2e-2 of
plain, and at S = 1 bit-equal to K10's output rounded to q's dtype; K10
out within 2e-2 and its (m, l) within 1e-3 relative; K11 (one launch of
K7's kernel a call) within 2e-2 of its plain version and of K7, two
launches bit-equal, its merge fault seen. K14 (causal flash attention)
within 2e-2 of its plain version at D 64, 128 and 256, S 1, 63, 65, 128,
200 and 2048 on strided views, the same bits from strided views as from
contiguous copies. K4 (mma and wgmma regimes), K12 and K13 across their
K splits: within tolerance and bit-equal on a repeated launch; K4 and K13
on integer inputs (unit or power-of-two scales) equal to the exact
product bit for bit. Speculative serving, split decode and the dense
session at a tiny width, by the kernels they launch; a CUDA session
raises when a kernel library does not load. The Executor's decode rungs
(captured CUDA graphs): a replay bit-equal to the same steps run
eagerly, LAUNCHES after n replays n times the capture's counts, no eager
decode forward after a rung's first use, replays drawing anew from the
registered generator, scratch refusing to grow while capturing, a failed
capture raising with no eager retry, and run(burst=8) after warmup giving
run()'s greedy tokens with no program made after warmup. Beam bursts
(runtime/beam.py): a burst's replay bit-equal to the same burst run
eagerly (sequences, scores, pools outside the trash row), each replay
launching K10 once a layer a step and neither K7 nor K5; the tail
attention with K10 within 2e-2 of its plain route on int8 and bf16
pages; run_beams after warmup_beams making no program, every burst a
replay. The serving surface: a rung whose lanes carry bad words and a
logits processor, a replay bit-equal to its eager body; a processor that
reads the device failing its capture with no eager retry; a prefill
after adopted pages (prefix reuse) through K6, bit-equal to the plain
write, and K8, within 2e-2 of its plain version, with a cold run's
tokens. Dynamic outliers, fp8 and int8_lr: K1 (no norm) at an empty,
32- and 256-wide fp_ind (100 entries -1) and K2 at those ko against
their plain versions; the adaptive linear card against CPU (selection
and state equal, output within K2's tolerance); the e4m3 casts card
against CPU byte for byte; an fp8 Executor's decode as graph replays
with no paged kernel and the gather route counted, none on int8 pools;
GenerationSession over an e4m3 dense cache; int8_lr's K1 -> K2 route in
prefill and in the decode replays, traced.
The decoding extras and runtime LoRA at the tiny width: a Medusa tree
verify (mask, rope_pos, hidden) and a LoRA lane's forward card against
CPU, K1 only without its norm under adapters, Medusa decoding and an
adapted Executor's replays.
The dense families: K7's rows layout at 71 and 48 query heads a KV head
(Falcon-7B, the MQA coders) within 2e-2 of plain, one launch counted as
paged_decode_attention_rows, two launches bit-equal; K2 and K4 in its
three regimes at N = 4672 (Falcon-7B's qkv) and 1600 (GPT-2 XL), a
partial last column tile, against their plain versions and counted as
.n_tail; a Gemma-2 model's windowed and global layers through K7 and K8
on the card against the CPU.
The expert models (models/moe.py): the sorted route (one K4 launch an
expert and projection on the non-empty experts, one readback) and the
all-rows route (2 x E K4 launches, none read back) on int8, unpacked
int4, grouped int4 (the plain route by format) and float stacks against
the CPU's plain versions within 1e-3 of the largest output; the all-rows
route captured in a CUDA graph, its replay bit-equal to the eager call;
a tiny Mixtral Executor's rungs holding 2 + 2 x E K4 launches a layer a
step and the all-rows route only, its first tokens the CPU Executor's.
The recurrent-state models: a 2-layer Mamba and a 3-layer RecurrentGemma
(int8_mix), a prefill and 4 decode steps over their state card against
CPU within 2e-2, K1 -> K2 (and RecurrentGemma's K4 and K8) launched as
their layers ask."""

import os

import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu_torch.ops import _build
from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as mm
from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as nq
from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pa
from mixq_tensorrt_llm_tpu_torch.ops import paged_write as pw
from mixq_tensorrt_llm_tpu_torch.ops import ref
from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
from mixq_tensorrt_llm_tpu_torch.quant import core as qcore
from mixq_tensorrt_llm_tpu_torch.runtime.kv_cache import PAD_POS

NP_, BS, D = 24, 16, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _pools(gen, dev, hkv):
    return {
        "k": torch.randint(-127, 128, (NP_, hkv, BS, D), generator=gen,
                           device=dev, dtype=torch.int8),
        "v": torch.randint(-127, 128, (NP_, hkv, BS, D), generator=gen,
                           device=dev, dtype=torch.int8),
        "k_scale": torch.rand((NP_, hkv, BS), generator=gen, device=dev)
        * 0.02 + 1e-3,
        "v_scale": torch.rand((NP_, hkv, BS), generator=gen, device=dev)
        * 0.02 + 1e-3,
    }


def _same_outside_trash(a, b):
    return all(torch.equal(a[n][1:], b[n][1:]) for n in a)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_write_kernels_bit_equal(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    pools = _pools(gen, cuda, 4)
    before = dict(_build.LAUNCHES)
    pg = torch.tensor([3, 0, 9, 5], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 4, 15, 2], dtype=torch.int32, device=cuda)
    nk = (torch.randn((4, 4, D), generator=gen, device=cuda) * 3).to(dtype)
    nv = (torch.randn((4, 4, D), generator=gen, device=cuda) * 3).to(dtype)
    ker = {k: v.clone() for k, v in pools.items()}
    pln = {k: v.clone() for k, v in pools.items()}
    pw.paged_write_token(ker, pg, off, nk, nv)
    pw.paged_write_token_plain(pln, pg, off, nk, nv)
    assert _same_outside_trash(ker, pln)

    blk = torch.tensor([[7] * BS + [8] * 5 + [0] * (BS - 5), [0] * 2 * BS],
                       dtype=torch.int32, device=cuda)
    off = torch.arange(2 * BS, dtype=torch.int32, device=cuda).remainder(
        BS).repeat(2, 1)
    nk = (torch.randn((2, 2 * BS, 4, D), generator=gen, device=cuda)
          * 3).to(dtype)
    nv = (torch.randn((2, 2 * BS, 4, D), generator=gen, device=cuda)
          * 3).to(dtype)
    pw.paged_write_chunk(ker, blk, off, nk, nv)
    pw.paged_write_chunk_plain(pln, blk, off, nk, nv)
    torch.cuda.synchronize()
    assert _same_outside_trash(ker, pln)
    assert _build.LAUNCHES["paged_write_token"] == \
        before.get("paged_write_token", 0) + 1
    assert _build.LAUNCHES["paged_write_chunk"] == \
        before.get("paged_write_chunk", 0) + 1


def _layer_write_case(gen, dev, s, pool, with_bpos, layout, pad, h=4,
                      d=64, b=4):
    """kv_cache.paged_write's inputs as a layer gives them: 4 lanes of S
    tokens over 16-token pages (lane 0 from position 0, or 3 before its
    last; lane 1 on a recycled table, the page of its last token dropped
    from the window when block_pos is given; lane 2 inactive: table 0;
    lane 3 with its last tokens padded to PAD_POS if ``pad``, which needs
    a mask), distinct pages, a valid mask and
    the lengths it comes from, new K contiguous and new V a strided slice
    of a packed qkv row ("unaligned": both views 2 bytes off, the kernel's
    scalar route)."""
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as kvc
    np_, bs = 96, BS
    chunk = pw.chunk_route(s, bs)
    starts = [0, 2 * bs, 0, bs] if chunk else [bs - 3, 2 * bs + 5, 0, 9]
    mb = -(-(max(starts) + s) // bs) + 1
    table = (torch.randperm(np_ - 1, generator=gen, device=dev)[:b * mb]
             + 1).int().reshape(b, mb)
    table[2] = 0
    bpos = (torch.arange(mb, dtype=torch.int32, device=dev) * bs).repeat(
        b, 1)
    perm = torch.randperm(mb, generator=gen, device=dev)
    bpos[1] = bpos[1][perm]
    table[1] = table[1][perm]
    if with_bpos:                 # the recycled page that holds tokens
        last = (starts[1] + s - 1) // bs * bs
        bpos[1, int((bpos[1] == last).nonzero())] = (mb + 3) * bs
    bpos[2] = int(PAD_POS)
    pos = torch.tensor(starts, dtype=torch.int32, device=dev)[:, None] + \
        torch.arange(s, dtype=torch.int32, device=dev)
    lens = torch.tensor([starts[0] + max(s - 2, 1), starts[1] + s, 0,
                         starts[3] + max(s - 3, 1)], dtype=torch.int32,
                        device=dev)
    if pad and s > 3:
        pos[3, -3:] = int(PAD_POS)
    valid = pos < lens[:, None]
    width = (8 + 2 * h) * d + (1 if layout == "unaligned" else 0)
    dtype = torch.float32 if pool == "float32" else torch.bfloat16
    qkv = (torch.randn((b, s, width), generator=gen, device=dev)
           * (torch.rand((b, s, 1), generator=gen, device=dev) * 4 + 0.01)
           ).to(dtype)
    o = width - 2 * h * d
    nk = qkv[..., o:o + h * d].reshape(b, s, h, d)
    if layout != "unaligned":
        nk = nk.contiguous()
    nv = qkv[..., o + h * d:].reshape(b, s, h, d)
    if pool == "int8":
        pools = _pools(gen, dev, h)
        pools = {n: torch.cat([t] * 4) for n, t in pools.items()}
    else:
        pools = {n: (torch.randn((np_, h, bs, d), generator=gen, device=dev)
                     * 2).to(getattr(torch, pool)) for n in ("k", "v")}
    return kvc, pools, table, pos, (bpos if with_bpos else None), valid, \
        lens, nk, nv


def _traced_kernels(fn):
    """Names of the device activities one call of fn queues, by
    torch.profiler (a window is traced again, up to six times, where the
    tracer returns no device activity at all)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(6):
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return []


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["strided", "unaligned", "expanded"])
@pytest.mark.parametrize("mask", ["none", "valid", "kv_valid_len"])
@pytest.mark.parametrize("with_bpos", [False, True])
@pytest.mark.parametrize("pool", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("s", [1, 5, 8, 11, 40, 64, 256])
def test_layer_write_one_launch_bit_equal(cuda, s, pool, with_bpos, mask,
                                          layout):
    """kv_cache.paged_write on the card is one launch of K5 (S <= 8, and S
    11 and 40, not multiples of the page: every column) or K6 (S 64 and
    256), locating each token in the kernel, and leaves pools and scales
    bit-equal outside the trash row to the plain route (_locate, then the
    plain scatter or the chunk's drop rule), with and without block_pos, a
    valid mask or kv_valid_len, from a strided V (and unaligned rows).
    "expanded": the draft prefill's positions, arange(S) expanded over the
    lanes (a lane stride of 0), and a valid mask that is a strided view.
    The call queues one write kernel and no other device work, by the
    traced names: V and the index tensors are read through their
    strides, not copied."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    kvc, pools, table, pos, bpos, valid, lens, nk, nv = _layer_write_case(
        gen, cuda, s, pool, with_bpos, layout,
        pad=mask != "none" and layout != "expanded")
    if layout == "expanded":
        pos = torch.arange(s, dtype=torch.int32, device=cuda)[None].expand(
            table.shape[0], s)
        valid = torch.stack([pos < lens[:, None]] * 2, -1)[..., 0]
        assert pos.stride() == (0, 1) and not valid.is_contiguous()
    kw = dict(block_pos=bpos,
              valid=valid if mask == "valid" else None,
              kv_valid_len=lens if mask == "kv_valid_len" else None)
    ker = {k: v.clone() for k, v in pools.items()}
    pln = {k: v.clone() for k, v in pools.items()}
    name = ("paged_write_chunk" if pw.chunk_route(s, BS)
            else "paged_write_token") + ("" if pool == "int8" else "_fp")
    before = dict(_build.LAUNCHES)
    kvc.paged_write(ker, table, pos, nk, nv, **kw)
    assert _launched(name, before) == 1
    assert sum(_build.LAUNCHES.values()) - sum(before.values()) == 1
    names = _traced_kernels(      # the same write again: the same bits
        lambda: kvc.paged_write(ker, table, pos, nk, nv, **kw))
    kname = ("write_chunk_kernel" if pw.chunk_route(s, BS)
             else "write_token_kernel")
    assert len(names) == 1 and kname in names[0], names
    kvc.paged_write_plain(pln, table, pos, nk, nv, **kw)
    torch.cuda.synchronize()
    assert _same_outside_trash(ker, pln)
    assert not _same_outside_trash(ker, pools)


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [(4, 4, 0, 0, 0.0), (8, 2, 24, 16, 0.0),
                          (8, 2, 0, 0, 20.0)])
def test_attention_kernels_match_plain(cuda, hq, hkv, window, sink,
                                       softcap):
    gen = torch.Generator(device=cuda).manual_seed(1)
    pools = _pools(gen, cuda, hkv)
    args = (pools["k"], pools["v"], pools["k_scale"], pools["v_scale"])
    scale = D ** -0.5
    kw = dict(window=window, sink=sink, softcap=softcap)
    # lane 0: 3 pages with a recycled order; lane 1: inactive
    table = torch.tensor([[4, 6, 5, 5], [0, 0, 0, 0]], dtype=torch.int32,
                         device=cuda)
    bpos = torch.tensor([[0, 2 * BS, BS, PAD_POS], [PAD_POS] * 4],
                        dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 1], dtype=torch.int32, device=cuda)
    q = torch.randn((2, hq, D), generator=gen, device=cuda).bfloat16()
    out = pa.paged_decode_attention(q, *args, table, lens, scale,
                                    block_pos=bpos, **kw)
    ref = pa.paged_attention_plain(q[:, None], *args, table,
                                   (lens - 1)[:, None], lens, scale,
                                   block_pos=bpos, **kw)[:, 0]
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    assert float((out.float() - ref.float()).abs().max()) <= 2e-2

    c = 40                         # not a multiple of the 16-token tile
    qs = torch.tensor([8, 0], dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 0], dtype=torch.int32, device=cuda)
    q = torch.randn((2, c, hq, D), generator=gen, device=cuda).bfloat16()
    out = pa.paged_prefill_attention(q, *args, table, qs, lens, scale,
                                     block_pos=bpos, **kw)
    pos = qs[:, None] + torch.arange(c, device=cuda)
    ref = pa.paged_attention_plain(q, *args, table, pos, lens, scale,
                                   block_pos=bpos, **kw)
    torch.cuda.synchronize()
    valid = (pos < lens[:, None])[:, :, None, None]
    err = torch.where(valid, (out.float() - ref.float()).abs(), 0.0)
    assert float(err.max()) <= 2e-2


def _launched(name, before):
    return _build.LAUNCHES.get(name, 0) - before.get(name, 0)


def _close(out, want, dtype):
    """1e-4 of the largest |value| in f32; in bf16 one bf16 step (2^-7 of
    the value at most) plus that."""
    o, w = out.float(), want.float()
    top = float(w.abs().max())
    if dtype == torch.float32:
        return float((o - w).abs().max()) <= 1e-4 * top
    return bool(((o - w).abs() <= w.abs() * 2 ** -7 + 1e-4 * top).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [4096, 11008])
def test_norm_quant_kernel_matches_plain(cuda, dtype, k):
    gen = torch.Generator(device=cuda).manual_seed(2)
    m, ko = 100, 128
    x = (torch.randn((m, k), generator=gen, device=cuda) * 3).to(dtype)
    gamma = torch.rand((k,), generator=gen, device=cuda) + 0.5
    ind = torch.randperm(k, generator=gen, device=cuda)[:ko].sort().values
    ind = ind.int()
    before = dict(_build.LAUNCHES)
    for got, want in (
            (nq.rmsnorm_quant_split(x, gamma, ind),
             nq.rmsnorm_quant_split_plain(x, gamma, ind)),
            (nq.quant_split(x, ind), nq.quant_split_plain(x, ind))):
        torch.cuda.synchronize()
        diff = (got[0].int() - want[0].int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) \
            > 0.999
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[2].float(), want[2].float(),
                                   rtol=1e-2, atol=1e-2)
    assert _launched("rmsnorm_quant_split", before) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,variant", [(40, 4096, "registers"),
                                         (1024, 4096, "registers"),
                                         (40, 32768, "shared")])
def test_norm_quant_kernels_rows_and_repeats(cuda, dtype, m, k, variant):
    """K1 at the verify's 40 rows and a prefill call's 1024 (7B width, the
    register kernel at FEW_ROW_CHUNKS and MANY_ROW_CHUNKS chunks a
    thread; at 1024 rows each block walks several) and at the widest row
    (the shared-memory kernel), with and without the norm: K1's
    tolerances against plain, two launches bit-equal, one launch a call,
    the outlier channels 0 in q_x."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    ko = 128
    assert nq.norm_quant_plan(m, k, wm.sm_count(cuda.index or 0)).variant \
        == variant
    x = (torch.randn((m, k), generator=gen, device=cuda) * 3).to(dtype)
    gamma = torch.rand((k,), generator=gen, device=cuda) + 0.5
    ind = torch.randperm(k, generator=gen, device=cuda)[:ko].sort().values
    ind = ind.int()
    for kfn, pfn in ((lambda: nq.rmsnorm_quant_split(x, gamma, ind),
                      lambda: nq.rmsnorm_quant_split_plain(x, gamma, ind)),
                     (lambda: nq.quant_split(x, ind),
                      lambda: nq.quant_split_plain(x, ind))):
        before = dict(_build.LAUNCHES)
        got, again = kfn(), kfn()
        assert _launched("rmsnorm_quant_split", before) == 2
        want = pfn()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        diff = (got[0].int() - want[0].int()).abs()
        assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) \
            > 0.999
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
        torch.testing.assert_close(got[2].float(), want[2].float(),
                                   rtol=1e-2, atol=1e-2)
        assert bool((got[0][:, ind.long()] == 0).all())


def _mix_operands(gen, dev, m, k, n, ko):
    return dict(
        q_x=torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8),
        scale_row=torch.rand((m,), generator=gen, device=dev) * 0.02 + 1e-3,
        x_outliers=(torch.randn((m, ko), generator=gen, device=dev)
                    * 4).bfloat16(),
        qweight=torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                              dtype=torch.int8),
        scale_col=torch.rand((n,), generator=gen, device=dev) * 1e-3 + 1e-4,
        fp_weight=(torch.randn((ko, n), generator=gen, device=dev)
                   * 0.05).bfloat16())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 100, 300])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_matmul_kernels_match_plain(cuda, m, silu, dtype):
    gen = torch.Generator(device=cuda).manual_seed(3)
    ops = _mix_operands(gen, cuda, m, 512, 384, 128)
    want = mm.mixed_matmul_plain(**ops, silu=silu, out_dtype=dtype)
    before = dict(_build.LAUNCHES)
    for fn in (mm.mixed_matmul, mm.mixed_matmul_hybrid):
        out = fn(**ops, silu=silu, out_dtype=dtype)
        torch.cuda.synchronize()
        assert out.dtype == dtype and out.shape == (m, 384)
        assert _close(out, want, dtype), fn.__name__
    assert _launched("mixed_matmul", before) == 1
    assert _launched("mixed_matmul_hybrid", before) == 1


@pytest.mark.gpu
def test_mixed_matmul_int32_exact(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    m, k, n = 200, 4096, 256
    ops = _mix_operands(gen, cuda, m, k, n, 128)
    ops.update(scale_row=torch.ones((m,), device=cuda),
               scale_col=torch.ones((n,), device=cuda),
               x_outliers=torch.zeros((m, 128), device=cuda).bfloat16())
    out = mm.mixed_matmul(**ops, out_dtype=torch.float32)
    exact = ref.int8_matmul(ops["q_x"], ops["qweight"]).float()
    torch.cuda.synchronize()
    assert torch.equal(out, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(1, 2048, 384), (40, 2048, 384),
                                   (129, 2048, 384), (1024, 2048, 384),
                                   (1024, 1024, 4096)])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixed_wgmma_matches_plain_and_repeats(cuda, m, k, n, silu, dtype):
    """K2 at the row tiles it serves (16, 48 and 128 rows of x a block;
    129 a ragged second tile), N = 384 half a 256-column tile, 72 outlier
    channels (a ragged side stage); K split across blocks where the tiles
    leave SMs idle (every case but the last, whose 128 tiles fill the
    card): within tolerance of plain, two launches bit-equal (the split
    sums are integers), one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(30 + m)
    ops = _mix_operands(gen, cuda, m, k, n, 72)
    plan = mm.mixed_plan(m, k, n, wm.sm_count(cuda.index or 0))
    before = dict(_build.LAUNCHES)
    out = mm.mixed_matmul(**ops, silu=silu, out_dtype=dtype)
    again = mm.mixed_matmul(**ops, silu=silu, out_dtype=dtype)
    want = mm.mixed_matmul_plain(**ops, silu=silu, out_dtype=dtype)
    torch.cuda.synchronize()
    assert (plan.splits == 1) == (n == 4096)
    assert out.dtype == dtype and out.shape == (m, n)
    assert _close(out, want, dtype)
    assert torch.equal(out, again)
    assert _launched("mixed_matmul", before) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 40, 1024])
def test_mixed_wgmma_int32_exact_split(cuda, m):
    """Unit scales and no outliers at 7B o_proj's K and a 256-column N: the
    int32 product bit for bit, K split 8 or more ways at 1 and 40 rows."""
    gen = torch.Generator(device=cuda).manual_seed(40 + m)
    k, n = 4096, 256
    ops = _mix_operands(gen, cuda, m, k, n, 128)
    ops.update(scale_row=torch.ones((m,), device=cuda),
               scale_col=torch.ones((n,), device=cuda),
               x_outliers=torch.zeros((m, 128), device=cuda).bfloat16())
    out = mm.mixed_matmul(**ops, out_dtype=torch.float32)
    exact = ref.int8_matmul(ops["q_x"], ops["qweight"]).float()
    torch.cuda.synchronize()
    assert torch.equal(out, exact)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 3, 8, 16, 17, 40, 64, 100, 128, 129, 300,
                               1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wo_matmul_kernel_matches_plain(cuda, m, dtype):
    """K4 in both regimes (the mma kernel to K4_MMA_MAX_ROWS rows, the
    wgmma GEMM above): K = 1056 is no multiple of the 64-row stage, N = 384
    no multiple of the GEMM's 256-column tile."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    k, n = 1056, 384
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    scol = torch.rand((n,), generator=gen, device=cuda) * 2e-3 + 1e-4
    before = dict(_build.LAUNCHES)
    out = wm.wo_matmul(x, qw, scol, out_dtype=dtype)
    want = wm.wo_matmul_plain(x, qw, scol, out_dtype=dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    assert _close(out, want, dtype)
    assert _launched("wo_matmul", before) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 17, 40, 64, 100, 300])
def test_wo_matmul_exact_on_integer_inputs(cuda, m):
    """Integer x and unit scales: every product and sum is exact in f32,
    so K4 equals the integer product bit for bit in both regimes: the int8
    -> bf16 conversion is exact for every byte."""
    gen = torch.Generator(device=cuda).manual_seed(11 + m)
    k, n = 2048, 512
    xi = torch.randint(-8, 9, (m, k), generator=gen, device=cuda)
    qw = torch.randint(-128, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    out = wm.wo_matmul(xi.bfloat16(), qw, torch.ones((n,), device=cuda),
                       out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, (xi.double() @ qw.double()).float())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 16, 40, 64, 128])
@pytest.mark.parametrize("k,n", [(4096, 4096), (11008, 4096)])
def test_wo_matmul_split_repeats_bit_equal(cuda, m, k, n):
    """K4's mma regime with K split across blocks (7B shapes): two launches
    on the same inputs bit-equal (the splits are summed in a fixed
    order), within tolerance of plain."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    scol = torch.rand((n,), generator=gen, device=cuda) * 2e-3 + 1e-4
    plan = wm.wo_plan(m, k, n, wm.sm_count(cuda.index or 0))
    out = wm.wo_matmul(x, qw, scol, out_dtype=torch.float32)
    again = wm.wo_matmul(x, qw, scol, out_dtype=torch.float32)
    want = wm.wo_matmul_plain(x, qw, scol, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert plan.mt > 0 and plan.splits > 1
    assert _close(out, want, torch.float32)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_unsupported_shapes_raise(cuda):
    x = torch.zeros((4, 256), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="N % 64"):
        wm.wo_matmul(x, torch.zeros((256, 100), device=cuda,
                                    dtype=torch.int8),
                     torch.ones((100,), device=cuda))
    ops = _mix_operands(torch.Generator(device=cuda).manual_seed(0), cuda,
                        4, 96, 128, 128)
    with pytest.raises(ValueError, match="K % 64"):
        mm.mixed_matmul(**ops)
    with pytest.raises(ValueError, match="K % 8"):
        nq.quant_split(torch.zeros((4, 12), device=cuda),
                       torch.zeros((2,), device=cuda, dtype=torch.int32))


@pytest.mark.gpu
def test_tied_head_logits_are_f32(cuda):
    """The tied-embedding head (one cuBLAS product with an f32 output)
    equals the f32 product of the bf16-rounded operands within 1e-5."""
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig, _head
    gen = torch.Generator(device=cuda).manual_seed(6)
    cfg = ModelConfig(vocab_size=512, hidden_size=256, num_layers=1,
                      num_heads=2, num_kv_heads=2, tie_word_embeddings=True)
    params = {"embed": {"w": torch.randn((512, 256), generator=gen,
                                         device=cuda).bfloat16()},
              "final_norm": {"w": torch.rand((256,), generator=gen,
                                             device=cuda) + 0.5}}
    x = torch.randn((3, 1, 256), generator=gen, device=cuda).bfloat16()
    logits = _head(params, cfg, x)
    h = ref.rmsnorm(x, params["final_norm"]["w"], cfg.rms_norm_eps)
    want = h.float() @ params["embed"]["w"].float().T
    torch.cuda.synchronize()
    assert logits.dtype == torch.float32
    rel = float((logits - want).abs().max() / want.abs().max())
    assert rel <= 1e-5, rel


def _fp_pools(gen, dev, hkv, dtype):
    return {n: (torch.randn((NP_, hkv, BS, D), generator=gen, device=dev)
                * 2).to(dtype) for n in ("k", "v")}


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp_write_kernels_bit_equal(cuda, pool_dtype, dtype):
    """K5p / K6p: the new values cast to the pool's dtype, bit-equal to
    the plain scatter outside the trash row."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    pools = _fp_pools(gen, cuda, 4, pool_dtype)
    before = dict(_build.LAUNCHES)
    pg = torch.tensor([3, 0, 9, 5], dtype=torch.int32, device=cuda)
    off = torch.tensor([0, 4, 15, 2], dtype=torch.int32, device=cuda)
    nk = (torch.randn((4, 4, D), generator=gen, device=cuda) * 3).to(dtype)
    nv = (torch.randn((4, 4, D), generator=gen, device=cuda) * 3).to(dtype)
    ker = {k: v.clone() for k, v in pools.items()}
    pln = {k: v.clone() for k, v in pools.items()}
    pw.paged_write_token(ker, pg, off, nk, nv)
    pw.paged_write_token_plain(pln, pg, off, nk, nv)
    assert _same_outside_trash(ker, pln)

    blk = torch.tensor([[7] * BS + [8] * 5 + [0] * (BS - 5), [0] * 2 * BS],
                       dtype=torch.int32, device=cuda)
    off = torch.arange(2 * BS, dtype=torch.int32, device=cuda).remainder(
        BS).repeat(2, 1)
    off[0, BS:] = (off[0, BS:] + 1) % BS        # misaligned slab: dropped
    nk = (torch.randn((2, 2 * BS, 4, D), generator=gen, device=cuda)
          * 3).to(dtype)
    nv = (torch.randn((2, 2 * BS, 4, D), generator=gen, device=cuda)
          * 3).to(dtype)
    pw.paged_write_chunk(ker, blk, off, nk, nv)
    pw.paged_write_chunk_plain(pln, blk, off, nk, nv)
    torch.cuda.synchronize()
    assert _same_outside_trash(ker, pln)
    assert torch.equal(ker["k"][8], pools["k"][8])
    assert _launched("paged_write_token_fp", before) == 1
    assert _launched("paged_write_chunk_fp", before) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [(4, 4, 0, 0, 0.0), (8, 2, 24, 16, 0.0),
                          (8, 2, 0, 0, 20.0)])
def test_attention_kernels_fp_pages_match_plain(cuda, pool_dtype, hq, hkv,
                                                window, sink, softcap):
    """K7 / K8 over unquantized pages (no scales) within 2e-2 of plain."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    pools = _fp_pools(gen, cuda, hkv, pool_dtype)
    args = (pools["k"], pools["v"], None, None)
    scale = D ** -0.5
    kw = dict(window=window, sink=sink, softcap=softcap)
    table = torch.tensor([[4, 6, 5, 5], [0, 0, 0, 0]], dtype=torch.int32,
                         device=cuda)
    bpos = torch.tensor([[0, 2 * BS, BS, PAD_POS], [PAD_POS] * 4],
                        dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 1], dtype=torch.int32, device=cuda)
    q = torch.randn((2, hq, D), generator=gen, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    out = pa.paged_decode_attention(q, *args, table, lens, scale,
                                    block_pos=bpos, **kw)
    ref_ = pa.paged_attention_plain(q[:, None], *args, table,
                                    (lens - 1)[:, None], lens, scale,
                                    block_pos=bpos, **kw)[:, 0]
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    assert float((out.float() - ref_.float()).abs().max()) <= 2e-2

    c = 40
    qs = torch.tensor([8, 0], dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 0], dtype=torch.int32, device=cuda)
    q = torch.randn((2, c, hq, D), generator=gen, device=cuda).bfloat16()
    out = pa.paged_prefill_attention(q, *args, table, qs, lens, scale,
                                     block_pos=bpos, **kw)
    pos = qs[:, None] + torch.arange(c, device=cuda)
    ref_ = pa.paged_attention_plain(q, *args, table, pos, lens, scale,
                                    block_pos=bpos, **kw)
    torch.cuda.synchronize()
    valid = (pos < lens[:, None])[:, :, None, None]
    err = torch.where(valid, (out.float() - ref_.float()).abs(), 0.0)
    assert float(err.max()) <= 2e-2
    assert _launched("paged_decode_attention_fp", before) == 1
    assert _launched("paged_prefill_attention_fp", before) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("m", list(range(1, 18)) + [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_kernels_match_plain(cuda, m, dtype):
    """K12 and K13 against unpack + plain. K/2 = 640 is not a multiple of
    K13's 256-row chunk; group size 320 puts a group boundary inside a
    chunk."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    k, n = 1280, 384
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    q = torch.randint(-8, 8, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    qp = qcore.pack_int4(q)
    scol = torch.rand((n,), generator=gen, device=cuda) * 2e-2 + 1e-3
    before = dict(_build.LAUNCHES)
    out = wm.wo_matmul_packed(x, qp, scol, out_dtype=dtype)
    want = wm.wo_matmul_packed_plain(x, qp, scol, out_dtype=dtype)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (m, n)
    assert _close(out, want, dtype)
    for gs in (128, 320):
        sg = torch.rand((k // gs, n), generator=gen, device=cuda) * 2e-2 \
            + 1e-3
        out = wm.wo_matmul_packed_grouped(x, qp, sg, gs, out_dtype=dtype)
        want = wm.wo_matmul_packed_grouped_plain(x, qp, sg, gs,
                                                 out_dtype=dtype)
        torch.cuda.synchronize()
        assert out.shape == (m, n)
        assert _close(out, want, dtype), gs
    assert _launched("wo_matmul_packed", before) == 1
    assert _launched("wo_matmul_packed_grouped", before) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17])
@pytest.mark.parametrize("k,n", [(1240, 384), (130, 128), (13824, 5120)])
def test_packed_split_k_edges_and_repeats(cuda, m, k, n):
    """K12 where K/2 (620, 65, 6912) is no multiple of its 64-row chunk
    and K/2 is split across blocks: within GEMM tolerance of plain, and
    two launches on the same inputs bit-equal (the splits are summed in a
    fixed order)."""
    gen = torch.Generator(device=cuda).manual_seed(m + k)
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    qp = torch.randint(-128, 128, (k // 2, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    scol = torch.rand((n,), generator=gen, device=cuda) * 2e-2 + 1e-3
    plan = wm.packed_plan(m, k, n, wm.sm_count(cuda.index or 0))
    out = wm.wo_matmul_packed(x, qp, scol, out_dtype=torch.float32)
    again = wm.wo_matmul_packed(x, qp, scol, out_dtype=torch.float32)
    want = wm.wo_matmul_packed_plain(x, qp, scol, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert plan.splits > 1 or k == 130
    assert _close(out, want, torch.float32)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_packed_kernels_exact_on_integer_inputs(cuda):
    """Integer x and unit scales: every product and sum is exact in f32,
    so K12 equals the int32 product of x and the unpacked weight."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    m, k, n = 5, 1024, 256
    xi = torch.randint(-8, 8, (m, k), generator=gen, device=cuda)
    q = torch.randint(-8, 8, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    out = wm.wo_matmul_packed(xi.bfloat16(), qcore.pack_int4(q),
                              torch.ones((n,), device=cuda),
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(out, (xi.double() @ q.double()).float())


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 8, 16, 40])
@pytest.mark.parametrize("gs", [64, 128])
def test_grouped_kernel_exact_and_repeats(cuda, m, gs):
    """K13 on integer x with power-of-two group scales: every group's
    partial, its scaling and the sums are exact in f32, so K13 equals the
    exact product bit for bit; then on random inputs across its K splits
    (13B down_proj's K/2 = 6912) two launches bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(12 + m + gs)
    k, n = 2048, 256
    xi = torch.randint(-8, 9, (m, k), generator=gen, device=cuda)
    q = torch.randint(-8, 8, (k, n), generator=gen, device=cuda,
                      dtype=torch.int8)
    sg = torch.exp2(torch.randint(-3, 4, (k // gs, n), generator=gen,
                                  device=cuda).float())
    out = wm.wo_matmul_packed_grouped(xi.bfloat16(), qcore.pack_int4(q), sg,
                                      gs, out_dtype=torch.float32)
    exact = sum(xi[:, i * gs:(i + 1) * gs].double()
                @ q[i * gs:(i + 1) * gs].double() * sg[i].double()
                for i in range(k // gs))
    torch.cuda.synchronize()
    assert torch.equal(out, exact.float())

    k, n = 13824, 5120
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    qp = torch.randint(-128, 128, (k // 2, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    sg = torch.rand((k // gs, n), generator=gen, device=cuda) * 2e-2 + 1e-3
    plan = wm.grouped_plan(m, k, n, gs, wm.sm_count(cuda.index or 0))
    out = wm.wo_matmul_packed_grouped(x, qp, sg, gs, out_dtype=torch.float32)
    again = wm.wo_matmul_packed_grouped(x, qp, sg, gs,
                                        out_dtype=torch.float32)
    want = wm.wo_matmul_packed_grouped_plain(x, qp, sg, gs,
                                             out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert plan.splits > 1
    assert _close(out, want, torch.float32)
    assert torch.equal(out, again)


@pytest.mark.gpu
def test_packed_shapes_raise(cuda):
    x = torch.zeros((4, 256), device=cuda).bfloat16()
    qp = torch.zeros((128, 256), device=cuda, dtype=torch.int8)
    with pytest.raises(ValueError, match="N % 128"):
        wm.wo_matmul_packed(x, qp[:, :100].contiguous(),
                            torch.ones((100,), device=cuda))
    with pytest.raises(ValueError, match="group_size"):
        wm.wo_matmul_packed_grouped(x, qp, torch.ones((4, 256),
                                                      device=cuda), 64 + 4)
    # the kernel takes whole 64-row stages a group; the plain version any
    with pytest.raises(ValueError, match="group_size % 64"):
        wm.wo_matmul_packed_grouped(x, qp, torch.ones((8, 256),
                                                      device=cuda), 32)


def _pool_args(gen, dev, hkv, pages):
    """(K, V, K scale, V scale) of int8 pages, or bf16/f32 ones without
    scales."""
    if pages == "int8":
        p = _pools(gen, dev, hkv)
        return p["k"], p["v"], p["k_scale"], p["v_scale"]
    p = _fp_pools(gen, dev, hkv, getattr(torch, pages))
    return p["k"], p["v"], None, None


# lane 0: 3 pages in a recycled order; lane 1: inactive; lane 2: one page
_TABLE = [[4, 6, 5, 5], [0, 0, 0, 0], [9, 9, 9, 9]]
_BPOS = [[0, 2 * BS, BS, PAD_POS], [PAD_POS] * 4, [0] + [PAD_POS] * 3]


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("s", [2, 5, 8])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [(4, 4, 0, 0, 0.0), (8, 2, 24, 16, 0.0),
                          (8, 2, 0, 0, 20.0)])
def test_verify_kernel_matches_plain(cuda, pages, s, hq, hkv, window, sink,
                                     softcap):
    """K9 within 2e-2 of plain; the inactive lane gives 0; lane 2's rows
    past its 3 keys see only those; one launch."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    args = _pool_args(gen, cuda, hkv, pages)
    kw = dict(window=window, sink=sink, softcap=softcap,
              block_pos=torch.tensor(_BPOS, dtype=torch.int32, device=cuda))
    table = torch.tensor(_TABLE, dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 0, 3], dtype=torch.int32, device=cuda)
    qstart = torch.tensor([3 * BS - 5 - s, 0, 0], dtype=torch.int32,
                          device=cuda)
    q = torch.randn((3, s, hq, D), generator=gen, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    out = pa.paged_verify_attention(q, *args, table, lens, qstart, D ** -0.5,
                                    **kw)
    pos = qstart[:, None] + torch.arange(s, device=cuda)
    want = pa.paged_attention_plain(q, *args, table, pos, lens, D ** -0.5,
                                    **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool((out[1] == 0).all())
    assert float((out.float() - want.float()).abs().max()) <= 2e-2
    sfx = "" if pages == "int8" else "_fp"
    assert _launched("paged_verify_attention" + sfx, before) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16"])
@pytest.mark.parametrize("hq,hkv,window", [(4, 4, 0), (8, 2, 24)])
def test_verify_s1_bit_equal_to_decode(cuda, pages, hq, hkv, window):
    """K9 at S = 1 from qstart = lens - 1 is the decode kernel's K10 mode
    (the decode query's f32 output) rounded to q's dtype, bit for bit: the
    same arithmetic (K7 itself is the split-page kernel, held to plain)."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    args = _pool_args(gen, cuda, hkv, pages)
    kw = dict(window=window, sink=16 if window else 0,
              block_pos=torch.tensor(_BPOS, dtype=torch.int32, device=cuda))
    table = torch.tensor(_TABLE, dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 1, BS - 2], dtype=torch.int32,
                        device=cuda)
    q = torch.randn((3, hq, D), generator=gen, device=cuda).bfloat16()
    dec = pa.paged_decode_attention(q, *args, table, lens, D ** -0.5,
                                    stats=True, **kw)[0].to(q.dtype)
    ver = pa.paged_verify_attention(q[:, None], *args, table, lens, lens - 1,
                                    D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ver[:, 0], dec)


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("hq,hkv,window,softcap",
                         [(4, 4, 0, 0.0), (8, 2, 24, 0.0), (8, 2, 0, 20.0)])
def test_stats_and_split_kernels_match_plain(cuda, pages, hq, hkv, window,
                                             softcap):
    """K10: out within 2e-2, m and l within 1e-3 relative of plain, the
    inactive lane at out 0, m -1e30, l 0. K11 at splits 2, 3 and 4 (3
    pads the table, 4 has a range past it) within 2e-2 of its plain
    version and of K7, two launches bit-equal, one K11 launch a call and
    no K10 launch."""
    gen = torch.Generator(device=cuda).manual_seed(13)
    args = _pool_args(gen, cuda, hkv, pages)
    kw = dict(window=window, sink=16 if window else 0, softcap=softcap,
              block_pos=torch.tensor(_BPOS, dtype=torch.int32, device=cuda))
    table = torch.tensor(_TABLE, dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * BS - 5, 1, BS - 2], dtype=torch.int32,
                        device=cuda)
    q = torch.randn((3, hq, D), generator=gen, device=cuda).bfloat16()
    sfx = "" if pages == "int8" else "_fp"
    before = dict(_build.LAUNCHES)
    out, m, l = pa.paged_decode_attention(q, *args, table, lens, D ** -0.5,
                                          stats=True, **kw)
    po, pm, pl = pa.paged_decode_attention_stats_plain(
        q, *args, table, lens, D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert out.dtype == m.dtype == l.dtype == torch.float32
    assert float((out - po).abs().max()) <= 2e-2
    live = torch.tensor([0, 2], device=cuda)
    assert float((m[live] - pm[live]).abs().max()) <= \
        1e-3 * float(pm[live].abs().max())
    torch.testing.assert_close(l[live], pl[live], rtol=1e-3, atol=0)
    assert bool((out[1] == 0).all()) and bool((m[1] == -1e30).all()) \
        and bool((l[1] == 0).all())
    assert _launched("paged_decode_attention_stats" + sfx, before) == 1
    k7 = pa.paged_decode_attention(q, *args, table, lens, D ** -0.5, **kw)
    before = dict(_build.LAUNCHES)
    for splits in (2, 3, 4):
        got = pa.paged_decode_attention_split(q, *args, table, lens,
                                              D ** -0.5, kv_splits=splits,
                                              **kw)
        again = pa.paged_decode_attention_split(q, *args, table, lens,
                                                D ** -0.5, kv_splits=splits,
                                                **kw)
        want = pa.paged_decode_attention_split_plain(
            q, *args, table, lens, D ** -0.5, kv_splits=splits, **kw)
        torch.cuda.synchronize()
        assert got.dtype == q.dtype and bool((got[1] == 0).all())
        assert torch.equal(got, again)
        assert float((got.float() - want.float()).abs().max()) <= 2e-2
        assert float((got.float() - k7.float()).abs().max()) <= 2e-2
    assert _launched("paged_decode_attention_split" + sfx, before) == 6
    assert _launched("paged_decode_attention_stats" + sfx, before) == 0
    assert _launched("paged_decode_attention" + sfx, before) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [(4, 4, 0, 0, 0.0), (8, 2, 0, 0, 0.0),
                          (8, 2, 40, 16, 0.0), (4, 4, 0, 0, 20.0)])
def test_decode_split_kernel_matches_plain(cuda, pages, hq, hkv, window,
                                           sink, softcap):
    """K7 (each lane's table split across the blocks of one launch, merged
    in the same launch) within 2e-2 of plain at lengths 1, BS, BS + 1 and
    over recycled windowed tables (out-of-order block_pos, a sink), MHA and
    GQA; the inactive lane exactly 0; two launches bit-equal; one launch a
    call whatever the splits."""
    gen = torch.Generator(device=cuda).manual_seed(15)
    args = _pool_args(gen, cuda, hkv, pages)
    mb = 6
    lens = [1, BS, BS + 1, 1, 6 * BS - 3, 4 * BS + 2]
    table = torch.randint(1, NP_, (6, mb), generator=gen, device=cuda,
                          dtype=torch.int32)
    bpos = torch.full((6, mb), PAD_POS, dtype=torch.int32, device=cuda)
    for i, ln in enumerate(lens):
        n = -(-ln // BS)
        bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=cuda) * BS
    # lanes 4 and 5: recycled (sink page first, the rest out of order)
    bpos[4, :6] = torch.tensor([0, 4, 2, 5, 1, 3], device=cuda) * BS
    bpos[5, :5] = torch.tensor([0, 3, 4, 1, 2], device=cuda) * BS
    table[3], bpos[3] = 0, PAD_POS                   # inactive lane
    lens_t = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((6, hq, D), generator=gen, device=cuda).bfloat16()
    kw = dict(block_pos=bpos, window=window, sink=sink, softcap=softcap)
    plan = pa.decode_plan(6, hkv, hq // hkv, D, mb,
                          wm.sm_count(cuda.index or 0))
    sfx = "" if pages == "int8" else "_fp"
    before = dict(_build.LAUNCHES)
    out = pa.paged_decode_attention(q, *args, table, lens_t, D ** -0.5, **kw)
    again = pa.paged_decode_attention(q, *args, table, lens_t, D ** -0.5,
                                      **kw)
    want = pa.paged_attention_plain(q[:, None], *args, table,
                                    (lens_t - 1)[:, None], lens_t,
                                    D ** -0.5, **kw)[:, 0]
    torch.cuda.synchronize()
    assert plan.splits > 1
    assert bool(torch.isfinite(out).all()) and bool((out[3] == 0).all())
    assert float((out.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(out, again)
    assert _launched("paged_decode_attention" + sfx, before) == 2


@pytest.mark.gpu
def test_decode_split_merge_fault_is_seen(cuda):
    """The negative controls' hook: K7 with the last split that saw a key
    left out of its merge differs from plain by more than 2e-2 on a
    lane whose keys span several splits, and the hook leaves K7 right once
    it is reset."""
    gen = torch.Generator(device=cuda).manual_seed(16)
    args = _pool_args(gen, cuda, 4, "int8")
    table = torch.arange(1, 7, dtype=torch.int32, device=cuda)[None]
    bpos = (torch.arange(6, dtype=torch.int32, device=cuda) * BS)[None]
    lens = torch.tensor([6 * BS], dtype=torch.int32, device=cuda)
    q = torch.randn((1, 4, D), generator=gen, device=cuda).bfloat16()
    # the last page's keys point along each head's query: it takes nearly
    # all the attention, so leaving its split out moves every output
    args[0][6] = (torch.sign(q[0].float())[:, None, :] * 100).to(torch.int8)
    want = pa.paged_attention_plain(q[:, None], *args, table,
                                    (lens - 1)[:, None], lens, D ** -0.5,
                                    block_pos=bpos)[:, 0]
    try:
        pa.K7_MERGE_DROP = 1
        bad = pa.paged_decode_attention(q, *args, table, lens, D ** -0.5,
                                        block_pos=bpos)
    finally:
        pa.K7_MERGE_DROP = 0
    good = pa.paged_decode_attention(q, *args, table, lens, D ** -0.5,
                                     block_pos=bpos)
    torch.cuda.synchronize()
    assert float((bad.float() - want.float()).abs().max()) > 2e-2
    assert float((good.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [2, 4])
def test_split_kernel_merge_fault_is_seen(cuda, splits):
    """K11's merge is K7's: with the hook set, the last split that saw a
    key (the range holding the last page) is left out and the output
    moves by more than 2e-2; reset, K11 is within 2e-2 of plain."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    args = _pool_args(gen, cuda, 4, "int8")
    table = torch.arange(1, 7, dtype=torch.int32, device=cuda)[None]
    lens = torch.tensor([6 * BS], dtype=torch.int32, device=cuda)
    q = torch.randn((1, 4, D), generator=gen, device=cuda).bfloat16()
    args[0][6] = (torch.sign(q[0].float())[:, None, :] * 100).to(torch.int8)
    want = pa.paged_decode_attention_split_plain(q, *args, table, lens,
                                                 D ** -0.5, kv_splits=splits)
    try:
        pa.K7_MERGE_DROP = 1
        bad = pa.paged_decode_attention_split(q, *args, table, lens,
                                              D ** -0.5, kv_splits=splits)
    finally:
        pa.K7_MERGE_DROP = 0
    good = pa.paged_decode_attention_split(q, *args, table, lens, D ** -0.5,
                                           kv_splits=splits)
    torch.cuda.synchronize()
    assert float((bad.float() - want.float()).abs().max()) > 2e-2
    assert float((good.float() - want.float()).abs().max()) <= 2e-2


def _edge_lanes(gen, dev, mb=6):
    """K7's edge lanes: lengths 1, BS, BS + 1, an inactive lane, and two
    recycled tables (sink page first, the rest out of order)."""
    lens = [1, BS, BS + 1, 1, 6 * BS - 3, 4 * BS + 2]
    table = torch.randint(1, NP_, (6, mb), generator=gen, device=dev,
                          dtype=torch.int32)
    bpos = torch.full((6, mb), PAD_POS, dtype=torch.int32, device=dev)
    for i, ln in enumerate(lens):
        n = -(-ln // BS)
        bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=dev) * BS
    bpos[4, :6] = torch.tensor([0, 4, 2, 5, 1, 3], device=dev) * BS
    bpos[5, :5] = torch.tensor([0, 3, 4, 1, 2], device=dev) * BS
    table[3], bpos[3] = 0, PAD_POS                   # inactive lane
    return table, bpos, torch.tensor(lens, dtype=torch.int32, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [(4, 4, 0, 0, 0.0), (8, 2, 0, 0, 0.0),
                          (8, 2, 40, 16, 0.0), (4, 4, 0, 0, 20.0)])
def test_rows_kernels_edges_and_repeats(cuda, pages, hq, hkv, window, sink,
                                        softcap):
    """K9 (S = 5, rows from len - 3: the last two past len - 1) and K10 at
    lengths 1, BS and BS + 1 and over recycled windowed tables, MHA and
    GQA: within 2e-2 of plain (K10's m and l within 1e-3 relative), the
    inactive lane exactly 0 (K10: m -1e30, l 0), rows past len - 1 seeing
    only the keys below len, two launches bit-equal, one launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(18)
    args = _pool_args(gen, cuda, hkv, pages)
    table, bpos, lens = _edge_lanes(gen, cuda)
    kw = dict(block_pos=bpos, window=window, sink=sink, softcap=softcap)
    sfx = "" if pages == "int8" else "_fp"
    s = 5
    qstart = torch.clamp(lens - 3, min=0)
    q = torch.randn((6, s, hq, D), generator=gen, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    out = pa.paged_verify_attention(q, *args, table, lens, qstart, D ** -0.5,
                                    **kw)
    again = pa.paged_verify_attention(q, *args, table, lens, qstart,
                                      D ** -0.5, **kw)
    pos = qstart[:, None] + torch.arange(s, device=cuda)
    want = pa.paged_attention_plain(q, *args, table, pos, lens, D ** -0.5,
                                    **kw)
    q1 = q[:, 0].contiguous()
    o, m, l = pa.paged_decode_attention(q1, *args, table, lens, D ** -0.5,
                                        stats=True, **kw)
    o2, m2, l2 = pa.paged_decode_attention(q1, *args, table, lens,
                                           D ** -0.5, stats=True, **kw)
    po, pm, pl = pa.paged_decode_attention_stats_plain(
        q1, *args, table, lens, D ** -0.5, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(out).all()) and bool((out[3] == 0).all())
    assert float((out.float() - want.float()).abs().max()) <= 2e-2
    assert torch.equal(out, again)
    assert _launched("paged_verify_attention" + sfx, before) == 2
    live = torch.tensor([0, 1, 2, 4, 5], device=cuda)
    assert float((o - po).abs().max()) <= 2e-2
    assert float((m[live] - pm[live]).abs().max()) <= \
        1e-3 * float(pm[live].abs().max())
    torch.testing.assert_close(l[live], pl[live], rtol=1e-3, atol=0)
    assert bool((o[3] == 0).all()) and bool((m[3] == -1e30).all()) \
        and bool((l[3] == 0).all())
    assert torch.equal(o, o2) and torch.equal(m, m2) and torch.equal(l, l2)
    assert _launched("paged_decode_attention_stats" + sfx, before) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("pages", ["int8", "bfloat16", "float32"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("c", [9, 100, 256, 300])
def test_prefill_kernel_chunks_and_groups(cuda, pages, g, c):
    """K8 at C = 9 (the shortest chunk past the verify's 8 rows), 100, 256
    and 300 (ragged 128-row tiles), G = 1, 4 and 8 query heads a KV head
    (128 / G tokens a tile): a whole prompt, a later chunk whose prompt
    ends inside it over a recycled table, and an inactive lane; within
    2e-2 of plain on the rows below len, two launches bit-equal, one
    launch a call."""
    gen = torch.Generator(device=cuda).manual_seed(19 + c + g)
    hkv, np_ = 8 // g, 48
    hq = hkv * g
    shape = (np_, hkv, BS, D)
    if pages == "int8":
        args = (torch.randint(-127, 128, shape, generator=gen, device=cuda,
                              dtype=torch.int8),
                torch.randint(-127, 128, shape, generator=gen, device=cuda,
                              dtype=torch.int8),
                torch.rand(shape[:3], generator=gen, device=cuda) * 0.02
                + 1e-3,
                torch.rand(shape[:3], generator=gen, device=cuda) * 0.02
                + 1e-3)
    else:
        dt = getattr(torch, pages)
        args = tuple((torch.randn(shape, generator=gen, device=cuda)
                      * 2).to(dt) for _ in range(2)) + (None, None)
    qstart = [0, 2 * BS + 3, 0]
    lens = [c, 2 * BS + 3 + c - 4, 0]
    mb = -(-(lens[1]) // BS)
    table = torch.zeros((3, mb), dtype=torch.int32, device=cuda)
    bpos = torch.full((3, mb), PAD_POS, dtype=torch.int32, device=cuda)
    perm = torch.randperm(np_ - 1, generator=gen, device=cuda) + 1
    for i in range(2):
        n = -(-lens[i] // BS)
        table[i, :n] = perm[i * mb:i * mb + n].int()
        table[i, n:] = table[i, n - 1]
        bpos[i, :n] = torch.arange(n, dtype=torch.int32, device=cuda) * BS
    n1 = -(-lens[1] // BS)
    order = torch.cat([torch.zeros(1, dtype=torch.long, device=cuda),
                       torch.randperm(n1 - 1, generator=gen,
                                      device=cuda) + 1])
    table[1, :n1], bpos[1, :n1] = table[1, :n1][order], bpos[1, :n1][order]
    qs = torch.tensor(qstart, dtype=torch.int32, device=cuda)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda)
    q = torch.randn((3, c, hq, D), generator=gen, device=cuda).bfloat16()
    sfx = "" if pages == "int8" else "_fp"
    before = dict(_build.LAUNCHES)
    out = pa.paged_prefill_attention(q, *args, table, qs, ln, D ** -0.5,
                                     block_pos=bpos)
    again = pa.paged_prefill_attention(q, *args, table, qs, ln, D ** -0.5,
                                       block_pos=bpos)
    pos = qs[:, None] + torch.arange(c, device=cuda)
    want = pa.paged_attention_plain(q, *args, table, pos, ln, D ** -0.5,
                                    block_pos=bpos)
    torch.cuda.synchronize()
    valid = (pos < ln[:, None])[:, :, None, None]
    err = torch.where(valid, (out.float() - want.float()).abs(), 0.0)
    assert bool(torch.isfinite(torch.where(valid, out.float(), 0.0)).all())
    assert float(err.max()) <= 2e-2
    assert torch.equal(out, again)
    assert _launched("paged_prefill_attention" + sfx, before) == 2


@pytest.mark.gpu
@pytest.mark.parametrize("s,window,sink", [(384, 0, 0), (640, 0, 0),
                                           (640, 96, 4)])
@pytest.mark.parametrize("d", [64, 128])
def test_prefill_page_view_odd_block_size(cuda, s, window, sink, d):
    """causal_self_attention's GQA route: K8 over a page view whose block
    size is no power of two (S = 384: BS 192; S = 640: BS 160), with and
    without a window, within 2e-2 of the masked plain attention."""
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    gen = torch.Generator(device=cuda).manual_seed(s + d + window)
    b, hq, hkv = 2, 8, 2
    q = torch.randn((b, s, hq, d), generator=gen, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, d), generator=gen, device=cuda).bfloat16()
    v = torch.randn((b, s, hkv, d), generator=gen, device=cuda).bfloat16()
    before = dict(_build.LAUNCHES)
    out = fa.causal_self_attention(q, k, v, d ** -0.5, window=window,
                                   sink=sink)
    idx = torch.arange(s, device=cuda)
    mask = idx[None, :] <= idx[:, None]
    if window:
        mask &= (idx[None, :] > idx[:, None] - window) | (idx[None, :] < sink)
    want = ref.attention(q.float(), k.float(), v.float(),
                         mask=mask[None, None], scale=d ** -0.5)
    torch.cuda.synchronize()
    assert _launched("paged_prefill_attention_fp", before) == 1
    assert float((out.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.gpu
def test_verify_limits_raise(cuda):
    """More than 8 rows raise. 8 rows x 32 query heads a KV head at D =
    BS = 256 (256 rows: two row groups of 128), which the first verify
    kernel refused for its shared memory, now runs and matches plain."""
    gen = torch.Generator(device=cuda).manual_seed(17)
    z = (torch.randn((4, 1, 256, 256), generator=gen, device=cuda)
         * 0.5).bfloat16()
    table = torch.tensor([[1, 2]], dtype=torch.int32, device=cuda)
    lens = torch.tensor([300], dtype=torch.int32, device=cuda)
    qstart = lens - 8
    q = torch.randn((1, 9, 32, 256), generator=gen, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="1..8"):
        pa.paged_verify_attention(q, z, z, None, None, table, lens, qstart,
                                  1.0)
    q8 = q[:, :8].contiguous()
    out = pa.paged_verify_attention(q8, z, z, None, None, table, lens,
                                    qstart, 256 ** -0.5)
    pos = qstart[:, None] + torch.arange(8, device=cuda)
    want = pa.paged_attention_plain(q8, z, z, None, None, table, pos, lens,
                                    256 ** -0.5)
    torch.cuda.synchronize()
    assert float((out.float() - want.float()).abs().max()) <= 2e-2


def _tiny_serving_model(cuda, num_kv_heads=2):
    """A 2-layer int8_mix / int8-KV Llama at widths the kernels take (4
    heads of 64; GQA unless num_kv_heads=4)."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo,
                                                   QuantAlgo, QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=num_kv_heads,
                      head_dim=64,
                      quant=QuantConfig(algo=QuantAlgo.INT8_MIX,
                                        num_outliers=8,
                                        kv_cache=KVCacheQuantAlgo.INT8))
    gen = torch.Generator(device=cuda).manual_seed(14)
    params = llama.init_random_params(
        cfg, seed=14, device=cuda,
        act_scales=sp.distinct_act_scales(cfg, gen, cuda))
    return params, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("rounds", [1, 8])
def test_run_speculative_on_card(cuda, rounds):
    """run_speculative at a tiny width on the card, gamma 4 and a 1-layer
    draft: every request ends with its tokens and finite log-probs, K9
    (verify), K7 (draft steps), K1 -> K2 (the 5-row verify) launch, and
    the host reads back once per round or per device-paced call."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    draft = dict(params, layers=params["layers"][:1])
    dcfg = dataclasses.replace(cfg, num_layers=1)
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda)
    prompts = [[(7 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((5, 40, 17))]
    ids = [ex.submit(p, max_new_tokens=20) for p in prompts]
    _build.reset_launches()
    done = ex.run_speculative(draft, dcfg, gamma=4, rounds_per_call=rounds)
    torch.cuda.synchronize()
    for r in ids:
        assert len(done[r].generated) == 20
        assert all(map(torch.isfinite, torch.tensor(done[r].logprobs)))
    for name in ("paged_verify_attention", "paged_decode_attention",
                 "rmsnorm_quant_split", "mixed_matmul"):
        assert _build.LAUNCHES.get(name, 0) > 0, name
    assert ex.spec_readbacks == ex.spec_calls > 0
    assert 0 <= ex.spec_accepted <= ex.spec_proposed


@pytest.mark.gpu
def test_split_decode_on_card(cuda, monkeypatch):
    """MIXQ_KV_SPLITS=2: decode steps launch K11 (one launch of K7's
    kernel), never K7's or K10's wrapper, and the requests finish."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    monkeypatch.setenv("MIXQ_KV_SPLITS", "2")
    ex = Executor(params, cfg, max_batch=2, max_seq_len=128, block_size=16,
                  prefill_chunk=32, device=cuda)
    ids = [ex.submit(list(range(1, n + 1)), max_new_tokens=8)
           for n in (3, 50)]
    _build.reset_launches()
    done = ex.run()
    torch.cuda.synchronize()
    assert all(len(done[r].generated) == 8 for r in ids)
    assert _build.LAUNCHES.get("paged_decode_attention_split", 0) > 0
    assert _build.LAUNCHES.get("paged_decode_attention_stats", 0) == 0
    assert _build.LAUNCHES.get("paged_decode_attention", 0) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("s", [1, 63, 65, 128, 200, 2048])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_kernel_matches_plain(cuda, s, d):
    """K14 within 2e-2 of its plain version (bf16 output), one launch
    counted per call, on q, k, v views of one fused projection (the
    model's layout). S = 1, 63, 65 and 200 are no multiple of the 128-row
    q tiles or the key tiles: TMA's out-of-bounds rows are zeros and the
    rows past S are not written."""
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    gen = torch.Generator(device=cuda).manual_seed(s + d)
    b, h = (2 if s == 200 else 1), 4
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).bfloat16()
    q, k, v = (x.reshape(b, s, h, d) for x in qkv.split(h * d, dim=-1))
    before = _build.LAUNCHES.get("flash_causal_attention", 0)
    out = fa.flash_causal_attention(q, k, v, d ** -0.5)
    want = ref.flash_causal_attention(q, k, v, d ** -0.5)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["flash_causal_attention"] == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert float((out.float() - want.float()).abs().max()) <= 2e-2


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views of one fused (B, S, 3·H·D) projection, as the
    model hands them over: the same output as from contiguous copies, bit
    for bit; a view whose rows are not 16-byte aligned is copied first."""
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    gen = torch.Generator(device=cuda).manual_seed(3)
    b, s, h, d = 2, 256, 4, 64
    qkv = torch.randn((b, s, 3 * h * d), generator=gen,
                      device=cuda).bfloat16()
    q, k, v = (x.reshape(b, s, h, d) for x in qkv.split(h * d, dim=-1))
    out = fa.flash_causal_attention(q, k, v, 0.125)
    want = fa.flash_causal_attention(q.contiguous(), k.contiguous(),
                                     v.contiguous(), 0.125)
    odd = torch.randn((b, s, h * d + 4), generator=gen,
                      device=cuda).bfloat16()[..., 4:].reshape(b, s, h, d)
    got_odd = fa.flash_causal_attention(odd, k, v, 0.125)
    want_odd = fa.flash_causal_attention(odd.contiguous(), k, v, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(out, want) and torch.equal(got_odd, want_odd)


@pytest.mark.gpu
def test_flash_kernel_shapes_raise(cuda):
    from mixq_tensorrt_llm_tpu_torch.ops import attention as fa
    x = torch.zeros((1, 128, 2, 96), device=cuda).bfloat16()
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_causal_attention(x, x, x, 1.0)
    y = torch.zeros((1, 128, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_causal_attention(y, y, y, 1.0)


@pytest.mark.gpu
def test_dense_session_on_card(cuda):
    """GenerationSession at a tiny MHA width on the card: a 128-token
    bucket takes K14 once a layer and no paged kernel launches."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    params, cfg = _tiny_serving_model(cuda, num_kv_heads=4)
    prompts = [[(5 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((100, 128))]
    sess = GenerationSession(params, cfg, max_seq_len=256, device=cuda)
    _build.reset_launches()
    out = sess.generate(prompts, 8, return_context_logits=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("flash_causal_attention", 0) == \
        cfg.num_layers
    assert not any(n.startswith("paged_") for n in _build.LAUNCHES)
    assert out.num_generated == [8, 8]
    assert all(bool(torch.isfinite(c).all()) for c in out.context_logits)


@pytest.mark.gpu
def test_cuda_session_raises_when_a_kernel_library_fails(cuda, monkeypatch):
    """No fallback: a kernel library that does not load makes the CUDA
    session raise; the plain versions are not taken instead."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    params, cfg = _tiny_serving_model(cuda, num_kv_heads=4)

    def broken(name):
        raise OSError(f"cannot load lib{name}")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "load", broken)
    sess = GenerationSession(params, cfg, max_seq_len=256, device=cuda)
    with pytest.raises(OSError, match="cannot load"):
        sess.generate([[1] * 130], 2)


def _prefilled_executor(cuda, k, sampling=None):
    """A tiny-model Executor on the card whose 3 requests are prefilled,
    their pages extended by k: (executor, active (slot, request) pairs).
    The requests are not advanced, so each decode call sees the same
    inputs."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda)
    for i, n in enumerate((5, 40, 17)):
        ex.submit([(7 * i + j) % 500 + 1 for j in range(n)],
                  max_new_tokens=64, sampling=sampling)
    while ex.queue or ex.prefilling:
        ex._admit()
        ex._step_prefill()
    active = [(i, r) for i, r in enumerate(ex.slots) if r is not None]
    for _, r in active:
        ex.bm.extend(r.req_id, k)
    return ex, active


def _pool_copy(ex):
    return {n: t.clone() for n, t in ex.state.pools().items()}


def _pool_restore(ex, saved):
    for n, t in ex.state.pools().items():
        t.copy_(saved[n])


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_rung_replay_bit_equal_to_eager(cuda, k):
    """A decode rung's replay gives the tokens, log-probabilities and KV
    pools of the same k steps run eagerly, bit for bit; after the rung's
    first use no decode forward runs eagerly, every call is a replay, and
    LAUNCHES after n replays is n times the capture's counts."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    ex, active = _prefilled_executor(cuda, k)
    before = _pool_copy(ex)
    ex._decode(k, active)                       # warm pass, capture, replay
    rung = ex._rungs[(k, 0, None)]
    assert rung.graph is not None and rung.launches
    assert rung.launches.get("paged_decode_attention", 0) == 2 * k
    _pool_restore(ex, before)
    calls = [0]
    inner = mcommon.forward_paged

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    mcommon.forward_paged = counted
    try:
        _build.reset_launches()
        toks, lps = ex._decode(k, active)       # a replay
        torch.cuda.synchronize()
        assert calls[0] == 0
        assert _build.LAUNCHES == rung.launches
        replayed = _pool_copy(ex)
        for n in (2, 3):
            ex._decode(k, active)
            assert _build.LAUNCHES == {name: n * c for name, c in
                                       rung.launches.items()}
        assert calls[0] == 0
    finally:
        mcommon.forward_paged = inner
    assert ex.graph_replays == ex.decode_calls == 4
    _pool_restore(ex, before)
    out = ex._decode_body(k).cpu().numpy()      # the same steps, eagerly
    torch.cuda.synchronize()
    assert np.array_equal(toks, out[:, :k])
    assert np.array_equal(lps.view(np.int32), out[:, k:])
    for n, t in ex.state.pools().items():
        assert torch.equal(t, replayed[n]), n


@pytest.mark.gpu
def test_rung_replays_draw_anew(cuda):
    """The Executor's generator is registered with each graph: replays of
    a rung on the same inputs draw new stochastic tokens."""
    from mixq_tensorrt_llm_tpu_torch.runtime.sampler import SamplingConfig
    ex, active = _prefilled_executor(
        cuda, 4, SamplingConfig(greedy=False, temperature=1.0))
    draws = [ex._decode(4, active)[0][:3].copy() for _ in range(3)]
    assert ex.graph_replays == 3
    assert not np.array_equal(draws[1], draws[2])


@pytest.mark.gpu
def test_scratch_refuses_to_grow_while_capturing(cuda):
    """ops/_build.scratch raises where it would grow during a capture (a
    freed buffer would leave earlier graphs with a dangling pointer)."""
    _build.scratch(cuda, 4096, 4096)
    held = _build._PARTIALS[cuda].numel()
    g = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="during a CUDA graph capture"):
        with torch.cuda.graph(g):
            _build.scratch(cuda, 4 * held, 1)
    assert _build._PARTIALS[cuda].numel() == held


@pytest.mark.gpu
def test_failed_capture_raises_without_eager_retry(cuda):
    """A rung whose capture fails raises; the body is not run again
    eagerly, no rung is kept and no decode call is counted."""
    ex, active = _prefilled_executor(cuda, 1)
    inner, calls = ex._decode_body, []

    def failing(k, *bw_key):
        calls.append(torch.cuda.is_current_stream_capturing())
        if calls[-1]:
            raise RuntimeError("injected capture fault")
        return inner(k, *bw_key)

    ex._decode_body = failing
    with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
        ex._decode(1, active)
    assert calls == [False, True]
    assert not ex._rungs and ex.decode_calls == 0


@pytest.mark.gpu
def test_burst_serving_on_card_matches_single_steps(cuda):
    """run(burst=8) after warmup(burst=8) on the card: the greedy tokens
    of run(), every decode call a replay, no program made after warmup."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    prompts = [[(3 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((9, 70, 33))]
    outs = []
    for burst in (1, 8):
        ex = Executor(params, cfg, max_batch=4, max_seq_len=256,
                      block_size=16, prefill_chunk=32, device=cuda)
        ex.warmup(burst=burst)
        ids = [ex.submit(p, max_new_tokens=21) for p in prompts]
        done = ex.run(burst=burst)
        outs.append([done[r].generated for r in ids])
        assert ex.compiles_since_warmup == 0
        assert ex.graph_replays == ex.decode_calls > 0
    assert outs[0] == outs[1]


def _beam_search_on_card(cuda, graphs, prompts, runs=1, **kw):
    """paged_beam_search on the tiny model, ``runs`` times through one
    fresh BeamEngine: (the last result, engine, LAUNCHES of the last
    run)."""
    from mixq_tensorrt_llm_tpu_torch.runtime.beam import (BeamEngine,
                                                          paged_beam_search)
    params, cfg = _tiny_serving_model(cuda)
    eng = BeamEngine(params, cfg, cuda, graphs=graphs)
    for _ in range(runs):
        _build.reset_launches()
        res = paged_beam_search(params, cfg, prompts, 21, num_beams=3,
                                max_seq_len=256, block_size=16, engine=eng,
                                **kw)
        torch.cuda.synchronize()
    return res, eng, dict(_build.LAUNCHES)


@pytest.mark.gpu
def test_beam_burst_replay_bit_equal_to_eager(cuda):
    """paged_beam_search(burst=8), its second run through one engine (every
    burst a replay of the graph the first run captured), gives the
    sequences, scores and peak blocks of the same bursts run eagerly, and
    the same pools outside each layer's trash row 0; each replay adds its
    capture's launches: K10 once a layer a step, no K7 and no K5 (the
    pool is only read until the burst's flush)."""
    prompts = [[(5 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((9, 40, 16))]
    replayed, g_eng, launches = _beam_search_on_card(cuda, True, prompts,
                                                     runs=2, burst=8)
    eager, e_eng, _ = _beam_search_on_card(cuda, False, prompts, burst=8)
    assert replayed.sequences == eager.sequences
    assert replayed.scores == eager.scores
    assert replayed.peak_blocks == eager.peak_blocks
    assert g_eng.graph_replays == g_eng.bursts == 2 * e_eng.bursts > 0
    assert e_eng.graph_replays == 0
    assert launches.get("paged_decode_attention_stats", 0) \
        == 2 * e_eng.burst_steps
    assert launches.get("paged_decode_attention", 0) == 0
    assert launches.get("paged_write_token", 0) == 0
    nb = g_eng.state.num_pages // 2
    for name, t in g_eng.state.pools().items():
        u = e_eng.state.pools()[name]
        for layer in range(2):
            rows = slice(layer * nb + 1, (layer + 1) * nb)
            assert torch.equal(t[rows], u[rows]), (name, layer)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.gpu
def test_tail_attention_k10_matches_plain(cuda, pages):
    """models.common._attention_paged_tail on the card (K10 on the pool
    prefix, one launch) within 2e-2 of the same call on the CPU (K10's
    plain version), tails written alike."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo,
                                                   QuantConfig)
    kv = KVCacheQuantAlgo.INT8 if pages == "int8" else KVCacheQuantAlgo.NONE
    cfg = ModelConfig(num_heads=8, num_kv_heads=2, head_dim=D,
                      quant=QuantConfig(kv_cache=kv))
    gen = torch.Generator(device=cuda).manual_seed(3)
    pools = _pools(gen, cuda, 2) if pages == "int8" else {
        n: torch.randn((NP_, 2, BS, D), generator=gen, device=cuda,
                       dtype=torch.bfloat16) for n in ("k", "v")}
    b, kmax, t = 5, 4, 2
    tail = {n: torch.zeros((b, kmax) + p.shape[1:2] + p.shape[3:],
                           dtype=p.dtype, device=cuda)
            for n, p in pools.items() if n in ("k", "v")}
    tail["k"][:, :t] = (torch.randn(tail["k"][:, :t].shape, generator=gen,
                                    device=cuda) * 20).to(tail["k"].dtype)
    tail["v"][:, :t] = tail["k"][:, :t].flip(-1)
    if pages == "int8":
        for n in ("k", "v"):
            tail[n + "_scale"] = torch.full((b, kmax, 2), 0.01, device=cuda)
    table = torch.randint(1, NP_, (b, 3), generator=gen, device=cuda,
                          dtype=torch.int32)
    bpos = torch.tensor([[0, BS, 2 * BS]] * b, dtype=torch.int32,
                        device=cuda)
    bpos[0, 1:] = PAD_POS
    prefix = torch.tensor([3, BS, BS + 1, 2 * BS + 5, 3 * BS],
                          dtype=torch.int32, device=cuda)
    q = torch.randn((b, 1, 8, D), generator=gen, device=cuda,
                    dtype=torch.bfloat16)
    nk = torch.randn((b, 1, 2, D), generator=gen, device=cuda,
                     dtype=torch.bfloat16)
    nv = torch.randn((b, 1, 2, D), generator=gen, device=cuda,
                     dtype=torch.bfloat16)

    def run(dev):
        tl = {n: x.clone().to(dev) for n, x in tail.items()}
        out = mcommon._attention_paged_tail(
            cfg, q.to(dev), nk.to(dev), nv.to(dev),
            {n: x.to(dev) for n, x in pools.items()}, tl, t, table.to(dev),
            prefix.to(dev), block_pos=bpos.to(dev))
        return out.float().cpu(), {n: x.cpu() for n, x in tl.items()}

    _build.reset_launches()
    got, got_tail = run(cuda)
    torch.cuda.synchronize()
    name = "paged_decode_attention_stats" + ("" if pages == "int8" else "_fp")
    assert _build.LAUNCHES == {name: 1}
    want, want_tail = run(torch.device("cpu"))
    err = (got - want).abs().max() / want.abs().max()
    assert err <= 2e-2, err
    for n in tail:
        assert torch.equal(got_tail[n], want_tail[n]), n


@pytest.mark.gpu
def test_run_beams_on_card_after_warmup(cuda):
    """warmup_beams, then run_beams twice: no program made after warmup,
    every burst a replay, both runs the same sequences."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda)
    ex.warmup_beams(num_beams=4, burst=8, prompt_bucket=64,
                    max_new_tokens=20)
    outs = []
    for _ in range(2):
        ids = [ex.submit([(3 * i + j) % 500 + 1 for j in range(n)],
                         max_new_tokens=20)
               for i, n in enumerate((40, 64, 33, 17))]
        done = ex.run_beams(num_beams=4, burst=8)
        outs.append([done[r].generated for r in ids])
    eng = ex.beam_engine
    assert ex.compiles_since_warmup == 0
    assert eng.graph_replays == eng.bursts > 0
    assert outs[0] == outs[1] and all(len(g) == 20 for g in outs[0])


def _no_repeat(logits, history):
    """A logits processor: bans each lane's newest token."""
    return logits.scatter(1, history[:, -1:].clamp(min=0).long(), -1e9)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 4])
def test_rung_with_controls_replay_bit_equal_to_eager(cuda, k):
    """Lanes with bad words and a processor: the rung of their bucket is
    a captured graph whose replay gives the tokens, log-probabilities and
    pools of the same steps run eagerly, bit for bit; the bad-words-free
    rung of the same k is not used, and the banned tokens never come."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda,
                  logits_processors={"no_repeat": _no_repeat})
    controls = [dict(bad_words=[[7], [9, 11]]),
                dict(logits_processor="no_repeat"), {}]
    for i, (n, kw) in enumerate(zip((5, 40, 17), controls)):
        ex.submit([(7 * i + j) % 500 + 1 for j in range(n)],
                  max_new_tokens=64, **kw)
    while ex.queue or ex.prefilling:
        ex._admit()
        ex._step_prefill()
    active = [(i, r) for i, r in enumerate(ex.slots) if r is not None]
    for _, r in active:
        ex.bm.extend(r.req_id, k)
    before = _pool_copy(ex)
    ex._decode(k, active)                       # warm pass, capture, replay
    key = (k, 0, (2, 2))
    assert list(ex._rungs) == [key] and ex._rungs[key].graph is not None
    _pool_restore(ex, before)
    toks, lps = ex._decode(k, active)           # a replay
    torch.cuda.synchronize()
    replayed = _pool_copy(ex)
    assert ex.graph_replays == ex.decode_calls == 2
    _pool_restore(ex, before)
    out = ex._decode_body(k, (2, 2)).cpu().numpy()
    torch.cuda.synchronize()
    assert np.array_equal(toks, out[:, :k])
    assert np.array_equal(lps.view(np.int32), out[:, k:])
    for n, t in ex.state.pools().items():
        assert torch.equal(t, replayed[n]), n
    slot = {r.req_id: i for i, r in active}
    assert 7 not in toks[slot[0]]


@pytest.mark.gpu
def test_processor_reading_the_device_fails_capture(cuda):
    """A processor that reads a device value on the host cannot be
    captured: the rung raises, with no eager retry."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)

    def host_read(logits, history):
        return logits - float(logits.max())

    ex = Executor(params, cfg, max_batch=2, max_seq_len=128, block_size=16,
                  prefill_chunk=32, device=cuda,
                  logits_processors={"host_read": host_read})
    ex.submit([1, 2, 3], max_new_tokens=4, logits_processor="host_read")
    with pytest.raises(RuntimeError, match="CUDA graph capture failed"):
        ex.run()
    assert not ex._rungs and ex.decode_calls == 0


@pytest.mark.gpu
def test_prefill_after_adopted_pages_k6_k8(cuda, monkeypatch):
    """Prefix reuse on the card: a request adopting another's cached
    pages prefills from a page-aligned start past them through K6 and K8.
    K6's pools are bit-equal to the plain write's outside the trash row,
    K8 over the adopted pages is within 2e-2 of its plain version (the
    tolerance of every K8 test: bf16 output, sums in another order), and
    the tokens equal a cold Executor's."""
    from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pattn
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as pkv
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    shared = [(5 * j) % 500 + 1 for j in range(48)]
    prompts = [shared + [3] * 20, shared + [(11 * j) % 500 + 1
                                            for j in range(37)]]
    seen = {"write": 0, "attn": []}
    real_write, real_attn = pkv.paged_write, pattn.paged_prefill_attention

    def write(pools, table, pos, nk, nv, **kw):
        if nk.shape[1] > 8 and int(pos[:, 0].max()) > 0:
            want = {n: t.clone() for n, t in pools.items()}
            pkv.paged_write_plain(want, table, pos, nk, nv, **kw)
            real_write(pools, table, pos, nk, nv, **kw)
            torch.cuda.synchronize()
            for n in pools:
                assert torch.equal(pools[n][1:], want[n][1:]), n
            seen["write"] += 1
            return pools
        return real_write(pools, table, pos, nk, nv, **kw)

    def attn(q, kp, vp, ks, vs, table, q_start, lens, **kw):
        out = real_attn(q, kp, vp, ks, vs, table, q_start, lens, **kw)
        if int(q_start.max()) > 0:
            c = q.shape[1]
            q_pos = q_start[:, None] + torch.arange(c, device=q.device)
            want = pattn.paged_attention_plain(
                q, kp, vp, ks, vs, table, q_pos, lens, kw["scale"],
                kw["block_pos"], kw["window"], kw["sink"], kw["softcap"])
            rows = q_pos < lens[:, None]
            err = (out.float() - want.float())[rows].abs().max()
            assert float(err) <= 2e-2, err
            seen["attn"] += q_start.tolist()
        return out

    monkeypatch.setattr(pkv, "paged_write", write)
    monkeypatch.setattr(pattn, "paged_prefill_attention", attn)
    kw = dict(max_batch=2, max_seq_len=256, block_size=16, prefill_chunk=32,
              device=cuda)
    outs = []
    for reuse in (True, False):
        ex = Executor(params, cfg, enable_block_reuse=reuse, **kw)
        got = []
        for p in prompts:
            rid = ex.submit(p, max_new_tokens=6)
            got.append(ex.run()[rid].generated)
        outs.append(got)
        if reuse:
            assert ex.reused_blocks == 3          # 48 shared tokens
            assert seen["write"] > 0 and 48 in seen["attn"]
    assert outs[0] == outs[1]


# ---------------------------------------------------------------------------
# The quantization pipeline on the card (convert/, eval/ppl.py)
# ---------------------------------------------------------------------------

HF_TINY = dict(model_type="llama", hidden_size=256, intermediate_size=512,
               num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=4, vocab_size=512,
               max_position_embeddings=512, rms_norm_eps=1e-5,
               torch_dtype="float16")


@pytest.fixture
def hf_tiny(tmp_path):
    """A 2-layer HF Llama directory (4 MHA heads of 64, f16) with 8 planted
    outlier channels a layer, written on the CPU."""
    from mixq_tensorrt_llm_tpu_torch.tools.random_hf import \
        write_random_llama
    d = str(tmp_path / "hf")
    planted = write_random_llama(d, HF_TINY, seed=15, device="cpu",
                                 layers_per_shard=1, outliers=8)
    return d, planted


def _rel_rms(got, want) -> float:
    d = got.double() - want.double()
    return float(d.pow(2).mean().sqrt() / want.double().pow(2).mean().sqrt())


def _calib_batches(n=2, b=2, s=128):
    rng = np.random.default_rng(15)
    return [rng.integers(1, 512, (b, s)).astype(np.int32) for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("n", [64, 4096, 11008])
def test_select_outliers_ties_on_card(cuda, n, k):
    """jax.lax.top_k's tie order on the card: all-ones scales pick 0..k-1,
    planted ties the same channels as on the CPU."""
    k = min(k, n)
    ones = torch.ones(n)
    assert torch.equal(qcore.select_outliers(ones.to(cuda), k).cpu(),
                       torch.arange(k, dtype=torch.int32))
    gen = torch.Generator().manual_seed(n + k)
    act = torch.randint(1, 4, (n,), generator=gen).float()
    act[torch.randperm(n, generator=gen)[:k // 2]] = 7.0
    assert torch.equal(qcore.select_outliers(act.to(cuda), k).cpu(),
                       qcore.select_outliers(act, k))


def _rel_max(got, want) -> float:
    """The largest channel difference over the largest value."""
    return float((got - want).abs().max() / want.abs().max())


# bf16 stats and act_scales, card against CPU at a channel (over the
# module's largest value); the card's distance from an f32 calibration
# over the CPU bf16 run's
STATS_MAX, F32_RATIO = 1e-2, 2.0
LOGITS_RMS = 5e-2        # the ppl forward's logits, card against CPU


@pytest.mark.gpu
def test_collect_stats_on_card(cuda, hf_tiny):
    """forward(collect_stats=True) of the float model on the card (K14 at
    the 128-token prefill) against the CPU's bf16 forward and an f32 CPU
    forward (the witness), for each module and layer: card - CPU within
    2e-2 relative RMS and STATS_MAX of the largest value at every
    channel, and the card no further from f32 than F32_RATIO x the CPU
    bf16 forward is. Largest readings (H100): card - CPU 7.2e-3 (layer
    1's gate_up input), card - f32 over CPU bf16 - f32 1.62 (there)."""
    import dataclasses
    from mixq_tensorrt_llm_tpu_torch.convert import hf
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    from mixq_tensorrt_llm_tpu_torch.models import registry
    d, _ = hf_tiny
    cfg = registry.config_from_hf(hf.load_hf_config(d))
    sd = hf.load_hf_state_dict(d)
    tokens = torch.from_numpy(_calib_batches(1)[0])
    b, s = tokens.shape
    stats = {}
    for name, dev, dtype in (("cpu", torch.device("cpu"), cfg.dtype),
                             ("f32", torch.device("cpu"), torch.float32),
                             ("card", cuda, cfg.dtype)):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = registry.params_from_hf(c, sd, device=dev)
        _build.reset_launches()
        _, _, stats[name] = mc.forward(
            params, c, tokens.to(dev),
            torch.arange(s, device=dev)[None].expand(b, s),
            mc.init_kv_cache(c, b, s, device=dev),
            torch.full((b,), s, device=dev), collect_stats=True,
            full_prefill=True)
    assert _build.LAUNCHES.get("flash_causal_attention", 0) == 2
    for mod, want in stats["cpu"].items():
        got, f32 = stats["card"][mod].cpu(), stats["f32"][mod]
        assert got.shape == want.shape == (2, want.shape[1])
        for i in range(2):
            reading = (_rel_rms(got[i], want[i]), _rel_max(got[i], want[i]),
                       _rel_max(got[i], f32[i]), _rel_max(want[i], f32[i]))
            print(f"stats {mod}[{i}]: card - CPU {reading[1]:.3e} (relative"
                  f" RMS {reading[0]:.3e}), card - f32 {reading[2]:.3e}, "
                  f"CPU - f32 {reading[3]:.3e}")
            assert reading[0] <= 2e-2, (mod, i, reading)
            assert reading[1] <= STATS_MAX, (mod, i, reading)
            assert reading[2] <= F32_RATIO * reading[3], (mod, i, reading)


@pytest.mark.gpu
def test_quantize_hf_model_card_vs_cpu(cuda, hf_tiny, tmp_path):
    """Calibrated on the card: the planted channels found; the same
    act_scales quantized on the CPU give bit-equal int8 weights, fp_ind and
    fp_weight, scale_col within 1e-6; a CPU calibration (bf16 forwards)
    picks the same outliers, its act_scales within 2e-2 relative RMS and
    STATS_MAX at every channel of the card's, the card no further from an
    f32 CPU calibration than F32_RATIO x the CPU bf16 one. Largest
    readings (H100): card - CPU 7.0e-3 (layer 1's gate_up input), card -
    f32 over CPU bf16 - f32 1.0."""
    from mixq_tensorrt_llm_tpu_torch.convert import calibrate, hf
    from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import \
        read_safetensors
    from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo,
                                                   QuantAlgo, QuantConfig)
    d, planted = hf_tiny
    quant = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=8,
                        kv_cache=KVCacheQuantAlgo.INT8)
    hf.quantize_hf_model(d, str(tmp_path / "card"), quant,
                         calib_batches=_calib_batches(), device=cuda)
    scales = str(tmp_path / "card" / "act_scales.npz")
    hf.quantize_hf_model(d, str(tmp_path / "cpu"), quant,
                         act_scales_path=scales, device="cpu")
    hf.quantize_hf_model(d, str(tmp_path / "cpu_cal"), quant,
                         calib_batches=_calib_batches(), device="cpu")
    hf.quantize_hf_model(d, str(tmp_path / "f32_cal"), quant,
                         calib_batches=_calib_batches(), device="cpu",
                         dtype=torch.float32)
    card = read_safetensors(str(tmp_path / "card" / "model.safetensors"))
    cpu = read_safetensors(str(tmp_path / "cpu" / "model.safetensors"))
    assert sorted(card) == sorted(cpu)
    for name, t in card.items():
        if name.endswith("scale_col"):
            torch.testing.assert_close(t, cpu[name], rtol=1e-6, atol=0)
        else:
            assert torch.equal(t, cpu[name]), name
    for i in range(2):
        for mod in ("qkv_proj", "gate_up_proj"):
            assert torch.equal(card[f"layers.{mod}.fp_ind"][i].long(),
                               planted[i])
    want = calibrate.load_act_scales(str(tmp_path / "cpu_cal" /
                                         "act_scales.npz"))
    got = calibrate.load_act_scales(scales)
    f32 = calibrate.load_act_scales(str(tmp_path / "f32_cal" /
                                        "act_scales.npz"))
    for key, w in want.items():
        reading = (_rel_rms(got[key], w), _rel_max(got[key], w),
                   _rel_max(got[key], f32[key]), _rel_max(w, f32[key]))
        print(f"act_scales {key}: card - CPU {reading[1]:.3e} (relative "
              f"RMS {reading[0]:.3e}), card - f32 {reading[2]:.3e}, CPU - "
              f"f32 {reading[3]:.3e}")
        assert reading[0] <= 2e-2, (key, reading)
        assert reading[1] <= STATS_MAX, (key, reading)
        assert reading[2] <= F32_RATIO * reading[3], (key, reading)
    cpu_cal = read_safetensors(str(tmp_path / "cpu_cal" /
                                   "model.safetensors"))
    for mod in ("qkv_proj", "gate_up_proj"):
        assert torch.equal(cpu_cal[f"layers.{mod}.fp_ind"],
                           card[f"layers.{mod}.fp_ind"])


@pytest.mark.gpu
def test_evaluate_ppl_card_vs_cpu(cuda, hf_tiny, tmp_path, monkeypatch):
    """LLM over the HF directory (int8_mix, int8 KV) on the card: block
    perplexity through K1 -> K2, K4 (prefill regime) and K14, total NLL
    within 1e-4 relative of the CPU's over the same checkpoint (reading
    1.9e-5, H100); the ppl forward's logits within LOGITS_RMS relative
    RMS of the CPU's (reading 1.03e-2), which K2 without its outlier side
    GEMM must exceed (reading 1.28); with full_prefill False no K14; a
    second LLM loads and writes nothing."""
    from mixq_tensorrt_llm_tpu_torch.api import LLM
    from mixq_tensorrt_llm_tpu_torch.eval.ppl import evaluate_ppl
    from mixq_tensorrt_llm_tpu_torch.models import common as mc
    d, _ = hf_tiny
    kw = dict(quant="int8_mix", kv_cache_quant="int8",
              cache_dir=str(tmp_path / "cache"), max_seq_len=256)
    llm = LLM(d, device=cuda, **kw)
    weights = os.path.join(llm._ckpt_dir, "model.safetensors")
    stamp = os.stat(weights).st_mtime_ns
    stream = np.random.default_rng(16).integers(1, 512, 3 * 128 + 5)
    _build.reset_launches()
    got = evaluate_ppl(llm.params, llm.cfg, stream, seq_len=128,
                       batch_size=2)
    seen = dict(_build.LAUNCHES)
    for name in ("rmsnorm_quant_split", "mixed_matmul", "wo_matmul",
                 "wo_matmul.prefill", "flash_causal_attention"):
        assert seen.get(name, 0) > 0, (name, seen)
    assert seen["flash_causal_attention"] == 2 * 2      # 2 batches x 2
    cpu = LLM(llm._ckpt_dir, device="cpu", max_seq_len=256)
    want = evaluate_ppl(cpu.params, cpu.cfg, stream, seq_len=128,
                        batch_size=2)
    assert got.blocks == want.blocks == 3
    assert abs(got.total_nll - want.total_nll) <= 1e-4 * want.total_nll
    blocks = torch.tensor(stream[:2 * 128]).view(2, 128)

    def logits(params, cfg, dev):
        t = blocks.to(dev)
        b, s = t.shape
        out, _ = mc.forward(
            params, cfg, t, torch.arange(s, dtype=torch.int32, device=dev)[
                None].expand(b, s), mc.init_kv_cache(cfg, b, s, device=dev),
            torch.full((b,), s, dtype=torch.int32, device=dev),
            full_prefill=True)
        return out.cpu()

    base = logits(cpu.params, cpu.cfg, torch.device("cpu"))
    sound = _rel_rms(logits(llm.params, llm.cfg, cuda), base)
    real = mm.mixed_matmul
    monkeypatch.setattr(mm, "mixed_matmul", lambda q, sr, xo, qw, sc, fw, **k:
                        real(q, sr, xo, qw, sc, torch.zeros_like(fw), **k))
    control = _rel_rms(logits(llm.params, llm.cfg, cuda), base)
    monkeypatch.setattr(mm, "mixed_matmul", real)
    print(f"ppl logits card - CPU: {sound:.3e} relative RMS, without K2's "
          f"side GEMM {control:.3e}; total NLL "
          f"{abs(got.total_nll - want.total_nll) / want.total_nll:.3e}")
    assert sound <= LOGITS_RMS < control, (sound, control)
    _build.reset_launches()
    cached = evaluate_ppl(llm.params, llm.cfg, stream, seq_len=128,
                          batch_size=2, full_prefill=False)
    assert _build.LAUNCHES.get("flash_causal_attention", 0) == 0
    assert np.isfinite(cached.ppl)
    again = LLM(d, device=cuda, **kw)
    assert again._ckpt_dir == llm._ckpt_dir
    assert os.stat(weights).st_mtime_ns == stamp


# ---------------------------------------------------------------------------
# Runtime-adaptive outliers, fp8 and int8_lr on the card
# ---------------------------------------------------------------------------

def _tiny_format_model(cuda, algo, kv, dynamic=False, num_kv_heads=2):
    """_tiny_serving_model's geometry (hidden 256, 4 heads of 64) in
    another format: fp8 / int8_lr weights, fp8 / int8 KV, or int8_mix
    with dynamic outliers (cap 64) and both RMSNorm weights of layer 0 at
    8 on four channels outside its static sets."""
    from mixq_tensorrt_llm_tpu_torch.models import llama
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo,
                                                   QuantAlgo, QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.tools import serving_profile as sp
    cfg = ModelConfig(vocab_size=512, hidden_size=256, intermediate_size=512,
                      num_layers=2, num_heads=4, num_kv_heads=num_kv_heads,
                      head_dim=64,
                      quant=QuantConfig(algo=QuantAlgo(algo), num_outliers=8,
                                        max_outliers=64,
                                        dynamic_outliers=dynamic,
                                        kv_cache=KVCacheQuantAlgo(kv)))
    gen = torch.Generator(device=cuda).manual_seed(16)
    params = llama.init_random_params(
        cfg, seed=16, device=cuda,
        act_scales=sp.distinct_act_scales(cfg, gen, cuda))
    if dynamic:
        static = set(params["layers"][0]["qkv_proj"]["fp_ind"].tolist()) | \
            set(params["layers"][0]["gate_up_proj"]["fp_ind"].tolist())
        planted = [c for c in range(256) if c not in static][:4]
        for norm in ("input_norm", "post_norm"):
            params["layers"][0][norm]["w"][planted] = 8.0
        return params, cfg, planted
    return params, cfg


@pytest.mark.gpu
@pytest.mark.parametrize("m", [8, 1024])
@pytest.mark.parametrize("ko,pad", [(0, 0), (32, 0), (256, 100)])
def test_k1_k2_at_dynamic_and_lr_widths(cuda, m, ko, pad):
    """K1 (no norm) over an empty fp_ind, 32 entries and 256 with 100 of
    them -1 (the dynamic padding: gathers 0, zeroes nothing), then K2 at
    that ko: K1's and K2's tolerances against their plain versions, one
    launch each a call."""
    gen = torch.Generator(device=cuda).manual_seed(ko + m)
    k, n = 4096, 1024
    x = (torch.randn((m, k), generator=gen, device=cuda) * 3).to(
        torch.bfloat16)
    ind = torch.randperm(k, generator=gen, device=cuda)[:ko].int()
    ind[ko - pad:] = -1
    qw = torch.randint(-127, 128, (k, n), generator=gen, device=cuda,
                       dtype=torch.int8)
    scol = torch.rand((n,), generator=gen, device=cuda) * 1e-2
    fpw = (torch.randn((ko, n), generator=gen, device=cuda) * 0.05).to(
        torch.bfloat16)
    before = dict(_build.LAUNCHES)
    got = nq.quant_split(x, ind)
    want = nq.quant_split_plain(x, ind)
    out = mm.mixed_matmul(*got[:3], qw, scol, fpw)
    plain = mm.mixed_matmul_plain(*got[:3], qw, scol, fpw)
    torch.cuda.synchronize()
    assert _launched("rmsnorm_quant_split", before) == 1
    assert _launched("mixed_matmul", before) == 1
    diff = (got[0].int() - want[0].int()).abs()
    assert int(diff.max()) <= 1 and float((diff == 0).float().mean()) > 0.999
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0)
    assert got[2].shape == (m, ko)
    torch.testing.assert_close(got[2].float(), want[2].float(), rtol=1e-2,
                               atol=1e-2)
    if pad:
        assert bool((got[2][:, ko - pad:] == 0).all())
    assert _close(out, plain, torch.bfloat16)


@pytest.mark.gpu
def test_adaptive_linear_on_card_matches_cpu(cuda):
    """quant/dynamic.adaptive_mix_linear at cap 256 on the card (K1 with
    -1 padding, then K2) against the same call on the CPU: the selection
    and the state equal, the output within K2's tolerance."""
    from mixq_tensorrt_llm_tpu_torch.quant import dynamic as qdyn
    gen = torch.Generator(device=cuda).manual_seed(21)
    k, n = 1024, 768
    x = torch.randn((2, 48, k), generator=gen, device=cuda)
    x[..., [5, 77, 901]] *= 12.0
    x = x.to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device=cuda) * 0.02
    qw, scol = qcore.quantize_weight_int8(w)
    state = torch.zeros((k,), device=cuda)
    state[torch.randperm(k, generator=gen, device=cuda)[:128]] = 12.0
    before = dict(_build.LAUNCHES)
    out, st = qdyn.adaptive_mix_linear(x, qw, scol,
                                       qdyn.DynamicOutlierState(state),
                                       cap=256, sigma=6.0, base_k=128)
    torch.cuda.synchronize()
    assert _launched("rmsnorm_quant_split", before) == 1
    assert _launched("mixed_matmul", before) == 1
    cpu = qdyn.adaptive_mix_linear(
        x.cpu(), qw.cpu(), scol.cpu(), qdyn.DynamicOutlierState(state.cpu()),
        cap=256, sigma=6.0, base_k=128)
    assert torch.equal(st.chan_max.cpu(), cpu[1].chan_max)
    sel = qdyn.dynamic_fp_ind(st.chan_max, 256, 6.0, 128)
    assert sel.tolist() == qdyn.dynamic_fp_ind(cpu[1].chan_max, 256, 6.0,
                                               128).tolist()
    assert {5, 77, 901} <= set(sel.tolist()) and -1 in sel.tolist()
    assert _close(out.cpu(), cpu[0], torch.bfloat16)


@pytest.mark.gpu
def test_fp8_casts_card_bit_equal_to_cpu(cuda):
    """The e4m3 weight and KV casts give the CPU's bytes on the card
    (values next to 448, subnormals, the scale floor, zero rows)."""
    gen = torch.Generator(device=cuda).manual_seed(22)
    w = torch.randn((4096, 4096), generator=gen, device=cuda) * 0.02
    w[:, 0] = torch.linspace(-1, 1, 4096, device=cuda)
    w[:, 1] = 2.0 ** -torch.arange(4096, device=cuda).clamp(max=120).float()
    w[:, 2] = 0.0
    w[:, 3] *= 1e-12
    w[7] = 0.0
    kv = torch.randn((8, 32, 128), generator=gen, device=cuda) * 3
    kv[0, 0] = 0.0
    kv[1, 1] *= 1e-12
    for got, want in ((qcore.quantize_weight_fp8(w),
                       qcore.quantize_weight_fp8(w.cpu())),
                      (qcore.quantize_kv(kv, dtype=qcore.FP8),
                       qcore.quantize_kv(kv.cpu(), dtype=qcore.FP8))):
        assert torch.equal(got[0].view(torch.uint8).cpu(),
                           want[0].view(torch.uint8))
        assert torch.equal(got[1].cpu(), want[1])


@pytest.mark.gpu
def test_fp8_executor_decode_replays_without_paged_kernels(cuda):
    """fp8 weights and e4m3 pools on the card: after warmup(burst=4) every
    decode call is a graph replay and no program is made; no K5-K11
    launch (JAX never hands e4m3 pages to its paged kernels), the gather
    route counted in prefill and in the replays. The same model on int8
    pools never takes the gather route."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    prompts = [[(5 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((9, 70, 33))]
    for kv in ("fp8", "int8"):
        params, cfg = _tiny_format_model(cuda, "fp8", kv)
        ex = Executor(params, cfg, max_batch=4, max_seq_len=256,
                      block_size=16, prefill_chunk=32, device=cuda)
        ex.warmup(burst=4)
        ids = [ex.submit(p, max_new_tokens=12) for p in prompts]
        _build.reset_launches()
        steps = ex.decode_steps
        done = ex.run(burst=4)
        torch.cuda.synchronize()
        assert all(len(done[r].generated) == 12 for r in ids)
        assert ex.compiles_since_warmup == 0
        assert ex.graph_replays == ex.decode_calls > 0
        gathers = _build.LAUNCHES.get("paged_gather", 0)
        if kv == "fp8":
            assert ex.state.k.dtype == qcore.FP8
            assert not any(n.startswith("paged_") and n != "paged_gather"
                           for n in _build.LAUNCHES), dict(_build.LAUNCHES)
            assert gathers >= cfg.num_layers * (ex.decode_steps - steps) > 0
        else:
            assert gathers == 0
            assert _build.LAUNCHES.get("paged_decode_attention", 0) > 0


@pytest.mark.gpu
def test_session_over_fp8_dense_cache(cuda):
    """GenerationSession over an e4m3 dense cache: K14 once a layer at the
    prefill, no paged kernel, 8 tokens a prompt, finite logits."""
    from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
    params, cfg = _tiny_format_model(cuda, "fp8", "fp8", num_kv_heads=4)
    prompts = [[(5 * i + j) % 500 + 1 for j in range(n)]
               for i, n in enumerate((100, 128))]
    sess = GenerationSession(params, cfg, max_seq_len=256, device=cuda)
    _build.reset_launches()
    out = sess.generate(prompts, 8, return_context_logits=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES.get("flash_causal_attention", 0) == cfg.num_layers
    assert not any(n.startswith("paged_") for n in _build.LAUNCHES)
    assert out.num_generated == [8, 8]
    assert all(bool(torch.isfinite(c).all()) for c in out.context_logits)


@pytest.mark.gpu
def test_int8_lr_route_on_card(cuda):
    """int8_lr on the card: every lr linear is K1 (no outliers) -> K2 with
    the rank-32 correction as its side GEMM, in prefill and in the decode
    replays (int8_lr takes no weight-only route), K4 for down_proj; one
    linear within K2's tolerance of the CPU's; the traced prefill shows
    K1's and K2's kernels."""
    from mixq_tensorrt_llm_tpu_torch.ops import dispatch
    from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_format_model(cuda, "int8_lr", "int8")
    lp = params["layers"][0]["qkv_proj"]
    assert lp["lr_u"].shape == (256, 32) and lp["lr_v"].shape[0] == 32
    x = torch.randn((40, 256), device=cuda).to(torch.bfloat16)
    before = dict(_build.LAUNCHES)
    got = dispatch.linear(lp, x, QuantAlgo.INT8_LR)
    torch.cuda.synchronize()
    assert _launched("rmsnorm_quant_split", before) == 1
    assert _launched("mixed_matmul", before) == 1
    want = dispatch.linear({k: v.cpu() for k, v in lp.items()}, x.cpu(),
                           QuantAlgo.INT8_LR)
    assert _close(got.cpu(), want, torch.bfloat16)
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda)
    ex.submit(list(range(1, 40)), max_new_tokens=1)
    names = _traced_kernels(ex.run)
    assert any("norm_quant" in n for n in names)
    assert any("mixed_wgmma_kernel" in n for n in names)
    ids = [ex.submit(list(range(1, n)), max_new_tokens=6) for n in (20, 50)]
    _build.reset_launches()
    ex.run()
    torch.cuda.synchronize()
    steps = ex.decode_steps
    assert ex.graph_replays == ex.decode_calls > 0
    # 3 lr linears a layer a step, at least, from the decode replays
    assert _build.LAUNCHES["mixed_matmul"] >= 3 * cfg.num_layers * 5
    assert _build.LAUNCHES["rmsnorm_quant_split"] == \
        _build.LAUNCHES["mixed_matmul"]
    assert _build.LAUNCHES.get("wo_matmul", 0) > 0
    assert steps > 0 and all(len(ex.finished[r].generated) == 6
                             for r in ids)


def _cpu_params(params):
    """A params tree's copy on the CPU (the layers' dicts, an expert
    layer's nested ``moe`` entry, and every tensor in them)."""
    cpu = torch.device("cpu")

    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, list):
            return [copy(x) for x in v]
        return v.to(cpu)
    return copy(params)


@pytest.mark.gpu
def test_tree_mask_forward_on_card(cuda):
    """A Medusa verify (the default tree's 11 rows at offset slots, the
    ancestor mask, rope_pos, return_hidden) over a prefilled context on
    the card: K1 -> K2 launched, logits and the pre-norm hidden within
    the cross-device tolerance of the CPU route; then medusa_generate on
    the card commits its 12 tokens."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.runtime import medusa
    params, cfg = _tiny_serving_model(cuda, num_kv_heads=4)
    cpu = _cpu_params(params)
    tree = medusa.build_tree(medusa.DEFAULT_CHOICES)
    rng = np.random.default_rng(3)
    ctx = rng.integers(1, 500, 24)
    rows = rng.integers(1, 500, (1, tree.num_nodes + 1)).astype(np.int32)
    anc, depths = medusa.verify_layout(tree)

    def run(dev, p):
        cache = mcommon.init_kv_cache(cfg, 1, 64, device=dev)
        mcommon.forward(p, cfg, torch.tensor(ctx[None], device=dev),
                        torch.arange(24, device=dev)[None], cache,
                        torch.tensor([24], device=dev), full_prefill=True)
        _build.reset_launches()
        out = medusa.tree_verify(p, cfg, cache, rows, depths,
                                 torch.as_tensor(anc, device=dev), 24)
        return [x.float().cpu() for x in out], dict(_build.LAUNCHES)

    (lg, hid), seen = run(cuda, params)
    (lg0, hid0), _ = run(torch.device("cpu"), cpu)
    assert seen.get("rmsnorm_quant_split", 0) == 3 * cfg.num_layers
    assert seen.get("mixed_matmul", 0) == 3 * cfg.num_layers
    assert float((lg - lg0).abs().max() / lg0.abs().max()) < 5e-2
    assert float((hid - hid0).abs().max() / hid0.abs().max()) < 2e-2
    heads = medusa.init_random_heads(cfg, torch.Generator().manual_seed(0),
                                     4, device=cuda)
    seq, stats = medusa.medusa_generate(params, cfg, heads,
                                        list(range(1, 40)), 12,
                                        device=cuda)
    assert stats.tokens == 12 and len(seq) == 51


@pytest.mark.gpu
def test_lora_lane_on_card(cuda):
    """A random two-adapter stack on the tiny model: forward(lora_ids=[2])
    on the card within the cross-device tolerance of the CPU route (K1
    without its norm, then K2), and an Executor on the card serving ids
    0/1/2 after warmup(burst=4): every decode call a replay (the lanes'
    ids a static input of the rungs), no program after warmup."""
    from mixq_tensorrt_llm_tpu_torch.convert.lora import attach_lora
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    params, cfg = _tiny_serving_model(cuda)
    gen = torch.Generator().manual_seed(5)
    stack = {}
    for mod, (nin, nout, r) in {"qkv_proj": (256, cfg.qkv_out, 8),
                                "o_proj": (256, 256, 4),
                                "gate_up_proj": (256, 1024, 4),
                                "down_proj": (512, 256, 4)}.items():
        a = torch.randn((2, 3, nin, r), generator=gen) * 0.05
        b = torch.randn((2, 3, r, nout), generator=gen) * 0.05
        a[:, 0], b[:, 0] = 0, 0
        stack[mod] = {"A": a.bfloat16().to(cuda), "B": b.bfloat16().to(cuda)}
    attach_lora(params, stack)
    cpu = _cpu_params(params)
    tok = torch.arange(1, 25)[None]

    def fwd(dev, p):
        cache = mcommon.init_kv_cache(cfg, 1, 32, device=dev)
        return mcommon.forward(p, cfg, tok.to(dev),
                               torch.arange(24, device=dev)[None], cache,
                               torch.tensor([24], device=dev),
                               lora_ids=torch.tensor([2], device=dev))[0]

    names = _traced_kernels(lambda: fwd(cuda, params))
    k1 = [n for n in names if "norm_quant" in n]
    assert k1 and all("false" in n for n in k1), k1
    got, want = fwd(cuda, params).float().cpu(), fwd("cpu", cpu)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-2
    ex = Executor(params, cfg, max_batch=4, max_seq_len=256, block_size=16,
                  prefill_chunk=32, device=cuda)
    ex.warmup(burst=4)
    ids = [ex.submit(list(range(1 + i, 20 + 7 * i)), max_new_tokens=9,
                     lora_id=i % 3) for i in range(4)]
    done = ex.run(burst=4)
    assert ex.graph_replays == ex.decode_calls > 0
    assert ex.compiles_since_warmup == 0
    assert all(len(done[r].generated) == 9 for r in ids)


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,pages", [(71, 64, "int8"), (48, 128, "int8"),
                                       (71, 64, "bfloat16")])
def test_decode_rows_route_large_groups(cuda, g, d, pages):
    """K7 where a KV head's query heads do not fit the split kernel's
    block: the rows layout at S = 1, chosen from the shapes, against the
    plain version (a recycled table, a window on lane 1)."""
    gen = torch.Generator(device=cuda).manual_seed(g + d)
    bs, hkv, np_ = 128, 1, 12
    if pages == "int8":
        kp = torch.randint(-127, 128, (np_, hkv, bs, d), generator=gen,
                           device=cuda, dtype=torch.int8)
        vp = torch.randint(-127, 128, (np_, hkv, bs, d), generator=gen,
                           device=cuda, dtype=torch.int8)
        ks = torch.rand((np_, hkv, bs), generator=gen, device=cuda) * 0.02
        vs = torch.rand((np_, hkv, bs), generator=gen, device=cuda) * 0.02
    else:
        kp = torch.randn((np_, hkv, bs, d), generator=gen,
                         device=cuda).bfloat16()
        vp = torch.randn((np_, hkv, bs, d), generator=gen,
                         device=cuda).bfloat16()
        ks = vs = None
    assert pa.decode_route(g, d, bs, kp.element_size(), ks is not None,
                           True) == "rows"
    table = torch.tensor([[3, 5, 4, 0], [7, 8, 9, 10]], dtype=torch.int32,
                         device=cuda)
    bpos = torch.tensor([[0, 2 * bs, bs, PAD_POS], [0, bs, 2 * bs, 3 * bs]],
                        dtype=torch.int32, device=cuda)
    lens = torch.tensor([3 * bs - 7, 4 * bs - 1], dtype=torch.int32,
                        device=cuda)
    q = torch.randn((2, g * hkv, d), generator=gen, device=cuda).bfloat16()
    for window in (0, 200):
        before = dict(_build.LAUNCHES)
        out = pa.paged_decode_attention(q, kp, vp, ks, vs, table, lens,
                                        d ** -0.5, block_pos=bpos,
                                        window=window)
        again = pa.paged_decode_attention(q, kp, vp, ks, vs, table, lens,
                                          d ** -0.5, block_pos=bpos,
                                          window=window)
        want = pa.paged_attention_plain(q[:, None], kp, vp, ks, vs, table,
                                        (lens - 1)[:, None], lens,
                                        d ** -0.5, block_pos=bpos,
                                        window=window)[:, 0]
        torch.cuda.synchronize()
        sfx = "" if pages == "int8" else "_fp"
        assert _launched("paged_decode_attention_rows" + sfx, before) == 2
        assert _launched("paged_decode_attention" + sfx, before) == 0
        assert float((out.float() - want.float()).abs().max()) <= 2e-2
        assert torch.equal(out, again)


@pytest.mark.gpu
@pytest.mark.parametrize("k,n", [(4544, 4672), (1600, 1600)])
@pytest.mark.parametrize("m", [1, 8, 40, 129, 1024])
def test_n_tail_gemms_match_plain(cuda, k, n, m):
    """K2 and K4 at N % 128 == 64 (a partial last column tile): Falcon-7B's
    qkv (4544 -> 4672) and GPT-2 XL's hidden (1600), at decode (1, 8),
    the verify's 40 rows (K4's mid regime) and prefill (129, 1024; K4's
    wgmma GEMM), against their plain versions, two launches bit-equal,
    each counted as .n_tail."""
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    ops = _mix_operands(gen, cuda, m, k, n, 128)
    before = dict(_build.LAUNCHES)
    out = mm.mixed_matmul(**ops, out_dtype=torch.bfloat16)
    again = mm.mixed_matmul(**ops, out_dtype=torch.bfloat16)
    want = mm.mixed_matmul_plain(**ops, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert _close(out, want, torch.bfloat16) and torch.equal(out, again)
    assert _launched("mixed_matmul.n_tail", before) == 2
    x = torch.randn((m, k), generator=gen, device=cuda).bfloat16()
    scol = ops["scale_col"]
    plan = wm.wo_plan(m, k, n, wm.sm_count(cuda.index or 0))
    for dtype in (torch.float32, torch.bfloat16):
        before = dict(_build.LAUNCHES)
        out = wm.wo_matmul(x, ops["qweight"], scol, out_dtype=dtype)
        again = wm.wo_matmul(x, ops["qweight"], scol, out_dtype=dtype)
        want = wm.wo_matmul_plain(x, ops["qweight"], scol, out_dtype=dtype)
        torch.cuda.synchronize()
        assert _close(out, want, dtype) and torch.equal(out, again)
        assert _launched("wo_matmul.n_tail", before) == 2
        assert _launched("wo_matmul." + wm.k4_regime(plan), before) == 2


@pytest.mark.gpu
def test_gemma2_layers_windows_on_card(cuda):
    """A 4-layer Gemma-2 (int8_mix, int8 KV, head dim 256, window 32 on
    layers 0 and 2): an Executor prefill of a 100-token prompt and 4
    decode steps on the card (K8 and K7 with each layer's window) against
    the CPU within the cross-device tolerance; K7 and K8 launched once a
    layer a call."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    from mixq_tensorrt_llm_tpu_torch.models import families
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as pkv
    cfg = mcommon.ModelConfig(
        arch="gemma2", vocab_size=512, hidden_size=512,
        intermediate_size=1024, num_layers=4, num_heads=4, num_kv_heads=2,
        head_dim=256, attn_scale=256 ** -0.5, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, post_block_norms=True, sliding_window=32,
        sliding_window_pattern=2, hidden_act="gelu_pytorch_tanh",
        embed_scale=512 ** 0.5, tie_word_embeddings=True,
        quant=QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=16,
                          kv_cache=KVCacheQuantAlgo.INT8))
    params = families.init_random_params(cfg, seed=3, device=cuda)
    cpu = _cpu_params(params)

    def run(dev, p):
        state = pkv.init_paged_kv(cfg, 8, 128, device=dev)
        table = torch.tensor([[1, 2]], dtype=torch.int32, device=dev)
        toks = torch.arange(3, 103, device=dev)[None]
        pos = torch.arange(100, dtype=torch.int32, device=dev)[None]
        lg, _ = mcommon.forward_paged(p, cfg, toks, pos, state, table,
                                      torch.tensor([100], device=dev),
                                      last_pos=torch.tensor([99],
                                                            device=dev))
        out = [lg[:, -1].float().cpu()]
        for step in range(4):
            t = torch.tensor([[7 + step]], device=dev)
            ps = torch.tensor([[100 + step]], dtype=torch.int32, device=dev)
            lg, _ = mcommon.forward_paged(p, cfg, t, ps, state, table,
                                          torch.tensor([101 + step],
                                                       device=dev))
            out.append(lg[:, -1].float().cpu())
        return torch.stack(out)

    before = dict(_build.LAUNCHES)
    got = run(cuda, params)
    torch.cuda.synchronize()
    assert _launched("paged_prefill_attention", before) == cfg.num_layers
    assert _launched("paged_decode_attention", before) == 4 * cfg.num_layers
    want = run(torch.device("cpu"), cpu)
    assert float((got - want).abs().max() / want.abs().max()) < 5e-2


def _moe_block(fmt, dev, e=8, h=256, i=384, shared=False):
    """(cfg, moe params on ``dev``, their CPU copy) of one expert block."""
    from mixq_tensorrt_llm_tpu_torch.models import llama as mllama
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant.config import (QuantAlgo,
                                                          QuantConfig)
    algo = {"none": QuantAlgo.NONE, "w8a16": QuantAlgo.W8A16,
            "w4a16": QuantAlgo.W4A16, "w4a16_g": QuantAlgo.W4A16_G}[fmt]
    cfg = ModelConfig(arch="mixtral", vocab_size=128, hidden_size=h,
                      intermediate_size=i, num_layers=1, num_heads=2,
                      num_kv_heads=2, head_dim=128, num_experts=e,
                      top_k_experts=2, moe_shared_intermediate=256
                      if shared else 0,
                      quant=QuantConfig(algo=algo, group_size=128))
    gen = torch.Generator().manual_seed(5)
    fl = mllama.random_experts(cfg, lambda *s: torch.randn(
        s, generator=gen) * 0.05)
    fl["router_w"] = fl["router_w"] * 20
    cpu = mllama.quantize_moe(cfg, fl)
    return cfg, {k: {n: t.to(dev) for n, t in v.items()}
                 for k, v in cpu.items()}, cpu


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["w8a16", "w4a16", "w4a16_g", "none"])
def test_moe_routes_match_plain(cuda, fmt):
    from mixq_tensorrt_llm_tpu_torch.models import moe
    cfg, p, cpu = _moe_block(fmt, cuda, shared=fmt == "w8a16")
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((2, 48, cfg.hidden_size), generator=gen)
    want = moe.moe_mlp(cfg, cpu, x)
    xc = x.to(cuda)
    for rows, static in ((96, False), (96, True), (24, False)):
        before = dict(_build.LAUNCHES)
        if static:
            with moe.static_shapes():
                got = moe.moe_mlp(cfg, p, xc)
        else:
            got = moe.moe_mlp(cfg, p, xc[:, :rows // 2])
        torch.cuda.synchronize()
        ref_ = want[:, :got.shape[1]]
        err = float((got.cpu() - ref_).abs().max() / ref_.abs().max())
        assert err < 1e-3, (rows, static, err)
        sorted_ = rows > moe.ALL_ROWS_MAX and not static
        k4 = _launched("wo_matmul", before)
        shared = 2 if fmt == "w8a16" else 0
        if fmt in ("w8a16", "w4a16"):
            experts = (_launched("moe.groups", before) if sorted_
                       else cfg.num_experts)
            assert k4 == 2 * experts + shared
        else:                # the plain route by format: no K4
            assert k4 == shared
        assert _launched("moe.sorted", before) == int(sorted_)
        assert _launched("moe.all_rows", before) == int(not sorted_)


@pytest.mark.gpu
def test_moe_all_rows_route_captured(cuda):
    """The all-rows route inside a CUDA graph: no readback breaks the
    capture, and the replay gives the eager call's bits."""
    from mixq_tensorrt_llm_tpu_torch.models import moe
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import capture_graph
    cfg, p, _ = _moe_block("w8a16", cuda)
    x = torch.randn((8, 1, cfg.hidden_size), device=cuda)
    with moe.static_shapes():
        eager = moe.moe_mlp(cfg, p, x)

        def body():
            return moe.moe_mlp(cfg, p, x)
        graph, out, launches = capture_graph(
            body, cuda, torch.cuda.graph_pool_handle(), "moe all rows")
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert launches["wo_matmul"] == 2 * cfg.num_experts
    assert "moe.sorted" not in launches


@pytest.mark.gpu
def test_moe_executor_replays_all_rows(cuda):
    """A tiny Mixtral (int8_mix, int8 KV) through the Executor on the
    card after warmup: each rung's graph holds 2 + 2 x E K4 launches a
    layer a step and the all-rows route only; the prefill call (64 + 96
    rows) sorted; every lane's first token (the prefill's) equal to the
    CPU Executor's."""
    from mixq_tensorrt_llm_tpu_torch.models import llama as mllama
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.quant.config import (
        KVCacheQuantAlgo, QuantAlgo, QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    cfg = ModelConfig(arch="mixtral", vocab_size=512, hidden_size=256,
                      intermediate_size=384, num_layers=2, num_heads=2,
                      num_kv_heads=1, head_dim=128, num_experts=8,
                      top_k_experts=2, dtype=torch.float32,
                      quant=QuantConfig(algo=QuantAlgo.INT8_MIX,
                                        num_outliers=16,
                                        kv_cache=KVCacheQuantAlgo.INT8))
    params = mllama.init_random_params(cfg, seed=4, device=cuda)
    prompts = [list(range(3, 67)), list(range(100, 196))]
    out = {}
    for dev, p in ((cuda, params), (torch.device("cpu"),
                                    _cpu_params(params))):
        ex = Executor(p, cfg, max_batch=2, max_seq_len=256, block_size=128,
                      seed=0, device=dev)
        ex.warmup(burst=4)
        ids = [ex.submit(q, max_new_tokens=8) for q in prompts]
        before = dict(_build.LAUNCHES)
        done = ex.run(burst=4)
        out[dev.type] = [done[i].generated[0] for i in ids]
        assert all(len(done[i].generated) == 8 for i in ids)
        if dev.type == "cuda":
            assert ex.compiles_since_warmup == 0
            assert ex.graph_replays == ex.decode_calls > 0
            for rung in ex._rungs.values():
                assert rung.launches["wo_matmul"] == \
                    rung.k * cfg.num_layers * (2 + 2 * cfg.num_experts)
                assert rung.launches["moe.all_rows"] == \
                    rung.k * cfg.num_layers
                assert "moe.sorted" not in rung.launches
            assert _launched("moe.sorted", before) == cfg.num_layers
    assert out["cuda"] == out["cpu"]


def _recurrent_witness(cfg, params, cuda, prompt_lens):
    """(card logits, CPU logits, the card run's launches) of a prefill of
    two prompts (``prompt_lens`` tokens, right-padded to the longer, the
    head at each lane's last) and 4 decode steps of fixed tokens through
    models.common.forward over the model's recurrent state."""
    from mixq_tensorrt_llm_tpu_torch.models import common as mcommon
    cpu = _cpu_params(params)
    s = max(prompt_lens)

    def run(dev, p):
        state = mcommon.init_kv_cache(cfg, 2, s + 8, device=dev)
        toks = (torch.arange(2 * s, device=dev).reshape(2, s) * 37) % 500 + 3
        lens = torch.tensor(prompt_lens, dtype=torch.int32, device=dev)
        pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
            2, s)
        lg, _ = mcommon.forward(p, cfg, toks, pos, state, lens,
                                full_prefill=True, last_pos=lens - 1)
        out = [lg[:, 0]]
        for step in range(4):
            t = torch.tensor([[7 + step], [9 + step]], device=dev)
            lg, _ = mcommon.forward(p, cfg, t, (lens + step)[:, None], state,
                                    lens + step + 1)
            out.append(lg[:, 0])
        return torch.stack(out).float().cpu()

    before = dict(_build.LAUNCHES)
    got = run(cuda, params)
    torch.cuda.synchronize()
    launches = {n: _launched(n, before) for n in _build.LAUNCHES}
    return got, run(torch.device("cpu"), cpu), launches


@pytest.mark.gpu
def test_mamba_layers_on_card(cuda):
    """A 2-layer Mamba (int8_mix, 16 outliers; hidden 256, d_inner 512,
    d_state 16): a prefill of prompts of 160 and 200 tokens and 4 decode
    steps on the card against the CPU within 2e-2 of the largest logit;
    in_proj and out_proj through K1 -> K2 at every forward (2 a layer)."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import mamba
    from mixq_tensorrt_llm_tpu_torch.quant.config import (QuantAlgo,
                                                          QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    cfg = mamba.config_from_hf(types.SimpleNamespace(**dict(
        random_hf.MAMBA_2_8B_HF, vocab_size=512, hidden_size=256,
        intermediate_size=512, num_hidden_layers=2, time_step_rank=16)),
        QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=16))
    params = mamba.init_random_params(cfg, seed=3, device=cuda)
    got, want, launches = _recurrent_witness(cfg, params, cuda, [160, 200])
    assert launches.get("rmsnorm_quant_split") == 2 * 2 * 5
    assert launches.get("mixed_matmul") == 2 * 2 * 5
    assert not any(n.startswith("paged") for n in launches if launches[n])
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2


@pytest.mark.gpu
def test_recurrentgemma_layers_on_card(cuda):
    """A 3-layer RecurrentGemma (int8_mix, 16 outliers; hidden 512, 4
    query heads on 1 KV head of 128, window 64): a prefill of prompts of
    200 and 256 tokens (the window biting; K8 over the page view at the
    attention layer) and 4 decode steps on the card against the CPU within
    2e-2 of the largest logit; the mix linears through K1 -> K2 (11 a
    forward), down_proj through K4 (3 a forward)."""
    import types
    from mixq_tensorrt_llm_tpu_torch.models import recurrentgemma as rg
    from mixq_tensorrt_llm_tpu_torch.quant.config import (QuantAlgo,
                                                          QuantConfig)
    from mixq_tensorrt_llm_tpu_torch.tools import random_hf
    cfg = rg.config_from_hf(types.SimpleNamespace(**dict(
        random_hf.RECURRENTGEMMA_2B_HF, vocab_size=512, hidden_size=512,
        intermediate_size=1024, num_hidden_layers=3, num_attention_heads=4,
        head_dim=128, lru_width=512, attention_window_size=64)),
        QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=16))
    params = rg.init_random_params(cfg, seed=4, device=cuda)
    got, want, launches = _recurrent_witness(cfg, params, cuda, [200, 256])
    assert launches.get("paged_prefill_attention_fp") == 1
    assert launches.get("rmsnorm_quant_split") == 11 * 5
    assert launches.get("mixed_matmul") == 11 * 5
    assert launches.get("wo_matmul") == 3 * 5
    assert float((got - want).abs().max() / want.abs().max()) < 2e-2
