"""Port parity: the plain versions of the paged attention kernels K7
(paged_decode_attention) and K8 (paged_prefill_attention) against the JAX
Pallas kernels in interpret mode (2e-2: those round q and p to bf16 and
emit bf16) and against the JAX gather path in f32 (1e-5). Covers GQA,
recycled block_pos tables, window + sink, softcap and fully masked lanes
(which the kernels return as 0). Unquantized bf16 pages (no scales, JAX's
quantized=False mode) against the same kernels, 2e-2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import ref as jref
from mixq_tensorrt_llm_tpu.ops.paged_attention import (
    paged_decode_attention as j_decode, paged_prefill_attention as j_prefill)
from mixq_tensorrt_llm_tpu.runtime.kv_cache import PAD_POS
from mixq_tensorrt_llm_tpu.runtime.kv_cache import paged_gather as j_gather
from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as tpa

NP_, BS, D, MB = 20, 8, 32, 4


def _pool(seed, hkv):
    rng = np.random.default_rng(seed)
    return (rng.integers(-127, 128, (NP_, hkv, BS, D)).astype(np.int8),
            rng.integers(-127, 128, (NP_, hkv, BS, D)).astype(np.int8),
            rng.uniform(0.002, 0.03, (NP_, hkv, BS)).astype(np.float32),
            rng.uniform(0.002, 0.03, (NP_, hkv, BS)).astype(np.float32))


def _tables(lens, recycled):
    """Distinct pages per lane; identity bases; lane `recycled` has its
    non-sink pages out of order; PAD_POS past each lane's pages; a lane
    of len <= 0 is fully inactive (table 0, all PAD_POS)."""
    b = len(lens)
    table = np.zeros((b, MB), np.int32)
    bpos = np.full((b, MB), PAD_POS, np.int32)
    nxt = 1
    for i, ln in enumerate(lens):
        n = -(-ln // BS) if ln > 0 else 0
        table[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
        if n:
            table[i, n:] = table[i, n - 1]
            bpos[i, :n] = np.arange(n) * BS
    if recycled is not None:
        n = -(-lens[recycled] // BS)
        bpos[recycled, 1:n] = bpos[recycled, 1:n][::-1]
    return table, bpos


def _gather_ref(q, pool, table, bpos, qpos, lens, scale, window, sink,
                softcap):
    """The JAX gather path (models/common.py:713-738) in f32."""
    caches = {"k": jnp.asarray(pool[0]), "v": jnp.asarray(pool[1]),
              "k_scale": jnp.asarray(pool[2]), "v_scale": jnp.asarray(pool[3])}
    k, v = j_gather(caches, jnp.asarray(table), jnp.float32)
    b = table.shape[0]
    kv_pos = (bpos[:, :, None] + np.arange(BS)[None, None]).reshape(b, -1)
    kv_pos = kv_pos[:, None, None, :]
    qp = qpos[:, None, :, None]
    mask = (kv_pos <= qp) & (kv_pos < lens[:, None, None, None])
    if window:
        mask &= (kv_pos > qp - window) | (kv_pos < sink)
    out = jref.attention(jnp.asarray(q), k, v, mask=jnp.asarray(mask),
                         scale=scale, softcap=softcap)
    return np.asarray(out), mask.any(-1)[:, 0]          # (B, S, ...), (B, S)


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [   # (hq, hkv, window, sink, softcap)
    (4, 4, 0, 0, 0.0),
    (8, 2, 0, 0, 0.0),          # GQA
    (8, 2, 12, 8, 0.0),         # sliding window + sink
    (4, 2, 0, 0, 15.0),         # softcap
]


@pytest.mark.parametrize("hq,hkv,window,sink,softcap", CASES)
def test_decode_plain_vs_jax(hq, hkv, window, sink, softcap):
    rng = np.random.default_rng(hq * 10 + hkv)
    lens = np.array([27, 1, 9, 32], np.int32)
    table, bpos = _tables([27, 0, 9, 32], recycled=3)
    pool = _pool(1, hkv)
    q = rng.standard_normal((4, hq, D)).astype(np.float32)
    scale = D ** -0.5
    kw = dict(block_pos=bpos, window=window, sink=sink, softcap=softcap)
    got = tpa.paged_decode_attention(
        _t(q), *map(_t, pool), _t(table), _t(lens), scale,
        **{**kw, "block_pos": _t(bpos)}).numpy()
    assert np.all(got[1] == 0.0)                 # inactive lane
    want = np.asarray(j_decode(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(lens), scale, **{**kw, "block_pos": jnp.asarray(bpos)},
        interpret=True), np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    ref, seen = _gather_ref(q[:, None], pool, table, bpos,
                            (lens - 1)[:, None], lens, scale, window, sink,
                            softcap)
    live = seen[:, 0]
    np.testing.assert_allclose(got[live], ref[live][:, 0], atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("hq,hkv,window,sink,softcap", CASES)
def test_prefill_plain_vs_jax(hq, hkv, window, sink, softcap):
    rng = np.random.default_rng(hq * 10 + hkv + 1)
    c = 16
    qstart = np.array([0, 16, 0, 8], np.int32)
    lens = np.array([11, 30, 0, 24], np.int32)
    table, bpos = _tables([11, 30, 0, 24], recycled=1)
    pool = _pool(2, hkv)
    q = rng.standard_normal((4, c, hq, D)).astype(np.float32)
    scale = D ** -0.5
    kw = dict(window=window, sink=sink, softcap=softcap)
    got = tpa.paged_prefill_attention(
        _t(q), *map(_t, pool), _t(table), _t(qstart), _t(lens), scale,
        block_pos=_t(bpos), **kw).numpy()
    assert np.all(got[2] == 0.0)                 # inactive lane
    qpos = qstart[:, None] + np.arange(c)[None]
    valid = qpos < lens[:, None]                 # rows past the prompt: don't care
    want = np.asarray(j_prefill(
        jnp.asarray(q), *map(jnp.asarray, pool), jnp.asarray(table),
        jnp.asarray(qstart), jnp.asarray(lens), scale,
        block_pos=jnp.asarray(bpos), interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-2, rtol=0)
    ref, _ = _gather_ref(q, pool, table, bpos, qpos, lens, scale, window,
                         sink, softcap)
    np.testing.assert_allclose(got[valid], ref[valid], atol=1e-5, rtol=1e-5)


def _bf16_pool(seed, hkv):
    """bf16 K/V pages: (JAX arrays, torch tensors) of the same values,
    small enough that the JAX kernels' bf16 output rounds within 2e-2."""
    rng = np.random.default_rng(seed)
    pages = [jnp.asarray(rng.standard_normal((NP_, hkv, BS, D)) * 0.5,
                         jnp.bfloat16) for _ in range(2)]
    return pages, [torch.from_numpy(np.asarray(p, np.float32)).bfloat16()
                   for p in pages]


@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [CASES[1], CASES[2], CASES[3]])
def test_bf16_pages_plain_vs_jax(hq, hkv, window, sink, softcap):
    """K7 and K8 on bf16 pools: the plain versions against the JAX kernels
    in their quantized=False mode (interpret)."""
    rng = np.random.default_rng(hq + hkv + 7)
    (jk, jv), (tk, tv) = _bf16_pool(3, hkv)
    scale = D ** -0.5
    kw = dict(window=window, sink=sink, softcap=softcap)
    lens = np.array([27, 1, 9, 32], np.int32)
    table, bpos = _tables([27, 0, 9, 32], recycled=3)
    q = rng.standard_normal((4, hq, D)).astype(np.float32)
    got = tpa.paged_decode_attention(_t(q), tk, tv, None, None, _t(table),
                                     _t(lens), scale, block_pos=_t(bpos),
                                     **kw).numpy()
    assert np.all(got[1] == 0.0)
    want = np.asarray(j_decode(jnp.asarray(q), jk, jv, None, None,
                               jnp.asarray(table), jnp.asarray(lens), scale,
                               block_pos=jnp.asarray(bpos), interpret=True,
                               **kw), np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)

    c = 16
    qstart = np.array([0, 16, 0, 8], np.int32)
    lens = np.array([11, 30, 0, 24], np.int32)
    table, bpos = _tables([11, 30, 0, 24], recycled=1)
    q = rng.standard_normal((4, c, hq, D)).astype(np.float32)
    got = tpa.paged_prefill_attention(_t(q), tk, tv, None, None, _t(table),
                                      _t(qstart), _t(lens), scale,
                                      block_pos=_t(bpos), **kw).numpy()
    valid = (qstart[:, None] + np.arange(c)[None]) < lens[:, None]
    want = np.asarray(j_prefill(jnp.asarray(q), jk, jv, None, None,
                                jnp.asarray(table), jnp.asarray(qstart),
                                jnp.asarray(lens), scale,
                                block_pos=jnp.asarray(bpos), interpret=True,
                                **kw), np.float32)
    np.testing.assert_allclose(got[valid], want[valid], atol=2e-2, rtol=0)


def test_cuda_kernel_geometry_checked():
    tpa.check_kernel_geometry(128, 128)
    with pytest.raises(ValueError, match="block_size"):
        tpa.check_kernel_geometry(8, 128)
    with pytest.raises(ValueError, match="head_dim"):
        tpa.check_kernel_geometry(128, 80)


# K7's launch plan and shared memory (ops/paged_attention.py decode_plan,
# decode_split_smem), pure Python: the kernel runs only on the card
SMS = 132


@pytest.mark.parametrize("b,hkv,g", [(8, 32, 1), (8, 40, 1), (8, 8, 4),
                                     (8, 8, 5), (1, 32, 1), (16, 32, 1),
                                     (64, 8, 4), (256, 40, 1)])
@pytest.mark.parametrize("mb", [1, 2, 5, 6, 7, 32, 64])
def test_decode_plan_covers_the_table(b, hkv, g, mb):
    """Every table entry of a lane in exactly one split, none empty; the
    grid (Hkv, B, splits) gives every SM a block unless each entry is its
    own split, and stays within SPLIT_BLOCKS_PER_SM blocks an SM where it
    splits at all; the partials hold (acc, m, l) per row and split."""
    p = tpa.decode_plan(b, hkv, g, 128, mb, SMS)
    covered = []
    for s in range(p.splits):
        lo, hi = s * p.pages_per_split, min((s + 1) * p.pages_per_split, mb)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(mb))
    assert p.grid == (hkv, b, p.splits)
    blocks = hkv * b * p.splits
    assert blocks >= SMS or p.splits == mb
    assert p.splits == 1 or hkv * b * (p.splits - 1) \
        < tpa.SPLIT_BLOCKS_PER_SM * SMS
    assert (p.scratch is None) == (p.splits == 1)
    if p.scratch:
        assert p.scratch == b * hkv * p.splits * g * (128 + 2)


def test_decode_plan_fills_the_card_at_the_main_shapes():
    """The smoke's decode shapes (8 lanes, a 6-entry table): Llama-2-7B
    (32 KV heads) and 13B (40) split each lane in 2, GQA (8 KV heads)
    takes one entry a split, 1 lane x 32 entries 11 splits of 3; the plan
    reads shapes only, never the lane lengths, so the launch needs no host
    readback."""
    import inspect
    assert "lens" not in inspect.signature(tpa.decode_plan).parameters
    assert tpa.decode_plan(8, 32, 1, 128, 6, SMS).splits == 2
    assert tpa.decode_plan(8, 40, 1, 128, 6, SMS).splits == 2
    assert tpa.decode_plan(8, 8, 4, 128, 6, SMS).splits == 6
    assert tpa.decode_plan(1, 32, 1, 128, 32, SMS)[:2] == (11, 3)


@pytest.mark.parametrize("page_bytes,quant", [(1, True), (2, False),
                                              (4, False)])
def test_decode_split_smem_fits(page_bytes, quant):
    """K7's block fits the 227 KB of shared memory for every page geometry
    the kernels take (BS 16-256, head_dim 32-256) up to 16 query heads a
    KV head; a ring stage's K and V stay within SPLIT_STAGE_KV."""
    for g in (1, 4, 8, 16):
        for d in range(32, 257, 32):
            for bs in range(16, 257, 16):
                need = tpa.decode_split_smem(g, d, bs, page_bytes, quant)
                assert need <= 232448
    # Llama-2-7B int8 pages: a whole 128-token page a stage
    assert tpa.decode_split_smem(1, 128, 128, 1, True) == \
        2 * (2 * 128 * 128 + 8 * 128) + 4 * (8 * 20 + 128 + 8 * 128 + 3)


# K9 / K10's launch plan and shared memory (ops/paged_attention.py
# rows_plan, rows_smem), pure Python: the kernels run only on the card
@pytest.mark.parametrize("b,hkv,rows", [(8, 32, 1), (8, 32, 5), (8, 8, 20),
                                        (8, 40, 5), (1, 32, 1), (4, 4, 64),
                                        (1, 1, 256), (64, 8, 40),
                                        (2, 1, 700)])
@pytest.mark.parametrize("mb", [1, 2, 6, 7, 32])
def test_rows_plan_covers_the_table(b, hkv, rows, mb):
    """Every table entry of a lane in exactly one split, none empty; the
    rows in groups of at most 16 a warp (4 warps at one m-tile, 8 above),
    every row in one group; the grid (Hkv, B, groups x splits) comes
    within a factor 2 of ROWS_BLOCKS_PER_SM blocks an SM (whole entries a
    split: rounding may halve the splits) unless each entry is its own
    split, and stays within it where it splits at all; partials (acc, m,
    l) per row and split, a ticket per (lane, KV head, group)."""
    p = tpa.rows_plan(b, hkv, rows, 128, mb, SMS)
    assert p.warps == (tpa.ROWS_WARPS if rows <= 16 else 8)
    covered = []
    for s in range(p.splits):
        lo, hi = s * p.pages_per_split, min((s + 1) * p.pages_per_split, mb)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(mb))
    group_rows = [min(16 * p.warps, rows - g * 16 * p.warps)
                  for g in range(p.groups)]
    assert all(r > 0 for r in group_rows) and sum(group_rows) == rows
    assert p.grid == (hkv, b, p.groups * p.splits)
    lanes = hkv * b * p.groups
    per_sm = tpa.ROWS_BLOCKS_PER_SM
    assert 2 * p.splits > min(mb, -(-per_sm * SMS // lanes))
    assert p.splits == 1 or lanes * (p.splits - 1) < per_sm * SMS
    assert p.tickets == lanes
    assert (p.scratch is None) == (p.splits == 1)
    if p.scratch:
        assert p.scratch == b * hkv * p.splits * rows * (128 + 2)


def test_rows_plan_at_the_main_shapes():
    """The smoke's verify and decode shapes (8 lanes, a 6-entry table):
    Llama-2-7B MHA at S = 5 and S = 1 one block a (lane, KV head), GQA (8
    KV heads, 20 rows: 8 warps) 3 splits of 2 entries, 1 lane x 32
    entries 5 splits of 7; the plan reads shapes only, never the lengths,
    so no launch reads back."""
    import inspect
    assert "lens" not in inspect.signature(tpa.rows_plan).parameters
    assert tpa.rows_plan(8, 32, 5, 128, 6, SMS)[:4] == (4, 1, 1, 6)
    assert tpa.rows_plan(8, 32, 1, 128, 6, SMS)[:4] == (4, 1, 1, 6)
    assert tpa.rows_plan(8, 8, 20, 128, 6, SMS)[:4] == (8, 1, 3, 2)
    assert tpa.rows_plan(1, 32, 1, 128, 32, SMS)[:4] == (4, 1, 5, 7)


def _old_verify_smem(rows, d, bs):
    """The shared memory the first K9 / K10 kernel asked for (every row's
    q, probabilities and sums in f32), which bounded what the wrappers
    accepted before."""
    return (2 * rows * d + rows * bs + 3 * rows) * 4


@pytest.mark.parametrize("page_bytes,quant,mma", [(1, True, True),
                                                   (2, False, True),
                                                   (1, True, False),
                                                   (2, False, False),
                                                   (4, False, False)])
def test_rows_smem_fits_every_shape_accepted_before(page_bytes, quant, mma):
    """K9 / K10's block fits the 227 KB of shared memory for every page
    geometry (BS 16-256, head_dim 32-256) and every row count the first
    kernel accepted (S = 8 x G = 8 at D = 256 among them), on every route
    (mma for bf16 q on int8 / bf16 pages, f32 otherwise); above 128 rows
    (8 warps of 16) the block's memory no longer grows (more row groups
    instead)."""
    for d in range(32, 257, 32):
        for bs in range(16, 257, 16):
            for rows in range(1, 129):
                assert tpa.rows_smem(rows, d, bs, page_bytes, quant,
                                     mma) <= 232448, (rows, d, bs)
            top = max(r for r in range(1, 1024)
                      if _old_verify_smem(r, d, bs) <= 232448)
            assert tpa.rows_smem(top, d, bs, page_bytes, quant, mma) == \
                tpa.rows_smem(128, d, bs, page_bytes, quant, mma)
    # the smoke's main shape: int8 pages, 128-token pages, one 32 KB stage
    # of a whole page, and q's fragments of one m-tile
    assert tpa.rows_smem(5, 128, 128, 1, True, True) == \
        2 * (2 * 128 * 128 + 8 * 128) + 1 * 8 * 32 * 16
    assert tpa.rows_smem(64, 256, 256, 1, True, True) <= 232448
