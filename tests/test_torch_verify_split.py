"""Port parity for the decode kernel's other three modes, their plain
versions on the CPU against the JAX package (Pallas kernels in interpret
mode; inputs from numpy with a seed):

- K9 ``paged_verify_attention`` (S query rows per lane from qstart): int8
  and bf16 pages, MHA and GQA, ragged qstart, window + sink, softcap, an
  inactive lane; 2e-2, as the JAX kernel rounds q and p to bf16. At S = 1
  it equals the port's ``paged_decode_attention``.
- K10 ``paged_decode_attention(stats=True)``: out within 2e-2, m and l
  within 1e-3 relative. q is bf16-exact and the scale a power of two, so
  the JAX kernel's logits are exact f32 sums as the port's are; rows that
  see no key are m -1e30, l 0, out 0 in both. ``ref.attention_stats`` and
  ``ref.merge_attention_stats`` against the JAX ops/ref.py in f32, 1e-5.
- K11 ``paged_decode_attention_split`` at splits 2, 3, 4 (3 pads the
  table), int8 and bf16 pages, and windowed: against the JAX split within
  2e-2 (tests/test_kv_split.py), and against the port's single scan in f32
  within 1e-5. Its kernel's split plan (``split_decode_plan``), pure
  Python: the ranges each split covers, as the kernel computes them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import ref as jref
from mixq_tensorrt_llm_tpu.ops.paged_attention import (
    paged_decode_attention as j_decode,
    paged_decode_attention_split as j_split,
    paged_verify_attention as j_verify)
from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as tpa
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref

NP_, BS, D, MB = 20, 8, 32, 4
PAD = 1 << 30


def _pool(seed, hkv, pages):
    """(numpy K, V, K scale, V scale): int8 pages with scales, or bf16
    values (as f32 numpy) without."""
    rng = np.random.default_rng(seed)
    shape = (NP_, hkv, BS, D)
    if pages == "int8":
        return (rng.integers(-127, 128, shape).astype(np.int8),
                rng.integers(-127, 128, shape).astype(np.int8),
                rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32),
                rng.uniform(0.002, 0.03, shape[:-1]).astype(np.float32))
    return (_bf16(rng.standard_normal(shape) * 0.5),
            _bf16(rng.standard_normal(shape) * 0.5), None, None)


def _bf16(x):
    """x rounded to bf16, as f32 numpy."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _args(pool, pages, lib):
    """The pool as the JAX ("jax") or port ("torch") functions take it."""
    if lib == "jax":
        dt = jnp.bfloat16 if pages == "bf16" else None
        return [None if a is None else jnp.asarray(a, dt if i < 2 else None)
                for i, a in enumerate(pool)]
    return [None if a is None else
            (torch.from_numpy(a).bfloat16() if pages == "bf16" and i < 2
             else torch.from_numpy(a)) for i, a in enumerate(pool)]


def _tables(lens):
    """Distinct pages per lane, identity bases, PAD_POS past each lane's
    pages; a lane of len 0 is inactive (table 0, all PAD_POS)."""
    b = len(lens)
    table = np.zeros((b, MB), np.int32)
    bpos = np.full((b, MB), PAD, np.int32)
    nxt = 1
    for i, ln in enumerate(lens):
        n = -(-ln // BS)
        table[i, :n] = np.arange(nxt, nxt + n)
        nxt += n
        if n:
            table[i, n:] = table[i, n - 1]
            bpos[i, :n] = np.arange(n) * BS
    return table, bpos


def _t(a):
    return torch.from_numpy(np.array(a))


CASES = [   # (hq, hkv, window, sink, softcap)
    (4, 4, 0, 0, 0.0),
    (8, 2, 0, 0, 0.0),          # GQA
    (8, 2, 12, 8, 0.0),         # sliding window + sink
    (4, 2, 0, 0, 15.0),         # softcap
]


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap", CASES)
def test_verify_plain_vs_jax(pages, hq, hkv, window, sink, softcap):
    """K9 at S = 5: lane 0 ends at its last key, lane 2's rows lie well
    before its length (per-row causal positions), lane 1 is inactive."""
    rng = np.random.default_rng(hq * 10 + hkv + len(pages))
    s = 5
    lens = np.array([27, 0, 21, 32], np.int32)
    qstart = np.array([22, 0, 3, 26], np.int32)
    table, bpos = _tables(lens)
    pool = _pool(1, hkv, pages)
    q = rng.standard_normal((4, s, hq, D)).astype(np.float32)
    scale = D ** -0.5
    kw = dict(window=window, sink=sink, softcap=softcap)
    got = tpa.paged_verify_attention(
        _t(q), *_args(pool, pages, "torch"), _t(table), _t(lens),
        _t(qstart), scale, block_pos=_t(bpos), **kw).numpy()
    assert np.all(got[1] == 0.0)                 # inactive lane
    want = np.asarray(j_verify(
        jnp.asarray(q), *_args(pool, pages, "jax"), jnp.asarray(table),
        jnp.asarray(lens), jnp.asarray(qstart), scale,
        block_pos=jnp.asarray(bpos), interpret=True, **kw), np.float32)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)


def test_verify_s1_equals_decode():
    """K9 at S = 1 from qstart = lens - 1 is K7's function."""
    rng = np.random.default_rng(3)
    lens = np.array([27, 1, 9, 32], np.int32)
    table, bpos = _tables([27, 0, 9, 32])
    pool = _args(_pool(2, 2, "int8"), "int8", "torch")
    q = _t(rng.standard_normal((4, 8, D)).astype(np.float32))
    kw = dict(block_pos=_t(bpos), window=12, sink=8)
    dec = tpa.paged_decode_attention(q, *pool, _t(table), _t(lens),
                                     D ** -0.5, **kw)
    ver = tpa.paged_verify_attention(q[:, None], *pool, _t(table),
                                     _t(lens), _t(lens - 1), D ** -0.5,
                                     **kw)
    assert torch.equal(ver[:, 0], dec)


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.parametrize("hq,hkv,window,sink,softcap",
                         [CASES[1], CASES[2], CASES[3]])
def test_stats_plain_vs_jax(pages, hq, hkv, window, sink, softcap):
    """K10: out, m and l; lane 1 (table 0, PAD_POS, len 1) sees no key."""
    rng = np.random.default_rng(hq + hkv + len(pages))
    lens = np.array([27, 1, 9, 32], np.int32)
    table, bpos = _tables([27, 0, 9, 32])
    pool = _pool(4, hkv, pages)
    q = _bf16(rng.standard_normal((4, hq, D)))
    scale = 0.25                          # q * scale stays bf16-exact
    kw = dict(window=window, sink=sink, softcap=softcap)
    out, m, l = (x.numpy() for x in tpa.paged_decode_attention(
        _t(q), *_args(pool, pages, "torch"), _t(table), _t(lens), scale,
        block_pos=_t(bpos), stats=True, **kw))
    assert out.dtype == m.dtype == l.dtype == np.float32
    jo, jm, jl = (np.asarray(x, np.float32) for x in j_decode(
        jnp.asarray(q), *_args(pool, pages, "jax"), jnp.asarray(table),
        jnp.asarray(lens), scale, block_pos=jnp.asarray(bpos), stats=True,
        interpret=True, **kw))
    np.testing.assert_allclose(out, jo, atol=2e-2, rtol=0)
    assert np.all(out[1] == 0) and np.all(m[1] == -1e30) \
        and np.all(l[1] == 0)
    np.testing.assert_array_equal(jm[1], m[1])
    np.testing.assert_array_equal(jl[1], l[1])
    live = [0, 2, 3]
    assert np.abs(m[live] - jm[live]).max() <= 1e-3 * np.abs(jm[live]).max()
    np.testing.assert_allclose(l[live], jl[live], rtol=1e-3)


def test_attention_stats_and_merge_vs_jax():
    """ref.attention_stats on int8 K/V with scales, a mask that empties
    some rows, and softcap; then merge_attention_stats of three disjoint
    key ranges (one of them empty for some rows) against the single
    softmax and against JAX's merge, all f32."""
    rng = np.random.default_rng(5)
    b, sq, hq, hkv, skv = 2, 3, 4, 2, 24
    q = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    k = rng.integers(-127, 128, (b, skv, hkv, D)).astype(np.int8)
    v = rng.integers(-127, 128, (b, skv, hkv, D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (b, skv, hkv)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (b, skv, hkv)).astype(np.float32)
    mask = rng.random((b, 1, sq, skv)) < 0.6
    mask[1, :, 2] = False                            # a row with no key
    kw = dict(scale=D ** -0.5, softcap=20.0)
    whole = [x.numpy() for x in tref.attention_stats(
        *map(_t, (q, k, v, ks, vs)), mask=_t(mask), **kw)]
    jwhole = jref.attention_stats(*map(jnp.asarray, (q, k, v, ks, vs)),
                                  mask=jnp.asarray(mask), **kw)
    for got, want in zip(whole, jwhole):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    parts, jparts = [], []
    for lo, hi in ((0, 8), (8, 16), (16, 24)):
        part_mask = mask.copy()
        part_mask[..., :lo] = part_mask[..., hi:] = False
        if lo == 8:
            part_mask[0, :, 0] = False               # an empty part row
        args = (q, k, v, ks, vs)
        parts.append(tref.attention_stats(*map(_t, args),
                                          mask=_t(part_mask), **kw))
        jparts.append(jref.attention_stats(*map(jnp.asarray, args),
                                           mask=jnp.asarray(part_mask),
                                           **kw))
    merged = tref.merge_attention_stats(parts).numpy()
    np.testing.assert_allclose(
        merged, np.asarray(jref.merge_attention_stats(jparts)), rtol=1e-5,
        atol=1e-5)
    mask[0, :, 0, 8:16] = False                      # what the parts saw
    want = tref.attention_stats(*map(_t, (q, k, v, ks, vs)), mask=_t(mask),
                                **kw)[0].numpy()
    np.testing.assert_allclose(merged, want, rtol=1e-5, atol=1e-5)


def _split_setup(pages, seed=0):
    """As tests/test_kv_split.py: 3 lanes, Hq 4 / Hkv 2, 8 table entries
    of random pages, lengths 64 (every entry), 3 and 21."""
    rng = np.random.default_rng(seed)
    global_pool = _pool(seed + 7, 2, pages)
    table = np.stack([rng.permutation(NP_)[:8] for _ in range(3)]
                     ).astype(np.int32)
    lens = np.array([8 * BS, 3, 2 * BS + 5], np.int32)
    q = _bf16(rng.standard_normal((3, 4, D)))
    return q, global_pool, table, lens


@pytest.mark.parametrize("pages", ["int8", "bf16"])
@pytest.mark.parametrize("splits", [2, 3, 4])
def test_split_plain_vs_jax(pages, splits):
    q, pool, table, lens = _split_setup(pages)
    got = tpa.paged_decode_attention_split(
        _t(q).bfloat16(), *_args(pool, pages, "torch"), _t(table), _t(lens),
        0.125, kv_splits=splits)
    assert got.dtype == torch.bfloat16
    want = np.asarray(j_split(
        jnp.asarray(q, jnp.bfloat16), *_args(pool, pages, "jax"),
        jnp.asarray(table), jnp.asarray(lens), scale=0.125,
        kv_splits=splits, interpret=True), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)
    # in f32 the split and merge is the single scan's function
    args = (_t(q), *_args(pool, pages, "torch"), _t(table), _t(lens), 0.125)
    torch.testing.assert_close(
        tpa.paged_decode_attention_split(*args, kv_splits=splits),
        tpa.paged_decode_attention(*args), rtol=1e-5, atol=1e-5)


def test_split_windowed_vs_jax():
    q, pool, table, lens = _split_setup("bf16", seed=1)
    kw = dict(window=10, sink=2)
    got = tpa.paged_decode_attention_split(
        _t(q), *_args(pool, "bf16", "torch"), _t(table), _t(lens), 0.125,
        kv_splits=2, **kw)
    want = np.asarray(j_split(
        jnp.asarray(q), *_args(pool, "bf16", "jax"), jnp.asarray(table),
        jnp.asarray(lens), scale=0.125, kv_splits=2, interpret=True, **kw),
        np.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=0)
    torch.testing.assert_close(got, tpa.paged_decode_attention(
        _t(q), *_args(pool, "bf16", "torch"), _t(table), _t(lens), 0.125,
        **kw), rtol=1e-5, atol=1e-5)


# K11's kernel plan, pure Python (the kernel runs only on the card)
SMS = 132


def _kernel_ranges(p, mb):
    """[(range, first entry, end)] of each kernel split, as
    csrc/paged_attention.cu decode_split_kernel computes them."""
    out = []
    for z in range(p.splits):
        zr = z // p.splits_per_range
        r1 = min(mb, (zr + 1) * p.range_pages)
        j0 = min(r1, zr * p.range_pages
                 + (z % p.splits_per_range) * p.pages_per_split)
        out.append((zr, j0, min(r1, j0 + p.pages_per_split)))
    return out


@pytest.mark.parametrize("kv_splits", range(1, 9))
@pytest.mark.parametrize("mb", [1, 2, 5, 6, 7, 10, 11, 32])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("hkv,g", [(32, 1), (8, 4)])
def test_split_decode_plan_covers_the_ranges(kv_splits, mb, b, hkv, g):
    """Every real table entry in exactly one kernel split; no split
    straddles one of the kv_splits equal ranges of the table's width
    rounded up to a multiple of kv_splits (the JAX package's padding);
    the split count a multiple of kv_splits and at least K7's plan's."""
    p = tpa.split_decode_plan(b, hkv, g, D, mb, kv_splits, SMS)
    width = -(-mb // kv_splits)
    assert p.range_pages == width
    assert p.splits == kv_splits * p.splits_per_range
    assert p.splits >= tpa.decode_plan(b, hkv, g, D, mb, SMS).splits
    covered = []
    for zr, lo, hi in _kernel_ranges(p, mb):
        assert lo <= hi                          # empty past the table
        if lo < hi:
            assert zr * width <= lo and hi <= (zr + 1) * width
        covered.extend(range(lo, hi))
    assert covered == list(range(mb))
    assert p.scratch == (b * hkv * p.splits * g * (D + 2) if p.splits > 1
                         else None)


def test_split_decode_plan_at_the_smoke_shapes():
    """8 lanes of a 6-entry table at 32 KV heads, splits 4: ranges of 2
    entries, the last past the table (an empty split, as the JAX package's
    padded lane); 1 lane x 32 entries: 12 splits of at most 3 entries
    against K7's 11. Shapes only: no lengths, so no host readback."""
    import inspect
    assert "lens" not in inspect.signature(
        tpa.split_decode_plan).parameters
    p = tpa.split_decode_plan(8, 32, 1, 128, 6, 4, SMS)
    assert (p.splits, p.range_pages, p.pages_per_split) == (4, 2, 2)
    assert _kernel_ranges(p, 6)[-1][1:] == (6, 6)
    p = tpa.split_decode_plan(1, 32, 1, 128, 32, 4, SMS)
    assert (p.splits, p.pages_per_split) == (12, 3)
    with pytest.raises(ValueError):
        tpa.split_decode_plan(8, 32, 1, 128, 6, 0, SMS)
