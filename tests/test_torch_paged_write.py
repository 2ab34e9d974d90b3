"""Port parity: the plain versions of the paged KV write kernels K5
(paged_write_token) and K6 (paged_write_chunk), and of K5p / K6p (the same
writes into unquantized f32 or bf16 pools), the kv_cache write routing
(with block_pos, recycled tables, PAD_POS tokens, kv_valid_len and a
strided V) and the block manager, against the JAX package; and the write
kernels' launch plan. The JAX kernels run in interpret mode. Pages and
scales must be bit-exact everywhere but the trash row 0."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops.paged_write import (
    paged_write_chunk as j_chunk, paged_write_token as j_token)
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu_torch.ops import paged_write as tpw
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv

NP_, H, BS, D = 9, 2, 8, 32


def _pools(seed):
    rng = np.random.default_rng(seed)
    return {
        "k": rng.integers(-127, 128, (NP_, H, BS, D)).astype(np.int8),
        "v": rng.integers(-127, 128, (NP_, H, BS, D)).astype(np.int8),
        "k_scale": rng.uniform(0.01, 0.1, (NP_, H, BS)).astype(np.float32),
        "v_scale": rng.uniform(0.01, 0.1, (NP_, H, BS)).astype(np.float32),
    }


def _new(seed, shape):
    rng = np.random.default_rng(seed)
    mag = rng.uniform(1e-3, 10.0, shape[:-1] + (1,))
    return (rng.standard_normal(shape) * mag).astype(np.float32)


def _jax(pools):
    return {k: jnp.asarray(v) for k, v in pools.items()}


def _torch(pools):
    return {k: torch.from_numpy(v.copy()) for k, v in pools.items()}


def _assert_equal_outside_trash(got, want):
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name])[1:],
                                      np.asarray(want[name])[1:],
                                      err_msg=name)


def test_token_write_bitexact():
    pools = _pools(0)
    pg = np.array([3, 0, 7, 5], np.int32)       # lane 1 masked -> trash
    off = np.array([0, 4, 7, 2], np.int32)
    nk, nv = _new(1, (4, H, D)), _new(2, (4, H, D))
    want = j_token(_jax(pools), jnp.asarray(pg), jnp.asarray(off),
                   jnp.asarray(nk), jnp.asarray(nv), interpret=True)
    got = tpw.paged_write_token(_torch(pools), torch.from_numpy(pg),
                                torch.from_numpy(off), torch.from_numpy(nk),
                                torch.from_numpy(nv))
    _assert_equal_outside_trash({k: v.numpy() for k, v in got.items()}, want)


def test_chunk_write_bitexact_and_drop_rule():
    pools = _pools(3)
    b, s = 4, 2 * BS
    blk = np.zeros((b, s), np.int32)
    off = np.tile(np.arange(s) % BS, (b, 1)).astype(np.int32)
    blk[0, :BS], blk[0, BS:] = 2, 4
    blk[0, BS + 5:] = 0                  # prompt ends inside slab 2
    blk[1] = 0                           # inactive lane
    blk[2, :BS], blk[2, BS:] = 6, 8
    off[2, BS:] = (off[2, BS:] + 1) % BS  # misaligned slab: dropped
    blk[3, :BS], blk[3, BS:] = 7, 3
    blk[3, 3] = 5                        # a token claiming another page
    nk, nv = _new(4, (b, s, H, D)), _new(5, (b, s, H, D))
    want = j_chunk(_jax(pools), jnp.asarray(blk), jnp.asarray(off),
                   jnp.asarray(nk), jnp.asarray(nv), interpret=True)
    got = tpw.paged_write_chunk(_torch(pools), torch.from_numpy(blk),
                                torch.from_numpy(off), torch.from_numpy(nk),
                                torch.from_numpy(nv))
    got = {k: v.numpy() for k, v in got.items()}
    _assert_equal_outside_trash(got, want)
    for name in pools:   # dropped slab (page 8) and page 5 untouched
        np.testing.assert_array_equal(got[name][8], pools[name][8])
        np.testing.assert_array_equal(got[name][5], pools[name][5])
    with pytest.raises(ValueError, match="multiple"):
        tpw.paged_write_chunk(_torch(pools), torch.from_numpy(blk[:, :5]),
                              torch.from_numpy(off[:, :5]),
                              torch.from_numpy(nk[:, :5]),
                              torch.from_numpy(nv[:, :5]))


@pytest.mark.parametrize("s,start", [(1, 13), (5, 6), (8, 5), (16, 8),
                                     (11, 3)])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_write_routing_matches_jax(s, start, windowed):
    """S = 1 and S <= 8 (K5's route, S = 8 its top), S % BS == 0 (K6),
    other (K5's route; JAX's scatter) against the JAX scatter/update path,
    with block_pos tables and invalid tokens."""
    pools = _pools(6)
    b, mb = 2, 4
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    bpos = np.array([[0, 8, 16, 24], [0, 8, 16, 24]], np.int32)
    if windowed:   # lane 1 recycled its second page to the tail
        bpos[1] = [0, 24, 8, 16]
    pos = start + np.arange(s, dtype=np.int32)[None].repeat(b, 0)
    lens = np.array([start + s, start + max(s - 2, 0)], np.int32)
    valid = pos < lens[:, None]
    nk, nv = _new(7, (b, s, H, D)), _new(8, (b, s, H, D))
    want = jkv.paged_write(_jax(pools), jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(nk), jnp.asarray(nv), True,
                           valid=jnp.asarray(valid),
                           block_pos=jnp.asarray(bpos), use_kernels=False)
    got = tkv.paged_write(_torch(pools), torch.from_numpy(table),
                          torch.from_numpy(pos), torch.from_numpy(nk),
                          torch.from_numpy(nv),
                          valid=torch.from_numpy(valid),
                          block_pos=torch.from_numpy(bpos))
    _assert_equal_outside_trash({k: v.numpy() for k, v in got.items()}, want)


def _qkv_views(seed, b, s, unaligned):
    """New K contiguous and new V a strided view of a packed qkv row (as
    the model's split gives it); ``unaligned`` shifts both views by one
    element."""
    rng = np.random.default_rng(seed)
    pad = 1 if unaligned else 0
    qkv = torch.from_numpy((rng.standard_normal((b, s, pad + 3 * H * D))
                            * rng.uniform(1e-3, 10.0, (b, s, 1))
                            ).astype(np.float32))
    nk = qkv[..., pad + H * D:pad + 2 * H * D].reshape(b, s, H, D)
    nv = qkv[..., pad + 2 * H * D:].reshape(b, s, H, D)
    assert not nv.is_contiguous()
    return nk.contiguous(), nv


@pytest.mark.parametrize("case", ["chunk_recycled", "chunk_pad_pos",
                                  "token_pad_pos", "token_strided_v",
                                  "chunk_strided_v_unaligned",
                                  "token_kv_valid_len",
                                  "chunk_kv_valid_len"])
def test_paged_write_layer_cases_match_jax(case):
    """kv_cache.paged_write as a layer calls it, against JAX's paged_write
    (use_kernels=False): a chunk on a recycled table (block_pos out of
    order, a page windowed out), invalid tokens at PAD_POS, V a strided
    view of a packed qkv row, and kv_valid_len (the port's argument; JAX
    gets the mask it stands for, as its models/common.py builds it)."""
    pools = _pools(20)
    chunk = case.startswith("chunk")
    b, mb = 2, 5
    s = 2 * BS if chunk else 5
    table = np.array([[1, 2, 3, 4, 4], [5, 6, 7, 8, 8]], np.int32)
    bpos = np.array([[0, 8, 16, 24, int(tkv.PAD_POS)],
                     [0, 8, 16, 24, int(tkv.PAD_POS)]], np.int32)
    start = np.array([8, 0] if chunk else [21, 10], np.int32)
    if case == "chunk_recycled":   # lane 1: sink, then 32 and 16 recycled;
        bpos[1, 1:4] = [40, 32, 16]  # its page for 8..15 left the window
    pos = start[:, None] + np.arange(s, dtype=np.int32)[None]
    lens = start + np.array([s - 3, s], np.int32)
    if case.endswith("pad_pos"):
        pos[0, -3:] = tkv.PAD_POS
    valid = pos < lens[:, None]
    nk, nv = _qkv_views(21, b, s, case.endswith("unaligned"))
    if "strided" not in case:
        nv = nv.contiguous()
    want = jkv.paged_write(_jax(pools), jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(nk.numpy()),
                           jnp.asarray(nv.contiguous().numpy()), True,
                           valid=jnp.asarray(valid),
                           block_pos=jnp.asarray(bpos), use_kernels=False)
    kw = (dict(kv_valid_len=torch.from_numpy(lens))
          if case.endswith("kv_valid_len")
          else dict(valid=torch.from_numpy(valid)))
    got = tkv.paged_write(_torch(pools), torch.from_numpy(table),
                          torch.from_numpy(pos), nk, nv,
                          block_pos=torch.from_numpy(bpos), **kw)
    got = {k: v.numpy() for k, v in got.items()}
    _assert_equal_outside_trash(got, want)
    assert any((got[n][1:] != pools[n][1:]).any() for n in pools)


SMS = 132                      # the H100's SMs


@pytest.mark.parametrize("fp", [False, True])
def test_write_plan_fills_the_card_on_the_smoke_chunk(fp):
    """K6's plan for the smoke's chunk (4 lanes x 256 tokens, 32 or 40
    heads x 128, 128-token pages): 16 lanes a row, 16-byte loads, at least
    one wave of resident blocks, several rows in flight a warp, at most
    two passes a block, and every row of a slab inside exactly one block's
    range."""
    h = 40 if fp else 32
    plan = tpw.write_plan(True, 4, 256, h, 128, 128, True, SMS)
    assert (plan.vec, plan.group) == (8, 16)
    assert plan.grid == 4 * 2 * plan.per_slab
    assert plan.grid >= SMS * tpw.CHUNK_BLOCKS_PER_SM
    assert 32 // plan.group * tpw.CHUNK_ROWS >= 4
    rows = 128 * 2 * h
    per = -(-rows // plan.per_slab)
    assert per <= 2 * tpw.CHUNK_THREADS // plan.group * tpw.CHUNK_ROWS
    assert (plan.per_slab - 1) * per < rows <= plan.per_slab * per


@pytest.mark.parametrize("b,s,h,bs,d,aligned,vec,group", [
    (8, 1, 32, 128, 128, True, 8, 16),     # 7B decode
    (8, 5, 40, 128, 128, True, 8, 16),     # the verify, 13B heads
    (2, 3, 4, 8, 32, True, 8, 4),          # a tiny model
    (2, 3, 4, 8, 36, True, 1, 8),          # head_dim not a multiple of 8
    (2, 3, 4, 8, 64, False, 1, 8),         # unaligned rows
    (1, 1, 1, 16, 256, True, 8, 32),       # the widest head
])
def test_write_plan_token_route(b, s, h, bs, d, aligned, vec, group):
    """K5's plan: the lanes of a row cover head_dim at 8 values a lane
    (16-byte loads only for aligned rows of D % 8 == 0), and the grid's
    lane groups cover every (token, head, K/V) row (the kernel walks the
    rows past 16 blocks an SM)."""
    plan = tpw.write_plan(False, b, s, h, bs, d, aligned, SMS)
    assert (plan.vec, plan.group, plan.per_slab) == (vec, group, 0)
    assert 8 * plan.group >= d and (plan.group == 1 or 8 * plan.group < 2 * d)
    groups = plan.grid * tpw.TOKEN_THREADS // plan.group
    assert groups >= b * s * 2 * h or plan.grid == 16 * SMS


@pytest.mark.parametrize("s,bs,chunk", [(1, 128, False), (8, 8, False),
                                        (5, 4, False), (16, 8, True),
                                        (256, 128, True), (11, 8, False),
                                        (200, 128, False)])
def test_chunk_route(s, bs, chunk):
    """K6's route takes S % BS == 0 above 8 tokens, as the JAX package
    routes its chunk kernel; every other S takes K5's."""
    assert tpw.chunk_route(s, bs) is chunk


def _fp_pools(seed, dtype):
    """Unquantized pools as f32 numpy arrays holding values of ``dtype``."""
    rng = np.random.default_rng(seed)
    return {n: np.asarray(jnp.asarray(rng.standard_normal((NP_, H, BS, D)),
                                      dtype), np.float32) for n in "kv"}


def _both(pools, dtype):
    """The same pools for JAX (of ``dtype``) and the port (torch dtype)."""
    tdt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    return ({k: jnp.asarray(v, dtype) for k, v in pools.items()},
            {k: torch.from_numpy(v.copy()).to(tdt) for k, v in pools.items()})


def _np32(pools):
    return {k: np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
            else v.float().numpy() for k, v in pools.items()}


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_fp_token_and_chunk_write_bitexact(dtype):
    """K5p / K6p plain versions against JAX's _write_kernel_plain /
    _chunk_kernel_plain: f32 values cast into f32 or bf16 pools, the chunk
    with its trash, inactive-lane and misaligned-slab rules."""
    pools = _fp_pools(10, dtype)
    pg = np.array([3, 0, 7, 5], np.int32)
    off = np.array([0, 4, 7, 2], np.int32)
    nk, nv = _new(11, (4, H, D)), _new(12, (4, H, D))
    jp, tp = _both(pools, dtype)
    want = j_token(jp, jnp.asarray(pg), jnp.asarray(off), jnp.asarray(nk),
                   jnp.asarray(nv), interpret=True)
    got = tpw.paged_write_token(tp, torch.from_numpy(pg),
                                torch.from_numpy(off), torch.from_numpy(nk),
                                torch.from_numpy(nv))
    assert got["k"].dtype == tp["v"].dtype and "k_scale" not in got
    _assert_equal_outside_trash(_np32(got), _np32(want))

    b, s = 3, 2 * BS
    blk = np.zeros((b, s), np.int32)
    off = np.tile(np.arange(s) % BS, (b, 1)).astype(np.int32)
    blk[0, :BS], blk[0, BS:] = 2, 4
    blk[0, BS + 3:] = 0                  # prompt ends inside slab 2
    blk[2, :BS], blk[2, BS:] = 6, 8
    off[2, BS:] = (off[2, BS:] + 1) % BS  # misaligned slab: dropped
    nk, nv = _new(13, (b, s, H, D)), _new(14, (b, s, H, D))
    jp, tp = _both(pools, dtype)
    want = j_chunk(jp, jnp.asarray(blk), jnp.asarray(off), jnp.asarray(nk),
                   jnp.asarray(nv), interpret=True)
    got = _np32(tpw.paged_write_chunk(tp, torch.from_numpy(blk),
                                      torch.from_numpy(off),
                                      torch.from_numpy(nk),
                                      torch.from_numpy(nv)))
    _assert_equal_outside_trash(got, _np32(want))
    np.testing.assert_array_equal(got["k"][8], _np32(pools)["k"][8])


@pytest.mark.parametrize("s,start", [(1, 13), (16, 8), (11, 3)])
def test_fp_paged_write_routing_matches_jax(s, start):
    """Unquantized pools through kv_cache.paged_write: K5p, K6p and the
    scatter, against JAX's unquantized write path."""
    pools = _fp_pools(15, jnp.float32)
    table = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    bpos = np.array([[0, 8, 16, 24], [0, 24, 8, 16]], np.int32)
    pos = start + np.arange(s, dtype=np.int32)[None].repeat(2, 0)
    lens = np.array([start + s, start + max(s - 2, 0)], np.int32)
    valid = pos < lens[:, None]
    nk, nv = _new(16, (2, s, H, D)), _new(17, (2, s, H, D))
    want = jkv.paged_write(_jax(pools), jnp.asarray(table), jnp.asarray(pos),
                           jnp.asarray(nk), jnp.asarray(nv), False,
                           valid=jnp.asarray(valid),
                           block_pos=jnp.asarray(bpos), use_kernels=False)
    got = tkv.paged_write(_torch(pools), torch.from_numpy(table),
                          torch.from_numpy(pos), torch.from_numpy(nk),
                          torch.from_numpy(nv),
                          valid=torch.from_numpy(valid),
                          block_pos=torch.from_numpy(bpos))
    _assert_equal_outside_trash({k: v.numpy() for k, v in got.items()}, want)


def test_paged_gather_matches_jax():
    pools = _pools(9)
    table = np.array([[2, 4, 4], [7, 1, 3]], np.int32)
    jk, jv = jkv.paged_gather(_jax(pools), jnp.asarray(table), jnp.float32)
    tk, tv = tkv.paged_gather(_torch(pools), torch.from_numpy(table),
                              torch.float32)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window", [None, 2])
def test_block_manager_matches_jax(window):
    """The same admission / growth / rewind / free sequence through both
    managers gives the same tables, positions and free counts."""
    kw = dict(sink_blocks=1 if window else 0, window_blocks=window)
    jbm, tbm = jkv.BlockManager(12, 4, **kw), tkv.BlockManager(12, 4, **kw)
    ops = [("add", 0, 6), ("add", 1, 3), ("extend", 0, 5), ("extend", 1, 9),
           ("free", 0, 0), ("add", 2, 2), ("extend", 2, 7)]
    if window is None:
        ops += [("rewind", 1, 5), ("extend", 1, 2)]
    for op, sid, n in ops:
        for bm in (jbm, tbm):
            {"add": lambda: bm.add_sequence(sid, n),
             "extend": lambda: bm.extend(sid, n),
             "rewind": lambda: bm.rewind(sid, n),
             "free": lambda: bm.free_sequence(sid)}[op]()
        live = sorted(tbm.seqs)
        assert sorted(jbm.seqs) == live
        np.testing.assert_array_equal(tbm.block_table(live, 6),
                                      jbm.block_table(live, 6))
        np.testing.assert_array_equal(tbm.block_pos(live, 6),
                                      jbm.block_pos(live, 6))
        assert tbm.num_free == jbm.num_free
        assert 0 not in [b for s in tbm.seqs.values() for b in s.blocks]
    with pytest.raises(RuntimeError, match="exhausted"):
        tbm.add_sequence(9, 100)
