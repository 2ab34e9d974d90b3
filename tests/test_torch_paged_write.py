"""Port parity: the plain versions of the paged KV write kernels K5
(paged_write_token) and K6 (paged_write_chunk), and of K5p / K6p (the same
writes into unquantized f32 or bf16 pools), the kv_cache write routing
and the block manager, against the JAX package. The JAX kernels run in
interpret mode. Pages and scales must be bit-exact everywhere but the
trash row 0."""

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


@pytest.mark.parametrize("s,start", [(1, 13), (5, 6), (16, 8), (11, 3)])
@pytest.mark.parametrize("windowed", [False, True])
def test_paged_write_routing_matches_jax(s, start, windowed):
    """S = 1 (K5), S <= 8 (chained K5), S % BS == 0 (K6), other (scatter)
    against the JAX scatter/update path, with block_pos tables and
    invalid tokens."""
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
