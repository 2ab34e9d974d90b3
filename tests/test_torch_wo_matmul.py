"""K4 (wo_matmul, weight-only W8A16) and K13 (wo_matmul_packed_grouped):
the port's plain versions (their CPU route) against the JAX package's
Pallas kernels in interpret mode, at the M of every regime the CUDA kernels
split into (decode M <= 16, the 40-row speculative verify, the mma
kernel's edge at 64 rows a block and the wgmma GEMM above
K4_MMA_MAX_ROWS). Same numpy inputs to both; tolerance 2e-2, the JAX
package's own. Then the kernels' launch plans, pure Python: the mma
kernel's K splits (K4, K12, K13) and K4's regime."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.quant import core as jcore
from mixq_tensorrt_llm_tpu.ops import wo_matmul as jwo
from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as two

SMEM_MAX = 227 * 1024


@pytest.mark.parametrize("m", [1, 4, 8, 16, 17, 40, 64, 100, 128, 129, 256])
def test_wo_matmul_matches_pallas(m):
    k, n = 256, 256
    rng = np.random.default_rng(30 + m)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scol = (rng.random(n) * 2e-3 + 1e-4).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    got = two.wo_matmul(torch.from_numpy(x), torch.from_numpy(qw),
                        torch.from_numpy(scol), out_dtype=torch.float32)
    want = jwo.wo_matmul(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scol),
                         out_dtype=jnp.float32, interpret=True, block_m=64,
                         block_n=128, block_k=128)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("m", [8, 40])
@pytest.mark.parametrize("gs", [64, 128])
def test_wo_matmul_packed_grouped_matches_pallas(m, gs):
    """K13's plain version at decode and verify M, at the group sizes its
    kernel takes (multiples of 64), with K/2 = 3 groups of 128 or 6 of
    64: the high nibbles' groups start at K/(2 gs), an odd offset at 128."""
    k, n = 768, 256
    rng = np.random.default_rng(40 + m + gs)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jq, js = jcore.quantize_weight_int4_grouped(jnp.asarray(w), gs)
    qp = jcore.pack_int4(jq)
    x = rng.standard_normal((m, k)).astype(np.float32)
    got = two.wo_matmul_packed_grouped(
        torch.from_numpy(x), torch.from_numpy(np.array(qp)),
        torch.from_numpy(np.array(js)), gs, out_dtype=torch.float32)
    want = jwo.wo_matmul_packed_grouped(
        jnp.asarray(x, jnp.bfloat16), qp, js, gs, out_dtype=jnp.float32,
        interpret=True, block_k=gs)
    assert got.shape == (m, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


HID = {"7b": (4096, 11008), "13b": (5120, 13824)}


def _int4_shapes(model):
    """(K, N) of the four linears of a Llama-2 decode step."""
    h, i = HID[model]
    return [(h, 3 * h), (h, h), (h, 2 * i), (i, h)]


def _check_splits(p, rows):
    """The splits' chunk ranges cover the weight's `rows` exactly once,
    none empty and none past the end; returns their start rows."""
    covered, starts = [], []
    for s in range(p.splits):
        lo = s * p.chunks_per_split * two.MMA_CHUNK
        hi = min((s + 1) * p.chunks_per_split * two.MMA_CHUNK, rows)
        assert lo < hi
        covered.extend(range(lo, hi))
        starts.append(lo)
    assert covered == list(range(rows))
    return starts


def _check_fill(p, units):
    """The grid fills at least three quarters of the blocks 132 SMs hold,
    in at most two waves, unless K has too few units to split further or
    the tiles alone are more than a wave."""
    slots = two.blocks_per_sm(p.mt) * 132
    blocks = p.grid[0] * p.grid[1] * p.grid[2]
    base = blocks // p.splits
    assert blocks >= 0.75 * slots or p.splits == units or base >= slots
    assert blocks <= 2 * slots or p.splits == 1


@pytest.mark.parametrize("model", ["7b", "13b"])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 64])
def test_packed_plan_fills_the_card_and_covers_k(model, m):
    """K12's split plan at every 7B and 13B int4 decode shape, 132 SMs:
    at least 132 blocks, and the splits' chunk ranges cover the K/2 packed
    rows exactly once (none empty, none past the end), with the staged x
    and the ring within the block's shared memory."""
    for k, n in _int4_shapes(model):
        p = two.packed_plan(m, k, n, 132)
        assert p.grid == (n // 128, p.splits, -(-m // 16))
        assert p.grid[0] * p.grid[1] * p.grid[2] >= 132
        _check_fill(p, p.chunks)
        _check_splits(p, k // 2)
        assert p.smem <= SMEM_MAX
        assert p.mt == (8 if m <= 8 else 16)
        assert (p.scratch is None) == (p.splits == 1)
        if p.scratch:
            assert p.scratch == (p.splits, p.grid[2], p.mt, n)


@pytest.mark.parametrize("kp", [1, 63, 64, 65, 620, 6912])
def test_packed_plan_odd_k(kp):
    """K/2 not a multiple of the 64-row chunk, or below one chunk: every
    packed row in exactly one split."""
    p = two.packed_plan(8, 2 * kp, 256, 132)
    assert p.chunks == -(-kp // two.MMA_CHUNK)
    assert (p.splits - 1) * p.chunks_per_split < p.chunks \
        <= p.splits * p.chunks_per_split


@pytest.mark.parametrize("model", ["7b", "13b"])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 64, 128, 129, 1024])
def test_wo_plan_regime_and_splits(model, m):
    """K4's plan at every 7B and 13B linear (the int4 prefill runs K4 on
    the unpacked weight): up to K4_MMA_MAX_ROWS rows the mma kernel with
    the smallest block that holds M (64-row slabs above), a grid that
    fills the card in at most two waves, K covered exactly once, shared
    memory within 227 KB; above, the wgmma GEMM's tiles cover M and N."""
    for k, n in _int4_shapes(model):
        p = two.wo_plan(m, k, n, 132)
        assert p.smem <= SMEM_MAX
        if m > two.K4_MMA_MAX_ROWS:
            assert p.mt == 0 and p.splits == 1 and p.scratch is None
            assert p.grid == (-(-m // two.GEMM_ROWS), -(-n // two.GEMM_COLS),
                              1)
            continue
        assert p.mt == min(t for t in two.K4_MTS if t >= min(m, 64))
        assert p.slabs == -(-m // p.mt) and p.tiles == n // 128
        assert p.grid == (p.tiles, p.splits, p.slabs)
        _check_fill(p, p.chunks)
        _check_splits(p, k)
        assert (p.scratch is None) == (p.splits == 1)
        if p.scratch:
            assert p.scratch == (p.splits, p.slabs, p.mt, n)


def test_wo_plan_threshold_is_the_callers():
    """The regime follows the threshold passed in (chip_smoke.py times both
    regimes at one M by passing it): the mma kernel at or below it."""
    assert two.wo_plan(40, 11008, 4096, 132, 39).mt == 0
    assert two.wo_plan(40, 11008, 4096, 132, 40).mt == 40
    assert two.wo_plan(1024, 11008, 4096, 132, 1024).mt == 64


@pytest.mark.parametrize("gs", [64, 128, 256])
@pytest.mark.parametrize("groups", [1, 3, 27, 54, 107])
@pytest.mark.parametrize("m", [1, 8, 40])
def test_grouped_plan_splits_on_group_boundaries(gs, groups, m):
    """K13's plan: K/2 = groups x gs packed rows (odd group counts
    included), every split starts on a group boundary and holds whole
    groups, the splits cover K/2 exactly once, and the grid fills the card
    where there are enough groups to split."""
    kp, n = groups * gs, 5120
    p = two.grouped_plan(m, 2 * kp, n, gs, 132)
    starts = _check_splits(p, kp)
    assert all(s % gs == 0 for s in starts)
    assert (p.chunks_per_split * two.MMA_CHUNK) % gs == 0
    assert p.smem <= SMEM_MAX
    _check_fill(p, groups)
