"""K2 (mixed_matmul), K3 (mixed_matmul_hybrid) and mix_linear: the port's
plain versions (its CPU route) against the JAX package's Pallas kernels in
interpret mode, same numpy inputs to both.

Tolerance 2e-2 (rtol and atol), the JAX package's own for these kernels
(tests/test_pallas_kernels.py); with unit scales and no outliers the
result is the int32 product itself and must be exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import mixed_matmul as jmm
from mixq_tensorrt_llm_tpu_torch.ops import mixed_matmul as tmm


def _operands(seed, m, k, n, ko):
    rng = np.random.default_rng(seed)
    return dict(
        q_x=rng.integers(-127, 128, (m, k)).astype(np.int8),
        scale_row=(rng.random(m) * 0.02 + 1e-3).astype(np.float32),
        x_outliers=(rng.standard_normal((m, ko)) * 4).astype(np.float32),
        qweight=rng.integers(-127, 128, (k, n)).astype(np.int8),
        scale_col=(rng.random(n) * 1e-3 + 1e-4).astype(np.float32),
        fp_weight=(rng.standard_normal((ko, n)) * 0.05).astype(np.float32))


def _both(ops):
    """(torch args, jax args); outlier activations and weights in bf16."""
    bf = ("x_outliers", "fp_weight")
    t = {k: torch.from_numpy(v).to(torch.bfloat16) if k in bf
         else torch.from_numpy(v) for k, v in ops.items()}
    j = {k: jnp.asarray(v, jnp.bfloat16) if k in bf else jnp.asarray(v)
         for k, v in ops.items()}
    return t, j


@pytest.mark.parametrize("m,k,n,ko,silu", [
    (64, 256, 256, 128, False),
    (100, 256, 128, 128, False),     # M not a multiple of the tile
    (256, 512, 384, 128, False),     # several K and N steps
    (64, 256, 256, 128, True),
])
def test_mixed_matmul_matches_pallas(m, k, n, ko, silu):
    t, j = _both(_operands(10, m, k, n, ko))
    got = tmm.mixed_matmul(**t, silu=silu, out_dtype=torch.float32)
    want = jmm.mixed_matmul(**j, silu=silu, out_dtype=jnp.float32,
                            interpret=True, block_m=64, block_n=128,
                            block_k=256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_int_accumulator_exact():
    m, k, n = 32, 256, 128
    rng = np.random.default_rng(0)
    q_x = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    args = dict(q_x=q_x, scale_row=np.ones(m, np.float32),
                x_outliers=np.zeros((m, 128), np.float32), qweight=qw,
                scale_col=np.ones(n, np.float32),
                fp_weight=np.zeros((128, n), np.float32))
    t, j = _both(args)
    got = tmm.mixed_matmul(**t, out_dtype=torch.float32).numpy()
    want = np.asarray(jmm.mixed_matmul(**j, out_dtype=jnp.float32,
                                       interpret=True, block_m=32,
                                       block_n=128, block_k=128))
    exact = (q_x.astype(np.int64) @ qw.astype(np.int64)).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    np.testing.assert_array_equal(want, exact)


@pytest.mark.parametrize("silu", [False, True])
def test_hybrid_matches_pallas(silu):
    t, j = _both(_operands(60, 100, 256, 384, 128))
    got = tmm.mixed_matmul_hybrid(**t, silu=silu, out_dtype=torch.float32)
    want = jmm.mixed_matmul_hybrid(**j, silu=silu, out_dtype=jnp.float32,
                                   interpret=True, block_m=64, block_n=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_mix_linear_matches_pallas():
    rng = np.random.default_rng(50)
    m, k, n, ko = 64, 256, 256, 128
    x = (rng.standard_normal((m, k)) * 2).astype(np.float32)
    ind = np.sort(rng.choice(k, ko, replace=False)).astype(np.int32)
    qw = rng.integers(-127, 128, (k, n)).astype(np.int8)
    scol = (rng.random(n) * 1e-3 + 1e-4).astype(np.float32)
    fpw = (rng.standard_normal((ko, n)) * 0.05).astype(np.float32)
    got = tmm.mix_linear(torch.from_numpy(x), torch.from_numpy(qw),
                         torch.from_numpy(scol), torch.from_numpy(ind),
                         torch.from_numpy(fpw).bfloat16(),
                         out_dtype=torch.float32)
    want = jmm.mix_linear(jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scol),
                          jnp.asarray(ind), jnp.asarray(fpw, jnp.bfloat16),
                          out_dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


# K2's launch plan (ops/mixed_matmul.py mixed_plan), pure Python: the
# kernel itself runs only on the card (tests/test_torch_gpu.py)
SMS, SMEM_MAX = 132, 232448
MIX_SHAPES = {"7b": [(4096, 12288), (4096, 4096), (4096, 22016)],
              "13b": [(5120, 15360), (5120, 5120), (5120, 27648)]}


def _check_mixed_plan(p, m, k, n):
    """Row and column tiles cover M and N; every 128-deep k step is in
    exactly one split, none empty; one wave of blocks where K is split;
    the ring within the block's shared memory."""
    assert p.row_tiles * p.nx >= m > (p.row_tiles - 1) * p.nx
    assert p.col_tiles * tmm.MIX_COLS >= n > (p.col_tiles - 1) * tmm.MIX_COLS
    assert p.steps == -(-k // tmm.MIX_DEPTH)
    covered = []
    for s in range(p.splits):
        lo = s * p.steps_per_split
        hi = min(lo + p.steps_per_split, p.steps)
        assert lo < hi
        covered.extend(range(lo, hi))
    assert covered == list(range(p.steps))
    tiles = p.row_tiles * p.col_tiles
    assert p.grid == (p.row_tiles, p.col_tiles, p.splits)
    assert tiles * p.splits <= SMS or p.splits == 1
    assert p.smem <= SMEM_MAX
    assert (p.scratch is None) == (p.splits == 1)
    if p.scratch:
        assert p.scratch == p.splits * tiles * p.nx * tmm.MIX_COLS


@pytest.mark.parametrize("model", ["7b", "13b"])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, 48, 49, 128, 129, 1024])
def test_mixed_plan_tiles_and_splits(model, m):
    """At every 7B and 13B mix linear (qkv, o_proj, gate_up): x's row tile
    is the smallest of MIX_NX that holds M (128-row tiles above), and where
    the tiles leave SMs idle K is split so that at least half of the 132
    SMs get a block (the 40-row verify: 96-128 blocks at 7B, 108-120 at
    13B), unless every k step is a split already."""
    for k, n in MIX_SHAPES[model]:
        p = tmm.mixed_plan(m, k, n, SMS)
        assert p.nx == min(t for t in tmm.MIX_NX if t >= min(m, 128))
        _check_mixed_plan(p, m, k, n)
        tiles = p.row_tiles * p.col_tiles
        assert (tiles * p.splits >= SMS // 2 or tiles > SMS // 2
                or p.splits == p.steps)


@pytest.mark.parametrize("m,k,n", [(1, 64, 128), (3, 192, 384),
                                   (100, 512, 384), (300, 512, 384),
                                   (129, 1024, 256), (40, 11008, 4096),
                                   (2048, 64, 27648)])
def test_mixed_plan_edges(m, k, n):
    """K below one step or not a multiple of it, N a half column tile, M
    past a tile: every row, column and k step in exactly one block."""
    _check_mixed_plan(tmm.mixed_plan(m, k, n, SMS), m, k, n)


def test_mixed_plan_reads_shapes_only():
    """The plan depends on the shapes and the SM count alone, so a launch
    reads nothing back from the device."""
    import inspect
    assert list(inspect.signature(tmm.mixed_plan).parameters) == \
        ["m", "k", "n", "sms"]
    assert tmm.mixed_plan(40, 4096, 12288, SMS).splits == 2
