"""K4 (wo_matmul, weight-only W8A16): the port's plain version (its CPU
route) against the JAX package's Pallas kernel in interpret mode, in the
decode (M <= 16) and prefill regimes the CUDA kernel splits into. Same
numpy inputs to both; tolerance 2e-2, the JAX package's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import wo_matmul as jwo
from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as two


@pytest.mark.parametrize("m", [1, 4, 8, 100, 256])
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


HID = {"7b": (4096, 11008), "13b": (5120, 13824)}


def _int4_shapes(model):
    """(K, N) of the four linears of a Llama-2 decode step."""
    h, i = HID[model]
    return [(h, 3 * h), (h, h), (h, 2 * i), (i, h)]


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
        covered = []
        for s in range(p.splits):
            lo = s * p.chunks_per_split * two.PACKED_CHUNK
            hi = min((s + 1) * p.chunks_per_split * two.PACKED_CHUNK, k // 2)
            assert lo < hi
            covered.extend(range(lo, hi))
        assert covered == list(range(k // 2))
        assert p.smem <= 227 * 1024
        assert p.mt == (8 if m <= 8 else 16)
        assert (p.scratch is None) == (p.splits == 1)
        if p.scratch:
            assert p.scratch == (p.splits, p.grid[2], p.mt, n)


@pytest.mark.parametrize("kp", [1, 63, 64, 65, 620, 6912])
def test_packed_plan_odd_k(kp):
    """K/2 not a multiple of the 64-row chunk, or below one chunk: every
    packed row in exactly one split."""
    p = two.packed_plan(8, 2 * kp, 256, 132)
    assert p.chunks == -(-kp // two.PACKED_CHUNK)
    assert (p.splits - 1) * p.chunks_per_split < p.chunks \
        <= p.splits * p.chunks_per_split
