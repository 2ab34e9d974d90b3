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
