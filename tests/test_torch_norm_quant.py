"""K1's plain version (the port's CPU route) against the JAX package's
Pallas kernel in interpret mode: fused RMSNorm -> outlier split -> int8
quantization, and the split without the norm. Same numpy inputs to both.

Tolerances are the JAX package's own for this kernel
(tests/test_pallas_kernels.py): int8 codes at most 1 apart and more than
99.9% equal (the f32 order of the norm's sum differs, which can move a
value across a rounding boundary), scale_row rtol 1e-5, x_out 1e-2. The
kernel's launch plan (``norm_quant_plan``), pure Python: which of its two
kernels each width takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import norm_quant as jnq
from mixq_tensorrt_llm_tpu_torch.ops import norm_quant as tnq

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _inputs(seed, m, k, ko, scale=2.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * scale).astype(np.float32)
    gamma = (np.abs(rng.standard_normal(k)) + 0.5).astype(np.float32)
    ind = np.sort(rng.choice(k, ko, replace=False)).astype(np.int32)
    return x, gamma, ind


def _assert_close(got, want):
    gq, gs, go = (t.float().numpy() for t in got)
    wq, ws, wo = (np.asarray(a, np.float32) for a in want)
    assert gq.shape == wq.shape and gs.shape == ws.shape
    assert go.shape == wo.shape
    diff = np.abs(gq - wq)
    assert diff.max() <= 1 and (diff == 0).mean() > 0.999
    np.testing.assert_allclose(gs, ws, rtol=1e-5)
    np.testing.assert_allclose(go, wo, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,k,ko,dtype", [
    (32, 256, 128, torch.float32),
    (100, 384, 128, torch.float32),      # M not a multiple of the tile
    (16, 4096, 128, torch.float32),      # Llama-2-7B hidden width
    (24, 256, 128, torch.bfloat16),
])
def test_rmsnorm_quant_split_matches_pallas(m, k, ko, dtype):
    x, gamma, ind = _inputs(40, m, k, ko)
    xt = torch.from_numpy(x).to(dtype)
    got = tnq.rmsnorm_quant_split(xt, torch.from_numpy(gamma),
                                  torch.from_numpy(ind))
    want = jnq.rmsnorm_quant_split(jnp.asarray(x, _JDT[dtype]),
                                   jnp.asarray(gamma), jnp.asarray(ind),
                                   interpret=True)
    _assert_close(got, want)


def test_quant_split_matches_pallas():
    x, _, ind = _inputs(43, 64, 256, 128, scale=3.0)
    got = tnq.quant_split(torch.from_numpy(x), torch.from_numpy(ind))
    want = jnq.quant_split(jnp.asarray(x), jnp.asarray(ind), interpret=True)
    _assert_close(got, want)
    # the outlier channels are out of q_x and in x_out
    assert bool((got[0][:, torch.from_numpy(ind).long()] == 0).all())
    np.testing.assert_array_equal(
        got[2].float().numpy(),
        torch.from_numpy(x[:, ind]).bfloat16().float().numpy())


def test_batched_shape_and_f32_norm():
    """Leading dims are kept; the normed row stays f32 (ops.ref rounds it
    to x's dtype first), so for bf16 input the plain K1 is ops.ref on the
    f32 norm, not ops.ref.rmsnorm_quant_split."""
    from mixq_tensorrt_llm_tpu_torch.ops import ref
    x, gamma, ind = _inputs(45, 16, 256, 128)
    xt = torch.from_numpy(x).reshape(2, 8, 256).bfloat16()
    q, s, o = tnq.rmsnorm_quant_split(xt, torch.from_numpy(gamma),
                                      torch.from_numpy(ind))
    assert q.shape == (2, 8, 256) and s.shape == (2, 8)
    assert o.shape == (2, 8, 128) and q.dtype == torch.int8
    xf = xt.float()
    normed = (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + 1e-6)
              * torch.from_numpy(gamma))
    want = ref.quant_split(normed, torch.from_numpy(ind))
    for a, b in zip((q, s, o), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("k,variant", [
    (4096, "registers"),         # Llama-2-7B qkv, o_proj, gate_up inputs
    (5120, "registers"),         # Llama-2-13B (int4_mix)
    (11008, "registers"),        # 7B down_proj input
    (13824, "registers"),        # 13B down_proj input
    (16384, "registers"),        # the widest row in registers
    (16392, "shared"),
    (32768, "shared"),           # the widest the wrapper takes
])
@pytest.mark.parametrize("m", [1, 40, 1024])
def test_norm_quant_plan_picks_the_variant(k, variant, m):
    """Rows of up to REG_THREADS x REG_MAX_CHUNKS chunks of 8 values live
    in registers: warps' worth of threads that cover the row with no idle
    warp, FEW_ROW_CHUNKS chunks a thread where the rows do not fill the
    132 SMs, MANY_ROW_CHUNKS where they do (more where the row needs them
    to fit); wider rows in shared memory."""
    p = tnq.norm_quant_plan(m, k, 132)
    assert p.variant == variant
    chunks = k // 8
    if variant == "shared":
        assert (p.threads, p.chunks_per_thread) == (tnq.SHARED_THREADS, 0)
        return
    cpt = p.chunks_per_thread
    assert p.threads % 32 == 0 and 32 <= p.threads <= tnq.REG_THREADS
    assert 1 <= cpt <= tnq.REG_MAX_CHUNKS
    assert p.threads * cpt >= chunks > (p.threads - 32) * cpt
    want = tnq.MANY_ROW_CHUNKS if m >= 132 else tnq.FEW_ROW_CHUNKS
    assert cpt == max(want, -(-chunks // tnq.REG_THREADS))
