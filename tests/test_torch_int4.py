"""Port parity, int4 weights: the quantizers and packing of quant/core
bit-exact against the JAX package (every byte value through unpack, every
nibble pair through pack), the plain versions of K12
(wo_matmul_packed) and K13 (wo_matmul_packed_grouped) against the JAX
Pallas kernels in interpret mode, the group-by-group wo_matmul_grouped
against JAX's, and the dispatch of w4a16 / w4a16_g / int4_mix linears at
M 4, 64 and 256 against JAX's. Same numpy inputs to both; GEMMs within
2e-2, the JAX package's own tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import dispatch as jdispatch
from mixq_tensorrt_llm_tpu.ops import ref as jref
from mixq_tensorrt_llm_tpu.ops import wo_matmul as jwo
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu.quant import core as jcore
from mixq_tensorrt_llm_tpu_torch.ops import dispatch as tdispatch
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref
from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as two
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo
from mixq_tensorrt_llm_tpu_torch.quant import core as tcore

K, N = 256, 128


def _w(seed, k=K, n=N):
    """Rows over two decades of magnitude (group scales differ)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)) * np.logspace(-2, 0, k)[:, None]
    return w.astype(np.float32)


def _eq(t, j, msg=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=msg)


def test_unpack_every_byte_and_pack_every_pair():
    """All 256 byte values sign-extend as JAX's int8 shifts do, and every
    (low, high) pair of int4 values packs to JAX's byte."""
    b = np.arange(256, dtype=np.uint8).view(np.int8).reshape(1, 256)
    _eq(tcore.unpack_int4(torch.from_numpy(b)), jcore.unpack_int4(
        jnp.asarray(b)))
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8))
    q = np.stack([lo.ravel(), hi.ravel()]).astype(np.int8)      # (2, 256)
    packed = tcore.pack_int4(torch.from_numpy(q))
    assert packed.dtype == torch.int8 and packed.shape == (1, 256)
    _eq(packed, jcore.pack_int4(jnp.asarray(q)))
    _eq(tcore.unpack_int4(packed), q)
    with pytest.raises(ValueError, match="even"):
        tcore.pack_int4(torch.zeros((3, 4), dtype=torch.int8))


def test_int4_quantizers_bitexact():
    w = _w(0) * np.random.default_rng(1).uniform(1e-3, 1e2, (1, N)).astype(
        np.float32)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    _eq(tcore.weight_scale_int4(tw), jcore.weight_scale_int4(jw))
    for t, j in zip(tcore.quantize_weight_int4(tw),
                    jcore.quantize_weight_int4(jw)):
        _eq(t, j)
    tq, ts = tcore.quantize_weight_int4_grouped(tw, 32)
    jq, js = jcore.quantize_weight_int4_grouped(jw, 32)
    _eq(tq, jq)
    _eq(ts, js)
    assert int(tq.min()) >= -7 and int(tq.max()) <= 7
    _eq(tcore.dequantize_weight_grouped(tq, ts, torch.float32),
        jcore.dequantize_weight_grouped(jq, js, jnp.float32))
    tq4, ts4 = tcore.quantize_weight_int4(tw)
    _eq(tcore.dequantize_weight(tq4, ts4, torch.float32),
        jcore.dequantize_weight(jnp.asarray(tq4.numpy()),
                                jnp.asarray(ts4.numpy()), jnp.float32))


def test_make_mix_artifact_int4_bitexact():
    w = _w(2) * 0.02
    act = (np.random.default_rng(3).permutation(K) + 1).astype(np.float32)
    ja = jcore.make_mix_artifact(jnp.asarray(w), jnp.asarray(act), 16, bits=4)
    ta = tcore.make_mix_artifact(torch.from_numpy(w), torch.from_numpy(act),
                                 16, bits=4)
    for name in ("qweight", "scale_col", "fp_ind"):
        _eq(getattr(ta, name), getattr(ja, name), name)
    assert int(ta.qweight.min()) >= -8 and int(ta.qweight.max()) <= 7


@pytest.mark.parametrize("m", [3, 8])
def test_wo_matmul_packed_plain_matches_pallas(m):
    rng = np.random.default_rng(4)
    q = rng.integers(-8, 8, (K, N)).astype(np.int8)
    scol = (rng.random(N) * 0.05 + 0.01).astype(np.float32)
    x = rng.standard_normal((m, K)).astype(np.float32)
    qp = np.array(jcore.pack_int4(jnp.asarray(q)))
    got = two.wo_matmul_packed(torch.from_numpy(x), torch.from_numpy(qp),
                               torch.from_numpy(scol), out_dtype=torch.float32)
    want = jwo.wo_matmul_packed(jnp.asarray(x, jnp.bfloat16), jnp.asarray(qp),
                                jnp.asarray(scol), out_dtype=jnp.float32,
                                interpret=True)
    assert got.shape == (m, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("gs", [32, 64])
def test_wo_matmul_packed_grouped_plain_matches_pallas(gs):
    """block_k 64 packed rows against groups of 32 and 64: both halves'
    group offsets (the high nibbles start at group K/(2 gs))."""
    w = _w(5)
    jq, js = jcore.quantize_weight_int4_grouped(jnp.asarray(w), gs)
    qp = jcore.pack_int4(jq)
    x = np.random.default_rng(6).standard_normal((5, K)).astype(np.float32)
    got = two.wo_matmul_packed_grouped(
        torch.from_numpy(x), torch.from_numpy(np.array(qp)),
        torch.from_numpy(np.asarray(js)), gs, out_dtype=torch.float32)
    want = jwo.wo_matmul_packed_grouped(
        jnp.asarray(x, jnp.bfloat16), qp, js, gs, out_dtype=jnp.float32,
        interpret=True, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)


def test_wo_matmul_grouped_matches_jax():
    """The group-by-group accumulation equals JAX's einsum over the (G, M,
    N) partials up to f32 summation order."""
    w = _w(7)
    jq, js = jcore.quantize_weight_int4_grouped(jnp.asarray(w), 32)
    x = np.random.default_rng(8).standard_normal((6, K)).astype(np.float32)
    got = tref.wo_matmul_grouped(torch.from_numpy(x),
                                 torch.from_numpy(np.asarray(jq)),
                                 torch.from_numpy(np.asarray(js)),
                                 out_dtype=torch.float32)
    want = jref.wo_matmul_grouped(jnp.asarray(x), jq, js,
                                  out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


ALGOS = [(QuantAlgo.W4A16, JAlgo.W4A16), (QuantAlgo.W4A16_G, JAlgo.W4A16_G),
         (QuantAlgo.INT4_MIX, JAlgo.INT4_MIX)]


@pytest.mark.parametrize("algo,jalgo", ALGOS, ids=lambda a: a.value)
def test_quantize_linear_params_bitexact(algo, jalgo):
    """The params dict (packed by default, pack=False kept unpacked) is
    the JAX package's, bit for bit."""
    w = _w(9)
    act = (np.random.default_rng(10).permutation(K) + 1).astype(np.float32)
    for pack in (None, False):
        jp = jdispatch.quantize_linear_params(
            jnp.asarray(w), jalgo, act_scale=jnp.asarray(act),
            num_outliers=16, pack=pack, group_size=64)
        tp = tdispatch.quantize_linear_params(
            torch.from_numpy(w), algo, act_scale=torch.from_numpy(act),
            num_outliers=16, pack=pack, group_size=64)
        assert tp.keys() == jp.keys()
        for leaf in jp:
            np.testing.assert_array_equal(
                tp[leaf].float().numpy(), np.asarray(jp[leaf], np.float32),
                err_msg=leaf)
    assert "qweight_packed" in tp or pack is False


@pytest.mark.parametrize("algo,jalgo", ALGOS, ids=lambda a: a.value)
def test_linear_dispatch_matches_jax(algo, jalgo):
    """Packed params at M 4 and 64 (the port's K12/K13 routes, plain on
    the CPU) and 256 (unpack, then K4 / the grouped product / K1 -> K2),
    and norm_linear, against the JAX dispatch on the same params."""
    w = _w(11) * 0.1
    act = (np.random.default_rng(12).permutation(K) + 1).astype(np.float32)
    jp = jdispatch.quantize_linear_params(
        jnp.asarray(w), jalgo, act_scale=jnp.asarray(act), num_outliers=16,
        group_size=128)
    tp = {k: torch.from_numpy(np.asarray(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    assert "qweight_packed" in tp
    norm_w = np.random.default_rng(13).uniform(0.5, 1.5, K).astype(
        np.float32)
    for m in (4, 64, 256):
        x = np.random.default_rng(m).standard_normal((m, K)).astype(
            np.float32)
        got = tdispatch.linear(tp, torch.from_numpy(x), algo)
        want = jdispatch.linear(jp, jnp.asarray(x), jalgo)
        assert got.shape == (m, N) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                                   atol=2e-2, err_msg=f"M={m}")
    got = tdispatch.norm_linear(tp, torch.from_numpy(x), algo,
                                torch.from_numpy(norm_w))
    want = jdispatch.norm_linear(jp, jnp.asarray(x), jalgo,
                                 jnp.asarray(norm_w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
