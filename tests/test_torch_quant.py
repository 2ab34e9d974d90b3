"""Port parity: quant/core of mixq_tensorrt_llm_tpu_torch against the JAX
package, bit-exact on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.quant import core as jcore
from mixq_tensorrt_llm_tpu_torch.quant import core as tcore


def _rand(seed, shape, spread=True):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if spread:   # per-row magnitudes over five decades
        x *= rng.uniform(1e-3, 1e2, shape[:-1] + (1,)).astype(np.float32)
    return x


def _np(x):
    return np.asarray(x)


@pytest.mark.parametrize("shape", [(64, 48), (128, 96)])
def test_quantize_weight_int8_bitexact(shape):
    w = _rand(0, shape)
    jq, js = jcore.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tcore.quantize_weight_int8(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(
        tcore.weight_scale_int8(torch.from_numpy(w)).numpy(),
        _np(jcore.weight_scale_int8(jnp.asarray(w))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_activations_bitexact(dtype):
    x = _rand(1, (33, 64))
    x[3] = 0.0                       # all-zero row: scale floors at 1e-8
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = jcore.quantize_activations(jx)
    tq, ts = tcore.quantize_activations(tx)
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


def test_quantize_kv_bitexact_and_dequant():
    kv = _rand(2, (3, 5, 4, 32))
    jq, js = jcore.quantize_kv(jnp.asarray(kv))
    tq, ts = tcore.quantize_kv(torch.from_numpy(kv))
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(
        tcore.dequantize_kv(tq, ts, dtype=torch.float32).numpy(),
        _np(jcore.dequantize_kv(jq, js, dtype=jnp.float32)))


def test_select_outliers_and_split():
    rng = np.random.default_rng(3)
    act = (rng.permutation(96) + 1).astype(np.float32)   # distinct: no ties
    w = _rand(4, (96, 40))
    ji = jcore.select_outliers(jnp.asarray(act), 12)
    ti = tcore.select_outliers(torch.from_numpy(act), 12)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(
        tcore.split_outlier_weight(torch.from_numpy(w), ti).float().numpy(),
        _np(jcore.split_outlier_weight(jnp.asarray(w), ji)).astype(
            np.float32))
    np.testing.assert_array_equal(
        tcore.outlier_mask(ti, 96).numpy(), _np(jcore.outlier_mask(ji, 96)))


@pytest.mark.parametrize("k", [8, 128])
@pytest.mark.parametrize("n", [64, 4096, 11008])
@pytest.mark.parametrize("scales", ["ones", "planted_ties"])
def test_select_outliers_ties_match_jax(scales, n, k):
    """Equal scales go lower index first, as jax.lax.top_k takes them:
    all-ones scales (no calibration) pick channels 0..k-1; planted ties
    straddling the k-th place keep the lower indices."""
    k = min(k, n)
    act = np.ones(n, np.float32)
    if scales == "planted_ties":
        rng = np.random.default_rng(n + k)
        act = rng.integers(1, 4, n).astype(np.float32)   # many ties
        act[rng.choice(n, k // 2, replace=False)] = 7.0
    want = _np(jcore.select_outliers(jnp.asarray(act), k))
    got = tcore.select_outliers(torch.from_numpy(act), k)
    np.testing.assert_array_equal(got.numpy(), want)
    if scales == "ones":
        np.testing.assert_array_equal(got.numpy(), np.arange(k))


def test_extract_outliers_and_zero():
    x = _rand(5, (7, 64))
    ind = np.array([1, 5, 9, 63], np.int32)
    jo, jz = jcore.extract_outliers_and_zero(jnp.asarray(x), jnp.asarray(ind))
    to, tz = tcore.extract_outliers_and_zero(torch.from_numpy(x),
                                             torch.from_numpy(ind))
    np.testing.assert_array_equal(to.numpy(), _np(jo))
    np.testing.assert_array_equal(tz.numpy(), _np(jz))


def test_make_mix_artifact_bitexact():
    rng = np.random.default_rng(6)
    w = _rand(7, (64, 80), spread=False) * 0.02
    act = (rng.permutation(64) + 1).astype(np.float32)
    ja = jcore.make_mix_artifact(jnp.asarray(w), jnp.asarray(act), 16)
    ta = tcore.make_mix_artifact(torch.from_numpy(w), torch.from_numpy(act),
                                 16)
    for name in ("qweight", "scale_col", "fp_ind"):
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      _np(getattr(ja, name)), err_msg=name)
    np.testing.assert_array_equal(ta.fp_weight.float().numpy(),
                                  _np(ja.fp_weight).astype(np.float32))
    ja4 = jcore.make_mix_artifact(jnp.asarray(w), jnp.asarray(act), 16,
                                  bits=4)
    ta4 = tcore.make_mix_artifact(torch.from_numpy(w), torch.from_numpy(act),
                                  16, bits=4)
    for name in ("qweight", "scale_col", "fp_ind"):
        np.testing.assert_array_equal(getattr(ta4, name).numpy(),
                                      _np(getattr(ja4, name)), err_msg=name)
    with pytest.raises(ValueError, match="bits"):
        tcore.make_mix_artifact(torch.from_numpy(w), torch.from_numpy(act),
                                16, bits=3)
