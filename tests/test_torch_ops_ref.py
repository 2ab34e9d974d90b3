"""Port parity: ops/ref and ops/dispatch of mixq_tensorrt_llm_tpu_torch
against the JAX package on the same numpy inputs. Integer outputs
(quantized activations, the int32 accumulator) must match exactly; GEMM
outputs within 2e-2 and scales within 1e-5, the tolerances of
tests/test_pallas_kernels.py; f32 attention within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.ops import dispatch as jdispatch
from mixq_tensorrt_llm_tpu.ops import ref as jref
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu_torch.ops import dispatch as tdispatch
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo

M, K, N, KO = 24, 128, 96, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[:, [3, 40, 77]] *= 30.0                     # outlier channels
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    act = (rng.permutation(K) + 1).astype(np.float32)
    act[[3, 40, 77]] += 1000.0
    norm_w = rng.uniform(0.5, 1.5, K).astype(np.float32)
    return x, w, act, norm_w


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol, what=""):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: rel err {err} > {tol}"


def test_rmsnorm(data):
    x, _, _, nw = data
    _close(tref.rmsnorm(_t(x), _t(nw), 1e-5),
           jref.rmsnorm(jnp.asarray(x), jnp.asarray(nw), 1e-5), 1e-5)


def test_quant_split_bitexact(data):
    x, _, act, _ = data
    ind = np.sort(np.argsort(-act)[:KO]).astype(np.int32)
    jq, js, jo = jref.quant_split(jnp.asarray(x), jnp.asarray(ind))
    tq, ts, to = tref.quant_split(_t(x), torch.from_numpy(ind))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(to.float().numpy(),
                                  np.asarray(jo, np.float32))


def test_rmsnorm_quant_split(data):
    x, _, act, nw = data
    ind = np.sort(np.argsort(-act)[:KO]).astype(np.int32)
    jq, js, jo = jref.rmsnorm_quant_split(jnp.asarray(x), jnp.asarray(nw),
                                          jnp.asarray(ind))
    tq, ts, to = tref.rmsnorm_quant_split(_t(x), _t(nw),
                                          torch.from_numpy(ind))
    # the norm's rsqrt may differ by an ulp between XLA and PyTorch, which
    # can move a value across a rounding boundary: at most 1 LSB
    assert np.abs(tq.numpy().astype(np.int32)
                  - np.asarray(jq).astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    _close(to, jo, 1e-2)


def test_mixed_matmul_int32_exact(data):
    x, w, act, _ = data
    jart = jdispatch.quantize_linear_params(
        jnp.asarray(w), JAlgo.INT8_MIX, act_scale=jnp.asarray(act),
        num_outliers=KO)
    ind = np.asarray(jart["fp_ind"])
    q, s, o = jref.quant_split(jnp.asarray(x), jnp.asarray(ind))
    jacc = jax.lax.dot_general(q, jart["qweight"], (((1,), (0,)), ((), ())),
                               preferred_element_type=jnp.int32)
    tacc = tref.int8_matmul(torch.from_numpy(np.array(q)),
                            torch.from_numpy(np.array(jart["qweight"])))
    assert tacc.dtype == torch.int32
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    args_j = (q, s, o, jart["qweight"], jart["scale_col"], jart["fp_weight"])
    args_t = [torch.from_numpy(np.array(a)) if a.dtype != jnp.bfloat16
              else _t(a).bfloat16() for a in args_j]
    for silu in (False, True):
        _close(tref.mixed_matmul(*args_t, silu=silu, out_dtype=torch.float32),
               jref.mixed_matmul(*args_j, silu=silu, out_dtype=jnp.float32),
               2e-2, f"mixed_matmul silu={silu}")


@pytest.mark.parametrize("algo", ["none", "w8a16", "int8_mix"])
def test_quantize_linear_params_and_linear(data, algo):
    x, w, act, nw = data
    jp = jdispatch.quantize_linear_params(
        jnp.asarray(w), JAlgo(algo), act_scale=jnp.asarray(act),
        num_outliers=KO)
    tp = tdispatch.quantize_linear_params(
        _t(w), QuantAlgo(algo), act_scale=_t(act), num_outliers=KO)
    assert set(tp) == set(jp)
    for name in jp:
        np.testing.assert_array_equal(
            tp[name].float().numpy(), np.asarray(jp[name], np.float32),
            err_msg=name)
    _close(tdispatch.linear(tp, _t(x), QuantAlgo(algo)),
           jdispatch.linear(jp, jnp.asarray(x), JAlgo(algo), backend="ref"),
           2e-2, f"linear {algo}")
    _close(tdispatch.norm_linear(tp, _t(x), QuantAlgo(algo), _t(nw)),
           jdispatch.norm_linear(jp, jnp.asarray(x), JAlgo(algo),
                                 jnp.asarray(nw), backend="ref"),
           2e-2, f"norm_linear {algo}")


def test_wo_matmul_and_mix_linear(data):
    x, w, act, _ = data
    jp = jdispatch.quantize_linear_params(
        jnp.asarray(w), JAlgo.INT8_MIX, act_scale=jnp.asarray(act),
        num_outliers=KO)
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else
        getattr(torch, str(v.dtype))) for k, v in jp.items()}
    _close(tref.wo_matmul(_t(x), tp["qweight"], tp["scale_col"],
                          out_dtype=torch.float32),
           jref.wo_matmul(jnp.asarray(x), jp["qweight"], jp["scale_col"],
                          out_dtype=jnp.float32), 2e-2, "wo_matmul")
    _close(tref.mix_linear(_t(x), tp["qweight"], tp["scale_col"],
                           tp["fp_ind"], tp["fp_weight"],
                           out_dtype=torch.float32),
           jref.mix_linear(jnp.asarray(x), jp["qweight"], jp["scale_col"],
                           jp["fp_ind"], jp["fp_weight"],
                           out_dtype=jnp.float32), 2e-2, "mix_linear")


def test_unported_algo_raises(data):
    """Every algo is ported now: int8_lr and fp8 quantize and apply as the
    JAX package does (within 2e-2), and a name that is no algo raises."""
    x, w, _, _ = data
    for algo in (QuantAlgo.INT8_LR, QuantAlgo.FP8):
        tp = tdispatch.quantize_linear_params(_t(w), algo)
        jp = jdispatch.quantize_linear_params(jnp.asarray(w),
                                              JAlgo(algo.value))
        assert set(tp) == set(jp)
        _close(tdispatch.linear(tp, _t(x), algo),
               jdispatch.linear(jp, jnp.asarray(x), JAlgo(algo.value)),
               2e-2, algo.value)
    with pytest.raises(ValueError):
        tdispatch.linear({}, _t(w), QuantAlgo("fp16"))


@pytest.mark.parametrize("softcap", [0.0, 20.0])
def test_attention_and_int8kv(softcap):
    rng = np.random.default_rng(1)
    b, sq, skv, hq, hkv, d = 2, 5, 11, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, skv, hkv, d)).astype(np.float32)
    mask = rng.random((b, 1, sq, skv)) < 0.7
    mask[..., 0] = True
    _close(tref.attention(_t(q), _t(k), _t(v), mask=torch.from_numpy(mask),
                          softcap=softcap),
           jref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          mask=jnp.asarray(mask), softcap=softcap), 1e-5,
           "attention")
    kq = rng.integers(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    vq = rng.integers(-127, 128, (b, skv, hkv, d)).astype(np.int8)
    ks = rng.uniform(0.001, 0.02, (b, skv, hkv)).astype(np.float32)
    vs = rng.uniform(0.001, 0.02, (b, skv, hkv)).astype(np.float32)
    _close(tref.attention_int8kv(_t(q), torch.from_numpy(kq), _t(ks),
                                 torch.from_numpy(vq), _t(vs),
                                 mask=torch.from_numpy(mask),
                                 softcap=softcap),
           jref.attention_int8kv(jnp.asarray(q), jnp.asarray(kq),
                                 jnp.asarray(ks), jnp.asarray(vq),
                                 jnp.asarray(vs), mask=jnp.asarray(mask),
                                 softcap=softcap), 1e-5, "attention_int8kv")
