"""Port parity: the fp8 and int8_lr formats against the JAX package on the
CPU.

fp8: ``quantize_weight_fp8`` and ``quantize_kv(dtype=float8_e4m3fn)`` bit
for bit on the uint8 views (torch's cast against ml_dtypes'), at values
next to +-448, subnormals (below 2^-6 after scaling), the 1e-8 scale floor
and all-zero rows; e4m3 paged pools and dense caches through
``forward_paged`` / ``forward`` (logits within 2e-3 of the largest; pools
and caches outside the trash block with codes at most one step apart, 99%
equal, scales within 1e-5: the packages' f32 K/V differ in the last ulp), with the gather route counted on e4m3
pools and never taken on int8 ones; ``@e4m3`` checkpoints both ways.
int8_lr: ``make_lr_artifact``'s qweight and scale_col exact and u @ v
within 1e-3 relative RMS (singular vectors are defined up to sign, so u
and v are not compared alone), ``lr_linear`` and ``dispatch.linear``
within 2e-2. The Executors on fp8 + fp8 KV and on int8_lr + int8 KV:
greedy tokens identical to the JAX Executor's; beam bursts over e4m3
pages: sequences equal, scores within 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import checkpoint as jckpt
from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.ops import dispatch as jdispatch
from mixq_tensorrt_llm_tpu.ops import ref as jref
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.quant import core as jcore
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.convert import (load_checkpoint,
                                                 save_checkpoint)
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.ops import dispatch as tdispatch
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref
from mixq_tensorrt_llm_tpu_torch.quant import core as tcore
from mixq_tensorrt_llm_tpu_torch.quant.config import QuantAlgo
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor

LOGIT_TOL = 2e-3
GEMM_TOL = 2e-2
UV_TOL = 1e-3
FP8 = torch.float8_e4m3fn
EX_KW = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=16,
             prefill_lanes=2)


def _jcfg(algo, kv):
    return JConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=256, dtype=jnp.float32,
                   quant=JQuant(algo=algo, num_outliers=8, kv_cache=kv))


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, algo, kv in (("fp8", JAlgo.FP8, JKV.FP8),
                           ("int8_lr", JAlgo.INT8_LR, JKV.INT8)):
        jcfg = _jcfg(algo, kv)
        cfg = ModelConfig.from_dict(jcfg.to_dict())
        tp = tllama.init_random_params(cfg, seed=1, device="cpu")
        out[name] = jcfg, _to_jax(tp), cfg, tp
    return out


def _to_jax(tp):
    """Port params -> the JAX package's tree (layers stacked), leaf for
    leaf: the same model on both sides without JAX's slower eager init."""
    def j(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        if t.dtype == torch.float8_e4m3fn:
            return jnp.asarray(t.view(torch.uint8).numpy().view(
                jnp.float8_e4m3fn))
        return jnp.asarray(t.numpy())
    out = {k: {leaf: j(t) for leaf, t in sub.items()}
           for k, sub in tp.items() if k != "layers"}
    out["layers"] = {mod: {leaf: j(torch.stack([lay[mod][leaf]
                                                for lay in tp["layers"]]))
                           for leaf in tp["layers"][0][mod]}
                     for mod in tp["layers"][0]}
    return out


def _bytes(a) -> np.ndarray:
    """A one-byte tensor of either package as its uint8 bytes."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


def _rel(got, want) -> float:
    want, got = np.asarray(want, np.float32), np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _edge_weight() -> np.ndarray:
    """(64, 96) with the edge cases in columns: 448 itself and its
    neighbours in e4m3 after scaling, subnormals, the scale floor, an
    all-zero column and row."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 96)) * 0.05).astype(np.float32)
    w[:, 0] = np.linspace(-1.0, 1.0, 64)                # +-448 after scaling
    w[:8, 1] = [1.0, 0.99, 0.98, 0.97, -0.999, 0.9375, 0.96875, 0.984375]
    w[:, 2] = 2.0 ** -np.arange(64, dtype=np.float32)   # deep subnormals
    w[0, 3], w[1:, 3] = 448.0, rng.uniform(0, 2 ** -6, 63)
    w[:, 4] = 0.0                                       # absmax 0: the floor
    w[:, 5] = 1e-12 * rng.standard_normal(64)           # floored scale
    w[7] = 0.0
    return w


def test_quantize_weight_fp8_bit_equal():
    w = _edge_weight()
    jq, js = jcore.quantize_weight_fp8(jnp.asarray(w))
    tq, ts = tcore.quantize_weight_fp8(torch.from_numpy(w))
    assert tq.dtype == FP8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tcore.FP8_MAX == jcore.FP8_MAX
    # 448 and subnormal codes occur (exponent field 0, mantissa not)
    codes = _bytes(tq) & 0x7F
    assert (codes == 0x7E).any() and ((codes > 0) & (codes < 8)).any()


@pytest.mark.parametrize("axis", [-1, 2])
def test_quantize_kv_fp8_bit_equal(axis):
    rng = np.random.default_rng(1)
    kv = rng.standard_normal((3, 5, 4, 16)).astype(np.float32)
    kv[0, 0] = 0.0                                       # all-zero rows
    kv[1, 1, 1] = 2.0 ** -np.arange(16, dtype=np.float32)
    kv[2, 2, 2] *= 1e-12
    kv[2, 3, 0, :4] = [448.0, -448.0, 447.0, 1e-30]
    jq, js = jcore.quantize_kv(jnp.asarray(kv), axis=axis,
                               dtype=jnp.float8_e4m3fn)
    tq, ts = tcore.quantize_kv(torch.from_numpy(kv), axis=axis, dtype=FP8)
    np.testing.assert_array_equal(_bytes(tq), _bytes(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tcore.dequantize_kv(tq, ts, dtype=torch.float32, axis=axis).numpy(),
        np.asarray(jcore.dequantize_kv(jq, js, dtype=jnp.float32, axis=axis)))


@pytest.mark.parametrize("shape", [(64, 96), (16, 48)])
def test_make_lr_artifact_matches_jax(shape):
    rng = np.random.default_rng(shape[0])
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    jq, js, ju, jv = jcore.make_lr_artifact(jnp.asarray(w))
    tq, ts, tu, tv = tcore.make_lr_artifact(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    r = min(32, *shape)
    assert tu.shape == (shape[0], r) and tv.shape == (r, shape[1])
    assert tu.dtype == tv.dtype == torch.bfloat16
    juv = np.asarray(ju.astype(jnp.float32) @ jv.astype(jnp.float32))
    tuv = (tu.float() @ tv.float()).numpy()
    assert np.sqrt(((tuv - juv) ** 2).mean() / (juv ** 2).mean()) <= UV_TOL
    # the correction shrinks the residual the int8 weight leaves
    resid = w - tq.float().numpy() * ts.numpy()[None, :]
    assert np.linalg.norm(resid - tuv) < np.linalg.norm(resid)


@pytest.mark.parametrize("algo", [JAlgo.FP8, JAlgo.INT8_LR])
def test_linear_matches_jax(algo, rows=24):
    rng = np.random.default_rng(rows)
    w = (rng.standard_normal((64, 128)) * 0.05).astype(np.float32)
    x = rng.standard_normal((rows, 64)).astype(np.float32)
    jp = jdispatch.quantize_linear_params(jnp.asarray(w), algo,
                                          bias=jnp.ones((128,)))
    tp = tdispatch.quantize_linear_params(torch.from_numpy(w),
                                          QuantAlgo(algo.value),
                                          bias=torch.ones((128,)))
    assert set(tp) == set(jp)
    np.testing.assert_array_equal(_bytes(tp["qweight"]),
                                  _bytes(jp["qweight"]))
    want = jdispatch.linear(jp, jnp.asarray(x), algo)
    got = tdispatch.linear(tp, torch.from_numpy(x), QuantAlgo(algo.value))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= GEMM_TOL
    if algo == JAlgo.INT8_LR:
        want = jref.lr_linear(jnp.asarray(x), jp["qweight"], jp["scale_col"],
                              jp["lr_u"], jp["lr_v"], out_dtype=jnp.float32)
        got = tref.lr_linear(torch.from_numpy(x), tp["qweight"],
                             tp["scale_col"], tp["lr_u"], tp["lr_v"],
                             out_dtype=torch.float32)
        assert _rel(got.numpy(), want) <= GEMM_TOL


def _pools_close(jstate, tstate):
    """Outside each layer's trash row: scales within 1e-5 relative, codes
    at most one step apart and 99% equal (the two packages' f32 K/V differ
    in the last ulp, which can move a value across a rounding boundary;
    the casts themselves are bit-equal, above)."""
    nb = jstate.k.shape[0] // 2
    rows = np.r_[1:nb, nb + 1:2 * nb]
    for name in ("k", "v"):
        j = _bytes(getattr(jstate, name))[rows].astype(np.int16)
        t = _bytes(getattr(tstate, name))[rows].astype(np.int16)
        if getattr(tstate, name).dtype == torch.int8:
            j, t = (j + 128) % 256, (t + 128) % 256   # two's complement
        assert np.abs(j - t).max() <= 1 and (j == t).mean() >= 0.99
        np.testing.assert_allclose(
            getattr(tstate, name + "_scale")[rows].numpy(),
            np.asarray(getattr(jstate, name + "_scale"))[rows], rtol=1e-5)


@pytest.fixture
def gathers(monkeypatch):
    """Counts the calls of kv_cache.paged_gather (the e4m3 pools' route;
    on the card it counts itself in ops._build.LAUNCHES)."""
    calls = [0]
    real = tkv.paged_gather

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    monkeypatch.setattr(tkv, "paged_gather", counted)
    return calls


@pytest.mark.parametrize("name", ["fp8", "int8_lr"])
def test_forward_paged_matches_jax(models, name, gathers):
    """A prefill chunk and a decode step; e4m3 pools go through the gather
    route (counted), int8 pools never do."""
    jcfg, jp, cfg, tp = models[name]
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 256, (2, 16)).astype(np.int32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16)).copy()
    lens = np.array([16, 11], np.int32)
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jstate = jkv.init_paged_kv(jcfg, 8, 8)
    tstate = tkv.init_paged_kv(cfg, 8, 8, device="cpu")
    assert tstate.k.dtype == (FP8 if name == "fp8" else torch.int8)
    for tok, p, n in ((toks, pos, lens), (toks[:, :1] + 1, lens[:, None],
                                          lens + 1)):
        jl, jstate = jcommon.forward_paged(
            jp, jcfg, jnp.asarray(tok), jnp.asarray(p), jstate,
            jnp.asarray(table), jnp.asarray(n))
        tl, tstate = tcommon.forward_paged(
            tp, cfg, torch.from_numpy(tok), torch.from_numpy(p), tstate,
            torch.from_numpy(table), torch.from_numpy(n))
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL
    _pools_close(jstate, tstate)
    assert gathers[0] == (2 * cfg.num_layers if name == "fp8" else 0)


def test_dense_fp8_cache_matches_jax(models):
    jcfg, jp, cfg, tp = models["fp8"]
    rng = np.random.default_rng(4)
    toks = rng.integers(1, 256, (2, 12)).astype(np.int32)
    pos = np.broadcast_to(np.arange(12, dtype=np.int32), (2, 12)).copy()
    lens = np.full((2,), 12, np.int32)
    jc = jcommon.init_kv_cache(jcfg, 2, 24)
    tc = tcommon.init_kv_cache(cfg, 2, 24, device="cpu")
    assert tc.k.dtype == FP8 and tc.quantized
    for full, tok, p, n in ((True, toks, pos, lens),
                            (False, toks[:, :1], lens[:, None], lens + 1)):
        jl, jc = jcommon.forward(jp, jcfg, jnp.asarray(tok), jnp.asarray(p),
                                 jc, jnp.asarray(n), full_prefill=full)
        tl, tc = tcommon.forward(tp, cfg, torch.from_numpy(tok),
                                 torch.from_numpy(p), tc,
                                 torch.from_numpy(n), full_prefill=full)
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL
    for name in ("k", "v"):
        j = _bytes(getattr(jc, name)).astype(np.int16)
        t = _bytes(getattr(tc, name)).astype(np.int16)
        assert np.abs(j - t).max() <= 1 and (j == t).mean() >= 0.99
        np.testing.assert_allclose(getattr(tc, name + "_scale").numpy(),
                                   np.asarray(getattr(jc, name + "_scale")),
                                   rtol=1e-5)


@pytest.mark.parametrize("name", ["fp8", "int8_lr"])
def test_executor_matches_jax(models, name, gathers):
    jcfg, jp, cfg, tp = models[name]
    jex = JExecutor(jp, jcfg, seed=0, **EX_KW)
    tex = Executor(tp, cfg, seed=0, device="cpu", **EX_KW)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 12)]
    jids = [jex.submit(p, max_new_tokens=8) for p in prompts]
    tids = [tex.submit(p, max_new_tokens=8) for p in prompts]
    jdone, tdone = jex.run(), tex.run()
    assert [tdone[r].generated for r in tids] == \
        [jdone[r].generated for r in jids]
    assert (gathers[0] > 0) == (name == "fp8")


@pytest.mark.parametrize("name", ["fp8", "int8_lr"])
def test_checkpoints_both_ways(models, name, tmp_path):
    """The JAX package's @e4m3 checkpoint loads in the port tensor for
    tensor, and the port's loads in the JAX package."""
    jcfg, jp, cfg, tp = models[name]
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, jcfg)
    got, gcfg = load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert gcfg == cfg
    save_checkpoint(str(tmp_path / "t"), got, gcfg)
    back, bcfg = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert bcfg.quant == jcfg.quant
    for mod in ("qkv_proj", "o_proj", "gate_up_proj", "down_proj"):
        for leaf, j in jp["layers"][mod].items():
            for li in range(2):
                t = got["layers"][li][mod][leaf]
                assert t.dtype == tp["layers"][li][mod][leaf].dtype
                np.testing.assert_array_equal(
                    _bytes(t) if t.dtype == FP8 else t.float().numpy(),
                    _bytes(j[li]) if t.dtype == FP8
                    else np.asarray(j[li].astype(jnp.float32)))
            b = back["layers"][mod][leaf]
            assert b.dtype == j.dtype
            np.testing.assert_array_equal(
                np.asarray(b).view(np.uint8) if b.dtype == jnp.float8_e4m3fn
                else np.asarray(b.astype(jnp.float32)),
                np.asarray(j).view(np.uint8) if b.dtype == jnp.float8_e4m3fn
                else np.asarray(j.astype(jnp.float32)))


def test_paged_beam_search_fp8_matches_jax(models, gathers):
    """Beam bursts over e4m3 pages: the burst tails in e4m3 and the pool
    prefix through the gather route (the JAX package's non-kernel route);
    sequences equal, scores within 5e-4 of the JAX package's (the
    tolerance of test_torch_beam.py on quantized KV)."""
    from mixq_tensorrt_llm_tpu.runtime import beam as jbeam
    from mixq_tensorrt_llm_tpu_torch.runtime import beam as tbeam
    jcfg, jp, cfg, tp = models["fp8"]
    prompts = [[5, 6, 7, 8, 9], [11, 12, 13]]
    kw = dict(num_beams=3, max_seq_len=64, block_size=8, burst=4)
    want = jbeam.paged_beam_search(jp, jcfg, prompts, 6, **kw)
    got = tbeam.paged_beam_search(tp, cfg, prompts, 6, device="cpu", **kw)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(np.asarray(got.scores),
                               np.asarray(want.scores), atol=5e-4, rtol=0)
    assert gathers[0] > 0
