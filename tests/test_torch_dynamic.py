"""Port parity: runtime-adaptive outliers (quant/dynamic.py) against the
JAX package on the CPU.

The selection (``dynamic_fp_ind``) is held exactly, ties included: the
seeded state holds each layer's static set at exactly 2 sigma, and both
packages take equal values lower channel first. The adaptive linear's
output is held within 2e-2 of its largest value and the new state's
floats within 2e-2 (both within 1e-5 here: the same f32 absmax); forward
and forward_paged logits within 2e-3 of the largest logit, as
test_torch_model.py holds the static path; the Executor's greedy tokens
and its state against the JAX Executor's after serving, after
``warmup`` (whose own prefills move the state in both packages alike)
and after serving again. The tiny f32 model has both RMSNorm weights of
layer 0 set to 8 at three channels outside the static sets, so those
channels cross sigma and join the selection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.quant import dynamic as jdyn
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.quant import dynamic as tdyn
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor

LOGIT_TOL = 2e-3
FLOAT_TOL = 2e-2
SIGMA = 6.0
PLANTED = [3, 17, 40]
EX_KW = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=16,
             prefill_lanes=2)


def _jcfg(**quant):
    q = dict(algo=JAlgo.INT8_MIX, num_outliers=8, max_outliers=16,
             kv_cache=JKV.INT8, dynamic_outliers=True)
    q.update(quant)
    return JConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=256, dtype=jnp.float32,
                   quant=JQuant(**q))


@pytest.fixture(scope="module")
def model():
    jcfg = _jcfg()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    tp = tllama.init_random_params(cfg, seed=1, device="cpu",
                                   act_scales=acts)
    for norm in ("input_norm", "post_norm"):
        tp["layers"][0][norm]["w"][PLANTED] = 8.0
    return jcfg, _to_jax(tp), cfg, tp


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


def _rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _state_equal(jst, tst):
    assert set(jst) == set(tst)
    for m in jst:
        assert _rel(tst[m].numpy(), jst[m]) <= FLOAT_TOL, m


def _selections(state, cap=16, base_k=8):
    return {m: [tdyn.dynamic_fp_ind(torch.as_tensor(np.asarray(v[li])), cap,
                                    SIGMA, base_k).tolist()
                for li in range(v.shape[0])] for m, v in state.items()}


def _states(n: int, seed: int):
    """A seeded (tied) state: 8 channels at exactly 2 sigma, the rest 0;
    and a planted one: those plus random absmaxes, some above sigma."""
    rng = np.random.default_rng(seed)
    tied = np.zeros((n,), np.float32)
    tied[rng.choice(n, 8, replace=False)] = 2 * SIGMA
    planted = np.maximum(tied, rng.uniform(0, 7, n).astype(np.float32))
    planted[rng.choice(n, 4, replace=False)] = 2 * SIGMA   # more ties
    return {"tied": tied, "planted": planted,
            "all_tied": np.full((n,), 2 * SIGMA, np.float32)}


@pytest.mark.parametrize("cap,n", [(8, 64), (256, 512)])
@pytest.mark.parametrize("kind", ["tied", "planted", "all_tied"])
@pytest.mark.parametrize("base_k", [4, 8])
def test_dynamic_fp_ind_matches_jax(cap, n, kind, base_k):
    chan_max = _states(n, cap + n)[kind]
    want = np.asarray(jdyn.dynamic_fp_ind(jnp.asarray(chan_max), cap, SIGMA,
                                          base_k))
    got = tdyn.dynamic_fp_ind(torch.from_numpy(chan_max), cap, SIGMA, base_k)
    assert got.dtype == torch.int32
    assert got.tolist() == want.tolist()


def test_adaptive_mix_linear_matches_jax(model, rows=24):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(rows)
    x = rng.standard_normal((2, rows, 64)).astype(np.float32)
    x[..., PLANTED[1]] = 20.0                # crosses sigma
    state = _states(64, 5)["tied"]
    jq = jp["layers"]["qkv_proj"]
    jo, jst = jdyn.adaptive_mix_linear(
        jnp.asarray(x), jq["qweight"][0], jq["scale_col"][0],
        jdyn.DynamicOutlierState(jnp.asarray(state)), cap=16, sigma=SIGMA,
        base_k=8, out_dtype=jnp.float32)
    tq = tp["layers"][0]["qkv_proj"]
    to, tst = tdyn.adaptive_mix_linear(
        torch.from_numpy(x), tq["qweight"], tq["scale_col"],
        tdyn.DynamicOutlierState(torch.from_numpy(state)), cap=16,
        sigma=SIGMA, base_k=8, out_dtype=torch.float32)
    assert to.shape == (2, rows, tq["qweight"].shape[1])
    assert _rel(to.numpy(), jo) <= FLOAT_TOL
    assert _rel(tst.chan_max.numpy(), jst.chan_max) <= FLOAT_TOL
    want = jdyn.dynamic_fp_ind(jst.chan_max, 16, SIGMA, 8)
    got = tdyn.dynamic_fp_ind(tst.chan_max, 16, SIGMA, 8)
    assert got.tolist() == np.asarray(want).tolist()
    assert PLANTED[1] in got.tolist()


def test_init_model_state_matches_jax(model):
    jcfg, jp, cfg, tp = model
    jst, tst = jdyn.init_model_state(jp, jcfg), tdyn.init_model_state(tp, cfg)
    assert set(tst) == set(jst) == set(tdyn.MIX_STATE_MODULES)
    for m in jst:
        assert tst[m].dtype == torch.float32
        np.testing.assert_array_equal(tst[m].numpy(), np.asarray(jst[m]))
    # every static channel ranks in, nothing else (no call has run yet)
    for m, sel in _selections(tst).items():
        for li, s in enumerate(sel):
            static = tp["layers"][li][m]["fp_ind"].tolist()
            assert sorted(i for i in s if i >= 0) == sorted(static)


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 256, (2, 16)).astype(np.int32)
    return toks


def test_forward_outlier_state_matches_jax(model, prompts):
    jcfg, jp, cfg, tp = model
    b, s = prompts.shape
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    lens = np.full((b,), s, np.int32)
    jst, tst = jdyn.init_model_state(jp, jcfg), tdyn.init_model_state(tp, cfg)
    jl, _, jns = jcommon.forward(
        jp, jcfg, jnp.asarray(prompts), jnp.asarray(pos),
        jcommon.init_kv_cache(jcfg, b, 32), jnp.asarray(lens),
        full_prefill=True, outlier_state=jst)
    out = tcommon.forward(
        tp, cfg, torch.from_numpy(prompts), torch.from_numpy(pos),
        tcommon.init_kv_cache(cfg, b, 32, device="cpu"),
        torch.from_numpy(lens), full_prefill=True, outlier_state=tst,
        collect_stats=True)
    assert len(out) == 4                   # logits, cache, state, stats
    tl, _, tns, stats = out
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL
    _state_equal(jns, tns)
    sel = _selections(tns)
    assert sel == _selections(jns)
    for m in ("qkv_proj", "gate_up_proj"):  # the planted channels joined
        assert set(PLANTED) <= set(sel[m][0])
    assert set(stats) == {"qkv_proj", "o_proj", "gate_up_proj", "down_proj"}
    # the static path differs at the planted layer
    tl_static, _ = tcommon.forward(
        tp, cfg, torch.from_numpy(prompts), torch.from_numpy(pos),
        tcommon.init_kv_cache(cfg, b, 32, device="cpu"),
        torch.from_numpy(lens), full_prefill=True)
    assert _rel(tl_static.numpy(), jl) > LOGIT_TOL


def test_forward_paged_outlier_state_matches_jax(model, prompts):
    """A prefill chunk moves the state; a decode step (weight-only) passes
    it through unchanged, in both packages."""
    jcfg, jp, cfg, tp = model
    b, s = prompts.shape
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    lens = np.array([16, 11], np.int32)
    table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    jstate = jkv.init_paged_kv(jcfg, 8, 8)
    tstate = tkv.init_paged_kv(cfg, 8, 8, device="cpu")
    jst, tst = jdyn.init_model_state(jp, jcfg), tdyn.init_model_state(tp, cfg)
    jl, jstate, jns = jcommon.forward_paged(
        jp, jcfg, jnp.asarray(prompts), jnp.asarray(pos), jstate,
        jnp.asarray(table), jnp.asarray(lens), outlier_state=jst)
    tl, tstate, tns = tcommon.forward_paged(
        tp, cfg, torch.from_numpy(prompts), torch.from_numpy(pos), tstate,
        torch.from_numpy(table), torch.from_numpy(lens), outlier_state=tst)
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL
    _state_equal(jns, tns)
    assert _selections(tns) == _selections(jns)
    tok = np.array([[5], [6]], np.int32)
    jl, _, jns2 = jcommon.forward_paged(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(lens[:, None]), jstate,
        jnp.asarray(table), jnp.asarray(lens + 1), outlier_state=jns)
    tl, _, tns2 = tcommon.forward_paged(
        tp, cfg, torch.from_numpy(tok), torch.from_numpy(lens[:, None]),
        tstate, torch.from_numpy(table), torch.from_numpy(lens + 1),
        outlier_state=tns)
    assert _rel(tl.numpy(), jl) <= LOGIT_TOL
    for m in tns:
        assert torch.equal(tns2[m], tns[m])
        np.testing.assert_array_equal(np.asarray(jns2[m]), np.asarray(jns[m]))


def test_executor_dynamic_matches_jax(model):
    """Greedy tokens identical to the JAX Executor's and the state equal
    after serving; then warmup, whose own prefills move the state in both
    packages alike, and a second serve over the warmed state."""
    jcfg, jp, cfg, tp = model
    jex = JExecutor(jp, jcfg, seed=0, **EX_KW)
    tex = Executor(tp, cfg, seed=0, device="cpu", **EX_KW)
    _state_equal(jex.ostate, tex.ostate)
    rng = np.random.default_rng(4)
    for serve in range(2):
        if serve:
            before = {m: v.clone() for m, v in tex.ostate.items()}
            jex.warmup()
            tex.warmup()
            _state_equal(jex.ostate, tex.ostate)
            assert any(not torch.equal(before[m], tex.ostate[m])
                       for m in before)
        prompts = [rng.integers(1, 256, n).tolist() for n in (5, 20)]
        jids = [jex.submit(p, max_new_tokens=8) for p in prompts]
        tids = [tex.submit(p, max_new_tokens=8) for p in prompts]
        jdone, tdone = jex.run(), tex.run()
        assert [tdone[r].generated for r in tids] == \
            [jdone[r].generated for r in jids]
        _state_equal(jex.ostate, tex.ostate)
        assert _selections(tex.ostate) == _selections(jex.ostate)
        for m in ("qkv_proj", "gate_up_proj"):
            assert set(PLANTED) <= set(_selections(tex.ostate)[m][0])


def test_dynamic_refusals(model):
    """Speculative serving refuses the dynamic state, as the JAX Executor
    does; int4_mix with dynamic outliers is refused at construction (the
    JAX package fails mid-forward on the packed weight)."""
    jcfg, jp, cfg, tp = model
    ex = Executor(tp, cfg, seed=0, device="cpu", **EX_KW)
    ex.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(ValueError, match="dynamic outliers"):
        ex.run_speculative(tp, cfg, gamma=2)
    with pytest.raises(ValueError, match="int4_mix"):
        ModelConfig.from_dict(_jcfg(algo=JAlgo.INT4_MIX).to_dict())
    static = ModelConfig.from_dict(_jcfg(dynamic_outliers=False).to_dict())
    assert Executor(tp, static, device="cpu", **EX_KW).ostate is None
