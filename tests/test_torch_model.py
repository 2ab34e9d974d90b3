"""Port parity: params conversion, quantization routing and forward_paged
logits of mixq_tensorrt_llm_tpu_torch against the JAX package on a tiny
f32 int8_mix / int8-KV Llama.

Logits tolerance: 2e-3 of the largest |logit|. Both sides compute in f32
from the same int8 weights; what differs is summation order and ulp-level
rsqrt/pow differences, which can move an int8 activation or KV value by
one step (1/127 of its row's scale) — about 1e-3 at these sizes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv

LOGIT_TOL = 2e-3


def tiny_jax_cfg(**kw):
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                max_position_embeddings=256, dtype=jnp.float32,
                quant=JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                             kv_cache=JKV.INT8))
    base.update(kw)
    return JConfig(**base)


def act_scales(cfg, seed=0):
    """Distinct calibration absmaxes (no top-k ties)."""
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(cfg.num_layers):
        for name, n in (("self_attn.q_proj", cfg.hidden_size),
                        ("self_attn.o_proj", cfg.q_size),
                        ("mlp.gate_proj", cfg.hidden_size),
                        ("mlp.down_proj", cfg.intermediate_size)):
            out[f"model.layers.{i}.{name}"] = (rng.permutation(n) + 1).astype(
                np.float32)
    return out


@pytest.fixture(scope="module")
def model():
    jcfg = tiny_jax_cfg()
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(0),
                                   act_scales=act_scales(jcfg))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


def test_config_roundtrip_and_unported_axes():
    jcfg = tiny_jax_cfg(qkv_bias=True, sliding_window=32)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    assert cfg.dtype == torch.float32 and cfg.qkv_bias
    assert cfg.sliding_window == 32
    assert cfg.quant.to_dict() == jcfg.quant.to_dict()
    # the dense family axes round-trip (models/families.py), the expert
    # axes and the recurrent-state models' (models/mamba.py,
    # models/recurrentgemma.py)
    for axis in (dict(norm_type="layernorm"), dict(pos_embedding="alibi"),
                 dict(parallel_blocks=True, shared_block_norm=True),
                 dict(rope_scaling_type="yarn", rope_attention_factor=1.2),
                 dict(rope_scaling_type="longrope",
                      rope_freq_factors=(1.0,) * 8)):
        jd = tiny_jax_cfg(**axis).to_dict()
        assert ModelConfig.from_dict(jd).to_dict() == jd
    jd = tiny_jax_cfg(num_experts=4).to_dict()     # models/moe.py
    assert ModelConfig.from_dict(jd).to_dict() == jd
    for axis in (dict(arch="mamba", ssm_state_size=8, dt_rank=4,
                      conv_kernel=3, use_conv_bias=False),
                 dict(arch="recurrentgemma", num_layers=3, conv_kernel=4)):
        jd = tiny_jax_cfg(**axis).to_dict()
        assert ModelConfig.from_dict(jd).to_dict() == jd


def test_params_from_numpy_checks_schema(model):
    jcfg, jp, cfg, tp = model
    assert len(tp["layers"]) == cfg.num_layers
    l0 = tp["layers"][0]
    assert l0["qkv_proj"]["qweight"].dtype == torch.int8
    assert l0["qkv_proj"]["fp_weight"].dtype == torch.bfloat16
    assert l0["down_proj"].keys() == {"qweight", "scale_col"}
    np.testing.assert_array_equal(
        l0["gate_up_proj"]["qweight"].numpy(),
        np.asarray(jp["layers"]["gate_up_proj"]["qweight"][0]))
    tree = jax.tree.map(np.asarray, jp)
    bad = dict(tree, layers=dict(tree["layers"]))
    bad["layers"]["o_proj"] = dict(tree["layers"]["o_proj"])
    bad["layers"]["o_proj"]["scale_col"] = \
        tree["layers"]["o_proj"]["scale_col"].astype(np.float16)
    with pytest.raises(ValueError, match="o_proj.scale_col"):
        params_from_numpy(bad, cfg, device="cpu")
    with pytest.raises(ValueError, match="keys"):
        params_from_numpy({k: v for k, v in tree.items() if k != "lm_head"},
                          cfg, device="cpu")


def test_quantize_layer_matches_jax():
    """The port's quantization routing gives the JAX package's params
    bit for bit from the same float weights and act_scales."""
    jcfg = tiny_jax_cfg()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(1)
    fl = {"qkv_proj": (64, jcfg.qkv_out), "o_proj": (64, 64),
          "gate_up_proj": (64, 256), "down_proj": (128, 64)}
    fl = {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
          for k, s in fl.items()}
    fl["input_norm"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    fl["post_norm"] = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    acts = act_scales(jcfg, seed=2)
    jl = jllama._quantize_layer(jcfg, {k: jnp.asarray(v)
                                       for k, v in fl.items()}, acts, 1)
    tl = tllama._quantize_layer(cfg, {k: torch.from_numpy(v)
                                      for k, v in fl.items()}, acts, 1)
    assert jl.keys() == tl.keys()
    for mod in jl:
        assert jl[mod].keys() == tl[mod].keys(), mod
        for leaf in jl[mod]:
            np.testing.assert_array_equal(
                tl[mod][leaf].float().numpy(),
                np.asarray(jl[mod][leaf], np.float32), err_msg=f"{mod}.{leaf}")


@pytest.mark.parametrize("algo", [JAlgo.W4A16, JAlgo.W4A16_G,
                                  JAlgo.INT4_MIX], ids=lambda a: a.value)
def test_quantize_layer_int4_matches_jax(algo):
    """The int4 algos' layers (packed weights, group_size passed through)
    equal the JAX package's bit for bit."""
    jcfg = tiny_jax_cfg(quant=JQuant(algo=algo, num_outliers=8,
                                     group_size=32))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    rng = np.random.default_rng(7)
    fl = {"qkv_proj": (64, jcfg.qkv_out), "o_proj": (64, 64),
          "gate_up_proj": (64, 256), "down_proj": (128, 64)}
    fl = {k: (rng.standard_normal(s) * 0.02).astype(np.float32)
          for k, s in fl.items()}
    fl["input_norm"] = fl["post_norm"] = np.ones(64, np.float32)
    acts = act_scales(jcfg, seed=8)
    jl = jllama._quantize_layer(jcfg, {k: jnp.asarray(v)
                                       for k, v in fl.items()}, acts, 0)
    tl = tllama._quantize_layer(cfg, {k: torch.from_numpy(v)
                                      for k, v in fl.items()}, acts, 0)
    assert "qweight_packed" in tl["down_proj"]
    for mod in jl:
        assert jl[mod].keys() == tl[mod].keys(), mod
        for leaf in jl[mod]:
            np.testing.assert_array_equal(
                tl[mod][leaf].float().numpy(),
                np.asarray(jl[mod][leaf], np.float32), err_msg=f"{mod}.{leaf}")


def test_forward_paged_w4a16_unquantized_kv_matches_jax():
    """w4a16 with packed weights over an unquantized (f32) pool: a prefill
    chunk and a decode step against JAX's forward_paged."""
    jcfg = tiny_jax_cfg(quant=JQuant(algo=JAlgo.W4A16))
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(9))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(10)
    b, c = 2, 16
    tokens = rng.integers(1, 256, (b, c)).astype(np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    lens = np.array([16, 11], np.int32)
    dec_tok = rng.integers(1, 256, (b, 1)).astype(np.int32)
    chunks = [(tokens, pos, lens, lens - 1),
              (dec_tok, lens[:, None].astype(np.int32), lens + 1, None)]
    for want, got in _run_both(jcfg, jp, cfg, tp, chunks):
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, err


def test_rope_matches_jax():
    pos = np.arange(40, dtype=np.int32).reshape(2, 20) * 7
    for scaling in (dict(), dict(rope_scaling_type="llama3",
                                 rope_scaling_factor=8.0)):
        jcfg = tiny_jax_cfg(**scaling)
        cfg = ModelConfig.from_dict(jcfg.to_dict())
        js, jc = jcommon.rope_sin_cos(jnp.asarray(pos), 16, 10000.0, cfg=jcfg)
        ts, tc = tcommon.rope_sin_cos(torch.from_numpy(pos), 16, 10000.0,
                                      cfg=cfg)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-4)
    x = np.random.default_rng(3).standard_normal((2, 20, 4, 16)).astype(
        np.float32)
    np.testing.assert_allclose(
        tcommon.apply_rope(torch.from_numpy(x), ts, tc).numpy(),
        np.asarray(jcommon.apply_rope(jnp.asarray(x), js, jc)), atol=1e-4)


def _run_both(jcfg, jp, cfg, tp, chunks, block_size=8, num_blocks=12):
    """Feed the same (tokens, positions, lens, last_pos) calls through both
    forward_paged implementations over their own pools; return logits."""
    b = chunks[0][0].shape[0]
    mb = 4
    table = np.arange(1, b * mb + 1, dtype=np.int32).reshape(b, mb)
    bpos = np.tile(np.arange(mb, dtype=np.int32) * block_size, (b, 1))
    jstate = jkv.init_paged_kv(jcfg, num_blocks, block_size)
    tstate = tkv.init_paged_kv(cfg, num_blocks, block_size, device="cpu")
    outs = []
    for tokens, pos, lens, last in chunks:
        jl, jstate = jcommon.forward_paged(
            jp, jcfg, jnp.asarray(tokens), jnp.asarray(pos), jstate,
            jnp.asarray(table), jnp.asarray(lens),
            block_pos=jnp.asarray(bpos),
            last_pos=None if last is None else jnp.asarray(last))
        tl, tstate = tcommon.forward_paged(
            tp, cfg, torch.from_numpy(tokens), torch.from_numpy(pos), tstate,
            torch.from_numpy(table), torch.from_numpy(lens),
            block_pos=torch.from_numpy(bpos),
            last_pos=None if last is None else torch.from_numpy(last))
        outs.append((np.asarray(jl), tl.numpy()))
    return outs


def test_forward_paged_logits_match_jax(model):
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(4)
    b, c = 2, 16
    tokens = rng.integers(1, 256, (b, c)).astype(np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    lens = np.array([16, 11], np.int32)
    # a full-chunk prefill, then last-position-only, then one decode step
    dec_tok = rng.integers(1, 256, (b, 1)).astype(np.int32)
    dec_pos = lens[:, None].astype(np.int32)
    chunks = [(tokens, pos, lens, None),
              (tokens, pos, lens, lens - 1),
              (dec_tok, dec_pos, lens + 1, None)]
    for want, got in _run_both(jcfg, jp, cfg, tp, chunks):
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, err
        assert np.isfinite(got).all()


def test_forward_paged_matches_jax_pallas_backend(monkeypatch):
    """The port's linears are the JAX package's ``pallas`` routing (K1 ->
    K2 for mix, K4 for W8A16): its forward_paged against JAX's under
    MIXQ_BACKEND=pallas, whose Pallas kernels run in interpret mode here.
    Widths are multiples of 128 (the Pallas wrappers assert it) and differ
    from every other test in this file, so no jitted trace made under the
    default backend is reused."""
    from mixq_tensorrt_llm_tpu.ops import dispatch as jdispatch
    jcfg = tiny_jax_cfg(hidden_size=128, intermediate_size=256, head_dim=32)
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(5),
                                   act_scales=act_scales(jcfg, seed=5))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(6)
    b, c = 2, 16
    tokens = rng.integers(1, 256, (b, c)).astype(np.int32)
    pos = np.tile(np.arange(c, dtype=np.int32), (b, 1))
    lens = np.array([16, 11], np.int32)
    dec_tok = rng.integers(1, 256, (b, 1)).astype(np.int32)
    chunks = [(tokens, pos, lens, lens - 1),
              (dec_tok, lens[:, None].astype(np.int32), lens + 1, None)]
    monkeypatch.setenv("MIXQ_BACKEND", "pallas")
    jdispatch.default_backend.cache_clear()
    try:
        outs = _run_both(jcfg, jp, cfg, tp, chunks)
    finally:
        jdispatch.default_backend.cache_clear()
    for want, got in outs:
        assert got.shape == want.shape
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= LOGIT_TOL, err
        assert np.isfinite(got).all()


def test_init_random_params_schema():
    jcfg = tiny_jax_cfg()
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    p = tllama.init_random_params(cfg, seed=0, device="cpu",
                                  act_scales=act_scales(jcfg))
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(0))
    assert p.keys() == jp.keys()
    for mod, leaves in p["layers"][0].items():
        for leaf, t in leaves.items():
            j = jp["layers"][mod][leaf]
            assert tuple(t.shape) == j.shape[1:], (mod, leaf)
            assert str(t.dtype).split(".")[1] == str(j.dtype), (mod, leaf)
    again = tllama.init_random_params(cfg, seed=0, device="cpu",
                                      act_scales=act_scales(jcfg))
    assert torch.equal(again["embed"]["w"], p["embed"]["w"])
