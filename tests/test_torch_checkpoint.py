"""Checkpoints are shared between the packages: a directory saved by the
JAX package loads into the port (without the safetensors package) to the
same tensors params_from_numpy gives for the same tree, and one saved by
the port loads into the JAX package bit for bit. Missing tensors raise
with their names; fp8 tensors (the JAX package's ``@e4m3`` U8 bytes) load
as float8_e4m3fn, byte for byte."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import checkpoint as jckpt
from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu_torch.convert import (load_checkpoint,
                                                 params_from_numpy,
                                                 save_checkpoint)
from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as tckpt
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig


def _jcfg(algo=JAlgo.INT8_MIX, **kw):
    return JConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, dtype=jnp.bfloat16,
                   quant=JQuant(algo=algo, num_outliers=8, kv_cache=JKV.INT8),
                   **kw)


@pytest.fixture(scope="module")
def model():
    jcfg = _jcfg()
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(3),
                                   act_scales=acts)
    return jcfg, jp


def _assert_params_equal(a, b):
    assert a.keys() == b.keys()
    for name in a:
        if name == "layers":
            assert len(a[name]) == len(b[name])
            for la, lb in zip(a[name], b[name]):
                _assert_params_equal(la, lb)
            continue
        assert a[name].keys() == b[name].keys(), name
        for leaf in a[name]:
            x, y = a[name][leaf], b[name][leaf]
            assert x.dtype == y.dtype and torch.equal(x, y), (name, leaf)


def test_jax_checkpoint_loads_into_port(model, tmp_path):
    jcfg, jp = model
    jckpt.save_checkpoint(str(tmp_path), jp, jcfg)
    params, cfg = load_checkpoint(str(tmp_path), device="cpu")
    assert cfg == ModelConfig.from_dict(jcfg.to_dict())
    want = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    _assert_params_equal(params, want)
    assert params["layers"][1]["qkv_proj"]["qweight"].dtype == torch.int8
    assert params["embed"]["w"].dtype == torch.bfloat16


def test_port_checkpoint_loads_into_jax_bit_for_bit(model, tmp_path):
    jcfg, jp = model
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    save_checkpoint(str(tmp_path), tp, cfg)
    back, jcfg2 = jckpt.load_checkpoint(str(tmp_path))
    assert jcfg2.to_dict() == jcfg.to_dict()
    flat_want = jckpt._flatten(jp)
    flat_got = jckpt._flatten(back)
    assert flat_got.keys() == flat_want.keys()
    for k, want in flat_want.items():
        got = flat_got[k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(np.asarray(got).view(np.uint8),
                                      np.asarray(want).view(np.uint8),
                                      err_msg=k)
    # and back into the port again
    params, _ = load_checkpoint(str(tmp_path), device="cpu")
    _assert_params_equal(params, tp)


@pytest.mark.parametrize("algo", [JAlgo.W4A16, JAlgo.W4A16_G,
                                  JAlgo.INT4_MIX], ids=lambda a: a.value)
def test_int4_checkpoints_roundtrip_both_ways(algo, tmp_path):
    """Packed int4 checkpoints (qweight_packed, scale_col or scale_g, the
    outliers of int4_mix; group size 32): JAX -> port equals
    params_from_numpy of the same tree, port -> JAX bit for bit."""
    jcfg = JConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, dtype=jnp.bfloat16,
                   quant=JQuant(algo=algo, num_outliers=8, group_size=32))
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(5))
    jckpt.save_checkpoint(str(tmp_path / "j"), jp, jcfg)
    params, cfg = load_checkpoint(str(tmp_path / "j"), device="cpu")
    assert cfg == ModelConfig.from_dict(jcfg.to_dict())
    want = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    _assert_params_equal(params, want)
    layer = params["layers"][0]
    assert layer["qkv_proj"]["qweight_packed"].shape == (32, cfg.qkv_out)
    assert ("scale_g" in layer["down_proj"]) == (algo == JAlgo.W4A16_G)

    save_checkpoint(str(tmp_path / "t"), params, cfg)
    back, jcfg2 = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert jcfg2.to_dict() == jcfg.to_dict()
    flat_want, flat_got = jckpt._flatten(jp), jckpt._flatten(back)
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_got[k]).view(np.uint8),
                                      np.asarray(w).view(np.uint8),
                                      err_msg=k)


def test_missing_tensor_raises_with_its_name(model, tmp_path):
    jcfg, jp = model
    tree = jax.tree.map(lambda a: a, jp)
    tree["layers"] = dict(jp["layers"])
    tree["layers"]["o_proj"] = {k: v for k, v in jp["layers"]["o_proj"].items()
                                if k != "fp_weight"}
    jckpt.save_checkpoint(str(tmp_path), tree, jcfg)
    with pytest.raises(ValueError, match="layers.o_proj.fp_weight"):
        load_checkpoint(str(tmp_path), device="cpu")
    with open(os.path.join(tmp_path, "config.json")) as f:
        d = json.load(f)
    d["num_layers"] = 3
    with open(os.path.join(tmp_path, "config.json"), "w") as f:
        json.dump(d, f)
    jckpt.save_checkpoint(str(tmp_path / "full"), jp, jcfg)
    with open(os.path.join(tmp_path, "full", "config.json"), "w") as f:
        json.dump(d, f)
    with pytest.raises(ValueError, match="2 stacked layers"):
        load_checkpoint(str(tmp_path / "full"), device="cpu")


def test_fp8_tensors_are_the_fp8_slice(tmp_path):
    """An fp8 checkpoint of the JAX package loads: its @e4m3 tensors as
    float8_e4m3fn with the same bytes, the rest as params_from_numpy."""
    jcfg = _jcfg(algo=JAlgo.FP8)
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(4))
    jckpt.save_checkpoint(str(tmp_path), jp, jcfg)
    got, cfg = load_checkpoint(str(tmp_path), device="cpu")
    assert cfg == ModelConfig.from_dict(jcfg.to_dict())
    for i, layer in enumerate(got["layers"]):
        q = layer["qkv_proj"]["qweight"]
        assert q.dtype == torch.float8_e4m3fn
        np.testing.assert_array_equal(
            q.view(torch.uint8).numpy(),
            np.asarray(jp["layers"]["qkv_proj"]["qweight"][i]).view(np.uint8))


def test_safetensors_roundtrip_of_every_dtype(tmp_path):
    ts = {"a.bf16": torch.randn(3, 5).bfloat16(),
          "a.f32": torch.randn(7),
          "b.i8": torch.randint(-127, 128, (4, 2), dtype=torch.int8),
          "b.i32": torch.arange(6, dtype=torch.int32).reshape(2, 3),
          "c.empty": torch.zeros((0, 4))}
    path = str(tmp_path / "t.safetensors")
    tckpt.write_safetensors(path, ts)
    back = tckpt.read_safetensors(path)
    assert back.keys() == ts.keys()
    for k, t in ts.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k
