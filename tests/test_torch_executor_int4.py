"""Port parity on the int4 serving path: the port's Executor on the CPU
gives greedy tokens identical to the JAX Executor on f32 tiny Llamas with
packed int4 weights and an unquantized KV pool (``kv_cache`` none: pages
of the model dtype, bf16 in production, f32 here). w4a16 in the ragged
and the chunked-prefill settings, w4a16_g (groups of 32) and int4_mix (8
outliers) in one setting each. Both executors get the same block_size and
prefill_chunk."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor


@functools.lru_cache(maxsize=None)
def _model(algo):
    jcfg = JConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=256, dtype=jnp.float32,
                   quant=JQuant(algo=algo, num_outliers=8, group_size=32))
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(1),
                                   act_scales=acts)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert "qweight_packed" in tp["layers"][0]["qkv_proj"]
    return jcfg, jp, cfg, tp


def _serve_both(algo, prompts, max_new, **kw):
    jcfg, jp, cfg, tp = _model(algo)
    jex = JExecutor(jp, jcfg, seed=0, **kw)
    tex = Executor(tp, cfg, seed=0, device="cpu", **kw)
    jids = [jex.submit(p, max_new_tokens=max_new) for p in prompts]
    tids = [tex.submit(p, max_new_tokens=max_new) for p in prompts]
    jdone, tdone = jex.run(), tex.run()
    assert tex.state.k.dtype == tex.state.v.dtype and not tex.state.quantized
    return ([jdone[r].generated for r in jids],
            [tdone[r].generated for r in tids], tdone, tids)


def test_w4a16_ragged_requests_token_identical():
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 13, 30, 9, 21,
                                                          2)]
    want, got, done, ids = _serve_both(JAlgo.W4A16, prompts, 10, max_batch=4,
                                       max_seq_len=64, block_size=8,
                                       prefill_chunk=32)
    assert got == want
    assert all(len(done[r].generated) == 10 for r in ids)
    assert all(np.isfinite(done[r].logprobs).all() for r in ids)


def test_w4a16_chunked_prefill_token_identical():
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (40, 55, 17)]
    want, got, _, _ = _serve_both(JAlgo.W4A16, prompts, 8, max_batch=3,
                                  max_seq_len=72, block_size=8,
                                  prefill_chunk=16, prefill_lanes=2)
    assert got == want


@pytest.mark.parametrize("algo", [JAlgo.W4A16_G, JAlgo.INT4_MIX],
                         ids=lambda a: a.value)
def test_grouped_and_mix_int4_token_identical(algo):
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, 256, n).tolist() for n in (7, 26, 12)]
    want, got, _, _ = _serve_both(algo, prompts, 8, max_batch=3,
                                  max_seq_len=64, block_size=8,
                                  prefill_chunk=16)
    assert got == want
