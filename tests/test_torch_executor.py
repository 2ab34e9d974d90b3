"""Port parity, end of the main path: the port's Executor on the CPU gives
greedy tokens identical to the JAX Executor on an f32 int8_mix / int8-KV
tiny Llama, for ragged requests, chunked prefill of prompts longer than
prefill_chunk, and max_kv_tokens preemption. Both get the same block_size
and prefill_chunk. Plus the per-lane sampler against the JAX sampler."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import sampler as jsampler
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import sampler as tsampler
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor


@pytest.fixture(scope="module")
def model():
    jcfg = JConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=256, dtype=jnp.float32,
                   quant=JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                kv_cache=JKV.INT8))
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(1),
                                   act_scales=acts)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp, {}


def _jex(model, kw):
    """The JAX Executor of ``kw``, reset to a fresh one's host state with
    its compiled programs kept, as tests/test_torch_executor_serving.py
    resets its own."""
    jcfg, jp, _, _, made = model
    key = tuple(sorted(kw.items()))
    if key not in made:
        made[key] = JExecutor(jp, jcfg, seed=0, **kw)
        return made[key]
    ex = made[key]
    assert not kw.get("window_blocks"), "reset the manager's window too"
    ex.queue.clear()
    ex.prefilling.clear()
    ex.slots = [None] * ex.max_batch
    ex.bm = type(ex.bm)(ex.bm.num_blocks, ex.block_size)
    ex.finished, ex._next_id, ex.preemptions = {}, 0, 0
    ex.iteration_stats.clear()
    ex._iter_id = 0
    ex.key = jax.random.PRNGKey(0)
    return ex


def _serve_both(model, prompts, max_new, priorities=None, request_kw=None,
                **kw):
    jcfg, jp, cfg, tp, _ = model
    jex = _jex(model, kw)
    tex = Executor(tp, cfg, seed=0, device="cpu", **kw)
    pr = priorities or [0.5] * len(prompts)
    rkw = request_kw or {}
    jids = [jex.submit(p, max_new_tokens=max_new, priority=q, **rkw)
            for p, q in zip(prompts, pr)]
    tids = [tex.submit(p, max_new_tokens=max_new, priority=q, **rkw)
            for p, q in zip(prompts, pr)]
    jdone, tdone = jex.run(), tex.run()
    want = [jdone[r].generated for r in jids]
    got = [tdone[r].generated for r in tids]
    return jex, tex, want, got, tdone, tids


def test_ragged_requests_token_identical(model):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, 256, n).tolist() for n in (5, 13, 30, 9, 21,
                                                          2)]
    _, tex, want, got, done, ids = _serve_both(
        model, prompts, 10, max_batch=4, max_seq_len=64, block_size=8,
        prefill_chunk=32)
    assert got == want
    assert all(len(done[r].generated) == 10 for r in ids)
    assert all(np.isfinite(done[r].logprobs).all() for r in ids)


def test_chunked_prefill_token_identical(model):
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (40, 55, 17)]
    _, _, want, got, _, _ = _serve_both(
        model, prompts, 8, max_batch=3, max_seq_len=72, block_size=8,
        prefill_chunk=16, prefill_lanes=2)
    assert got == want


def test_finish_controls_token_identical(model):
    """eos with min_new_tokens (eos suppressed until then) and stop
    sequences end requests at the same token in both executors."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, 256, n).tolist() for n in (9, 20)]
    kw = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=16)
    _, _, free, _, _, _ = _serve_both(model, prompts, 12, **kw)
    request_kw = dict(eos_token_id=free[1][1], min_new_tokens=3,
                      stop_sequences=[free[0][2:4]])
    _, _, want, got, done, ids = _serve_both(model, prompts, 12,
                                             request_kw=request_kw, **kw)
    assert got == want
    assert len(got[0]) <= 4 and all(done[r].done for r in ids)


def test_windowed_kv_token_identical(model):
    """StreamingLLM windows: pages recycle in place once a sequence
    outgrows sink + window, and block_pos keeps the masks right."""
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, 256, n).tolist() for n in (30, 12)]
    _, _, want, got, _, _ = _serve_both(
        model, prompts, 24, max_batch=2, max_seq_len=64, block_size=8,
        prefill_chunk=16, sink_blocks=1, window_blocks=2)
    assert got == want


def test_preemption_token_identical(model):
    """A pool too small for both horizons (5 usable blocks): the
    low-priority request is preempted and replayed in both executors."""
    prompts = [list(range(1, 11)), list(range(20, 30))]
    jex, tex, want, got, done, ids = _serve_both(
        model, prompts, 20, priorities=[0.9, 0.1], max_batch=2,
        max_seq_len=64, block_size=8, prefill_chunk=8, max_kv_tokens=40)
    assert tex.preemptions > 0 and jex.preemptions == tex.preemptions
    assert got == want
    assert done[ids[1]].prompt == prompts[1]
    assert len(done[ids[1]].logprobs) == 20


def test_sampler_greedy_controls_match_jax():
    rng = np.random.default_rng(4)
    b, v = 5, 40
    logits = rng.standard_normal((b, v)).astype(np.float32) * 3
    history = rng.integers(-1, v, (b, 8)).astype(np.int32)
    sup_tok = np.array([-1, int(np.argmax(logits[1])), 3, -1, 7], np.int32)
    sup_flag = np.array([0, 1, 1, 0, 0], np.int32)
    cfgs_j = [jsampler.SamplingConfig(repetition_penalty=r)
              for r in (1.0, 1.3, 2.0, 1.0, 1.5)]
    cfgs_t = [tsampler.SamplingConfig(repetition_penalty=r)
              for r in (1.0, 1.3, 2.0, 1.0, 1.5)]
    want = jsampler.sample_batched(
        jnp.asarray(logits), jax.random.PRNGKey(0),
        jsampler.batch_params(cfgs_j), history=jnp.asarray(history),
        suppress_token=jnp.asarray(sup_tok),
        suppress_flag=jnp.asarray(sup_flag))
    gen = torch.Generator().manual_seed(0)
    got = tsampler.sample_batched(
        torch.from_numpy(logits), gen, tsampler.batch_params(cfgs_t),
        history=torch.from_numpy(history),
        suppress_token=torch.from_numpy(sup_tok),
        suppress_flag=torch.from_numpy(sup_flag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) != int(np.argmax(logits[1]))


def test_sampler_stochastic_lanes():
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(
        np.float32))
    cfgs = [tsampler.SamplingConfig(greedy=False, top_k=1),
            tsampler.SamplingConfig(greedy=False, top_k=5),
            tsampler.SamplingConfig(greedy=False, top_p=0.01),
            tsampler.SamplingConfig()]
    gen = torch.Generator().manual_seed(0)
    for _ in range(20):
        tok = tsampler.sample_batched(logits, gen,
                                      tsampler.batch_params(cfgs))
        top5 = torch.topk(logits[1], 5).indices.tolist()
        assert int(tok[0]) == int(logits[0].argmax())
        assert int(tok[1]) in top5
        assert int(tok[2]) == int(logits[2].argmax())
        assert int(tok[3]) == int(logits[3].argmax())
