"""Port parity of the Executor's decode bursts, mixed bursts and warmup:
on the CPU, ``run(burst=k)``, ``run(burst, mixed_burst)`` (through
``step_serving``) give greedy tokens identical to the JAX Executor's on
the f32 int8_mix / int8-KV tiny Llama of test_torch_executor.py, both
Executors with the same block_size and prefill_chunk: bursts against
single steps, eos / max_new_tokens / min_new_tokens inside a burst, the
repetition penalty's history carried through a burst, preemption under
KV pressure while bursting, the adaptive pow2 tail and
mixed bursts behind admission waves. Burst log-probabilities equal the
single-step ones within 1e-5; warmup leaves no residue, and after
``warmup(burst=4)`` a mixed workload makes no new program while a rung
warmup never made is counted (utils/compile_watch)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import (Executor,
                                                           pow2_floor)
from mixq_tensorrt_llm_tpu_torch.utils import compile_watch

SMALL = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=8)
WIDE = dict(max_batch=4, max_seq_len=64, block_size=8, prefill_chunk=8,
            prefill_lanes=2)
TIGHT = dict(SMALL, max_kv_tokens=40)       # 5 usable blocks


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
    # one JAX Executor per configuration, reused between serves (its
    # programs are compiled once)
    return jcfg, jp, cfg, tp, {}


def _jax_ex(model, kw):
    jcfg, jp, _, _, cache = model
    key = tuple(sorted(kw.items()))
    if key not in cache:
        cache[key] = JExecutor(jp, jcfg, seed=0, **kw)
    return cache[key]


def _serve(ex, requests, **run_kw):
    """Submit (prompt, max_new, request kwargs) triples, run; returns
    (generated lists, logprob lists, finished requests in order). A
    ``repetition_penalty`` kwarg becomes the request's SamplingConfig of
    the Executor's own package."""
    config = (jsampler if isinstance(ex, JExecutor)
              else tsampler).SamplingConfig

    def kwargs(rkw):
        rkw = dict(rkw)
        if "repetition_penalty" in rkw:
            rkw["sampling"] = config(
                repetition_penalty=rkw.pop("repetition_penalty"))
        return rkw

    ids = [ex.submit(p, max_new_tokens=n, **kwargs(rkw))
           for p, n, rkw in requests]
    done = ex.run(**run_kw)
    reqs = [done[r] for r in ids]
    return [r.generated for r in reqs], [r.logprobs for r in reqs], reqs


def _port(model, kw):
    return Executor(model[3], model[2], seed=0, device="cpu", **kw)


def _ragged(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 256, n).tolist() for n in lens]


CASES = {
    # test_paged_executor.py TestBurstDecode: burst against single steps
    "burst4": (WIDE, [([1, 2, 3, 4], 10, {}), ([9, 8, 7], 10, {}),
                      ([5, 5, 5, 5, 5], 10, {})], dict(burst=4)),
    # test_preemption.py: the adaptive tail (8 -> a 4-burst, then steps)
    "tail8": (SMALL, [([1, 2, 3], 5, {})], dict(burst=8)),
    # test_preemption.py: preemption while bursting
    "preempt4": (TIGHT, [(list(range(1, 11)), 20, {}),
                         (list(range(20, 30)), 20, {})], dict(burst=4)),
    # the repetition penalty's history carried through a burst
    "penalty4": (SMALL, [([1, 2, 3], 12, {"repetition_penalty": 1.5}),
                         ([5, 5, 5, 5, 5], 12, {"repetition_penalty": 1.5})],
                 dict(burst=4)),
    # mixed bursts behind admission waves: 6 requests, 2 prefill lanes
    "mixed4": (WIDE, [(p, 12, {}) for p in _ragged(3, (5, 13, 30, 9, 21,
                                                       2))],
               dict(burst=4, mixed_burst=4)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_burst_tokens_match_jax(model, case):
    kw, requests, run_kw = CASES[case]
    want, _, _ = _serve(_jax_ex(model, kw), requests, **run_kw)
    tex = _port(model, kw)
    got, lps, reqs = _serve(tex, requests, **run_kw)
    assert got == want
    assert all(r.done and len(g) == n for r, g, (_, n, _) in
               zip(reqs, got, requests))
    assert all(len(lp) == len(g) and np.isfinite(lp).all()
               for lp, g in zip(lps, got))
    burst = run_kw["burst"]
    assert tex.decode_steps > tex.decode_calls   # bursts ran
    assert {k for k, *_ in tex._rungs} <= {1} | {
        1 << i for i in range(1, burst.bit_length())}
    if case == "burst4":
        single, _, _ = _serve(_port(model, kw), requests)
        assert got == single
    if case == "preempt4":
        assert tex.preemptions > 0
        assert reqs[1].prompt == requests[1][0]
        assert len(reqs[1].logprobs) == 20


# (index of the eos in the free run, min_new_tokens, burst)
CONTROLS = {"eos": (4, 0, 4),          # eos inside a burst
            "min_new": (1, 5, 3),      # banned until 5 tokens
            "min_new_lifts": (2, 4, 4)}  # the ban lifts inside a burst


@pytest.mark.parametrize("control", sorted(CONTROLS))
def test_burst_finish_controls_match_jax(model, control):
    """eos inside a burst ends the request at that token (max 9); with
    min_new_tokens the eos is banned until then, also where the ban lifts
    between two steps of one burst (the countdown carried on the
    device)."""
    base, _, _ = _serve(_jax_ex(model, SMALL), [([1, 2, 3], 9, {})])
    idx, min_new, burst = CONTROLS[control]
    eos = base[0][idx]
    requests = [([1, 2, 3], 9, dict(eos_token_id=eos,
                                    min_new_tokens=min_new))]
    want, _, _ = _serve(_jax_ex(model, SMALL), requests, burst=burst)
    got, _, _ = _serve(_port(model, SMALL), requests, burst=burst)
    assert got == want
    if min_new == 0:
        assert got[0][-1] == eos and eos not in got[0][:-1]
    else:
        assert len(got[0]) >= min_new and eos not in got[0][:min_new - 1]


def test_burst_logprobs_match_single_steps(model):
    """test_executor_sampling.py: a burst records the log-probabilities
    of the single-step run (here within 1e-5: the same ops in the same
    order)."""
    requests = [([3, 1, 4], 10, {})]
    kw = dict(SMALL, max_batch=1)
    g1, lp1, _ = _serve(_port(model, kw), requests)
    g4, lp4, _ = _serve(_port(model, kw), requests, burst=4)
    assert g1 == g4
    np.testing.assert_allclose(lp4[0], lp1[0], rtol=0, atol=1e-5)
    assert all(lp <= 0.0 for lp in lp4[0])


def test_warmup_leaves_no_residue(model):
    """test_paged_executor.py: warmup() finishes its dummy requests,
    returns every page, and later requests get the tokens a cold
    Executor (and the JAX one) gives."""
    ex = _port(model, SMALL)
    ex.warmup(burst=2)
    assert not ex.finished and ex.num_active == 0 and not ex.has_work
    assert ex.bm.num_free == ex.bm.num_blocks - 1
    assert {k for k, *_ in ex._rungs} == {1, 2}
    requests = [([1, 2, 3], 5, {})]
    got, _, _ = _serve(ex, requests)
    cold, _, _ = _serve(_port(model, SMALL), requests)
    want, _, _ = _serve(_jax_ex(model, SMALL), requests)
    assert got == cold == want


def test_no_programs_after_warmup(model):
    """test_compile_watch.py: after warmup(burst=4) a mixed workload
    (ragged prompts, staggered budgets for the tail rungs, admission
    waves through the prefill lanes) makes no new program and loads no
    kernel library; a rung that warmup never made is counted."""
    kw = dict(max_batch=4, max_seq_len=128, block_size=8, prefill_chunk=8,
              prefill_lanes=2)
    ex = _port(model, kw)
    assert ex.compiles_since_warmup is None
    assert ex.cache_loads_since_warmup is None
    ex.warmup(burst=4)
    assert ex.compiles_since_warmup == 0
    assert ex.cache_loads_since_warmup == 0
    for prompts, budgets, burst in [
        ([[1, 2, 3], [7, 8]], [5, 5], 4),
        ([[4, 5, 6, 7, 8, 9], [2], [3, 3, 3]], [7, 6, 3], 4),
        ([[9] * 10], [4], 2),
        ([[1], [2], [3], [4]], [1, 1, 1, 1], 1),
    ]:
        _serve(ex, [(p, b, {}) for p, b in zip(prompts, budgets)],
               burst=burst)
    assert ex.compiles_since_warmup == 0, \
        "a serving shape slipped past warmup's enumeration"
    assert ex.cache_loads_since_warmup == 0

    cold = _port(model, kw)
    cold.warmup(burst=1)          # rung 1 only
    before = compile_watch.compile_count()
    _serve(cold, [([1, 2, 3], 9, {})], burst=4)
    assert cold.compiles_since_warmup > 0
    assert compile_watch.compile_count() > before


@pytest.mark.parametrize("n,want", [(1, 1), (2, 2), (3, 2), (16, 16),
                                    (17, 16)])
def test_pow2_floor(n, want):
    assert pow2_floor(n) == want
