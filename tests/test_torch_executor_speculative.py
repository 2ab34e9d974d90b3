"""Port parity, speculative decoding and split-KV decode: the port's
Executor.run_speculative on the CPU gives greedy tokens identical to the
JAX Executor's, with the same spec_rounds, on tiny f32 models (the
settings of tests/test_executor_speculative.py): a mixed batch with a
separately initialised 1-layer draft, self-draft, eos inside a round, a
lane near the context cap, an int8_mix / int8-KV self-draft, and
host-paced (rounds_per_call=1) against device-paced rounds. The draft
carries a paged pool of its own through the target's block tables. Plus
MIXQ_KV_SPLITS=2 on the port's plain run (the split-and-merge decode):
the same tokens as without it and as the JAX Executor's. Each JAX
Executor is made once per configuration and reset between cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime.sampler import SamplingConfig
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor

KW = dict(max_batch=3, max_seq_len=64, block_size=8, prefill_chunk=8)


def _jcfg(layers=2, **kw):
    return JConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=layers, num_heads=4, num_kv_heads=2,
                   head_dim=16, max_position_embeddings=128,
                   dtype=jnp.float32, **kw)


def _both(jcfg, seed):
    """(JAX params, JAX config, port params, port config) from one init."""
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(seed))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    return jp, jcfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       device="cpu"), cfg


@pytest.fixture(scope="module")
def models():
    """The target (2 layers), a separately initialised 1-layer draft (as
    the JAX tests' tiny_cfg(layers=1) with PRNGKey(5)), an int8_mix /
    int8-KV target, and the JAX Executors made so far ("jex")."""
    return dict(
        target=_both(_jcfg(), 0), draft=_both(_jcfg(layers=1), 5),
        int8=_both(_jcfg(quant=JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                      kv_cache=JKV.INT8)), 0), jex={})


def _jex(models, target, kw):
    """The JAX Executor of (target, kw), reset to a fresh one's host state
    with its compiled programs kept (a new one compiles them all again),
    as tests/test_torch_executor_serving.py resets its own."""
    jp, jcfg = models[target][:2]
    key = (target,) + tuple(sorted(kw.items()))
    if key not in models["jex"]:
        models["jex"][key] = JExecutor(jp, jcfg, seed=0, **kw)
        return models["jex"][key]
    ex = models["jex"][key]
    ex.queue.clear()
    ex.prefilling.clear()
    ex.slots = [None] * ex.max_batch
    ex.bm = type(ex.bm)(ex.bm.num_blocks, ex.block_size)
    ex.finished, ex._next_id, ex.preemptions = {}, 0, 0
    ex.iteration_stats.clear()
    ex._iter_id = 0
    ex.key = jax.random.PRNGKey(0)
    return ex


def _serve(ex, requests, spec=None):
    """Submit (prompt, max_new_tokens, eos) requests; run plain or
    speculatively (spec = (draft params, draft config, gamma,
    rounds_per_call)). Returns (generated token lists, finished)."""
    ids = [ex.submit(p, max_new_tokens=n, eos_token_id=e)
           for p, n, e in requests]
    if spec is None:
        done = ex.run()
    else:
        dp, dcfg, gamma, rounds = spec
        done = ex.run_speculative(dp, dcfg, gamma=gamma,
                                  rounds_per_call=rounds)
    return [done[r].generated for r in ids], [done[r] for r in ids]


def _jax_and_port(models, target, draft, requests, gamma, rounds=8,
                  kw=KW):
    """Both executors over the same requests, speculatively; draft is a
    key of ``models`` or "self". Returns (JAX tokens, JAX spec_rounds,
    port tokens, port executor, port requests)."""
    jp, jcfg, tp, cfg = models[target]
    jd, jdcfg, td, tdcfg = models[draft] if draft != "self" else \
        (jp, jcfg, tp, cfg)
    jex = _jex(models, target, kw)
    want, _ = _serve(jex, requests, (jd, jdcfg, gamma, rounds))
    tex = Executor(tp, cfg, seed=0, device="cpu", **kw)
    got, reqs = _serve(tex, requests, (td, tdcfg, gamma, rounds))
    return want, jex.spec_rounds, got, tex, reqs


MIXED = [([3, 1, 4], 8, None), ([2, 7], 5, None), ([5, 6, 7, 8], 11, None)]


@pytest.fixture(scope="module")
def mixed_plain(models):
    """The mixed batch through the port's plain run()."""
    _, _, tp, cfg = models["target"]
    return _serve(Executor(tp, cfg, seed=0, device="cpu", **KW), MIXED)[0]


@pytest.mark.parametrize("rounds", [1, 8])
def test_mixed_batch_token_identical(models, mixed_plain, rounds):
    """A 1-layer draft, gamma 3: host-paced (one round per readback) and
    device-paced (8 rounds per readback) rounds give JAX's tokens and
    spec_rounds, and plain run()'s tokens."""
    want, jrounds, got, tex, reqs = _jax_and_port(
        models, "target", "draft", MIXED, gamma=3, rounds=rounds)
    assert got == want == mixed_plain
    assert tex.spec_rounds == jrounds
    assert tex.spec_readbacks == tex.spec_calls
    if rounds == 1:
        assert tex.spec_calls == tex.spec_rounds
    assert 0 <= tex.spec_accepted <= tex.spec_proposed
    assert all(len(r.logprobs) == len(r.generated)
               and np.isfinite(r.logprobs).all() for r in reqs)


def test_self_draft_token_identical(models):
    """Draft == target: rounds collapse to about n / (gamma+1); spec_rounds
    equal to JAX's. Not every proposal is accepted, in either package:
    after a round that accepts all gamma drafts, the draft's KV lacks the
    last draft token's entry (it was proposed, never fed back), so the
    next round's draft reads one stale key."""
    want, jrounds, got, tex, _ = _jax_and_port(
        models, "target", "self", [([3, 1, 4], 12, None)], gamma=3,
        kw=dict(KW, max_batch=1))
    assert got == want and len(got[0]) == 12
    assert tex.spec_rounds == jrounds <= -(-12 // 4) + 1
    assert 0 < tex.spec_accepted < tex.spec_proposed


def test_eos_mid_round_token_identical(models):
    """A lane that hits eos inside an accepted block stops exactly there
    and runs on as a masked lane; its batch-mate is unaffected."""
    _, _, tp, cfg = models["target"]
    probe, _ = _serve(Executor(tp, cfg, seed=0, device="cpu",
                               **dict(KW, max_batch=2)),
                      [([3, 1, 4], 10, None)])
    eos = probe[0][4]
    want, jrounds, got, tex, reqs = _jax_and_port(
        models, "target", "draft",
        [([3, 1, 4], 10, eos), ([2, 7], 10, None)], gamma=3,
        kw=dict(KW, max_batch=2))
    assert got == want
    assert got[0] == probe[0][:5] and len(got[1]) == 10
    assert tex.spec_rounds == jrounds


def test_near_context_cap_token_identical(models):
    """A lane within gamma tokens of max_seq_len finishes with plain
    steps (3 + 21 tokens == the cap)."""
    want, jrounds, got, tex, _ = _jax_and_port(
        models, "target", "draft", [([3, 1, 4], 21, None)], gamma=4,
        kw=dict(KW, max_batch=1, max_seq_len=24))
    assert got == want and len(got[0]) == 21
    assert tex.spec_rounds == jrounds


@pytest.mark.parametrize("rounds,gamma", [(1, 3), (8, 4)])
def test_int8_self_draft_token_identical(models, rounds, gamma):
    """int8_mix weights and int8 KV, host- and device-paced: at gamma 3
    the verify's 4 rows run the weight-only linears, at gamma 4 its 5 rows
    the mixed int8 path (K1 -> K2); attention is K9's plain version, the
    draft's steps K7's."""
    want, jrounds, got, tex, _ = _jax_and_port(
        models, "int8", "self", [([3, 1, 4], 12, None),
                                 ([9, 2, 6, 5, 3], 9, None)], gamma=gamma,
        rounds=rounds, kw=dict(KW, max_batch=2))
    assert got == want
    assert tex.spec_rounds == jrounds


def test_split_decode_token_identical(models, monkeypatch):
    """MIXQ_KV_SPLITS=2 sends the port's decode steps through the split
    route (K11's plain version: page splits, exact merge): the same
    tokens as the single scan and as the JAX Executor."""
    jp, jcfg, tp, cfg = models["int8"]
    reqs = [([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3, 2, 3], 12,
             None), ([2, 7], 12, None)]
    kw = dict(KW, max_batch=2)
    want, _ = _serve(_jex(models, "int8", kw), reqs)
    single, _ = _serve(Executor(tp, cfg, seed=0, device="cpu", **kw), reqs)
    monkeypatch.setenv("MIXQ_KV_SPLITS", "2")
    split, _ = _serve(Executor(tp, cfg, seed=0, device="cpu", **kw), reqs)
    assert split == single == want


def test_rejections(models):
    """Stochastic sampling is refused as in JAX; the dense-cache draft
    (paged_draft=False), ported, gives the paged draft's tokens and
    rounds."""
    _, _, tp, cfg = models["target"]
    td, tdcfg = models["draft"][2:]
    ex = Executor(tp, cfg, device="cpu", **dict(KW, max_batch=1),
                  sampling=SamplingConfig(greedy=False, temperature=1.0))
    ex.submit([1, 2, 3], max_new_tokens=4)
    with pytest.raises(AssertionError, match="greedy"):
        ex.run_speculative(td, tdcfg, gamma=2)
    runs = []
    for paged in (True, False):
        ex = Executor(tp, cfg, device="cpu", **dict(KW, max_batch=1))
        rid = ex.submit([1, 2, 3], max_new_tokens=4)
        done = ex.run_speculative(td, tdcfg, gamma=2, paged_draft=paged)
        runs.append((done[rid].generated, ex.spec_rounds))
    assert runs[0] == runs[1] and len(runs[0][0]) == 4
