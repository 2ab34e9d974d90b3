"""Port parity of the beam entry points on the CPU, against the JAX
package on the same numpy-seeded f32 tiny Llamas: GenerationSession.
generate(num_beams=3), with and without bad words, gives JAX's sequences;
Executor.run_beams (int8_mix / int8 KV, batches of 2, per-request
min_new_tokens and stop sequences) gives the JAX Executor's tokens; after
warmup_beams, run_beams makes no program (utils/compile_watch) and its
reused pool gives what a fresh one gives, while a burst key warmup never
made is counted."""

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
from mixq_tensorrt_llm_tpu.runtime.session import (GenerationSession as
                                                   JSession)
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime.beam import paged_beam_search
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1], [11, 12, 13, 14, 15]]
EX = dict(max_batch=2, max_seq_len=64, block_size=8)


def _model(quant):
    q = (JQuant() if quant == "none" else
         JQuant(algo=JAlgo.INT8_MIX, num_outliers=8, kv_cache=JKV.INT8))
    jcfg = JConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, dtype=jnp.float32, quant=q)
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(0))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    return jcfg, jp, cfg, params_from_numpy(jax.tree.map(np.asarray, jp),
                                            cfg, device="cpu")


@pytest.fixture(scope="module")
def dense():
    return _model("none")


@pytest.fixture(scope="module")
def mixed():
    return _model("int8")


@pytest.mark.parametrize("control", ["none", "bad_words"])
def test_session_generate_beams_matches_jax(dense, control):
    jcfg, jp, cfg, tp = dense
    jsess = JSession(jp, jcfg, max_seq_len=64)
    sess = GenerationSession(tp, cfg, max_seq_len=64, device="cpu")
    kw = {}
    if control == "bad_words":
        base = sess.generate(PROMPTS, 6, num_beams=3)
        kw = dict(bad_words=[[base.sequences[0][len(PROMPTS[0])]]])
    want = jsess.generate(PROMPTS, 6, num_beams=3, **kw)
    got = sess.generate(PROMPTS, 6, num_beams=3, **kw)
    assert got.sequences == want.sequences
    assert got.num_generated == want.num_generated
    assert got.num_prompt_tokens == [len(p) for p in PROMPTS]
    if control == "bad_words":
        assert kw["bad_words"][0][0] not in got.sequences[0][len(PROMPTS[0]):]
        # the second call served from the same engine and pool
        assert sess._beams.state is not None


def _submit(ex, stop):
    """The three prompts, 7 new tokens each; request 0 bans eos 5 for 4
    tokens, request 2 stops on ``stop``."""
    return [ex.submit(PROMPTS[0], max_new_tokens=7, eos_token_id=5,
                      min_new_tokens=4),
            ex.submit(PROMPTS[1], max_new_tokens=7, eos_token_id=5),
            ex.submit(PROMPTS[2], max_new_tokens=7, eos_token_id=5,
                      stop_sequences=[stop])]


def test_run_beams_matches_jax(mixed):
    jcfg, jp, cfg, tp = mixed
    ex = Executor(tp, cfg, device="cpu", **EX)
    probe = _submit(ex, [0])
    stop = ex.run_beams(num_beams=3, burst=4)[probe[2]].generated[1:3]
    jex = JExecutor(jp, jcfg, **EX)
    ids_j = _submit(jex, stop)
    want = jex.run_beams(num_beams=3, burst=4)
    ids = _submit(ex, stop)
    got = ex.run_beams(num_beams=3, burst=4)
    for a, b in zip(ids, ids_j):
        assert got[a].done and got[a].generated == want[b].generated
    assert got[ids[2]].generated[-2:] == stop
    eng = ex.beam_engine
    # one readback a prefill (4 batches in the two runs) and one a burst
    assert eng.readbacks == eng.bursts + 4 and eng.bursts > 0
    assert eng.graph_replays == 0          # the CPU runs bursts eagerly


def test_warmup_beams_then_run_beams_makes_no_program(mixed):
    _, _, cfg, tp = mixed
    ex = Executor(tp, cfg, device="cpu", **EX)
    assert ex.compiles_since_warmup is None
    ex.warmup_beams(num_beams=3, burst=4, prompt_bucket=8, max_new_tokens=7)
    assert ex.compiles_since_warmup == 0
    batches = ([PROMPTS[0], PROMPTS[2]], [PROMPTS[0], PROMPTS[0]])
    served = []
    for prompts in batches:
        ids = [ex.submit(p, max_new_tokens=7) for p in prompts]
        done = ex.run_beams(num_beams=3, burst=4)
        assert ex.compiles_since_warmup == 0
        served.append([p + done[r].generated for p, r in zip(prompts, ids)])
    ex.submit(PROMPTS[1], max_new_tokens=7)
    ex.submit(PROMPTS[2], max_new_tokens=7)
    ex.run_beams(num_beams=3, burst=8)   # a burst key warmup never made
    assert ex.compiles_since_warmup > 0
    for prompts, seqs in zip(batches, served):
        fresh = paged_beam_search(tp, cfg, prompts, 7, num_beams=3,
                                  max_seq_len=64, block_size=8, burst=4,
                                  device="cpu")
        assert seqs == fresh.sequences


def test_run_beams_needs_uniform_budget(mixed):
    _, _, cfg, tp = mixed
    ex = Executor(tp, cfg, device="cpu", **EX)
    ex.submit(PROMPTS[0], max_new_tokens=4)
    ex.submit(PROMPTS[1], max_new_tokens=5)
    with pytest.raises(ValueError, match="uniform max_new_tokens"):
        ex.run_beams(num_beams=2)
