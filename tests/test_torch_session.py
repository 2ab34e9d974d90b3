"""Port parity for the dense generation path: GenerationSession (and LLM
over a checkpoint) on the CPU against the JAX package's, on a tiny f32
int8_mix Llama (MHA, head_dim 64) carried across with params_from_numpy,
with int8 KV and with an unquantized KV cache (the model's dtype).

- Buckets below 128 tokens: both sides attend with the masked einsum;
  greedy tokens must be identical, log-probabilities and logits within
  2e-3 of the largest |logit| (tests/test_torch_model.py's tolerance: the
  same f32 math in another summation order), except where one int8
  activation rounding flips (test_greedy_ragged_identical says how that
  is bounded).
- Buckets of 128 and 256: the port's prefill takes K14's plain version;
  JAX's side is made to run the stock Pallas flash kernel (in this test
  only, its ``resolve_interpret`` is patched to False under
  ``force_tpu_interpret_mode()``). Prefill logits within 2e-2 of the
  largest |logit| (the attention's bf16 rounding, tests/
  test_torch_attention.py), greedy tokens identical.
- The static sampler against JAX's, exactly, for greedy sampling and its
  controls; stochastic draws by seed and support.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.ops import attention as jattn
from mixq_tensorrt_llm_tpu.quant import core as jcore
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import sampler as jsampler
from mixq_tensorrt_llm_tpu.runtime.session import \
    GenerationSession as JSession
from mixq_tensorrt_llm_tpu_torch.api import LLM
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.ops import attention as tattn
from mixq_tensorrt_llm_tpu_torch.quant import KVCacheQuantAlgo
from mixq_tensorrt_llm_tpu_torch.quant import core as tcore
from mixq_tensorrt_llm_tpu_torch.runtime import sampler as tsampler
from mixq_tensorrt_llm_tpu_torch.runtime.sampler import SamplingConfig
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession

LOGIT_TOL = 2e-3
FLIP_TOL = 1e-2           # test_greedy_ragged_identical's docstring
FLASH_TOL = 2e-2
V = 256


def _model(kv, dtype=jnp.float32):
    jcfg = JConfig(vocab_size=V, hidden_size=128, intermediate_size=256,
                   num_layers=2, num_heads=2, num_kv_heads=2, head_dim=64,
                   max_position_embeddings=512, dtype=dtype,
                   quant=JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                kv_cache=kv))
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 128), ("self_attn.o_proj", 128),
                     ("mlp.gate_proj", 128), ("mlp.down_proj", 256))}
    jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(3),
                                   act_scales=acts)
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jcfg, jp, cfg, tp


@pytest.fixture(scope="module")
def models():
    return {"int8": _model(JKV.INT8), "none": _model(JKV.NONE),
            "bf16": _model(JKV.NONE, jnp.bfloat16)}


def sessions(model, **kw):
    jcfg, jp, cfg, tp = model
    return (JSession(jp, jcfg, **kw),
            GenerationSession(tp, cfg, device="cpu", **kw))


def prompts_of(lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, V, n).tolist() for n in lens]


def rel(got, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def record_quantization(monkeypatch):
    """Record every per-token int8 quantization (K1's (input, q_x)) that
    the JAX package and the port run, in call order: two lists of
    (f32 input, q_x) numpy pairs. JAX's side records from inside its jit
    through an ordered debug callback; its jit caches are cleared so that
    the patched function is traced."""
    jrec, trec = [], []
    jreal, treal = jcore.quantize_activations, tcore.quantize_activations

    def jquant(x):
        q, s = jreal(x)
        jax.debug.callback(lambda a, b: jrec.append((np.asarray(a),
                                                     np.asarray(b))),
                           x.astype(jnp.float32), q, ordered=True)
        return q, s

    def tquant(x):
        q, s = treal(x)
        trec.append((x.float().numpy().copy(), q.numpy().copy()))
        return q, s

    monkeypatch.setattr(jcore, "quantize_activations", jquant)
    monkeypatch.setattr(tcore, "quantize_activations", tquant)
    jax.clear_caches()
    return jrec, trec


def flip_sources(jrec, trec, lens, bucket):
    """Hold the port's quantization against JAX's, call by call, over the
    prompts' rows (lane-major, ``bucket`` rows a lane), and return
    ``{lane: first position a flip reaches}``.

    - The port's quantize_activations on JAX's recorded input is JAX's
      (eager) quantize_activations, bit for bit, scale included: the
      function is the same.
    - A row that no earlier flip reaches has the same q_x on both sides,
      or differs in ONE element by exactly 1: a rounding that its input,
      different in the last ulp, tipped over a tie (x/scale = 26.5 on one
      side, 26.500008 on the other). That row's position and every later
      one of its lane are then reached (the attention is causal), at
      every later call."""
    reached = {}
    assert len(jrec) == len(trec) and jrec
    for (jx, jq), (tx, tq) in zip(jrec, trec):
        assert jx.shape == tx.shape == (len(lens) * bucket, jx.shape[1])
        q, s = tcore.quantize_activations(torch.from_numpy(jx))
        q0, s0 = jcore.quantize_activations(jnp.asarray(jx))
        assert np.array_equal(q.numpy(), np.asarray(q0))
        assert np.array_equal(s.numpy(), np.asarray(s0))
        flips = {}
        for lane, n in enumerate(lens):
            for pos in range(min(n, reached.get(lane, n))):
                r = lane * bucket + pos
                d = tq[r].astype(np.int32) - jq[r].astype(np.int32)
                if d.any():
                    assert np.count_nonzero(d) == 1 and np.abs(d).max() == 1
                    flips.setdefault(lane, pos)
        for lane, pos in flips.items():
            reached[lane] = min(pos, reached.get(lane, pos))
    return reached


@pytest.mark.parametrize("kv", ["int8", "none"])
def test_greedy_ragged_identical(models, kv, monkeypatch):
    """Ragged prompts in a 32-token bucket, the port under teacher forcing
    (a logits processor forces JAX's greedy tokens, so both sides decode
    the same inputs).

    The two packages' f32 inputs to the int8 activation quantization
    differ in the last ulp (sums in another order, from the first RMSNorm
    on), and a rounding near a tie can flip one q_x element by one int8
    step. On an x86 CPU this happens at layer 0's o_proj, lane 2 (30
    tokens), position 18, channel 115: JAX's x/scale is 26.5 (rounds to
    26), the port's 26.500008 (27). ``flip_sources`` bounds each flip to
    one element by exactly 1, with the port's quantization bit-equal to
    JAX's on the same input. Held:

    - rows that no flip reaches: logits (prompt, each decode step) and
      log-probs within LOGIT_TOL of the largest |logit|;
    - the rows a flip reaches (its position and after, in its lane):
      within FLIP_TOL. One int8 step of one activation moves lane 2's
      logits by 0.9-3.0e-3 of the largest |logit| (3.24e-3 at most,
      measured on the CPU); FLIP_TOL leaves 3x that;
    - the port's own greedy choice (the argmax of its raw logits) equals
      JAX's token wherever JAX's top-2 gap exceeds the two sides' logit
      distance at that step (a gap of 8.4e-4 against a distance of
      1.3e-3 flips lane 2's 4th decoded token without forcing)."""
    js, ts = sessions(models[kv], max_seq_len=64)
    lens, bucket, steps = (5, 17, 30), 32, 10
    prompts = prompts_of(lens)
    jrec, trec = record_quantization(monkeypatch)
    jlogits, tlogits = [], []

    def jread(logits, hist):
        jax.debug.callback(lambda a: jlogits.append(np.asarray(a)), logits,
                           ordered=True)
        return logits

    try:
        want = js.generate(prompts, steps, return_context_logits=True,
                           logits_processors=(jread,))
    finally:
        jax.clear_caches()
    forced = torch.tensor([s[n:] for s, n in zip(want.sequences, lens)])

    def force(logits, hist):
        step = len(tlogits)
        tlogits.append(logits.float().numpy().copy())
        cols = torch.arange(logits.shape[-1])
        return torch.where(cols[None] == forced[:, step, None], 0.0,
                           -torch.inf)

    got = ts.generate(prompts, steps, return_context_logits=True,
                      logits_processors=(force,))
    assert got.sequences == want.sequences
    assert got.num_generated == want.num_generated == [steps] * 3
    assert len(jlogits) == len(tlogits) == steps
    monkeypatch.undo()                    # the quantizers unrecorded again
    reached = flip_sources(jrec, trec, lens, bucket)
    scale = max(float(np.abs(np.asarray(c)).max())
                for c in want.context_logits)

    def tol(lane, pos=None):
        hit = lane in reached and (pos is None or pos >= reached[lane])
        return (FLIP_TOL if hit else LOGIT_TOL) * scale

    for lane, (g, w) in enumerate(zip(got.context_logits,
                                      want.context_logits)):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape == (lens[lane], V)
        for pos in range(lens[lane]):
            assert np.abs(g[pos] - w[pos]).max() <= tol(lane, pos)
    for lane, (g, w) in enumerate(zip(got.logprobs, want.logprobs)):
        assert np.abs(np.asarray(g) - np.asarray(w)).max() <= tol(lane)
    for step, (tl, jl) in enumerate(zip(tlogits, jlogits)):
        for lane in range(len(lens)):
            dist = float(np.abs(tl[lane] - jl[lane]).max())
            assert dist <= tol(lane)
            top2 = np.sort(jl[lane])[-2:]
            assert int(np.argmax(jl[lane])) == int(forced[lane, step])
            if top2[1] - top2[0] > dist:
                assert int(np.argmax(tl[lane])) == int(forced[lane, step])


def test_controls_identical(models):
    """eos with min_new_tokens, stop sequences, bad words (one and two
    tokens), a logits processor and a repetition penalty, all at once."""
    js, ts = sessions(models["int8"], max_seq_len=64)
    prompts = prompts_of((6, 11, 23), seed=4)
    bias = np.random.default_rng(5).standard_normal(V).astype(np.float32)
    jproc = (lambda logits, hist: logits + 0.3 * jnp.asarray(bias),)
    tproc = (lambda logits, hist: logits + 0.3 * torch.from_numpy(bias),)
    sampling = dict(repetition_penalty=1.3)
    base = js.generate(prompts, 12, jsampler.SamplingConfig(**sampling),
                       logits_processors=jproc).sequences
    gen = [s[len(p):] for s, p in zip(base, prompts)]
    eos = gen[0][1]                       # banned at step 1, so lane 0 runs on
    stop = [gen[1][4:6]]
    bad = [[gen[2][3]], gen[2][6:8]]
    kw = dict(eos_token_id=eos, min_new_tokens=2, stop_sequences=stop,
              bad_words=bad)
    want = js.generate(prompts, 12, jsampler.SamplingConfig(**sampling),
                       logits_processors=jproc, **kw)
    got = ts.generate(prompts, 12, SamplingConfig(**sampling),
                      logits_processors=tproc, **kw)
    assert got.sequences == want.sequences
    assert got.num_generated == want.num_generated
    g = [s[len(p):] for s, p in zip(got.sequences, prompts)]
    assert g[0][1] != eos                 # min_new_tokens held eos back
    assert g[1][-2:] == stop[0] and len(g[1]) < 12    # stopped
    assert bad[0][0] not in g[2]


@pytest.mark.parametrize("lens,bucket", [((100, 128), 128),
                                         ((150, 201), 256)])
def test_flash_route_matches_stock_kernel(models, monkeypatch, lens, bucket):
    js, ts = sessions(models["int8"], max_seq_len=512)
    prompts = prompts_of(lens, seed=bucket)
    flash_calls = []
    real = tattn.flash_causal_attention
    monkeypatch.setattr(tattn, "flash_causal_attention",
                        lambda *a: flash_calls.append(1) or real(*a))
    got = ts.generate(prompts, 6, return_context_logits=True)
    assert len(flash_calls) == 2          # once a layer, at the prefill
    monkeypatch.setattr(jattn, "resolve_interpret", lambda _: False)
    from jax.experimental.pallas.ops.tpu import flash_attention as stock
    traced = []
    real_stock = stock.flash_attention
    monkeypatch.setattr(stock, "flash_attention",
                        lambda *a, **k: traced.append(1)
                        or real_stock(*a, **k))
    jax.clear_caches()                    # no masked trace is reused
    try:
        with pltpu.force_tpu_interpret_mode():
            want = js.generate(prompts, 6, return_context_logits=True)
    finally:
        jax.clear_caches()
    assert traced                         # the stock kernel (in the scan)
    for g, w, n in zip(got.context_logits, want.context_logits, lens):
        assert rel(g[n - 1], w[n - 1]) <= FLASH_TOL
        assert rel(g, w) <= FLASH_TOL
    assert got.sequences == want.sequences


def test_score_logits_matches_jax(models):
    js, ts = sessions(models["int8"], max_seq_len=64)
    tokens = np.asarray(prompts_of((24, 24), seed=7), np.int32)
    lens = np.asarray([24, 10], np.int32)
    want = np.asarray(js.score_logits(tokens, lens))
    got = ts.score_logits(tokens, lens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert rel(got, want) <= LOGIT_TOL


def test_bf16_kv_logits_near_jax(models):
    """A bf16 model with a bf16 (unquantized) cache: the prompts' logits
    within FLASH_TOL of JAX's. Tokens are not held equal here: the two
    frameworks round bf16 intermediates at other places (about 1e-2 of the
    largest logit after two layers), which flips near-ties."""
    js, ts = sessions(models["bf16"], max_seq_len=64)
    prompts = prompts_of((5, 17, 30))
    want = js.generate(prompts, 4, return_context_logits=True)
    got = ts.generate(prompts, 4, return_context_logits=True)
    cache = tcommon.init_kv_cache(models["bf16"][2], 1, 8, device="cpu")
    assert cache.k.dtype == torch.bfloat16 and not cache.quantized
    for g, w in zip(got.context_logits, want.context_logits):
        assert rel(g, w) <= FLASH_TOL


@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_session_matches_port_executor(models, kv):
    """Without the flash prefill the dense session attends over its cache
    as the paged Executor does over its pool: tokens identical (the JAX
    package's tests/test_paged_executor.py pairing), with an int8 cache and
    pool, and with bf16 ones."""
    _, _, cfg, tp = models[kv]
    ts = GenerationSession(tp, cfg, max_seq_len=64, prefill_buckets=(16,),
                           use_flash_prefill=False, device="cpu")
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7], [100, 101, 102, 103]]
    want = ts.generate(prompts, max_new_tokens=6).sequences
    ex = Executor(tp, cfg, max_batch=4, max_seq_len=64, block_size=8,
                  prefill_chunk=16, device="cpu")
    ids = [ex.submit(p, max_new_tokens=6) for p in prompts]
    done = ex.run()
    assert [done[i].sequence for i in ids] == want


def test_llm_over_jax_checkpoint(models, tmp_path):
    """A checkpoint the JAX package saves, served by the port's LLM: the
    tokens of JAX's LLM over the same directory."""
    from mixq_tensorrt_llm_tpu.api import LLM as JLLM
    from mixq_tensorrt_llm_tpu.convert.checkpoint import save_checkpoint
    jcfg, jp, _, _ = models["int8"]
    save_checkpoint(str(tmp_path), jp, jcfg)
    prompts = prompts_of((7, 20), seed=9)
    want = JLLM(str(tmp_path), max_seq_len=64,
                tokenizer=object()).generate_tokens(prompts, 8)
    llm = LLM(str(tmp_path), max_seq_len=64, device="cpu")
    assert llm.tokenizer is None          # no tokenizer files there
    got = llm.generate_tokens(prompts, 8)
    assert got.sequences == want.sequences
    ex = llm.make_executor(max_batch=2, block_size=8, prefill_chunk=16)
    assert ex.device == torch.device("cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        llm.generate("hello")


def _sample_inputs(seed=0, b=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, V)).astype(np.float32) * 3
    history = rng.integers(0, V, (b, 8)).astype(np.int32)
    history[0, :5] = -1                      # a short history
    history[1, -2:] = [17, 40]               # lane 1 ends with 17, 40
    words = [[int(np.argmax(logits[2]))], [17, 40, int(np.argmax(logits[1]))],
             [3, 4]]
    return logits, history, words


def test_sampler_controls_match_jax():
    logits, history, words = _sample_inputs()
    jl, jh = jnp.asarray(logits), jnp.asarray(history)
    tl, th = torch.from_numpy(logits), torch.from_numpy(history).long()
    jbw = jsampler.pack_bad_words(words)
    tbw = tsampler.pack_bad_words(words)
    assert np.array_equal(np.asarray(jbw), tbw.numpy())
    np.testing.assert_array_equal(
        tsampler.ban_bad_words(tl, th, tbw).numpy(),
        np.asarray(jsampler.ban_bad_words(jl, jh, jbw)))
    np.testing.assert_array_equal(
        tsampler.apply_repetition_penalty(tl, th, 1.3).numpy(),
        np.asarray(jsampler.apply_repetition_penalty(jl, jh, 1.3)))
    bias = np.linspace(-1, 1, V, dtype=np.float32)
    for cfg, kw in [
            (dict(), {}),
            (dict(repetition_penalty=1.3), {}),
            (dict(), dict(bad_words=True)),
            (dict(), dict(suppress=True)),
            (dict(repetition_penalty=0.7), dict(bad_words=True,
                                                suppress=True, proc=True))]:
        jkw, tkw = {}, {}
        if kw.get("bad_words"):
            jkw["bad_words"], tkw["bad_words"] = jbw, tbw
        if kw.get("suppress"):
            tok = int(np.argmax(logits[3]))
            jkw.update(suppress_token=jnp.int32(tok),
                       suppress_flag=jnp.int32(1))
            tkw.update(suppress_token=torch.tensor(tok),
                       suppress_flag=torch.tensor(1))
        if kw.get("proc"):
            jkw["processors"] = (lambda x, h: x * jnp.asarray(bias),)
            tkw["processors"] = (lambda x, h: x * torch.from_numpy(bias),)
        want = jsampler.sample(jl, jax.random.PRNGKey(0),
                               jsampler.SamplingConfig(**cfg), history=jh,
                               **jkw)
        got = tsampler.sample(tl, torch.Generator().manual_seed(0),
                              SamplingConfig(**cfg), history=th, **tkw)
        assert got.tolist() == np.asarray(want).tolist(), (cfg, kw)
    # the controls did bite: lane 2's argmax and lane 1's word end banned
    banned = tsampler.sample(tl, None, SamplingConfig(), history=th,
                             bad_words=tbw)
    assert banned[2] != words[0][0] and banned[1] != words[1][-1]


@pytest.mark.parametrize("per_lane", [False, True])
def test_sample_batched_bad_words_and_processors_match_jax(per_lane):
    """The Executor's sampler with the controls the static one hands it:
    per-lane penalties, bad words shared (N, L) or per lane (B, N, L; lane
    0's rows all pad, so inert there), a processor and a suppressed
    token, against JAX's sample_batched, exactly."""
    logits, history, words = _sample_inputs(2)
    packed = np.array(jsampler.pack_bad_words(words))
    if per_lane:
        packed = np.repeat(packed[None], logits.shape[0], axis=0)
        packed[0] = jsampler.BW_PAD
    boost = np.zeros_like(logits)
    boost[0, 7] = 100.0                   # the processor picks lane 0's token
    pens = (1.0, 1.3, 0.7, 1.0)
    sup_tok = np.array([-1, 5, 3, int(np.argmax(logits[3]))], np.int32)
    sup_flag = np.array([0, 1, 0, 1], np.int32)
    want = jsampler.sample_batched(
        jnp.asarray(logits), jax.random.PRNGKey(0),
        jsampler.batch_params([jsampler.SamplingConfig(repetition_penalty=r)
                               for r in pens]),
        history=jnp.asarray(history), suppress_token=jnp.asarray(sup_tok),
        suppress_flag=jnp.asarray(sup_flag),
        bad_words=jnp.asarray(packed),
        processors=(lambda x, h: x + jnp.asarray(boost),))
    got = tsampler.sample_batched(
        torch.from_numpy(logits), torch.Generator().manual_seed(0),
        tsampler.batch_params([SamplingConfig(repetition_penalty=r)
                               for r in pens]),
        history=torch.from_numpy(history).long(),
        suppress_token=torch.from_numpy(sup_tok).long(),
        suppress_flag=torch.from_numpy(sup_flag),
        bad_words=torch.from_numpy(packed).long(),
        processors=(lambda x, h: x + torch.from_numpy(boost),))
    assert got.tolist() == np.asarray(want).tolist()
    # the controls bit: the processor (lane 0), the one-token bad word
    # (lane 2) and the suppressed token (lane 3)
    assert got[0] == 7 and got[2] != words[0][0] and \
        got[3] != sup_tok[3]


@pytest.mark.parametrize("cfg", [dict(temperature=0.8, greedy=False),
                                 dict(top_k=5, greedy=False),
                                 dict(top_p=0.6, greedy=False)])
def test_stochastic_sample_by_seed_and_support(cfg):
    logits, history, _ = _sample_inputs(1, b=64)
    tl = torch.from_numpy(logits)
    conf = SamplingConfig(**cfg)

    def draw(seed):
        return tsampler.sample(tl, torch.Generator().manual_seed(seed), conf,
                               history=torch.from_numpy(history).long())

    a, b = draw(11), draw(11)
    assert torch.equal(a, b)
    assert not all(torch.equal(a, draw(s)) for s in (12, 13, 14))
    if conf.top_k:
        top = torch.topk(tl, conf.top_k, dim=-1).indices
        assert bool((top == a[:, None]).any(dim=-1).all())
    if conf.top_p < 1.0:
        srt = torch.sort(tl, dim=-1, descending=True)
        cum = torch.cumsum(torch.softmax(srt.values, -1), -1)
        for i in range(tl.shape[0]):
            n = int((cum[i] < conf.top_p).sum()) + 1   # the nucleus
            assert int(a[i]) in srt.indices[i, :n].tolist()


def test_unported_and_device_defaults_raise(models, tmp_path):
    """The options and entry points that were refused before their
    modules were ported now run: beams and forward with adapter ids on a
    model without adapters are the base model (as in JAX), rope_pos equal
    to the slots changes nothing, return_hidden appends the pre-norm
    hidden; the LLM's speculative, Medusa and ReDrafter entry points give
    their runtime functions' tokens. The device defaults still raise
    without a card."""
    _, _, cfg, tp = models["int8"]
    ts = GenerationSession(tp, cfg, max_seq_len=64, device="cpu")
    assert ts.generate([[1, 2]], 4, num_beams=2).num_generated == [4]
    from mixq_tensorrt_llm_tpu_torch.runtime.beam import paged_beam_search
    base = paged_beam_search(tp, cfg, [[1, 2]], 4, num_beams=2,
                             device="cpu")
    assert paged_beam_search(tp, cfg, [[1, 2]], 4, num_beams=2,
                             lora_ids=[1], device="cpu").sequences == \
        base.sequences
    fp8 = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, kv_cache=KVCacheQuantAlgo.FP8))
    assert tcommon.init_kv_cache(fp8, 1, 16, device="cpu").k.dtype == \
        torch.float8_e4m3fn
    tok = torch.ones((1, 2), dtype=torch.long)
    pos = torch.arange(2)[None]

    def fwd(**kw):
        cache = tcommon.init_kv_cache(cfg, 1, 16, device="cpu")
        return tcommon.forward(tp, cfg, tok, pos, cache, torch.tensor([2]),
                               **kw)

    want = fwd()[0]
    for opt in ("rope_pos", "lora_ids"):
        assert torch.equal(fwd(**{opt: pos if opt == "rope_pos"
                                  else torch.tensor([1])})[0], want)
    logits, _, hidden = fwd(return_hidden=True)
    assert torch.equal(logits, want) and hidden.shape == (1, 2, 128)
    # neither a checkpoint nor a Hugging Face directory
    with pytest.raises(FileNotFoundError, match="config.json"):
        LLM(str(tmp_path), device="cpu", cache_dir=str(tmp_path / "c"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationSession(tp, cfg)
    from mixq_tensorrt_llm_tpu_torch.convert import save_checkpoint
    save_checkpoint(str(tmp_path), tp, cfg)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LLM(str(tmp_path))
    llm = LLM(str(tmp_path), max_seq_len=64, device="cpu")
    from mixq_tensorrt_llm_tpu_torch.runtime import (medusa, redrafter,
                                                     speculative)
    got = llm.generate_speculative(llm, [[1, 2]], 4, temperature=0.0)
    want = speculative.speculative_generate_batched(
        tp, cfg, tp, cfg, [[1, 2]], 4, temperature=0.0, max_seq_len=64,
        device="cpu")
    assert got[0] == want[0] and len(got[0][0]) == 6
    gen = torch.Generator().manual_seed(0)
    heads = medusa.init_random_heads(cfg, gen, 4, device="cpu")
    assert llm.generate_medusa(heads, [1, 2], 4)[0] == \
        medusa.medusa_generate(tp, cfg, heads, [1, 2], 4, max_seq_len=64,
                               device="cpu")[0]
    drafter = redrafter.init_random_drafter(cfg, gen, device="cpu")
    got, stats = llm.generate_redrafter(drafter, [1, 2], 4, num_beams=2,
                                        draft_len=2)
    assert stats.tokens == 4 and got == redrafter.redrafter_generate(
        tp, cfg, drafter, [1, 2], 4, num_beams=2, draft_len=2,
        max_seq_len=64, device="cpu")[0]
