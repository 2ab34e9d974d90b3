"""Port parity of RecurrentGemma (models/recurrentgemma.py: the RG-LRU
recurrent blocks, the windowed attention, the grouped checkpoint layout)
against the JAX package on the CPU, at JAX tests/test_recurrentgemma.py's
tiny size (vocab 256, hidden 64, intermediate 192 (96 a branch), 3
layers of (recurrent, recurrent, attention), 4 query heads on 1 KV head
of 16, conv 4), with a window that does not bite (16) and one that does
(4) over 12 tokens.

Weights are random HF state dicts drawn from a numpy seed
(tools/random_hf), converted by the JAX package's params_from_hf and
carried into the port by convert/from_jax.py. Tolerances: the f32 model's
logits within 1e-4 of max |JAX| and its states within 1e-5 (the port's
doubling scan sums in another order than jax.lax.associative_scan);
int8_mix logits within 2e-2 (K1 / K2 and K4's plain versions here);
greedy tokens of f32 models identical.
"""

import dataclasses
import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import checkpoint as jckpt
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import registry as jreg
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu.runtime.session import \
    GenerationSession as JSession
from mixq_tensorrt_llm_tpu_torch import api
from mixq_tensorrt_llm_tpu_torch.convert import calibrate as tcalib
from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as tckpt
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.from_jax import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo, QuantConfig
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
from mixq_tensorrt_llm_tpu_torch.tools import random_hf

LOGIT_TOL, STATE_TOL, MIX_TOL = 1e-4, 1e-5, 2e-2
CPU = torch.device("cpu")
HF = dict(random_hf.RECURRENTGEMMA_2B_HF, vocab_size=256, hidden_size=64,
          intermediate_size=192, num_hidden_layers=3, num_attention_heads=4,
          num_key_value_heads=1, head_dim=16, lru_width=64,
          attention_window_size=16)
# lane 0 full, lane 1 right-padded after 7 tokens
TOKENS = np.random.default_rng(1).integers(3, 256, (2, 12)).astype(np.int32)
LENS = np.array([12, 7], np.int32)
PROMPTS = [[1, 5, 9], [4, 2, 7, 7, 1]]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def model(quant: str = "none", window: int = 16):
    """(JAX cfg, JAX params, port cfg, port params) of the f32 model under
    ``quant`` (int8_mix: 8 outliers) and attention ``window``, both from
    one HF state dict."""
    conf = dict(HF, attention_window_size=window)
    ns = types.SimpleNamespace(**conf)
    q = {"none": (JQuant(), QuantConfig()),
         "int8_mix": (JQuant(algo=JAlgo.INT8_MIX, num_outliers=8),
                      QuantConfig(algo=QuantAlgo.INT8_MIX,
                                  num_outliers=8))}[quant]
    jcfg = dataclasses.replace(jreg.config_from_hf(ns, q[0]),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(treg.config_from_hf(ns, q[1]),
                               dtype=torch.float32)
    jp = jreg.params_from_hf(jcfg, random_hf.random_recurrentgemma_state(
        conf, seed=0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def jax_prefill(quant: str = "none", window: int = 16):
    """The JAX package's prefill of TOKENS: (logits, RGState as numpy)."""
    jcfg, jp, _, _ = model(quant, window)
    b, s = TOKENS.shape
    cache = jcommon.init_kv_cache(jcfg, b, 16)
    pos = jnp.tile(jnp.arange(s, dtype=jnp.int32), (b, 1))
    logits, cache = jcommon.forward(jp, jcfg, jnp.asarray(TOKENS), pos,
                                    cache, jnp.asarray(LENS))
    return np.asarray(logits), {f: np.asarray(getattr(cache, f), np.float32)
                                for f in cache._fields}


def port_prefill(cfg, params, tokens=TOKENS, lens=LENS, cache=None):
    b, s = tokens.shape
    if cache is None:
        cache = tcommon.init_kv_cache(cfg, b, 16, device=CPU)
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    logits, cache = tcommon.forward(params, cfg, torch.from_numpy(tokens),
                                    pos, cache, torch.from_numpy(lens))
    return _np(logits), cache


@functools.lru_cache(maxsize=None)
def jax_tokens():
    jcfg, jp, _, _ = model()
    sess = JSession(jp, jcfg, max_seq_len=32, prefill_buckets=(8,))
    return sess.generate(PROMPTS, 6).sequences


def test_config_matches_jax_and_autoconfig(tmp_path):
    """``load_hf_config`` + ``registry.config_from_hf`` over a diff-only
    config.json (save_pretrained), a bare one at 3 layers (every other
    RecurrentGemmaConfig default: 10 KV heads, head_dim and lru_width
    computed) and the published recurrentgemma-2b one cut to 24 layers:
    the ModelConfig equal field for field to the JAX package's over
    AutoConfig."""
    import transformers
    transformers.RecurrentGemmaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=192,
        num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=1,
        head_dim=16, lru_width=64, attention_window_size=16,
        conv1d_width=4, logits_soft_cap=30.0).save_pretrained(
            str(tmp_path / "diff"))
    for name, d in (("bare", {"model_type": "recurrent_gemma",
                              "num_hidden_layers": 3}),
                    ("published", dict(random_hf.RECURRENTGEMMA_2B_HF,
                                       num_hidden_layers=24))):
        os.makedirs(tmp_path / name)
        with open(tmp_path / name / "config.json", "w") as f:
            json.dump(d, f)
    for name in ("diff", "bare", "published"):
        path = str(tmp_path / name)
        jcfg = jreg.config_from_hf(
            transformers.AutoConfig.from_pretrained(path))
        tcfg = treg.config_from_hf(thf.load_hf_config(path))
        assert tcfg.to_dict() == jcfg.to_dict(), name
        assert tcommon.ModelConfig.from_dict(jcfg.to_dict()) == tcfg
        if name == "bare":
            assert tcfg.num_kv_heads == 10
    assert (tcfg.num_kv_heads, tcfg.head_dim, tcfg.intermediate_size,
            tcfg.rotary_dim, tcfg.sliding_window) == (1, 256, 7680, 128,
                                                      2048)


@pytest.mark.parametrize("window", [16, 4])
def test_forward_logits_and_states_match_jax(window):
    """The f32 model's prefill of a full and a right-padded lane, the
    window over 12 tokens not biting (16) and biting (4): logits within
    1e-4, the attention KV, conv carries and LRU states within 1e-5 of
    JAX's."""
    jl, jstate = jax_prefill(window=window)
    _, _, tcfg, tp = model(window=window)
    tl, cache = port_prefill(tcfg, tp)
    assert _rel(tl, jl) < LOGIT_TOL
    for f in cache._fields:
        assert _rel(_np(getattr(cache, f)), jstate[f]) < STATE_TOL, f
    assert cache.lru.dtype == torch.float32


@pytest.mark.parametrize("window", [16, 4])
def test_prefill_then_decodes_equal_prefill(window):
    """prefill(7) + 5 single-token decodes give prefill(12)'s last logits:
    conv carries, LRU states and the windowed KV round-trip, with the
    window biting in the decodes (4) and not (16)."""
    _, _, tcfg, tp = model(window=window)
    toks = TOKENS[:1]
    full, _ = port_prefill(tcfg, tp, toks, LENS[:1])
    cache = tcommon.init_kv_cache(tcfg, 1, 16, device=CPU)
    pos = torch.arange(12, dtype=torch.int32)[None]
    tcommon.forward(tp, tcfg, torch.from_numpy(toks), pos, cache,
                    torch.tensor([7]))
    for t in range(7, 12):
        last, _ = tcommon.forward(
            tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor([[t]], dtype=torch.int32), cache,
            torch.tensor([t + 1]))
    assert _rel(_np(last[:, 0]), full[:, -1]) < LOGIT_TOL


def test_padded_lane_leaves_state_untouched():
    """Lane 1's pads (positions 7..11) leave its conv carries and LRU
    states where a solo run of its 7 tokens leaves them, and its KV and
    logits at the valid positions equal."""
    _, _, tcfg, tp = model()
    both, cache = port_prefill(tcfg, tp)
    solo, sc = port_prefill(tcfg, tp, TOKENS[1:, :7], LENS[1:])
    assert _rel(both[1, :7], solo[0]) < 1e-6
    for f in ("conv", "lru"):
        assert _rel(_np(getattr(cache, f)[:, :, 1]),
                    _np(getattr(sc, f)[:, :, 0])) < 1e-6, f
    assert _rel(_np(cache.k[:, :, 1, :7]), _np(sc.k[:, :, 0, :7])) < 1e-6


def test_lru_resets_at_position_zero():
    """A prefill from position 0 over the LRU states and KV another
    prefill left gives the fresh state's logits and states: RG-LRU resets
    there (a = 0, multiplier 1), and the KV past the valid length is
    masked. (The conv carry is history, not reset, in both packages: the
    session starts each call from a fresh state.)"""
    _, _, tcfg, tp = model()
    fresh, fc = port_prefill(tcfg, tp)
    again, cache = port_prefill(tcfg, tp, np.roll(TOKENS, 3, axis=1))
    assert _rel(again, fresh) > 1e-2           # other tokens, other state
    assert _rel(_np(cache.lru), _np(fc.lru)) > 1e-2
    cache.conv.zero_()
    second, cache = port_prefill(tcfg, tp, cache=cache)
    assert _rel(second, fresh) < 1e-6
    assert _rel(_np(cache.lru), _np(fc.lru)) < 1e-6


def test_int8_mix_matches_jax():
    """int8_mix (the mix linears K1 -> K2, down_proj W8A16 on K4; here
    their plain versions) within 2e-2 of JAX's int8_mix."""
    jl, _ = jax_prefill("int8_mix")
    _, _, tcfg, tp = model("int8_mix")
    layer0, layer2 = tp["layers"][0], tp["layers"][2]
    assert "fp_ind" in layer0["linear_x"] and "fp_ind" in layer2["qkv_proj"]
    assert set(layer0["down_proj"]) == {"qweight", "scale_col", "b"}
    tl, _ = port_prefill(tcfg, tp)
    assert _rel(tl, jl) < MIX_TOL


def test_session_greedy_tokens_match_jax():
    """GenerationSession on the CPU: greedy tokens identical to the JAX
    session's (the f32 model, one 8-token bucket), and a second call on
    the same session starts clean."""
    _, _, tcfg, tp = model()
    sess = GenerationSession(tp, tcfg, max_seq_len=32, prefill_buckets=(8,),
                             device=CPU)
    out = sess.generate(PROMPTS, 6)
    assert out.sequences == jax_tokens()
    assert sess.generate(PROMPTS, 6).sequences == out.sequences


@pytest.mark.parametrize("quant", ["none", "int8_mix"])
def test_checkpoints_cross_packages(tmp_path, quant):
    """JAX save_checkpoint (the per_pos / att / rec groups) -> port
    load_checkpoint: convert/from_jax's params leaf for leaf (and the f32
    model's greedy tokens the JAX session's); port save_checkpoint -> JAX
    load_checkpoint: the JAX params leaf for leaf."""
    jcfg, jp, tcfg, tp = model(quant)
    jckpt.save_checkpoint(str(tmp_path / "jax"), jp, jcfg)
    lp, lcfg = tckpt.load_checkpoint(str(tmp_path / "jax"), device=CPU)
    assert lcfg == tcfg
    for a, b in zip(jax.tree.leaves(lp), jax.tree.leaves(tp)):
        assert torch.equal(a, b)
    if quant == "none":
        sess = GenerationSession(lp, lcfg, max_seq_len=32,
                                 prefill_buckets=(8,), device=CPU)
        assert sess.generate(PROMPTS, 6).sequences == jax_tokens()
    tckpt.save_checkpoint(str(tmp_path / "port"), tp, tcfg)
    back, bcfg = jckpt.load_checkpoint(str(tmp_path / "port"))
    assert bcfg.to_dict() == jcfg.to_dict()
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(got) == len(want)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype, path
        np.testing.assert_array_equal(np.asarray(got[path], np.float32),
                                      np.asarray(leaf, np.float32))


def test_llm_over_hf_dir_and_checkpoint(tmp_path):
    """LLM over a random RecurrentGemma directory (tools/random_hf;
    quantized on first use, int8_mix) and over the checkpoint it wrote
    give the same tokens; that checkpoint equals the JAX package's
    quantize_hf_model output leaf for leaf."""
    from mixq_tensorrt_llm_tpu.convert import hf as jhf
    hf_dir = str(tmp_path / "hf")
    random_hf.write_random_recurrentgemma(hf_dir, HF, seed=2)
    llm = api.LLM(hf_dir, quant="int8_mix", max_seq_len=64, device=CPU,
                  cache_dir=str(tmp_path / "cache"))
    out = llm.generate_tokens([[1, 5, 9]], max_new_tokens=6)
    again = api.LLM(llm._ckpt_dir, max_seq_len=64, device=CPU)
    assert again.generate_tokens([[1, 5, 9]], 6).sequences == out.sequences
    assert out.num_generated == [6]
    jhf.quantize_hf_model(hf_dir, str(tmp_path / "jax"),
                          JQuant(algo=JAlgo.INT8_MIX))
    want = tckpt.read_safetensors(str(tmp_path / "jax" / "model.safetensors"))
    got = tckpt.read_safetensors(os.path.join(llm._ckpt_dir,
                                              "model.safetensors"))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _refuse_executor(cfg, params):
    Executor(params, cfg, max_batch=1, max_seq_len=32, block_size=8,
             prefill_chunk=8, device=CPU)


def _refuse_forward_paged(cfg, params):
    tcommon.forward_paged(params, cfg, torch.ones((1, 1), dtype=torch.int64),
                          torch.zeros((1, 1), dtype=torch.int32), None,
                          torch.zeros((1, 1), dtype=torch.int32),
                          torch.ones((1,), dtype=torch.int32))


def _refuse_beams(cfg, params):
    GenerationSession(params, cfg, max_seq_len=32, device=CPU).generate(
        PROMPTS, 4, num_beams=2)


def _refuse_calibration(cfg, params):
    tcalib.calibrate_act_scales(params, cfg, [TOKENS])


def _refuse_lora_ids(cfg, params):
    cache = tcommon.init_kv_cache(cfg, 2, 16, device=CPU)
    tcommon.forward(params, cfg, torch.from_numpy(TOKENS),
                    torch.arange(12, dtype=torch.int32)[None].expand(2, 12),
                    cache, torch.from_numpy(LENS),
                    lora_ids=torch.zeros(2, dtype=torch.int32))


def _refuse_speculative(cfg, params):
    from mixq_tensorrt_llm_tpu_torch.runtime.speculative import \
        speculative_generate_batched
    speculative_generate_batched(params, cfg, params, cfg, PROMPTS, 4,
                                 max_seq_len=32, device=CPU)


@pytest.mark.parametrize("refused", [
    _refuse_executor, _refuse_forward_paged, _refuse_beams,
    _refuse_calibration, _refuse_lora_ids, _refuse_speculative])
def test_refusals_name_the_arch(refused):
    """The paths the JAX package refuses (the Executor, forward_paged,
    beams, calibration, forward's LoRA ids) and session speculation, which
    cannot rewind a recurrent state, raise NotImplementedError naming the
    arch."""
    _, _, tcfg, tp = model()
    with pytest.raises(NotImplementedError, match="recurrentgemma"):
        refused(tcfg, tp)


def test_depth_off_the_pattern_refused():
    """A 26-layer config (the published depth, not a multiple of the
    3-layer pattern) is refused by both packages' readers, and by the
    port's ModelConfig."""
    ns = types.SimpleNamespace(**random_hf.RECURRENTGEMMA_2B_HF)
    with pytest.raises(AssertionError):
        jreg.config_from_hf(ns)
    with pytest.raises(ValueError, match="multiple of the block pattern"):
        treg.config_from_hf(ns)
    _, _, tcfg, _ = model()
    with pytest.raises(ValueError, match="multiple of the block pattern"):
        dataclasses.replace(tcfg, num_layers=26)
    with pytest.raises(ValueError, match="block pattern"):
        treg.config_from_hf(types.SimpleNamespace(
            **dict(HF, block_types=["recurrent", "attention"])))


def test_random_init_gives_finite_logits():
    """registry.init_random_params (int8_mix) on the CPU: finite logits."""
    _, _, tcfg, _ = model("int8_mix")
    params = treg.init_random_params(tcfg, seed=0, device=CPU)
    logits, _ = port_prefill(tcfg, params)
    assert np.isfinite(logits).all()
