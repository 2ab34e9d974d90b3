"""Port parity of the Mamba family (models/mamba.py, models.common's
dispatch to it, the session, LLM, the checkpoint and HF readers, the
refusals) against the JAX package on the CPU, at JAX tests/test_mamba.py's
tiny size (vocab 256, hidden 64, d_state 8, d_inner 128, dt_rank 4, conv
4, 2 layers).

Weights are random HF state dicts drawn from a numpy seed
(tools/random_hf), converted by the JAX package's params_from_hf and
carried into the port by convert/from_jax.py. Tolerances: the f32 model's
logits within 1e-4 of max |JAX| and its states within 1e-5 of their max
(the port's blocked scan sums in another order than
jax.lax.associative_scan); int8_mix logits within 2e-2 (K1 / K2's plain
versions here); greedy tokens of f32 models identical. The JAX package's
results are computed once per configuration (module fixtures).
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
from mixq_tensorrt_llm_tpu_torch import api, cli
from mixq_tensorrt_llm_tpu_torch.convert import calibrate as tcalib
from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as tckpt
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.from_jax import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import mamba as tmamba
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo, QuantConfig
from mixq_tensorrt_llm_tpu_torch.tools import random_hf

LOGIT_TOL, STATE_TOL, MIX_TOL = 1e-4, 1e-5, 2e-2
CPU = torch.device("cpu")
HF = dict(random_hf.MAMBA_2_8B_HF, vocab_size=256, hidden_size=64,
          intermediate_size=128, state_size=8, num_hidden_layers=2,
          time_step_rank=4)
# lane 0 full, lane 1 right-padded after 5 tokens
TOKENS = np.random.default_rng(1).integers(3, 256, (2, 8)).astype(np.int32)
LENS = np.array([8, 5], np.int32)
PROMPTS = [[1, 5, 9], [4, 2, 7, 7, 1]]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


@functools.lru_cache(maxsize=None)
def _state_dict():
    return random_hf.random_mamba_state(HF, seed=0)


@functools.lru_cache(maxsize=None)
def model(quant: str = "none"):
    """(JAX cfg, JAX params, port cfg, port params) of the f32 model under
    ``quant`` (int8_mix: 8 outliers), both from one HF state dict."""
    ns = types.SimpleNamespace(**HF)
    q = {"none": (JQuant(), QuantConfig()),
         "int8_mix": (JQuant(algo=JAlgo.INT8_MIX, num_outliers=8),
                      QuantConfig(algo=QuantAlgo.INT8_MIX,
                                  num_outliers=8))}[quant]
    jcfg = dataclasses.replace(jreg.config_from_hf(ns, q[0]),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(treg.config_from_hf(ns, q[1]),
                               dtype=torch.float32)
    jp = jreg.params_from_hf(jcfg, _state_dict())
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device=CPU)
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def jax_prefill(quant: str = "none"):
    """The JAX package's prefill of TOKENS: (logits, (conv, ssm))."""
    jcfg, jp, _, _ = model(quant)
    b, s = TOKENS.shape
    cache = jcommon.init_kv_cache(jcfg, b, 16)
    pos = jnp.tile(jnp.arange(s, dtype=jnp.int32), (b, 1))
    logits, cache = jcommon.forward(jp, jcfg, jnp.asarray(TOKENS), pos,
                                    cache, jnp.asarray(LENS))
    return np.asarray(logits), (np.asarray(cache.k, np.float32),
                                np.asarray(cache.v))


def port_prefill(cfg, params, tokens=TOKENS, lens=LENS):
    b, s = tokens.shape
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
    config.json (save_pretrained), a bare one (every MambaConfig default,
    d_inner and dt_rank computed) and the published mamba-2.8b-hf one:
    the ModelConfig equal field for field to the JAX package's over
    AutoConfig, and the config.json layouts read both ways."""
    import transformers
    kw = dict(vocab_size=256, hidden_size=64, state_size=8,
              num_hidden_layers=2, conv_kernel=4, expand=2,
              time_step_rank=4, use_conv_bias=False)
    transformers.MambaConfig(**kw).save_pretrained(str(tmp_path / "diff"))
    for name, d in (("bare", {"model_type": "mamba"}),
                    ("published", random_hf.MAMBA_2_8B_HF)):
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
    assert (tcfg.intermediate_size, tcfg.dt_rank, tcfg.ssm_state_size) == \
        (5120, 160, 16)


def test_forward_logits_and_states_match_jax():
    """The f32 model's prefill of a full and a right-padded lane: logits
    within 1e-4, the conv carry and the SSM state within 1e-5 of
    JAX's."""
    jl, (jconv, jssm) = jax_prefill()
    _, _, tcfg, tp = model()
    tl, cache = port_prefill(tcfg, tp)
    assert _rel(tl, jl) < LOGIT_TOL
    assert _rel(_np(cache.k), jconv) < STATE_TOL
    assert _rel(_np(cache.v), jssm) < STATE_TOL
    assert cache.k.dtype == tcfg.dtype and cache.v.dtype == torch.float32


def test_chunked_scan_matches_jax(monkeypatch):
    """A prefill scan cut into chunks of 3 tokens (h carried across the
    chunks) and blocks of 2 (one padded) within the same tolerances of
    JAX's one associative scan."""
    monkeypatch.setattr(tmamba, "SCAN_CHUNK", 3)
    monkeypatch.setattr(tmamba, "SCAN_BLOCK", 2)
    jl, (_, jssm) = jax_prefill()
    _, _, tcfg, tp = model()
    tl, cache = port_prefill(tcfg, tp)
    assert _rel(tl, jl) < LOGIT_TOL
    assert _rel(_np(cache.v), jssm) < STATE_TOL


@pytest.mark.parametrize("s", [1, 2, 5, 8, 13, 16, 17, 40, 300])
def test_linear_scan_matches_the_recurrence(s):
    """``linear_scan`` against the step-by-step recurrence from h0: one
    block, a padded last block, and (300) blocks of blocks."""
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0, 1, (2, s, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, s, 3, 4)).astype(
        np.float32))
    h = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    got = tmamba.linear_scan(a, b, h)
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        assert float((got[:, t] - h).abs().max()) < 1e-5


def test_prefill_then_decodes_equal_prefill():
    """prefill(5) + 3 single-token decodes give prefill(8)'s last logits:
    the conv carry and the SSM state round-trip through the cache."""
    _, _, tcfg, tp = model()
    toks = TOKENS[:1]
    full, _ = port_prefill(tcfg, tp, toks, LENS[:1])
    cache = tcommon.init_kv_cache(tcfg, 1, 16, device=CPU)
    pos = torch.arange(8, dtype=torch.int32)[None]
    tcommon.forward(tp, tcfg, torch.from_numpy(toks), pos, cache,
                    torch.tensor([5]))
    for t in range(5, 8):
        last, _ = tcommon.forward(
            tp, tcfg, torch.from_numpy(toks[:, t:t + 1]),
            torch.tensor([[t]], dtype=torch.int32), cache,
            torch.tensor([t + 1]))
    assert _rel(_np(last[:, 0]), full[:, -1]) < LOGIT_TOL


def test_padded_lane_leaves_state_untouched():
    """Lane 1's pads (positions 5..7) leave its conv carry and SSM state
    where a solo run of its 5 tokens leaves them, and its logits at the
    valid positions equal."""
    _, _, tcfg, tp = model()
    both, cache = port_prefill(tcfg, tp)
    solo, solo_cache = port_prefill(tcfg, tp, TOKENS[1:, :5], LENS[1:])
    assert _rel(both[1, :5], solo[0]) < 1e-6
    assert _rel(_np(cache.k[:, 1]), _np(solo_cache.k[:, 0])) < 1e-6
    assert _rel(_np(cache.v[:, 1]), _np(solo_cache.v[:, 0])) < 1e-6


def test_int8_mix_matches_jax():
    """int8_mix (in_proj and out_proj K1 -> K2, here their plain versions)
    within 2e-2 of JAX's int8_mix, and within sight of the f32 model."""
    jl, _ = jax_prefill("int8_mix")
    _, _, tcfg, tp = model("int8_mix")
    assert set(tp["layers"][0]["in_proj"]) == {"qweight", "scale_col",
                                               "fp_ind", "fp_weight"}
    tl, _ = port_prefill(tcfg, tp)
    assert _rel(tl, jl) < MIX_TOL
    assert _rel(tl, jax_prefill()[0]) < 0.5


def test_session_greedy_tokens_match_jax():
    """GenerationSession on the CPU: greedy tokens identical to the JAX
    session's (the f32 model, one 8-token bucket)."""
    _, _, tcfg, tp = model()
    sess = GenerationSession(tp, tcfg, max_seq_len=32, prefill_buckets=(8,),
                             device=CPU)
    out = sess.generate(PROMPTS, 6)
    assert out.sequences == jax_tokens()
    # a second call on the same session starts from a fresh state
    assert sess.generate(PROMPTS, 6).sequences == out.sequences


@pytest.mark.parametrize("quant", ["none", "int8_mix"])
def test_checkpoints_cross_packages(tmp_path, quant):
    """JAX save_checkpoint -> port load_checkpoint: the params convert
    /from_jax gives, leaf for leaf (and the f32 model's greedy tokens
    the JAX session's); port save_checkpoint -> JAX load_checkpoint: the
    JAX params leaf for leaf, the config field for field."""
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


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    """A random Mamba directory (tools/random_hf) with a WordLevel
    tokenizer."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    import transformers
    d = tmp_path_factory.mktemp("mamba_hf")
    random_hf.write_random_mamba(str(d), HF, seed=2)
    vocab = {f"w{i}": i for i in range(255)}
    vocab["<unk>"] = 255
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>").save_pretrained(str(d))
    return str(d)


def test_llm_over_hf_dir_checkpoint_and_cli(hf_dir, tmp_path, monkeypatch,
                                            capsys):
    """LLM over the HF directory (quantized on first use, int8_mix) and
    over the checkpoint it wrote give the same tokens; the checkpoint
    equals the JAX package's quantize_hf_model output leaf for leaf; the
    CLI's generate serves the directory; perplexity through eval/ is
    finite."""
    from mixq_tensorrt_llm_tpu.convert import hf as jhf
    kw = dict(quant="int8_mix", max_seq_len=64, device=CPU,
              cache_dir=str(tmp_path / "cache"))
    llm = api.LLM(hf_dir, **kw)
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

    ppl = llm.evaluate_ppl(list(range(1, 129)), seq_len=32, batch_size=2)
    assert np.isfinite(ppl.ppl) and ppl.blocks == 4

    monkeypatch.setattr(api, "LLM", functools.partial(api.LLM, device=CPU))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    cli.main(["generate", "--model", hf_dir, "--quant", "int8_mix",
              "--prompt", "w1 w5 w9", "--max_new_tokens", "4",
              "--max_seq_len", "64", "--output_logprobs"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "--- prompt: 'w1 w5 w9'"
    assert len(json.loads(lines[-1])["logprobs"]) == 4


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


def _refuse_collect_stats(cfg, params):
    cache = tcommon.init_kv_cache(cfg, 2, 16, device=CPU)
    tcommon.forward(params, cfg, torch.from_numpy(TOKENS),
                    torch.arange(8, dtype=torch.int32)[None].expand(2, 8),
                    cache, torch.from_numpy(LENS), collect_stats=True)


def _refuse_speculative(cfg, params):
    from mixq_tensorrt_llm_tpu_torch.runtime.speculative import \
        speculative_generate_batched
    speculative_generate_batched(params, cfg, params, cfg, PROMPTS, 4,
                                 max_seq_len=32, device=CPU)


@pytest.mark.parametrize("refused", [
    _refuse_executor, _refuse_forward_paged, _refuse_beams,
    _refuse_calibration, _refuse_collect_stats, _refuse_speculative])
def test_refusals_name_the_arch(refused):
    """The paths the JAX package refuses (the Executor, forward_paged,
    beams, calibration, forward's stats) and session speculation, which
    cannot rewind a recurrent state, raise NotImplementedError naming
    the arch."""
    _, _, tcfg, tp = model()
    with pytest.raises(NotImplementedError, match="mamba"):
        refused(tcfg, tp)


def test_random_init_gives_finite_logits():
    """registry.init_random_params (int8_mix) on the CPU: finite logits."""
    _, _, tcfg, _ = model("int8_mix")
    params = treg.init_random_params(tcfg, seed=0, device=CPU)
    logits, _ = port_prefill(tcfg, params)
    assert np.isfinite(logits).all()
