"""Port parity: the quantization pipeline (convert/hf.py, calibrate.py,
from_float.py, models/llama.py's HF side, models/registry.py) against the
JAX package on tiny Hugging Face models that ``transformers`` writes here.

The port reads config.json with ``json`` and the weights with its own
reader; the JAX package reads them through ``AutoConfig`` and
``safetensors``. Checkpoints are compared tensor by tensor: integer
tensors exactly, floats within 1e-5. The outlier channels are planted
(both RMSNorm weights 20 on them, all else near 1), so that calibration's
top-k is unambiguous in both packages.

act_scales and collected stats: every float linear rounds its input to
bf16 in both packages (``ops/dispatch.py`` NONE), and f32 sums run in
another order in each framework, so past the first linear a rounding can
go the other way and move a channel's max. ``forward(collect_stats=True)``
and ``calibrate_act_scales`` on their few tokens agree within 1e-5 in
every module (largest reading 3.3e-7). The calibrated quantize_hf_model
(2 batches of 2 x 16 tokens) holds layer 0's qkv input at 1e-5 and the
rest within two bf16 steps (2^-7) of the module's largest value; its
largest readings, layer 0 / layer 1: qkv 6.6e-8 / 6.6e-6, o_proj 3.5e-7 /
2.7e-4, gate_up 6.6e-5 / 1.9e-4, down_proj 1.0e-3 / 1.7e-3.
"""

import dataclasses
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import calibrate as jcal
from mixq_tensorrt_llm_tpu.convert import from_float as jff
from mixq_tensorrt_llm_tpu.convert import hf as jhf
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant.config import (QuantAlgo as JAlgo,
                                                QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu_torch.convert import calibrate as tcal
from mixq_tensorrt_llm_tpu_torch.convert import from_float as tff
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import read_safetensors
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref
from mixq_tensorrt_llm_tpu_torch.quant.config import (QuantAlgo,
                                                      QuantConfig)

transformers = pytest.importorskip("transformers")

K = 8                        # outliers
FLOAT_TOL = 1e-5
BF16_TOL = 2.0 ** -7         # two bf16 steps, relative to the largest value
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-5)


def _planted(seed, h=64):
    rng = np.random.default_rng(seed)
    return np.sort(rng.choice(np.arange(K, h), K, replace=False))


def _save_tiny(d, arch="llama", seed=0, dtype=torch.float32, **kw):
    """A tiny HF model with bf16-exact weights and K planted channels a
    layer, saved with save_pretrained (+ a WordLevel tokenizer)."""
    from tokenizers import Tokenizer, models, pre_tokenizers
    cls = {"llama": (transformers.LlamaConfig,
                     transformers.LlamaForCausalLM),
           "qwen2": (transformers.Qwen2Config,
                     transformers.Qwen2ForCausalLM),
           "mistral": (transformers.MistralConfig,
                       transformers.MistralForCausalLM)}[arch]
    cfg = cls[0](**{**TINY, **kw})
    torch.manual_seed(seed)
    model = cls[1](cfg).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.bfloat16().float())
        for i, layer in enumerate(model.model.layers):
            ch = torch.from_numpy(_planted(seed + i))
            for norm in (layer.input_layernorm,
                         layer.post_attention_layernorm):
                norm.weight.fill_(1.0)
                norm.weight[ch] = 20.0
    model.to(dtype).save_pretrained(str(d))
    vocab = {f"w{i}": i for i in range(254)}
    vocab["<unk>"], vocab["</s>"] = 254, 255
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>",
        eos_token="</s>").save_pretrained(str(d))
    return str(d)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    mk = tmp_path_factory.mktemp
    return {
        "llama": _save_tiny(mk("llama")),
        "qwen2": _save_tiny(mk("qwen2"), "qwen2", seed=1,
                            tie_word_embeddings=True),
    }


def _batches(seed=0, n=2, b=2, s=16):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (b, s)).astype(np.int32) for _ in range(n)]


def _quant(algo, jax_side=False, **kw):
    if jax_side:
        return JQuant(algo=JAlgo(algo.value), num_outliers=K,
                      group_size=32, **kw)
    return QuantConfig(algo=algo, num_outliers=K, group_size=32, **kw)


def _assert_ckpt_equal(jdir, tdir):
    with open(os.path.join(jdir, "config.json")) as f:
        jc = json.load(f)
    with open(os.path.join(tdir, "config.json")) as f:
        tc = json.load(f)
    assert {k: jc[k] for k in tc} == tc
    jt = read_safetensors(os.path.join(jdir, "model.safetensors"))
    tt = read_safetensors(os.path.join(tdir, "model.safetensors"))
    assert sorted(jt) == sorted(tt)
    for name in jt:
        a, b = jt[name], tt[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype in (torch.int8, torch.int32):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(b.float(), a.float(), rtol=FLOAT_TOL,
                                       atol=FLOAT_TOL, msg=name)


def _assert_scales_close(want, got, past_first=BF16_TOL):
    """Each module within FLOAT_TOL of its largest value at layer 0's qkv
    input, within ``past_first`` elsewhere."""
    assert sorted(want) == sorted(got)
    for key in want:
        a = np.asarray(want[key], np.float32)
        b = np.asarray(got[key], np.float32)
        tol = FLOAT_TOL if key.startswith("model.layers.0.self_attn.") \
            and key[-6:] in ("q_proj", "k_proj", "v_proj") else past_first
        err = np.abs(a - b).max() / np.abs(a).max()
        assert err <= tol, (key, err)


# ---------------------------------------------------------------------------
# config.json -> ModelConfig
# ---------------------------------------------------------------------------

CONFIGS = {
    "llama": ("llama", dict(TINY, head_dim=16)),
    "mistral_window": ("mistral", dict(TINY, sliding_window=32)),
    "qwen2_tied": ("qwen2", dict(TINY, tie_word_embeddings=True)),
    "qwen2_window_off": ("qwen2", dict(TINY, sliding_window=64,
                                       use_sliding_window=False)),
    "llama3_rope": ("llama", dict(TINY, rope_scaling=dict(
        rope_type="llama3", factor=8.0, low_freq_factor=1.0,
        high_freq_factor=4.0, original_max_position_embeddings=64))),
    "linear_rope": ("llama", dict(TINY, rope_scaling=dict(type="linear",
                                                          factor=2.0))),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_from_hf_matches_autoconfig(name, tmp_path):
    """The port's JSON reader against JAX through AutoConfig, the config
    saved with save_pretrained, and a bare config.json holding only
    model_type (every other field at its class default)."""
    arch, kw = CONFIGS[name]
    cls = {"llama": transformers.LlamaConfig,
           "mistral": transformers.MistralConfig,
           "qwen2": transformers.Qwen2Config}[arch]
    cls(**kw).save_pretrained(str(tmp_path / "full"))
    os.makedirs(tmp_path / "bare")
    with open(tmp_path / "bare" / "config.json", "w") as f:
        json.dump({"model_type": arch}, f)
    for d in ("full", "bare"):
        path = str(tmp_path / d)
        jcfg = jllama.config_from_hf(transformers.AutoConfig.from_pretrained(
            path))
        tcfg = treg.config_from_hf(thf.load_hf_config(path))
        jd, td = jcfg.to_dict(), tcfg.to_dict()
        assert {k: jd[k] for k in td} == td, d
        assert tcommon.ModelConfig.from_dict(jd) == tcfg


def test_unported_model_types_and_options_raise(tmp_path):
    # the recurrent-state models are ported (models/mamba.py,
    # models/recurrentgemma.py): bare config.json files read at their
    # class defaults (RecurrentGemma's 26 layers cut to 24: both packages
    # refuse a depth off its 3-layer pattern)
    for mt, extra, arch in (("mamba", {}, "mamba"),
                            ("recurrent_gemma", {"num_hidden_layers": 24},
                             "recurrentgemma")):
        os.makedirs(tmp_path / mt)
        with open(tmp_path / mt / "config.json", "w") as f:
            json.dump({"model_type": mt, **extra}, f)
        assert treg.config_from_hf(thf.load_hf_config(
            str(tmp_path / mt))).arch == arch
    # the expert models are ported (models/moe.py): a bare Mixtral
    # config.json reads at its class defaults
    os.makedirs(tmp_path / "mixtral")
    with open(tmp_path / "mixtral" / "config.json", "w") as f:
        json.dump({"model_type": "mixtral"}, f)
    mcfg = treg.config_from_hf(thf.load_hf_config(str(tmp_path / "mixtral")))
    assert (mcfg.arch, mcfg.num_experts, mcfg.top_k_experts) == \
        ("mixtral", 8, 2)
    with pytest.raises(ValueError, match="unsupported"):
        treg.config_from_hf(_ns(model_type="nonesuch"))
    # ported with the dense families: gemma (models/families.py) from a
    # bare config.json at its class defaults, aquila (Llama's converter
    # over Llama's defaults) and yarn RoPE, each as JAX reads it
    os.makedirs(tmp_path / "gemma")
    with open(tmp_path / "gemma" / "config.json", "w") as f:
        json.dump({"model_type": "gemma"}, f)
    from mixq_tensorrt_llm_tpu.models import registry as jreg
    jd = jreg.config_from_hf(transformers.AutoConfig.from_pretrained(
        str(tmp_path / "gemma"))).to_dict()
    tcfg = treg.config_from_hf(thf.load_hf_config(str(tmp_path / "gemma")))
    assert tcfg.arch == "gemma" and tcfg.to_dict() == jd
    os.makedirs(tmp_path / "aquila")
    with open(tmp_path / "aquila" / "config.json", "w") as f:
        json.dump(dict(TINY, model_type="aquila"), f)
    jaq = transformers.LlamaConfig(**TINY)
    jaq.model_type = "aquila"
    tcfg = treg.config_from_hf(thf.load_hf_config(str(tmp_path / "aquila")))
    assert tcfg.arch == "llama"
    assert tcfg.to_dict() == jreg.config_from_hf(jaq).to_dict()
    transformers.LlamaConfig(**TINY, rope_scaling=dict(
        rope_type="yarn", factor=4.0,
        original_max_position_embeddings=64)).save_pretrained(str(tmp_path))
    tcfg = treg.config_from_hf(thf.load_hf_config(str(tmp_path)))
    jcfg = jllama.config_from_hf(transformers.AutoConfig.from_pretrained(
        str(tmp_path)))
    assert tcfg.rope_scaling_type == "yarn"
    assert tcfg.to_dict() == jcfg.to_dict()
    # lora_dir is ported: an adapter directory without weights raises
    # FileNotFoundError, as JAX's merge does
    from mixq_tensorrt_llm_tpu_torch.convert.lora import \
        merge_lora_into_state_dict
    os.makedirs(tmp_path / "adapter")
    with open(tmp_path / "adapter" / "adapter_config.json", "w") as f:
        json.dump({"r": 4, "lora_alpha": 8}, f)
    with pytest.raises(FileNotFoundError, match="no adapter weights"):
        merge_lora_into_state_dict({}, str(tmp_path / "adapter"))


def _ns(**kw):
    import types
    return types.SimpleNamespace(**kw)


# ---------------------------------------------------------------------------
# quantize_hf_model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def calibrated(dirs, tmp_path_factory):
    """int8_mix with calibration, by both packages (f32 models)."""
    out = tmp_path_factory.mktemp("calib")
    jcfg = jhf.quantize_hf_model(dirs["llama"], str(out / "j"),
                                 _quant(QuantAlgo.INT8_MIX, True),
                                 calib_batches=_batches(),
                                 dtype=jnp.float32)
    tcfg = thf.quantize_hf_model(dirs["llama"], str(out / "t"),
                                 _quant(QuantAlgo.INT8_MIX),
                                 calib_batches=_batches(),
                                 dtype=torch.float32, device="cpu")
    return str(out / "j"), str(out / "t"), jcfg, tcfg


def test_quantize_calibrated_matches_jax(calibrated, dirs):
    jdir, tdir, jcfg, tcfg = calibrated
    _assert_ckpt_equal(jdir, tdir)
    want = dict(np.load(os.path.join(jdir, "act_scales.npz")))
    _assert_scales_close(want, tcal.load_act_scales(
        os.path.join(tdir, "act_scales.npz")))
    fp_ind = read_safetensors(os.path.join(tdir, "model.safetensors"))[
        "layers.qkv_proj.fp_ind"]
    for i in range(2):           # calibration found the planted channels
        np.testing.assert_array_equal(fp_ind[i].numpy(), _planted(i))
    for name in ("tokenizer.json", "tokenizer_config.json",
                 "special_tokens_map.json"):
        assert os.path.exists(os.path.join(tdir, name)), name


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_quantize_from_act_scales_file_matches_jax(fmt, calibrated, dirs,
                                                   tmp_path):
    """An act_scales artifact in the reference's key convention (.pt, a
    torch dict) or the packages' own .npz, given by path to both."""
    scales = tcal.load_act_scales(os.path.join(calibrated[1],
                                               "act_scales.npz"))
    path = str(tmp_path / f"scales.{fmt}")
    if fmt == "pt":
        torch.save({k: v.half() for k, v in scales.items()}, path)
    else:
        tcal.save_act_scales(scales, path)
    jhf.quantize_hf_model(dirs["llama"], str(tmp_path / "j"),
                          _quant(QuantAlgo.INT8_MIX, True),
                          act_scales_path=path, dtype=jnp.float32)
    thf.quantize_hf_model(dirs["llama"], str(tmp_path / "t"),
                          _quant(QuantAlgo.INT8_MIX), act_scales_path=path,
                          dtype=torch.float32, device="cpu")
    _assert_ckpt_equal(str(tmp_path / "j"), str(tmp_path / "t"))
    got = np.load(str(tmp_path / "t" / "act_scales.npz"))
    want = np.load(str(tmp_path / "j" / "act_scales.npz"))
    for k in want.files:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("algo", [QuantAlgo.W8A16, QuantAlgo.W4A16,
                                  QuantAlgo.W4A16_G, QuantAlgo.INT4_MIX,
                                  QuantAlgo.NONE])
def test_quantize_matches_jax(algo, dirs, tmp_path):
    """Each algo from the Qwen2 directory (biases, tied embeddings);
    int4_mix without act_scales falls back to ones in both."""
    jhf.quantize_hf_model(dirs["qwen2"], str(tmp_path / "j"),
                          _quant(algo, True), dtype=jnp.float32)
    thf.quantize_hf_model(dirs["qwen2"], str(tmp_path / "t"), _quant(algo),
                          dtype=torch.float32, device="cpu")
    _assert_ckpt_equal(str(tmp_path / "j"), str(tmp_path / "t"))
    assert os.path.exists(str(tmp_path / "t" / "tokenizer.json"))


def test_quantize_needs_neither_transformers_nor_safetensors(
        calibrated, dirs, tmp_path, monkeypatch):
    """As on the card: both packages unimportable."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    monkeypatch.setitem(sys.modules, "safetensors", None)
    with pytest.raises(ImportError):
        import transformers as _  # noqa: F401
    thf.quantize_hf_model(dirs["llama"], str(tmp_path / "t"),
                          _quant(QuantAlgo.INT8_MIX),
                          act_scales_path=os.path.join(calibrated[1],
                                                       "act_scales.npz"),
                          dtype=torch.float32, device="cpu")
    _assert_ckpt_equal(calibrated[1], str(tmp_path / "t"))


@pytest.mark.parametrize("fmt", ["f16_sharded", "bf16", "bin"])
def test_reads_hf_weight_files(fmt, tmp_path):
    """Sharded F16 safetensors, BF16 and pytorch_model.bin read to the
    tensors transformers saved, in their file dtype."""
    dtype = torch.bfloat16 if fmt == "bf16" else torch.float16
    model = transformers.LlamaForCausalLM(transformers.LlamaConfig(**TINY))
    model.to(dtype).save_pretrained(
        str(tmp_path), safe_serialization=fmt != "bin",
        max_shard_size="60KB" if fmt == "f16_sharded" else "5GB")
    files = os.listdir(tmp_path)
    if fmt == "f16_sharded":
        assert "model.safetensors.index.json" in files
    if fmt == "bin":
        assert not any(f.endswith(".safetensors") for f in files)
    sd = thf.load_hf_state_dict(str(tmp_path))
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for name, t in want.items():
        assert sd[name].dtype == dtype and torch.equal(sd[name], t), name


# ---------------------------------------------------------------------------
# forward: f32 against transformers, collect_stats and requantize vs JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama", "qwen2"])
def test_float_forward_matches_transformers(arch, dirs, monkeypatch):
    """The converted float model's logits against transformers' f32
    logits within 1e-4. The weights are bf16-exact, and the float linears'
    bf16 rounding of their inputs (JAX's NONE route, kept by the port) is
    switched off here, so the mapping (fusion, layout, biases, tied head,
    RoPE) is held at f32."""
    monkeypatch.setattr(tref, "bf16_matmul_f32",
                        lambda x, w: x.float() @ w.float())
    d = dirs[arch]
    cfg = dataclasses.replace(treg.config_from_hf(thf.load_hf_config(d)),
                              dtype=torch.float32)
    params = treg.params_from_hf(cfg, thf.load_hf_state_dict(d),
                                 device="cpu")
    tokens = torch.from_numpy(_batches(3, 1, 2, 24)[0]).long()
    with torch.no_grad():
        want = transformers.AutoModelForCausalLM.from_pretrained(d)(
            tokens).logits
    b, s = tokens.shape
    cache = tcommon.init_kv_cache(cfg, b, s, device="cpu")
    pos = torch.arange(s)[None].expand(b, s)
    got, _ = tcommon.forward(params, cfg, tokens, pos, cache,
                             torch.full((b,), s), full_prefill=True)
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= 1e-4, err


@pytest.fixture(scope="module")
def float_models(dirs):
    """The llama directory's float model in both packages (f32 dtype)."""
    d = dirs["llama"]
    jcfg = dataclasses.replace(jllama.config_from_hf(
        transformers.AutoConfig.from_pretrained(d)), dtype=jnp.float32)
    jp = jllama.params_from_hf(jcfg, jhf.load_hf_state_dict(d))
    tcfg = dataclasses.replace(treg.config_from_hf(thf.load_hf_config(d)),
                               dtype=torch.float32)
    tp = treg.params_from_hf(tcfg, thf.load_hf_state_dict(d), device="cpu")
    return jcfg, jp, tcfg, tp


def test_collect_stats_matches_jax(float_models):
    jcfg, jp, tcfg, tp = float_models
    tokens = _batches(5, 1, 2, 16)[0]
    b, s = tokens.shape
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    lens = np.full((b,), s, np.int32)
    jl, _, jst = jcommon.forward(jp, jcfg, jnp.asarray(tokens),
                                 jnp.asarray(pos),
                                 jcommon.init_kv_cache(jcfg, b, s),
                                 jnp.asarray(lens), collect_stats=True,
                                 full_prefill=True)
    tl, _, tst = tcommon.forward(
        tp, tcfg, torch.from_numpy(tokens), torch.from_numpy(pos),
        tcommon.init_kv_cache(tcfg, b, s, device="cpu"),
        torch.from_numpy(lens), collect_stats=True, full_prefill=True)
    assert sorted(jst) == sorted(tst)
    for mod in jst:
        want, got = np.asarray(jst[mod]), tst[mod].numpy()
        assert got.shape == want.shape == (2, want.shape[1])
        for i in range(2):
            err = np.abs(got[i] - want[i]).max() / np.abs(want[i]).max()
            assert err <= FLOAT_TOL, (mod, i, err)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-3,
                               rtol=0)


@pytest.mark.parametrize("algo", [QuantAlgo.INT8_MIX, QuantAlgo.W4A16])
def test_requantize_matches_jax(algo, float_models):
    """The float tree requantized, with the planted channels as act_scales
    for the mix linears."""
    jcfg, jp, tcfg, tp = float_models
    scales = {f"model.layers.{i}.{m}": np.where(
        np.isin(np.arange(n), _planted(i)), 9.0, 1.0).astype(np.float32)
        for i in range(2) for m, n in (("self_attn.q_proj", 64),
                                       ("self_attn.o_proj", 64),
                                       ("mlp.gate_proj", 64),
                                       ("mlp.down_proj", 128))}
    jq, jqc = jff.requantize(jp, jcfg, _quant(algo, True), scales)
    tq, tqc = tff.requantize(tp, tcfg, _quant(algo), scales)
    assert tqc.to_dict() == {k: jqc.to_dict()[k] for k in tqc.to_dict()}
    for name in ("embed", "final_norm", "lm_head"):
        for leaf, t in tq[name].items():
            np.testing.assert_array_equal(
                t.float().numpy(), np.asarray(jq[name][leaf], np.float32))
    for i, layer in enumerate(tq["layers"]):
        for mod, leaves in layer.items():
            assert sorted(leaves) == sorted(jq["layers"][mod]), mod
            for leaf, t in leaves.items():
                np.testing.assert_array_equal(
                    t.float().numpy(), np.asarray(
                        jq["layers"][mod][leaf][i], np.float32),
                    err_msg=f"{mod}.{leaf}")


def test_calibrate_act_scales_matches_jax(float_models):
    """calibrate_act_scales itself, with ragged batch shapes and a (S,)
    batch, in both packages."""
    jcfg, jp, tcfg, tp = float_models
    batches = _batches(7, 1, 3, 12) + [np.arange(1, 9, dtype=np.int32)]
    want = jcal.calibrate_act_scales(jp, jcfg, batches)
    got = tcal.calibrate_act_scales(tp, tcfg, batches)
    _assert_scales_close(want, got, past_first=FLOAT_TOL)
    with pytest.raises(ValueError, match="float"):
        tcal.calibrate_act_scales(tp, dataclasses.replace(
            tcfg, quant=_quant(QuantAlgo.INT8_MIX)), batches)


def test_llm_quantizes_caches_and_generates(calibrated, dirs, tmp_path):
    """LLM over an HF directory: quantized on first use into the cache
    directory JAX's LLM would name (the same key), loaded from there the
    second time with nothing written; tokenizer from the HF directory."""
    from mixq_tensorrt_llm_tpu.api import LLM as JLLM
    from mixq_tensorrt_llm_tpu_torch.api import LLM
    scales = os.path.join(calibrated[1], "act_scales.npz")
    kw = dict(quant="int8_mix", kv_cache_quant="int8",
              act_scales_path=scales, max_seq_len=64)
    llm = LLM(dirs["llama"], cache_dir=str(tmp_path / "t"), device="cpu",
              **kw)
    weights = os.path.join(llm._ckpt_dir, "model.safetensors")
    stamp = os.stat(weights).st_mtime_ns
    want = JLLM(dirs["llama"], cache_dir=str(tmp_path / "j"), **kw)
    assert os.path.basename(llm._ckpt_dir) == os.path.basename(
        want._ckpt_dir)
    _assert_ckpt_equal(want._ckpt_dir, llm._ckpt_dir)
    again = LLM(dirs["llama"], cache_dir=str(tmp_path / "t"), device="cpu",
                **kw)
    assert again._ckpt_dir == llm._ckpt_dir
    assert os.stat(weights).st_mtime_ns == stamp
    assert again.cfg.quant.kv_cache.value == "int8"
    assert again.tokenizer is not None
    out = again.generate_tokens([[1, 2, 3]], max_new_tokens=4)
    assert out.num_generated == [4]
    assert isinstance(again.generate("w1 w2", max_new_tokens=2), str)
    assert again.evaluate_ppl(list(range(100)), seq_len=32).blocks == 3


def test_random_hf_directory_loads_in_transformers(tmp_path):
    """tools/random_hf.py (what chip_smoke.py phase 4h writes, at 7B): a
    sharded directory transformers loads, its tensors the port's reader
    gives, the planted channels at the gain in both norms, none below the
    outlier count."""
    from mixq_tensorrt_llm_tpu_torch.tools.random_hf import (
        LLAMA2_7B_HF, write_random_llama)
    config = dict(LLAMA2_7B_HF, hidden_size=64, intermediate_size=128,
                  num_hidden_layers=3, num_attention_heads=4,
                  num_key_value_heads=2, vocab_size=96)
    planted = write_random_llama(str(tmp_path), config, seed=2,
                                 device="cpu", layers_per_shard=2,
                                 outliers=K)
    index = json.load(open(tmp_path / "model.safetensors.index.json"))
    assert sorted(set(index["weight_map"].values())) == [
        "model-00001-of-00002.safetensors",
        "model-00002-of-00002.safetensors"]
    model = transformers.AutoModelForCausalLM.from_pretrained(str(tmp_path))
    sd = thf.load_hf_state_dict(str(tmp_path))
    assert sorted(sd) == sorted(model.state_dict())
    for name, t in model.state_dict().items():
        assert torch.equal(sd[name].float(), t.float()), name
    for i, ch in planted.items():
        assert len(ch) == K and int(ch.min()) >= K
        for norm in ("input_layernorm", "post_attention_layernorm"):
            w = sd[f"model.layers.{i}.{norm}.weight"].float()
            assert torch.equal(torch.nonzero(w == 20.0)[:, 0], ch)
    cfg = treg.config_from_hf(thf.load_hf_config(str(tmp_path)))
    assert (cfg.num_layers, cfg.num_kv_heads, cfg.rms_norm_eps) == (3, 2,
                                                                     1e-5)
