"""Port parity of the dense decoder families (models/families.py, the
config axes of models/common.py, ops/ref.layernorm, the RoPE variants,
ALiBi) against the JAX package, on the tiny Hugging Face models of
tests/test_model_families.py (built here with ``transformers``, f32).

For each of the 21 dense model types (Falcon in its multi-query and its
new-decoder form): ``convert.hf.load_hf_config`` on the diff-only
config.json that ``save_pretrained`` writes against ``AutoConfig``;
``registry.config_from_hf`` against JAX's (``to_dict`` equal);
``registry.params_from_hf`` against JAX's, bit-equal leaf by leaf after
``params_from_numpy``; the f32 prefill forward's logits and its
collect_stats absmaxes (calibration's signal) within 1e-5 of JAX's.

The float linears of both packages round their inputs to bf16
(``ops/dispatch.py`` NONE), and the two frameworks' activation functions
differ in the last f32 bit, so a rounding can go the other way and move a
logit by ~1e-3 (readings with the shipped bf16 products: GPT-2 5.5e-4,
MPT 1.6e-3, GLM 2.2e-4; every other family below 3e-7). The 1e-5
comparison therefore runs both packages' float products in f32 (the
port's ``ops.ref.bf16_matmul_f32``, JAX's ``jnp.bfloat16`` inside its
dispatch and decoder modules, patched for the forward only; readings
below 4e-7).

int8_mix forwards (opt, gptj, bloom, phi, gemma, gemma2, qwen3) on the
same quantized params, the logits held to JAX's own
tests/test_model_families.py tolerances (relative error 0.2, argmax
agreement 0.75), here port against JAX; the quantized params bit-equal to
JAX's for opt and gemma2.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import registry as jreg
from mixq_tensorrt_llm_tpu.ops import dispatch as jdispatch
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.from_jax import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import families as tfam
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.ops import ref as tref
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo, QuantConfig

transformers = pytest.importorskip("transformers")
from test_model_families import FAMILIES, TOKENS  # noqa: E402

NAMES = sorted(n for n in FAMILIES
               if n not in ("qwen2_moe", "qwen3_moe", "dbrx"))
F32_TOL = 1e-5
INT8_NAMES = ["opt", "gptj", "bloom", "phi", "gemma", "gemma2", "qwen3"]


class _F32Jnp:
    """jax.numpy with bfloat16 read as float32 (the JAX modules' float
    products in f32)."""
    bfloat16 = jnp.float32

    def __getattr__(self, name):
        return getattr(jnp, name)


@contextlib.contextmanager
def _f32_products():
    """Both packages' float linears and tied heads as f32 products."""
    saved = (jdispatch.jnp, jcommon.jnp, tref.bf16_matmul_f32)
    jdispatch.jnp = jcommon.jnp = _F32Jnp()
    tref.bf16_matmul_f32 = lambda x, w: x.float() @ w.float()
    try:
        yield
    finally:
        jdispatch.jnp, jcommon.jnp, tref.bf16_matmul_f32 = saved


def _hf(name):
    cls, hf_cfg = FAMILIES[name]()
    torch.manual_seed(0)
    model = cls(hf_cfg).eval().float()
    return hf_cfg, {k: v.detach() for k, v in model.state_dict().items()}


def _jax_logits(cfg, params, tokens=TOKENS, stats=False):
    """JAX's prefill logits (and with ``stats`` its collect_stats
    absmaxes, {module: (L, in)})."""
    b, s = tokens.shape
    cache = jcommon.init_kv_cache(cfg, b, 16 if s <= 16 else s)
    pos = jnp.tile(jnp.arange(s), (b, 1))
    out = jcommon.forward(params, cfg, jnp.asarray(tokens), pos, cache,
                          jnp.full((b,), s, jnp.int32),
                          collect_stats=stats, full_prefill=stats)
    if stats:
        return np.asarray(out[0]), {m: np.asarray(v)
                                    for m, v in out[2].items()}
    return np.asarray(out[0])


def _port_logits(cfg, params, tokens=TOKENS, stats=False):
    b, s = tokens.shape
    cache = tcommon.init_kv_cache(cfg, b, 16 if s <= 16 else s,
                                  device="cpu")
    pos = torch.arange(s, dtype=torch.int32)[None].expand(b, s)
    out = tcommon.forward(params, cfg, torch.from_numpy(tokens), pos, cache,
                          torch.full((b,), s, dtype=torch.int32),
                          collect_stats=stats, full_prefill=stats)
    if stats:
        return out[0].numpy(), {m: v.numpy() for m, v in out[2].items()}
    return out[0].numpy()


def _both(hf_cfg, sd, quant=None):
    """(JAX cfg, JAX params, port cfg, port params) of one HF model, f32."""
    jq = JQuant() if quant is None else JQuant.from_dict(quant.to_dict())
    jcfg = dataclasses.replace(jreg.config_from_hf(hf_cfg, jq),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(
        treg.config_from_hf(hf_cfg, quant or QuantConfig()),
        dtype=torch.float32)
    tp = treg.params_from_hf(tcfg, sd, device="cpu")
    return jcfg, _jax_params(jcfg, sd), tcfg, tp


def _jax_params(jcfg, sd):
    return jreg.params_from_hf(jcfg, {k: v.numpy() for k, v in sd.items()})


@pytest.fixture(scope="module")
def family():
    """name -> (hf config, state dict, JAX cfg, JAX params, port cfg, port
    params, JAX (logits, stats), port (logits, stats): one prefill forward
    with f32 products), built once a module."""
    cache = {}

    def get(name):
        if name not in cache:
            hf_cfg, sd = _hf(name)
            jcfg, jp, tcfg, tp = _both(hf_cfg, sd)
            with _f32_products():
                runs = (_jax_logits(jcfg, jp, stats=True),
                        _port_logits(tcfg, tp, stats=True))
            cache[name] = (hf_cfg, sd, jcfg, jp, tcfg, tp) + runs
        return cache[name]
    return get


def _assert_params_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_params_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_params_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("name", NAMES)
def test_load_hf_config_matches_autoconfig(name, tmp_path):
    """The port's JSON reader on save_pretrained's diff-only config.json
    against JAX's reading through AutoConfig."""
    _, hf_cfg = FAMILIES[name]()
    hf_cfg.save_pretrained(str(tmp_path))
    auto = transformers.AutoConfig.from_pretrained(str(tmp_path))
    ns = thf.load_hf_config(str(tmp_path))
    for key in ("model_type", "vocab_size", "hidden_size",
                "num_hidden_layers", "num_attention_heads"):
        assert getattr(ns, key) == getattr(auto, key), key
    assert treg.config_from_hf(ns).to_dict() == \
        jreg.config_from_hf(auto).to_dict()


@pytest.mark.parametrize("name", NAMES)
def test_config_and_params_match_jax(name, family):
    _, _, jcfg, jp, tcfg, tp = family(name)[:6]
    assert tcfg.to_dict() == jcfg.to_dict()
    conv = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                             device="cpu")
    _assert_params_equal(tp, conv)


@pytest.mark.parametrize("name", NAMES)
def test_f32_logits_match_jax(name, family):
    (want, _), (got, _) = family(name)[6:]
    assert np.isfinite(got).all() and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_collect_stats_match_jax(name, family):
    """Calibration's signal: every linear's per-channel input absmax from
    forward(collect_stats=True), the activations JAX reads (the explicitly
    normed ones on LayerNorm families and shared norms, the raw residual
    for OLMo-2's projections), within 1e-5."""
    (_, want), (_, got) = family(name)[6:]
    assert sorted(got) == sorted(want)
    for mod, w in want.items():
        np.testing.assert_allclose(got[mod], w, atol=F32_TOL, rtol=0,
                                   err_msg=mod)


def _to_jax(tp):
    """Port params -> the JAX package's tree (layers stacked), leaf for
    leaf."""
    def j(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    out = {k: {leaf: j(t) for leaf, t in sub.items()}
           for k, sub in tp.items() if k != "layers"}
    out["layers"] = {mod: {leaf: j(torch.stack([lay[mod][leaf]
                                                for lay in tp["layers"]]))
                           for leaf in tp["layers"][0][mod]}
                     for mod in tp["layers"][0]}
    return out


@pytest.mark.parametrize("name", INT8_NAMES)
def test_int8_mix_forward_close(name, family):
    """The port's int8_mix forward against JAX's on the same quantized
    params; quantization itself is family-agnostic, and its params are
    held bit-equal to JAX's on a LayerNorm family with biases (opt) and a
    gated one with post-block norms (gemma2)."""
    hf_cfg, sd = family(name)[:2]
    quant = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=8)
    jq = JQuant.from_dict(quant.to_dict())
    jcfg = dataclasses.replace(jreg.config_from_hf(hf_cfg, jq),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(treg.config_from_hf(hf_cfg, quant),
                               dtype=torch.float32)
    tp = treg.params_from_hf(tcfg, sd, device="cpu")
    if name in ("opt", "gemma2"):
        jp = _jax_params(jcfg, sd)
        _assert_params_equal(tp, params_from_numpy(
            jax.tree.map(np.asarray, jp), tcfg, device="cpu"))
    else:
        jp = _to_jax(tp)
    got, want = _port_logits(tcfg, tp), _jax_logits(jcfg, jp)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 0.2, rel
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75


def _schema(tree):
    if isinstance(tree, dict):
        return {k: _schema(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_schema(v) for v in tree]
    return (tree.dtype, tuple(tree.shape))


def test_random_init_matches_schema(family):
    """init_random_params gives params_from_hf's schema on a structurally
    rich family (parallel blocks, LayerNorm, biases, lm_head bias)."""
    hf_cfg, sd = family("phi")[:2]
    cfg = treg.config_from_hf(
        hf_cfg, QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=4))
    a = treg.params_from_hf(cfg, sd, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    b = tfam.init_random_params(cfg, device="cpu", generator=gen)
    assert _schema(a) == _schema(b)
    c = tfam.init_random_params(cfg, seed=0, device="cpu")
    assert _schema(c) == _schema(a)
    torch.testing.assert_close(b["embed"]["w"], c["embed"]["w"])


def _tiny_llama():
    hf_cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval().float()
    return hf_cfg, {k: v.detach() for k, v in model.state_dict().items()}


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_baichuan_wpack_and_aquila():
    """Baichuan-7B is Llama with a fused W_pack, Aquila Llama under its own
    model_type: tiny Llama weights repacked into Baichuan's naming give the
    Llama route's logits exactly, and JAX's within 1e-5."""
    hf_cfg, sd = _tiny_llama()
    bsd = {}
    for k, v in sd.items():
        if ".self_attn.q_proj." in k:
            base = k.split(".self_attn.")[0]
            bsd[base + ".self_attn.W_pack.weight"] = torch.cat(
                [sd[base + f".self_attn.{n}_proj.weight"] for n in "qkv"])
        elif ".self_attn.k_proj." not in k and ".self_attn.v_proj." not in k:
            bsd[k] = v
    base = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                max_position_embeddings=64, rms_norm_eps=1e-6,
                tie_word_embeddings=False)
    jcfg_b, jp_b, tcfg_b, tp_b = _both(_NS(model_type="baichuan", **base),
                                       bsd)
    assert tcfg_b.pos_embedding == "rope"       # the 7B geometry
    assert tcfg_b.to_dict() == jcfg_b.to_dict()
    aq = _NS(model_type="aquila", num_key_value_heads=4, rope_theta=10000.0,
             **base)
    _, _, tcfg_a, tp_a = _both(aq, sd)
    assert tcfg_a.arch == "llama"
    with _f32_products():
        ref = _port_logits(tcfg_a, tp_a)
        got = _port_logits(tcfg_b, tp_b)
        want = _jax_logits(jcfg_b, jp_b)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_phi3_longrope_parity():
    """Phi-3 longrope (the long per-dim factor set, chosen at config time
    for a context past the original window) over 48 > 32 tokens."""
    half = 8
    hf_cfg = transformers.Phi3Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, original_max_position_embeddings=32,
        rope_scaling={"type": "longrope", "short_factor": [1.0] * half,
                      "long_factor": [1.0 + 0.3 * i for i in range(half)]},
        pad_token_id=0, eos_token_id=1, bos_token_id=2)
    torch.manual_seed(0)
    model = transformers.Phi3ForCausalLM(hf_cfg).eval().float()
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    jcfg, jp, tcfg, tp = _both(hf_cfg, sd)
    assert tcfg.rope_scaling_type == "longrope"
    assert tcfg.to_dict() == jcfg.to_dict()
    toks = np.array([[1, 5, 9, 42, 7, 100, 3, 200] * 6], np.int32)
    with _f32_products():
        got, want = _port_logits(tcfg, tp, toks), _jax_logits(jcfg, jp, toks)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_qwen2_yarn_parity(tmp_path):
    """Qwen2 with a yarn rope_scaling (the Llama lineage's converter): the
    config read from its config.json and the logits over 48 tokens."""
    hf_cfg = transformers.Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_scaling={
            "rope_type": "yarn", "factor": 4.0,
            "original_max_position_embeddings": 32})
    torch.manual_seed(0)
    model = transformers.Qwen2ForCausalLM(hf_cfg).eval().float()
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    hf_cfg.save_pretrained(str(tmp_path))
    assert treg.config_from_hf(thf.load_hf_config(str(tmp_path))) == \
        treg.config_from_hf(hf_cfg)
    jcfg, jp, tcfg, tp = _both(hf_cfg, sd)
    assert tcfg.rope_scaling_type == "yarn"
    assert tcfg.rope_attention_factor != 1.0
    assert tcfg.to_dict() == jcfg.to_dict()
    toks = np.array([[1, 5, 9, 42, 7, 100, 3, 200] * 6], np.int32)
    with _f32_products():
        got, want = _port_logits(tcfg, tp, toks), _jax_logits(jcfg, jp, toks)
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


def test_moe_family_types_name_their_module():
    """The expert families, once refused naming models/moe.py, now read as
    JAX reads them (their parity: tests/test_torch_moe.py)."""
    for name in ("qwen2_moe", "qwen3_moe", "dbrx"):
        _, hf_cfg = FAMILIES[name]()
        assert treg.config_from_hf(hf_cfg).to_dict() == \
            jreg.config_from_hf(hf_cfg).to_dict()
