"""Port parity of the expert models (models/moe.py; the MoE branch of
models/common.decoder_layer; Mixtral in models/llama.py; DBRX, Qwen2-MoE
and Qwen3-MoE in models/families.py; the checkpoint schema) against the
JAX package on the CPU, at JAX tests/test_moe.py's tiny size (hidden 64,
intermediate 96, 4 experts, top 2, 2 layers).

Tolerances: float expert stacks within 1e-5 of max |JAX| (both packages
take bf16 operands with f32 sums); int8 and int4 stacks within 2e-2, the
GEMM tolerance (the JAX package dequantizes the stack to bf16 before its
product, the port's K4 applies scale_col after the f32 sum); the port's
sorted and all-rows routes within 1e-6 of each other. The f32 model's
forward and collect_stats within 1e-5 of JAX's (readings in
``test_forward_and_stats_match_jax``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import checkpoint as jckpt
from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import moe as jmoe
from mixq_tensorrt_llm_tpu.models import registry as jreg
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu_torch.convert import checkpoint as tckpt
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.from_jax import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models import moe as tmoe
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.ops import _build
from mixq_tensorrt_llm_tpu_torch.quant import QuantAlgo, QuantConfig

transformers = pytest.importorskip("transformers")
from test_model_families import FAMILIES  # noqa: E402

H, I, E = 64, 96, 4
FLOAT_TOL, GEMM_TOL, ROUTES_TOL = 1e-5, 2e-2, 1e-6
SHARED_FLOAT_TOL = 1e-4
FORMATS = ["none", "w8a16", "w4a16", "w4a16_g"]


def moe_cfg(**kw):
    base = dict(arch="mixtral", vocab_size=128, hidden_size=H,
                intermediate_size=I, num_layers=2, num_heads=4,
                num_kv_heads=2, head_dim=16, max_position_embeddings=64,
                num_experts=E, top_k_experts=2, dtype=torch.float32)
    base.update(kw)
    return ModelConfig(**base)


def jcfg_of(cfg: ModelConfig) -> JConfig:
    return JConfig.from_dict({**cfg.to_dict(), "dtype": "float32"})


def _j(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _jtree(tree):
    return {k: _jtree(v) if isinstance(v, dict) else _j(v)
            for k, v in tree.items()}


def to_jax(tp):
    """Port params -> the JAX package's tree, layers stacked (an expert
    layer's ``moe`` entry one level deeper)."""
    out = {k: _jtree(v) for k, v in tp.items() if k != "layers"}

    def stack(trees):
        first = trees[0]
        return {k: stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else _j(torch.stack([t[k] for t in trees]))
                for k in first}
    out["layers"] = stack(tp["layers"])
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _moe_params(fmt: str, shared: bool = False, seed: int = 0):
    """(port cfg, port moe params, JAX moe params) of one expert block,
    the stacks quantized by each package from the same f32 draws."""
    rng = np.random.default_rng(seed)
    algo = {"none": QuantAlgo.NONE, "w8a16": QuantAlgo.W8A16,
            "w4a16": QuantAlgo.W4A16, "w4a16_g": QuantAlgo.W4A16_G}[fmt]
    cfg = moe_cfg(quant=QuantConfig(algo=algo, group_size=32),
                  moe_shared_intermediate=64 if shared else 0,
                  moe_norm_topk=not shared)
    gu = rng.standard_normal((E, H, 2 * I)).astype(np.float32) * 0.05
    dn = rng.standard_normal((E, I, H)).astype(np.float32) * 0.05
    rw = rng.standard_normal((H, E)).astype(np.float32)
    fl = {"router_w": torch.from_numpy(rw),
          "experts_gate_up": torch.from_numpy(gu),
          "experts_down": torch.from_numpy(dn)}
    if shared:
        fl["shared_gate_up_w"] = (torch.from_numpy(
            rng.standard_normal((H, 128)).astype(np.float32) * 0.05), None)
        fl["shared_down_w"] = (torch.from_numpy(
            rng.standard_normal((64, H)).astype(np.float32) * 0.05), None)
        fl["shared_gate_w"] = torch.from_numpy(
            rng.standard_normal((H, 1)).astype(np.float32) * 0.1)
    tp = tllama.quantize_moe(cfg, fl)
    jalgo = JAlgo(algo.value)
    jp = {"router": {"w": jnp.asarray(rw).astype(jnp.bfloat16)},
          "gate_up": jmoe.quantize_expert_linear(jnp.asarray(gu), jalgo, 32),
          "down": jmoe.quantize_expert_linear(jnp.asarray(dn), jalgo, 32)}
    if shared:
        jp.update({k: _jtree(tp[k]) for k in ("shared_gate_up",
                                              "shared_down", "shared_gate")})
    return cfg, tp, jp


def _x(b=2, s=48, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, s, H)).astype(np.float32)


@pytest.fixture(scope="module")
def block():
    """fmt -> (cfg, port params, JAX params, x, JAX ragged, JAX dense), the
    JAX outputs computed once."""
    cache = {}

    def get(fmt, shared=False):
        key = (fmt, shared)
        if key not in cache:
            cfg, tp, jp = _moe_params(fmt, shared)
            x = _x()
            jc = jcfg_of(cfg)
            jx = jnp.asarray(x)
            cache[key] = (cfg, tp, jp, x,
                          np.asarray(jmoe.moe_mlp(jc, jp, jx, ragged=True)),
                          np.asarray(jmoe.moe_mlp(jc, jp, jx, ragged=False)))
        return cache[key]
    return get


def test_router_and_routed_ids_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    rw = rng.standard_normal((16, 8)).astype(np.float32)
    rwb = torch.from_numpy(rw).to(torch.bfloat16)
    for norm in (True, False):
        got = tmoe.router_probs(torch.from_numpy(x), rwb, 2, norm)
        want = jmoe.router_probs(jnp.asarray(x), _j(rwb), 2, norm)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-7)
    # the routed ids of the ragged route: jax.lax.top_k's, ties to the
    # lower id (an all-equal row: experts 0..k-1)
    probs = np.concatenate([
        np.asarray(jax.nn.softmax(jnp.asarray(x.reshape(10, 16) @ rw))),
        np.full((1, 8), 1 / 8, np.float32),
        np.array([[0.1, 0.3, 0.1, 0.3, 0.05, 0.05, 0.05, 0.05]],
                 np.float32)])
    for k in (1, 2, 3):
        vals, ids = tmoe.top_k(torch.from_numpy(probs), k, False)
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert tmoe.top_k(torch.from_numpy(probs), 2, False)[1][10].tolist() \
        == [0, 1]
    assert tmoe.top_k(torch.from_numpy(probs), 2, False)[1][11].tolist() \
        == [1, 3]


@pytest.mark.parametrize("fmt", FORMATS)
def test_quantize_expert_linear_matches_jax(fmt):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((3, 64, 128)).astype(np.float32) * 0.05
    algo = {"none": QuantAlgo.NONE, "w8a16": QuantAlgo.W8A16,
            "w4a16": QuantAlgo.W4A16, "w4a16_g": QuantAlgo.W4A16_G}[fmt]
    got = tmoe.quantize_expert_linear(torch.from_numpy(w), algo, 32)
    want = jmoe.quantize_expert_linear(jnp.asarray(w), JAlgo(algo.value), 32)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))
    np.testing.assert_array_equal(
        tmoe._dequant_stack(got).float().numpy(),
        np.asarray(jmoe._dequant_stack(want), np.float32))


@pytest.mark.parametrize("fmt", FORMATS)
def test_moe_mlp_matches_jax(fmt, block):
    """The ragged route (sorted at 96 rows) against JAX's ragged_dot
    route, the dense route against JAX's dense route."""
    cfg, tp, _, x, j_ragged, j_dense = block(fmt)
    tol = FLOAT_TOL if fmt == "none" else GEMM_TOL
    _build.reset_launches()
    got = tmoe.moe_mlp(cfg, tp, torch.from_numpy(x)).numpy()
    assert _build.LAUNCHES.get("moe.sorted") == 1
    assert "moe.all_rows" not in _build.LAUNCHES
    assert _rel(got, j_ragged) <= tol, _rel(got, j_ragged)
    dense = tmoe.moe_mlp(cfg, tp, torch.from_numpy(x), ragged=False).numpy()
    assert _rel(dense, j_dense) <= tol, _rel(dense, j_dense)


@pytest.mark.parametrize("fmt", FORMATS)
def test_sorted_and_all_rows_routes_agree(fmt, block):
    cfg, tp, _, x, j_ragged, _ = block(fmt)
    xt = torch.from_numpy(x)
    sorted_out = tmoe.moe_mlp(cfg, tp, xt)
    _build.reset_launches()
    with tmoe.static_shapes():
        all_rows = tmoe.moe_mlp(cfg, tp, xt)
    assert _build.LAUNCHES.get("moe.all_rows") == 1
    assert "moe.sorted" not in _build.LAUNCHES
    assert _rel(all_rows.numpy(), sorted_out.numpy()) <= ROUTES_TOL
    # at most ALL_ROWS_MAX rows take the all-rows route without the flag
    _build.reset_launches()
    small = tmoe.moe_mlp(cfg, tp, xt[:, :32])
    assert _build.LAUNCHES == {"moe.all_rows": 1}
    assert _rel(small.numpy(), sorted_out[:, :32].numpy()) <= ROUTES_TOL


def test_shared_expert_matches_jax(block):
    """Qwen2-MoE's sigmoid-gated shared expert (norm_topk off), its
    linears W8A16 through dispatch.linear. Its float down linear rounds
    its f32 input to bf16 in both packages, and the frameworks' SiLU
    differ in the last f32 bit, so a rounding can go the other way: the
    float case is held at SHARED_FLOAT_TOL (reading 3.3e-5)."""
    for fmt in ("none", "w8a16"):
        cfg, tp, _, x, j_ragged, j_dense = block(fmt, shared=True)
        tol = SHARED_FLOAT_TOL if fmt == "none" else GEMM_TOL
        got = tmoe.moe_mlp(cfg, tp, torch.from_numpy(x)).numpy()
        assert _rel(got, j_ragged) <= tol
        dense = tmoe.moe_mlp(cfg, tp, torch.from_numpy(x),
                             ragged=False).numpy()
        assert _rel(dense, j_dense) <= tol


@pytest.fixture(scope="module")
def model():
    """An f32 Mixtral (float experts, int8 KV), built by the port, and
    JAX's forward on it: (cfg, port params, JAX cfg, JAX params)."""
    from mixq_tensorrt_llm_tpu_torch.quant import KVCacheQuantAlgo
    cfg = moe_cfg(quant=QuantConfig(kv_cache=KVCacheQuantAlgo.INT8))
    tp = tllama.init_random_params(cfg, seed=5, device="cpu")
    return cfg, tp, jcfg_of(cfg), to_jax(tp)


TOKENS = np.random.default_rng(6).integers(1, 128, (2, 40)).astype(np.int32)


def test_forward_and_stats_match_jax(model):
    """forward (prefill of 2 x 40 = 80 rows: the sorted route) and
    collect_stats; then one decode step over the cache (2 rows: all
    rows)."""
    cfg, tp, jc, jp = model
    b, s = TOKENS.shape
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jcache = jcommon.init_kv_cache(jc, b, 48)
    jl, jcache, jst = jcommon.forward(jp, jc, jnp.asarray(TOKENS),
                                      jnp.asarray(pos), jcache,
                                      jnp.full((b,), s, jnp.int32),
                                      collect_stats=True)
    tcache = tcommon.init_kv_cache(cfg, b, 48, device="cpu")
    _build.reset_launches()
    tl, _, tst = tcommon.forward(tp, cfg, torch.from_numpy(TOKENS),
                                 torch.from_numpy(pos), tcache,
                                 torch.full((b,), s, dtype=torch.int32),
                                 collect_stats=True)
    assert _build.LAUNCHES.get("moe.sorted") == cfg.num_layers
    assert _rel(tl.numpy(), jl) <= FLOAT_TOL
    assert set(tst) == set(jst)
    for m in jst:
        np.testing.assert_allclose(tst[m].numpy(), np.asarray(jst[m]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(tst["gate_up_proj"].numpy(),
                                  tst["down_proj"].numpy())
    nxt = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)[:, None]
    jl2, _ = jcommon.forward(jp, jc, jnp.asarray(nxt),
                             jnp.full((b, 1), s, jnp.int32), jcache,
                             jnp.full((b,), s + 1, jnp.int32))
    _build.reset_launches()
    tl2, _ = tcommon.forward(tp, cfg, torch.from_numpy(nxt),
                             torch.full((b, 1), s, dtype=torch.int32),
                             tcache, torch.full((b,), s + 1,
                                                dtype=torch.int32))
    assert _build.LAUNCHES.get("moe.all_rows") == cfg.num_layers
    assert _rel(tl2.numpy(), jl2) <= FLOAT_TOL


def test_forward_paged_matches_jax(model):
    """forward_paged over an int8 pool: a 40-token prefill into pages of
    8 (sorted route), then one step."""
    from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv
    cfg, tp, jc, jp = model
    b, s = TOKENS.shape
    table = np.arange(b * 6, dtype=np.int32).reshape(b, 6) + 1
    pos = np.tile(np.arange(s, dtype=np.int32), (b, 1))
    jst = jkv.init_paged_kv(jc, 16, 8)
    tst = tkv.init_paged_kv(cfg, 16, 8, device="cpu")
    outs = []
    for toks, p, ln in ((TOKENS, pos, s), (TOKENS[:, :1],
                                           np.full((b, 1), s, np.int32),
                                           s + 1)):
        jl, jst = jcommon.forward_paged(jp, jc, jnp.asarray(toks),
                                        jnp.asarray(p), jst,
                                        jnp.asarray(table),
                                        jnp.full((b,), ln, jnp.int32))
        tl, tst = tcommon.forward_paged(tp, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(p), tst,
                                        torch.from_numpy(table),
                                        torch.full((b,), ln,
                                                   dtype=torch.int32))
        outs.append(_rel(tl.numpy(), jl))
    assert max(outs) <= FLOAT_TOL, outs


def test_config_axes_round_trip():
    for kw in (dict(num_experts=8, top_k_experts=2),
               dict(arch="qwen2_moe", num_experts=60, top_k_experts=4,
                    moe_norm_topk=False, moe_intermediate=1408,
                    moe_shared_intermediate=5632, qkv_bias=True)):
        jd = JConfig(**kw).to_dict()
        assert ModelConfig.from_dict(jd).to_dict() == jd
    with pytest.raises(ValueError, match="top_k_experts"):
        ModelConfig(num_experts=4, top_k_experts=5)


# --------------------------------------------------------------------------
# Hugging Face: Mixtral, DBRX, Qwen2-MoE, Qwen3-MoE
# --------------------------------------------------------------------------

def _mixtral():
    from transformers import MixtralConfig, MixtralForCausalLM
    return MixtralForCausalLM, MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        sliding_window=None, attn_implementation="eager")


HF_MODELS = {"mixtral": _mixtral, "dbrx": FAMILIES["dbrx"],
             "qwen2_moe": FAMILIES["qwen2_moe"],
             "qwen3_moe": FAMILIES["qwen3_moe"]}


def _assert_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _assert_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert torch.equal(got, want), path


@pytest.mark.parametrize("name", sorted(HF_MODELS))
@pytest.mark.parametrize("quant", ["none", "int8_mix"])
def test_hf_params_match_jax(name, quant):
    """config_from_hf and params_from_hf against JAX's, leaf for leaf
    after params_from_numpy (int8_mix: qkv / o mixed, experts W8A16)."""
    cls, hf_cfg = HF_MODELS[name]()
    torch.manual_seed(0)
    sd = {k: v.detach() for k, v in cls(hf_cfg).eval().float()
          .state_dict().items()}
    q = (QuantConfig() if quant == "none"
         else QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=8))
    tcfg = treg.config_from_hf(hf_cfg, q)
    jcfg = jreg.config_from_hf(hf_cfg, JQuant.from_dict(q.to_dict()))
    assert tcfg.to_dict() == jcfg.to_dict()
    tp = treg.params_from_hf(tcfg, sd, device="cpu")
    jp = jreg.params_from_hf(jcfg, {k: v.numpy() for k, v in sd.items()})
    _assert_equal(tp, params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                        device="cpu"))


@pytest.mark.parametrize("name", sorted(HF_MODELS))
def test_load_hf_config_matches_autoconfig(name, tmp_path):
    """The port's JSON reader on save_pretrained's diff-only config.json
    (and on a bare one: the class defaults) against AutoConfig."""
    _, hf_cfg = HF_MODELS[name]()
    hf_cfg.save_pretrained(str(tmp_path))
    for path in (str(tmp_path), str(tmp_path / "bare")):
        if path.endswith("bare"):
            (tmp_path / "bare").mkdir()
            with open(tmp_path / "bare" / "config.json", "w") as f:
                json.dump({"model_type": hf_cfg.model_type}, f)
        auto = transformers.AutoConfig.from_pretrained(path)
        assert treg.config_from_hf(thf.load_hf_config(path)).to_dict() == \
            jreg.config_from_hf(auto).to_dict(), path


def test_mixed_dense_moe_stacks_refused():
    for name in ("qwen2_moe", "qwen3_moe"):
        _, hf_cfg = HF_MODELS[name]()
        hf_cfg.mlp_only_layers = [1]
        with pytest.raises(NotImplementedError, match="mixed dense/MoE"):
            treg.config_from_hf(hf_cfg)


@pytest.mark.parametrize("quant", ["int8_mix", "w4a16_g"])
def test_checkpoint_round_trip_with_jax(quant, tmp_path):
    """A JAX MoE checkpoint loads in the port leaf for leaf, and the
    port's loads in JAX; the shared expert rides along (Qwen2-MoE)."""
    algo = QuantAlgo(quant)
    cfg = moe_cfg(arch="qwen2_moe", qkv_bias=True, moe_intermediate=64,
                  moe_shared_intermediate=64, moe_norm_topk=False,
                  quant=QuantConfig(algo=algo, num_outliers=8,
                                    group_size=32))
    from mixq_tensorrt_llm_tpu_torch.models import families as tfam
    tp = tfam.init_random_params(cfg, seed=7, device="cpu")
    jc = jcfg_of(cfg)
    jckpt.save_checkpoint(str(tmp_path / "jax"), to_jax(tp), jc)
    back, cfg2 = tckpt.load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert cfg2.to_dict() == dataclasses.replace(
        cfg, dtype=torch.float32).to_dict()
    _assert_equal(back, tp)
    tckpt.save_checkpoint(str(tmp_path / "port"), tp, cfg)
    jback, jcfg2 = jckpt.load_checkpoint(str(tmp_path / "port"))
    assert jcfg2.num_experts == E and jcfg2.moe_shared_intermediate == 64
    ref = to_jax(tp)
    assert jax.tree.structure(jback) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))
