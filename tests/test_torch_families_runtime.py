"""Port parity of the dense decoder families through the runtime: the
port's Executor and GenerationSession on the CPU give greedy tokens
identical to the JAX package's on f32 models, for Gemma-2 (alternating
per-layer windows under a prompt longer than the window, attention and
final softcaps, post-block norms), BLOOM (ALiBi on the paged gather route,
its KV still written by the paged write), Falcon multi-query and GPT-NeoX
(partial rotary, parallel blocks). The JAX package's own
tests/test_model_families.py holds its Executor and session to the same
tokens, so the port's session is compared with the JAX Executor's run.
Models are built by the port and handed to JAX leaf for leaf (``_to_jax``),
which is faster than JAX's eager init.

Also: quantize_hf_model over a tiny OPT directory (LayerNorm, learned
positions) against JAX's; beam bursts refusing windows and ALiBi as JAX's
do; the Executor's refusal of head_dim 80 on the card, through the
geometry check;
K7's layout chosen from the shapes (the rows layout for Falcon-7B's and
the MQA coders' groups) and K4's half last column tile in its plan.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import hf as jhf
from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import registry as jreg
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import beam as jbeam
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import read_safetensors
from mixq_tensorrt_llm_tpu_torch.models import families as tfam
from mixq_tensorrt_llm_tpu_torch.models import registry as treg
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.ops import paged_attention as pattn
from mixq_tensorrt_llm_tpu_torch.ops import wo_matmul as wm
from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo, QuantAlgo,
                                               QuantConfig)
from mixq_tensorrt_llm_tpu_torch.runtime import beam as tbeam
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as pkv
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession

transformers = pytest.importorskip("transformers")
from test_model_families import FAMILIES  # noqa: E402

QUANT = QuantConfig(algo=QuantAlgo.INT8_MIX, num_outliers=8,
                    kv_cache=KVCacheQuantAlgo.INT8)
EX_KW = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=16)
PROMPTS = [list(range(1, 13)), [20, 21, 22]]   # 12 > the 8-token window
NEW = 8


def _to_jax(tp):
    """Port params -> the JAX package's tree (layers stacked)."""
    def j(t):
        t = t.detach().cpu()
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


def _jcfg(cfg: ModelConfig):
    return JConfig.from_dict({**cfg.to_dict(), "dtype": "float32"})


def _gemma2():
    cfg = ModelConfig(
        arch="gemma2", vocab_size=128, hidden_size=64, intermediate_size=96,
        num_layers=4, num_heads=4, num_kv_heads=2, head_dim=16,
        attn_scale=24 ** -0.5, attn_logit_softcap=50.0,
        final_logit_softcap=30.0, post_block_norms=True, sliding_window=8,
        sliding_window_pattern=2, hidden_act="gelu_pytorch_tanh",
        embed_scale=8.0, tie_word_embeddings=True,
        max_position_embeddings=128, dtype=torch.float32, quant=QUANT)
    return cfg, tfam.init_random_params(cfg, seed=1, device="cpu")


def _from_hf(name):
    cls, hf_cfg = FAMILIES[name]()
    torch.manual_seed(0)
    sd = {k: v.detach() for k, v in cls(hf_cfg).state_dict().items()}
    cfg = treg.config_from_hf(hf_cfg, QUANT)
    cfg = ModelConfig.from_dict({**cfg.to_dict(), "dtype": "float32"})
    return cfg, treg.params_from_hf(cfg, sd, device="cpu")


def _jax_tokens(cfg, tp, prompts=PROMPTS):
    """The JAX Executor's greedy tokens (its session gives the same, per
    its own tests/test_model_families.py)."""
    jex = JExecutor(_to_jax(tp), _jcfg(cfg), seed=0, **EX_KW)
    ids = [jex.submit(p, max_new_tokens=NEW) for p in prompts]
    done = jex.run()
    return [done[i].generated for i in ids]


def _port_executor(cfg, tp, prompts=PROMPTS):
    ex = Executor(tp, cfg, seed=0, device="cpu", **EX_KW)
    ids = [ex.submit(p, max_new_tokens=NEW) for p in prompts]
    done = ex.run()
    return [done[i].generated for i in ids]


def _port_session(cfg, tp, prompts=PROMPTS):
    sess = GenerationSession(tp, cfg, max_seq_len=64, prefill_buckets=(16,),
                             device="cpu")
    out = sess.generate(prompts, max_new_tokens=NEW)
    return [s[len(p):] for s, p in zip(out.sequences, prompts)]


def _jax_burst_step(cfg, tp):
    """One forward of JAX's beam burst (runtime/beam.py _forward_with_tail,
    where its refusals are) over an empty pool: 2 lanes, a 3-token
    prefix."""
    from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
    jcfg = _jcfg(cfg)
    st = jkv.init_paged_kv(jcfg, 4, 8)
    pools = {"k": st.k, "v": st.v, "k_scale": st.k_scale,
             "v_scale": st.v_scale}
    return jbeam._forward_with_tail(
        _to_jax(tp), jcfg, jnp.array([1, 2], jnp.int32), pools,
        jnp.ones((2, 2), jnp.int32), None, jnp.array([3, 3], jnp.int32),
        jbeam._init_tail(jcfg, 2, 4, True), jnp.int32(0), use_kernels=False)


def _count(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls.append(1)
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_gemma2_executor_and_session_match_jax(monkeypatch):
    """Alternating windows (layers 0 and 2 at 8 tokens, 1 and 3 global)
    under a 12-token prompt, softcaps, post-block norms."""
    cfg, tp = _gemma2()
    assert [cfg.layer_window(i) for i in range(4)] == [8, 0, 8, 0]
    windows = []
    paged = pkv.paged_attention

    def spy(*a, **k):
        windows.append(k["window"])
        return paged(*a, **k)
    monkeypatch.setattr(pkv, "paged_attention", spy)
    want = _jax_tokens(cfg, tp)
    assert _port_executor(cfg, tp) == want
    assert set(windows[:4]) == {0, 8} and windows[:4] == [8, 0, 8, 0]
    assert _port_session(cfg, tp) == want
    with pytest.raises(NotImplementedError, match="windows"):
        tbeam.paged_beam_search(tp, cfg, PROMPTS, 4, num_beams=2,
                                max_seq_len=64, block_size=8, burst=4,
                                device="cpu")
    with pytest.raises(AssertionError, match="windows"):
        _jax_burst_step(cfg, tp)


def test_bloom_alibi_executor_and_session_match_jax(monkeypatch):
    """ALiBi: the paged attention takes the gather route (no K7-K11), the
    write stays the paged write (K5 / K6 on the card)."""
    cfg, tp = _from_hf("bloom")
    assert cfg.pos_embedding == "alibi" and cfg.embed_norm
    want = _jax_tokens(cfg, tp)
    gathers = _count(monkeypatch, pkv, "paged_gather")
    writes = _count(monkeypatch, pkv, "paged_write")
    kernels = [_count(monkeypatch, pattn, n) for n in (
        "paged_decode_attention", "paged_verify_attention",
        "paged_prefill_attention", "paged_decode_attention_split")]
    assert _port_executor(cfg, tp) == want
    assert len(gathers) == len(writes) > 0
    assert not any(kernels)
    assert _port_session(cfg, tp) == want
    with pytest.raises(NotImplementedError, match="ALiBi"):
        tbeam.paged_beam_search(tp, cfg, PROMPTS, 4, num_beams=2,
                                max_seq_len=64, block_size=8, burst=4,
                                device="cpu")
    with pytest.raises(AssertionError, match="ALiBi"):
        _jax_burst_step(cfg, tp)


@pytest.mark.parametrize("name", ["falcon_mqa", "gpt_neox"])
def test_executor_matches_jax(name):
    cfg, tp = _from_hf(name)
    assert _port_executor(cfg, tp) == _jax_tokens(cfg, tp)


def _assert_ckpt_equal(jdir, tdir):
    import json
    with open(os.path.join(jdir, "config.json")) as f:
        jc = json.load(f)
    with open(os.path.join(tdir, "config.json")) as f:
        assert json.load(f) == jc
    jt = read_safetensors(os.path.join(jdir, "model.safetensors"))
    tt = read_safetensors(os.path.join(tdir, "model.safetensors"))
    assert sorted(jt) == sorted(tt)
    for name in jt:
        a, b = jt[name], tt[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert torch.equal(a, b), name


def test_quantize_layernorm_family_matches_jax(tmp_path):
    """quantize_hf_model over an OPT directory (LayerNorm with biases,
    learned positions, fc1/fc2): the same checkpoint as JAX's from the
    same act_scales (calibration's stats on LayerNorm families, the
    explicitly normed activations, are held against JAX's in
    tests/test_torch_families.py)."""
    cls, hf_cfg = FAMILIES["opt"]()
    torch.manual_seed(0)
    cls(hf_cfg).save_pretrained(str(tmp_path / "hf"))
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 128))}
    jhf.quantize_hf_model(str(tmp_path / "hf"), str(tmp_path / "j"),
                          JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                 kv_cache=JKV.INT8),
                          act_scales=acts, dtype=jnp.float32)
    thf.quantize_hf_model(str(tmp_path / "hf"), str(tmp_path / "t"), QUANT,
                          act_scales=acts, dtype=torch.float32,
                          device="cpu")
    _assert_ckpt_equal(str(tmp_path / "j"), str(tmp_path / "t"))


def test_head_dim_80_refused_on_the_card():
    """Phi-2's head dim 80 does not fit K7's token groups: the Executor
    raises at construction on the card, through this check (the session
    serves D = 80 on the masked route)."""
    with pytest.raises(ValueError, match=r"head_dim 80.*csrc/paged_attention"):
        pattn.check_kernel_geometry(128, 80)
    pattn.check_kernel_geometry(128, 64)


def test_decode_route_and_n_tail_plans(monkeypatch):
    """K7's layout from the shapes: the split kernel where its block fits,
    the rows layout for Falcon-7B's 71 query heads on one KV head and the
    MQA coders' 48 (int8 pages, bf16 q), neither for a group past both;
    K4's plan covers a half last column tile (N = 4672, Falcon-7B's qkv)."""
    assert pattn.decode_route(8, 128, 128, 1, True, True) == "split"
    assert pattn.decode_route(2, 256, 128, 1, True, True) == "split"
    assert pattn.decode_route(71, 64, 128, 1, True, True) == "rows"
    assert pattn.decode_route(48, 128, 128, 1, True, True) == "rows"
    assert pattn.decode_split_smem(71, 64, 128, 1, True) > pattn._MAX_SMEM
    # every geometry the kernels take fits the rows layout (groups of at
    # most 128 rows a block); past the limit neither does, and K7 raises
    monkeypatch.setattr(pattn, "_MAX_SMEM", 60000)
    pattn.decode_route.cache_clear()
    with pytest.raises(ValueError, match="rows layout"):
        pattn.decode_route(48, 128, 128, 1, True, True)
    monkeypatch.undo()
    pattn.decode_route.cache_clear()
    plan = wm.wo_plan(8, 4544, 4672, 132)
    assert plan.tiles == 37 and plan.grid[0] == 37
    assert wm.wo_plan(1024, 4544, 4672, 132).grid[1] == 19
