"""Port parity of the expert models through the runtime, on an f32 Mixtral
(JAX tests/test_moe.py's size: hidden 64, intermediate 96, 4 experts, top
2, 2 layers; float experts, int8 KV), built by the port and handed to JAX
leaf for leaf. The port's Executor gives greedy tokens identical to the
JAX Executor's over ragged requests with chunked prefill (prefill calls of
4 lanes x 32 tokens take the sorted route, smaller ones all rows) and
under max_kv_tokens preemption; its decode rungs take the all-rows route
only. No token flipped at these seeds, so no allowance is made for a
router tie (a k-th / (k+1)-th expert gap under 1e-6 could flip one).
Beams (``run_beams``, bursts on the all-rows route) give JAX's sequences;
the port's GenerationSession gives the JAX Executor's tokens.
``quantize_hf_model`` over a tiny Mixtral directory writes JAX's
checkpoint (ints exact, floats 1e-5), with act_scales calibrated by each
package too; ``LLM`` serves the directory (quantized on first use) and
``cli quantize``'s checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import hf as jhf
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.api import LLM
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import read_safetensors
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.ops import _build
from mixq_tensorrt_llm_tpu_torch.quant import (KVCacheQuantAlgo, QuantAlgo,
                                               QuantConfig)
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.runtime.session import GenerationSession
from mixq_tensorrt_llm_tpu_torch.tools.random_hf import write_random_llama

from test_torch_moe import jcfg_of, moe_cfg, to_jax

transformers = pytest.importorskip("transformers")

RAGGED = dict(max_batch=4, max_seq_len=64, block_size=8, prefill_chunk=32)
PREEMPT = dict(max_batch=2, max_seq_len=64, block_size=8, prefill_chunk=8,
               max_kv_tokens=40)


@pytest.fixture(scope="module")
def model():
    """(port cfg, port params, JAX cfg, JAX params, {kw: JAX Executor})."""
    cfg = moe_cfg(vocab_size=256, max_position_embeddings=128,
                  quant=QuantConfig(kv_cache=KVCacheQuantAlgo.INT8))
    tp = tllama.init_random_params(cfg, seed=11, device="cpu")
    return cfg, tp, jcfg_of(cfg), to_jax(tp), {}


def _jex(model, kw):
    """The JAX Executor of ``kw``, made once a module (its host state is
    fresh for each configuration's one use)."""
    _, _, jc, jp, made = model
    key = tuple(sorted(kw.items()))
    if key not in made:
        made[key] = JExecutor(jp, jc, seed=0, **kw)
    return made[key]


def _serve_both(model, prompts, new, priorities=None, **kw):
    cfg, tp = model[:2]
    jex = _jex(model, kw)
    tex = Executor(tp, cfg, seed=0, device="cpu", **kw)
    pr = priorities or [0.5] * len(prompts)
    jids = [jex.submit(p, max_new_tokens=new, priority=q)
            for p, q in zip(prompts, pr)]
    tids = [tex.submit(p, max_new_tokens=new, priority=q)
            for p, q in zip(prompts, pr)]
    jdone = jex.run()
    _build.reset_launches()
    tdone = tex.run()
    return (jex, tex, [jdone[r].generated for r in jids],
            [tdone[r].generated for r in tids], tdone, tids)


PROMPTS = [np.random.default_rng(2).integers(1, 256, n).tolist()
           for n in (40, 7, 25, 33, 12)]


def test_ragged_chunked_token_identical(model):
    _, tex, want, got, done, ids = _serve_both(model, PROMPTS, 10, **RAGGED)
    assert got == want
    assert all(np.isfinite(done[r].logprobs).all() for r in ids)
    seen = dict(_build.LAUNCHES)
    layers = model[0].num_layers
    # the first prefill call (4 lanes x 32 tokens) sorted, once a layer;
    # every decode step all rows
    assert seen["moe.sorted"] >= layers
    assert seen["moe.all_rows"] >= tex.decode_steps * layers


def test_preemption_token_identical(model):
    prompts = [list(range(1, 11)), list(range(20, 30))]
    jex, tex, want, got, done, ids = _serve_both(
        model, prompts, 20, priorities=[0.9, 0.1], **PREEMPT)
    assert tex.preemptions > 0 and jex.preemptions == tex.preemptions
    assert got == want
    assert len(done[ids[1]].logprobs) == 20


def test_decode_rungs_take_all_rows(model):
    """Inside the rungs (CUDA graph bodies on the card) every MoE layer
    takes the all-rows route, whatever the lane count."""
    cfg, tp = model[:2]
    ex = Executor(tp, cfg, seed=0, device="cpu", max_batch=4,
                  max_seq_len=64, block_size=8)
    ex.warmup(burst=4)
    steps = ex.decode_steps
    _build.reset_launches()
    for p in PROMPTS[:4]:
        ex.submit(p[:6], max_new_tokens=6)
    ex.run(burst=4)
    seen = dict(_build.LAUNCHES)
    assert ex.compiles_since_warmup == 0
    # 4 lanes x 6 tokens = 24 rows a prefill call: all rows there too
    assert "moe.sorted" not in seen
    assert seen["moe.all_rows"] >= (ex.decode_steps - steps) \
        * cfg.num_layers > 0


def test_beams_match_jax(model):
    cfg, tp, jc, jp, _ = model
    kw = dict(max_batch=2, max_seq_len=64, block_size=8)
    prompts = [PROMPTS[1], PROMPTS[4]]
    jex = JExecutor(jp, jc, **kw)
    jids = [jex.submit(p, max_new_tokens=6) for p in prompts]
    want = jex.run_beams(num_beams=3, burst=4)
    ex = Executor(tp, cfg, device="cpu", **kw)
    ids = [ex.submit(p, max_new_tokens=6) for p in prompts]
    _build.reset_launches()
    got = ex.run_beams(num_beams=3, burst=4)
    for a, b in zip(ids, jids):
        assert got[a].generated == want[b].generated
    assert _build.LAUNCHES["moe.all_rows"] > 0


def test_session_matches_jax_executor(model):
    prompts = [PROMPTS[1], PROMPTS[4]]
    want = _serve_both(model, prompts, 8, max_batch=2, max_seq_len=64,
                       block_size=8, prefill_chunk=16)[2]
    cfg, tp = model[:2]
    sess = GenerationSession(tp, cfg, max_seq_len=64, prefill_buckets=(16,),
                             device="cpu")
    out = sess.generate(prompts, max_new_tokens=8)
    assert [s[len(p):] for s, p in zip(out.sequences, prompts)] == want


@pytest.fixture(scope="module")
def mixtral_dir(tmp_path_factory):
    """A tiny Mixtral HF directory, made once by the port's writer (what
    save_pretrained leaves; transformers' modeling import is ~10 s)."""
    path = str(tmp_path_factory.mktemp("mixtral") / "hf")
    write_random_llama(path, dict(
        model_type="mixtral", architectures=["MixtralForCausalLM"],
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, rms_norm_eps=1e-5,
        sliding_window=None, rope_theta=1e6, tie_word_embeddings=False,
        torch_dtype="float32"), seed=0, device="cpu")
    return path


def test_quantize_hf_mixtral_matches_jax(mixtral_dir, tmp_path):
    """quantize_hf_model over a Mixtral directory, int8_mix (qkv / o mixed
    from the given act_scales, experts W8A16) with int8 KV: JAX's
    checkpoint; then LLM over the directory (w8a16, quantized on first
    use) generates."""
    rng = np.random.default_rng(0)
    acts = {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(2)
        for m, n in (("self_attn.q_proj", 64), ("self_attn.o_proj", 64),
                     ("mlp.gate_proj", 64), ("mlp.down_proj", 96))}
    jhf.quantize_hf_model(mixtral_dir, str(tmp_path / "j"),
                          JQuant(algo=JAlgo.INT8_MIX, num_outliers=8,
                                 kv_cache=JKV.INT8),
                          act_scales=acts, dtype=jnp.float32)
    thf.quantize_hf_model(mixtral_dir, str(tmp_path / "t"),
                          QuantConfig(algo=QuantAlgo.INT8_MIX,
                                      num_outliers=8,
                                      kv_cache=KVCacheQuantAlgo.INT8),
                          act_scales=acts, dtype=torch.float32,
                          device="cpu")
    for d in ("j", "t"):
        with open(tmp_path / d / "config.json") as f:
            if d == "j":
                jc = json.load(f)
            else:
                assert json.load(f) == jc
    jt = read_safetensors(os.path.join(tmp_path, "j", "model.safetensors"))
    tt = read_safetensors(os.path.join(tmp_path, "t", "model.safetensors"))
    assert sorted(jt) == sorted(tt)
    assert tt["layers.moe.gate_up.qweight"].shape == (2, 4, 64, 192)
    for name in jt:
        a, b = jt[name], tt[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5, msg=name)
        else:
            assert torch.equal(a, b), name
    llm = LLM(mixtral_dir, quant="w8a16", device="cpu", max_seq_len=32,
              cache_dir=str(tmp_path / "cache"))
    assert llm.cfg.arch == "mixtral" and llm.cfg.num_experts == 4
    assert llm.generate_tokens([[1, 2, 3]], 4).num_generated == [4]


def test_quantize_hf_mixtral_calibrated_matches_jax(mixtral_dir, tmp_path):
    """Calibration on the float Mixtral (its MoE layers record the shared
    normed input for gate_up and down, JAX :951-953): act_scales within
    1e-5 of their largest value at layer 0's qkv input and 2^-7 elsewhere
    (tests/test_torch_convert.py's tolerances: every float linear rounds
    its input to bf16 in both packages); the expert stacks, which no act_scale touches, equal
    to JAX's."""
    rng = np.random.default_rng(3)
    batches = [rng.integers(0, 128, (2, 16)).astype(np.int32)
               for _ in range(2)]
    jhf.quantize_hf_model(mixtral_dir, str(tmp_path / "j"),
                          JQuant(algo=JAlgo.INT8_MIX, num_outliers=8),
                          calib_batches=batches, dtype=jnp.float32)
    thf.quantize_hf_model(mixtral_dir, str(tmp_path / "t"),
                          QuantConfig(algo=QuantAlgo.INT8_MIX,
                                      num_outliers=8),
                          calib_batches=batches, dtype=torch.float32,
                          device="cpu")
    want = dict(np.load(tmp_path / "j" / "act_scales.npz"))
    got = dict(np.load(tmp_path / "t" / "act_scales.npz"))
    assert sorted(want) == sorted(got)
    assert "model.layers.1.mlp.down_proj" in got
    for key in want:
        tol = 1e-5 if key.startswith("model.layers.0.self_attn.") \
            and key[-6:] in ("q_proj", "k_proj", "v_proj") else 2 ** -7
        err = np.abs(want[key] - got[key]).max() / np.abs(want[key]).max()
        assert err <= tol, (key, err)
    np.testing.assert_array_equal(got["model.layers.0.mlp.gate_proj"],
                                  got["model.layers.0.mlp.down_proj"])
    jt = read_safetensors(os.path.join(tmp_path, "j", "model.safetensors"))
    tt = read_safetensors(os.path.join(tmp_path, "t", "model.safetensors"))
    for name in ("layers.moe.gate_up.qweight", "layers.moe.down.qweight",
                 "layers.moe.gate_up.scale_col", "layers.moe.router.w"):
        assert torch.equal(jt[name], tt[name]), name


def test_cli_quantize_mixtral(mixtral_dir, tmp_path, monkeypatch):
    """``cli quantize`` over a Mixtral directory (w8a16 here: no
    tokenizer for calibration), then LLM over the checkpoint."""
    import functools
    from mixq_tensorrt_llm_tpu_torch import cli
    monkeypatch.setattr(thf, "quantize_hf_model", functools.partial(
        thf.quantize_hf_model, device="cpu"))
    cli.main(["quantize", "--model_dir", mixtral_dir,
              "--output_dir", str(tmp_path / "ckpt"), "--qformat", "w8a16"])
    tt = read_safetensors(str(tmp_path / "ckpt" / "model.safetensors"))
    assert tt["layers.moe.gate_up.qweight"].dtype == torch.int8
    assert tt["layers.qkv_proj.qweight"].shape == (2, 64, 128)
    llm = LLM(str(tmp_path / "ckpt"), device="cpu", max_seq_len=32)
    assert llm.generate_tokens([[5, 6, 7]], 3).num_generated == [3]
