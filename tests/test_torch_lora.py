"""Port parity, LoRA: the same PEFT adapters through the JAX package and
through the port on the CPU (tests/test_runtime_lora.py's tiny Llama and
its two adapters, written here with the port's safetensors writer).

- ``load_adapter`` (safetensors and .bin), ``merge_lora_into_state_dict``
  and ``build_lora_stack``: bit-equal to JAX's; ``attach_lora`` splits
  the stack per layer;
- ``forward(lora_ids=...)`` at tests/test_runtime_lora.py's tolerances:
  id 0 within 1e-4 of the base model, an adapter within 3e-2 of the
  merged model, a lane of a mixed batch within 2e-2 of its lane alone;
  and within 2e-3 of JAX's forward with the same ids;
- the Executor with per-request adapters (a mixed batch, decode rungs,
  a mixed burst, a speculative verify): tokens identical to the JAX
  Executor's; ``submit(lora_id=...)`` without adapters raises JAX's
  ValueError;
- beams with adapter ids (dense, paged step by step and in bursts):
  JAX's sequences;
- ``quantize_hf_model(lora_dir=...)`` and ``cli quantize --lora_dir``: the
  checkpoint JAX's quantize_hf_model(lora_dir=...) writes.
The JAX side is built once per module."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.convert import lora as jlora
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import QuantAlgo as JAlgo
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu_torch.convert import lora as tlora
from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import (read_safetensors,
                                                            write_safetensors)
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig

_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
TOKENS = np.array([[1, 5, 9, 42, 7, 100, 3, 120]], np.int32)


def write_adapter(d, sd, targets, r, alpha, seed, binary=False):
    """A PEFT directory; targets: (layer, hf_target) pairs."""
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha,
                   "target_modules": sorted({t for _, t in targets})}, f)
    rng = np.random.default_rng(seed)
    tensors = {}
    for layer, tgt in targets:
        grp = "self_attn" if tgt in _ATTN else "mlp"
        out_f, in_f = sd[f"model.layers.{layer}.{grp}.{tgt}.weight"].shape
        base = f"base_model.model.model.layers.{layer}.{grp}.{tgt}"
        tensors[base + ".lora_A.weight"] = torch.from_numpy(
            rng.normal(size=(r, in_f)).astype(np.float32) * 0.05)
        tensors[base + ".lora_B.weight"] = torch.from_numpy(
            rng.normal(size=(out_f, r)).astype(np.float32) * 0.05)
    if binary:
        torch.save(tensors, os.path.join(d, "adapter_model.bin"))
    else:
        write_safetensors(os.path.join(d, "adapter_model.safetensors"),
                          tensors)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The HF directory (the port's random writer, f32), its state dict,
    the adapters and both packages' base params with the stack
    attached."""
    from mixq_tensorrt_llm_tpu.convert import hf as jhf
    from mixq_tensorrt_llm_tpu_torch.convert.hf import load_hf_state_dict
    from mixq_tensorrt_llm_tpu_torch.tools.random_hf import (
        LLAMA2_7B_HF, write_random_llama)
    root = tmp_path_factory.mktemp("lora")
    write_random_llama(str(root / "hf"), dict(
        LLAMA2_7B_HF, vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, torch_dtype="float32"), device="cpu")
    tsd = load_hf_state_dict(str(root / "hf"))
    sd = {k: v.numpy() for k, v in tsd.items()}
    dirs = [str(root / "a1"), str(root / "a2"), str(root / "a2bin")]
    write_adapter(dirs[0], sd, [(0, "q_proj"), (1, "q_proj")], r=4,
                  alpha=8, seed=1)
    t2 = [(0, "q_proj"), (0, "v_proj"), (0, "up_proj"), (1, "down_proj"),
          (1, "o_proj")]
    write_adapter(dirs[1], sd, t2, r=2, alpha=4, seed=2)
    write_adapter(dirs[2], sd, t2, r=2, alpha=4, seed=2, binary=True)

    # f32 activations, for the token-exact checks
    jcfg = dataclasses.replace(
        jllama.config_from_hf(jhf.load_hf_config(str(root / "hf")),
                              JQuant()), dtype=jnp.float32)
    jp = jlora.attach_lora(jllama.params_from_hf(jcfg, sd),
                           jlora.build_lora_stack(jcfg, dirs[:2]))
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = tlora.attach_lora(tllama.params_from_hf(cfg, tsd, device="cpu"),
                           tlora.build_lora_stack(cfg, dirs[:2],
                                                  device="cpu"))
    return dict(hf_dir=str(root / "hf"), sd=sd, tsd=tsd, dirs=dirs,
                jcfg=jcfg, jp=jp, cfg=cfg, tp=tp)


# ---------------------------------------------------------------------------
# the artifacts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", [0, 1, 2])
def test_load_adapter_bit_equal(setup, which):
    d = setup["dirs"][which]
    jc, jt = jlora.load_adapter(d)
    tc, tt = tlora.load_adapter(d)
    assert tc == jc and sorted(tt) == sorted(jt)
    for m in jt:
        assert sorted(tt[m]) == sorted(jt[m])
        for ab in jt[m]:
            assert tt[m][ab].dtype == np.float32
            np.testing.assert_array_equal(tt[m][ab], jt[m][ab])


@pytest.mark.parametrize("which", [0, 1])
def test_merge_bit_equal(setup, which):
    d = setup["dirs"][which]
    want = jlora.merge_lora_into_state_dict(setup["sd"], d)
    got = tlora.merge_lora_into_state_dict(setup["tsd"], d)
    assert sorted(got) == sorted(want)
    changed = 0
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k].float()),
                                      np.asarray(want[k], np.float32))
        changed += not np.array_equal(np.asarray(want[k], np.float32),
                                      setup["sd"][k])
    assert changed == (2 if which == 0 else 5)


def test_build_lora_stack_bit_equal_and_attached_per_layer(setup):
    want = jlora.build_lora_stack(setup["jcfg"], setup["dirs"][:2])
    got = tlora.build_lora_stack(setup["cfg"], setup["dirs"][:2],
                                 device="cpu")
    assert sorted(got) == sorted(want) == ["down_proj", "gate_up_proj",
                                           "o_proj", "qkv_proj"]
    for mod in want:
        for ab in ("A", "B"):
            assert got[mod][ab].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                got[mod][ab].float().numpy(),
                np.asarray(want[mod][ab].astype(jnp.float32)))
            assert not got[mod][ab][:, 0].any()        # adapter 0: base
            for i, lp in enumerate(setup["tp"]["layers"]):
                assert torch.equal(lp[mod]["lora_" + ab], got[mod][ab][i])
    assert tlora.has_lora(setup["tp"])


# ---------------------------------------------------------------------------
# forward(lora_ids)
# ---------------------------------------------------------------------------

def _port_forward(cfg, params, tokens, lora_ids=None):
    b, s = tokens.shape
    cache = tcommon.init_kv_cache(cfg, b, 16, device="cpu")
    return tcommon.forward(
        params, cfg, torch.from_numpy(tokens), torch.arange(s)[None].expand(
            b, s), cache, torch.full((b,), s),
        lora_ids=None if lora_ids is None else torch.tensor(lora_ids))[0]


def _jax_forward(cfg, params, tokens, lora_ids):
    b, s = tokens.shape
    cache = jcommon.init_kv_cache(cfg, b, 16)
    return np.asarray(jcommon.forward(
        params, cfg, jnp.asarray(tokens), jnp.tile(jnp.arange(s), (b, 1)),
        cache, jnp.full((b,), s, jnp.int32),
        lora_ids=jnp.asarray(lora_ids, jnp.int32))[0])


def test_forward_lora_ids(setup):
    """id 0 is the base model; each adapter acts as its merged model does;
    lanes of a mixed batch are independent; every lane within 2e-3 of
    JAX's forward with the same ids (each float linear rounds its input to
    bf16 in both packages: past the first, a rounding may go the other
    way; the adapters' f32 products add nothing larger)."""
    cfg, tp = setup["cfg"], setup["tp"]
    base = _port_forward(cfg, tp, TOKENS)
    torch.testing.assert_close(_port_forward(cfg, tp, TOKENS, [0]), base,
                               rtol=1e-4, atol=1e-4)
    for aid in (1, 2):
        merged = tllama.params_from_hf(
            cfg, tlora.merge_lora_into_state_dict(setup["tsd"],
                                                  setup["dirs"][aid - 1]),
            device="cpu")
        want = _port_forward(cfg, merged, TOKENS)
        got = _port_forward(cfg, tp, TOKENS, [aid])
        assert float((want - base).abs().max()) > 1e-3   # the adapter acts
        torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    toks3 = np.tile(TOKENS, (3, 1))
    mixed = _port_forward(cfg, tp, toks3, [0, 1, 2])
    for lane, aid in enumerate((0, 1, 2)):
        torch.testing.assert_close(
            mixed[lane:lane + 1], _port_forward(cfg, tp, TOKENS, [aid]),
            rtol=2e-2, atol=2e-2)
    want = _jax_forward(setup["jcfg"], setup["jp"], toks3, [0, 1, 2])
    np.testing.assert_allclose(mixed.numpy(), want, rtol=2e-3, atol=2e-3)


def test_forward_paged_lora_ids(setup):
    """forward_paged with ids: the dense forward's logits."""
    from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv
    cfg, tp = setup["cfg"], setup["tp"]
    toks3 = np.tile(TOKENS, (3, 1))
    state = tkv.init_paged_kv(cfg, 8, 8, device="cpu")
    table = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    got, _ = tcommon.forward_paged(
        tp, cfg, torch.from_numpy(toks3), torch.arange(8)[None].expand(3, 8),
        state, table, torch.full((3,), 8), lora_ids=torch.tensor([0, 1, 2]))
    torch.testing.assert_close(got, _port_forward(cfg, tp, toks3, [0, 1, 2]),
                               rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the Executor, beams
# ---------------------------------------------------------------------------

EXKW = dict(max_batch=4, max_seq_len=32, block_size=8, prefill_chunk=8)
REQS = [([1, 5, 9, 42], 6, 0), ([1, 5, 9, 42], 6, 1), ([7, 3, 2], 6, 2),
        ([4, 4, 9, 11, 20, 1], 6, 1)]


def _serve(ex, reqs, burst=1, spec=None):
    ids = [ex.submit(p, max_new_tokens=n, lora_id=a) for p, n, a in reqs]
    if spec is not None:
        done = ex.run_speculative(*spec)
    else:
        done = ex.run(burst=burst, mixed_burst=burst)
    return [done[r].generated for r in ids]


@pytest.fixture(scope="module")
def jax_executor_tokens(setup):
    """The JAX Executor's greedy tokens at burst 4 (greedy tokens do not
    depend on the burst: tests/test_torch_executor_burst.py)."""
    from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JEx
    return _serve(JEx(setup["jp"], setup["jcfg"], seed=0, **EXKW), REQS, 4)


@pytest.mark.parametrize("burst", [1, 4])
def test_executor_per_request_adapters_match_jax(setup, jax_executor_tokens,
                                                 burst):
    """Requests with ids 0, 1, 2 in one batch: JAX's tokens, through the
    prefill chunks and the decode rungs (burst 4: k-step rungs and mixed
    bursts behind a prefill); each lane as the same request alone."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    ex = Executor(setup["tp"], setup["cfg"], seed=0, device="cpu", **EXKW)
    got = _serve(ex, REQS, burst)
    assert got == jax_executor_tokens
    assert ex.has_lora and "lora" in ex._dec.host
    if burst == 1:
        alone = _serve(Executor(setup["tp"], setup["cfg"], seed=0,
                                device="cpu", **EXKW), REQS[2:3])
        assert alone[0] == got[2]


def test_executor_speculative_verify_serves_adapters(setup,
                                                     jax_executor_tokens):
    """A self-draft speculative run, host-paced as JAX paces it: the
    verify serves each lane's adapter, so the tokens are the plain run's
    (JAX's)."""
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    ex = Executor(setup["tp"], setup["cfg"], seed=0, device="cpu", **EXKW)
    got = _serve(ex, REQS, spec=(setup["tp"], setup["cfg"], 3, True, 1))
    assert got == jax_executor_tokens


def test_submit_without_adapters_raises(setup):
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    bare = tllama.params_from_hf(setup["cfg"], setup["tsd"], device="cpu")
    ex = Executor(bare, setup["cfg"], device="cpu", **EXKW)
    with pytest.raises(ValueError, match="no adapters"):
        ex.submit([1, 2, 3], max_new_tokens=4, lora_id=1)
    assert not ex.has_lora and "lora" not in ex._dec.host


BEAM_PROMPTS, BEAM_IDS = [[1, 5, 9, 42], [7, 3, 2], [4, 4, 9]], [1, 0, 2]


@pytest.fixture(scope="module")
def jax_beams(setup):
    """JAX's paged beam search at burst 4 with the adapter ids (its routes
    agree with each other: tests/test_torch_beam.py)."""
    from mixq_tensorrt_llm_tpu.runtime import beam as jbeam
    return jbeam.paged_beam_search(setup["jp"], setup["jcfg"], BEAM_PROMPTS,
                                   6, num_beams=3, max_seq_len=32,
                                   lora_ids=BEAM_IDS, block_size=8, burst=4)


@pytest.mark.parametrize("route", ["dense", "paged1", "paged4"])
def test_beams_with_adapter_ids_match_jax(setup, jax_beams, route):
    """Each request's adapter over its beams, on each of the port's routes:
    JAX's sequences, scores within 2e-5."""
    from mixq_tensorrt_llm_tpu_torch.runtime import beam as tbeam
    prompts = BEAM_PROMPTS
    kw = dict(num_beams=3, max_seq_len=32, lora_ids=BEAM_IDS)
    want = jax_beams
    if route == "dense":
        got = tbeam.beam_search(setup["tp"], setup["cfg"], prompts, 6,
                                device="cpu", **kw)
    else:
        got = tbeam.paged_beam_search(setup["tp"], setup["cfg"], prompts, 6,
                                      block_size=8, burst=int(route[-1]),
                                      device="cpu", **kw)
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, rtol=2e-5,
                               atol=2e-5)
    base = tbeam.beam_search(setup["tp"], setup["cfg"], prompts, 6,
                             num_beams=3, max_seq_len=32, device="cpu")
    assert base.sequences[1] == got.sequences[1]      # id 0: the base


# ---------------------------------------------------------------------------
# quantize with a merged adapter
# ---------------------------------------------------------------------------

def _assert_ckpt_equal(jdir, tdir):
    jt = read_safetensors(os.path.join(jdir, "model.safetensors"))
    tt = read_safetensors(os.path.join(tdir, "model.safetensors"))
    assert sorted(jt) == sorted(tt)
    for name in jt:
        a, b = jt[name], tt[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype in (torch.int8, torch.int32):
            assert torch.equal(a, b), name
        else:
            torch.testing.assert_close(b.float(), a.float(), rtol=1e-5,
                                       atol=1e-5, msg=name)


def test_quantize_with_lora_matches_jax(setup, tmp_path, monkeypatch):
    """quantize_hf_model(lora_dir=...) and ``cli quantize --lora_dir``:
    JAX's checkpoint; the adapter changes layer 0's qkv and leaves the
    rest of layer 0's mlp as it was."""
    import functools

    from mixq_tensorrt_llm_tpu.convert import hf as jhf
    from mixq_tensorrt_llm_tpu_torch import cli
    from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
    from mixq_tensorrt_llm_tpu_torch.quant.config import (QuantAlgo,
                                                          QuantConfig)
    hf_dir, ad = setup["hf_dir"], setup["dirs"][0]
    jhf.quantize_hf_model(hf_dir, str(tmp_path / "j"),
                          JQuant(algo=JAlgo.INT8_MIX, num_outliers=8),
                          lora_dir=ad)
    thf.quantize_hf_model(hf_dir, str(tmp_path / "t"),
                          QuantConfig(algo=QuantAlgo.INT8_MIX,
                                      num_outliers=8),
                          lora_dir=ad, device="cpu")
    _assert_ckpt_equal(str(tmp_path / "j"), str(tmp_path / "t"))
    monkeypatch.setattr(thf, "quantize_hf_model", functools.partial(
        thf.quantize_hf_model, device="cpu"))
    cli.main(["quantize", "--model_dir", hf_dir, "--output_dir",
              str(tmp_path / "c"), "--qformat", "int8_mix",
              "--num_outliers", "8", "--lora_dir", ad])
    _assert_ckpt_equal(str(tmp_path / "j"), str(tmp_path / "c"))
    thf.quantize_hf_model(hf_dir, str(tmp_path / "p"),
                          QuantConfig(algo=QuantAlgo.INT8_MIX,
                                      num_outliers=8))
    plain = read_safetensors(str(tmp_path / "p" / "model.safetensors"))
    lora = read_safetensors(str(tmp_path / "t" / "model.safetensors"))
    names = [n for n in plain if "qweight" in n]
    q0 = [n for n in names if "qkv" in n]
    assert any(not torch.equal(plain[n], lora[n]) for n in q0)
    assert all(torch.equal(plain[n], lora[n]) for n in names
               if "down_proj" in n)
