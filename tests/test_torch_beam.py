"""Port parity of beam search (runtime/beam.py) on the CPU: the same
numpy-seeded f32 tiny Llamas (2 layers, unquantized, and int8_mix with an
int8 KV cache) through the JAX package and the port (device="cpu").

BlockManager.fork / ensure_exclusive keep the JAX manager's ref counts and
free lists; the top-k keeps jax.lax.top_k's order on ties; the page copy
reads every source before it writes; the burst's tail attention
(models/common._attention_paged_tail) is within 1e-5 of JAX's;
paged_beam_search at burst 1, 4 and 8 (ragged prompts), with an eos that
stops beams early and with a burst longer than the budget, and the dense
beam_search give JAX's sequences, its scores within 2e-5 (5e-4 on int8
KV) and its peak_blocks; so do min_new_tokens, bad words, stop sequences
and a logits processor (written once in each framework) on the burst,
the per-step and the dense path. JAX results are computed once per
configuration and shared between cases."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import beam as jbeam
from mixq_tensorrt_llm_tpu.runtime import kv_cache as jkv
from mixq_tensorrt_llm_tpu_torch.convert import params_from_numpy
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import beam as tbeam
from mixq_tensorrt_llm_tpu_torch.runtime import kv_cache as tkv

PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1], [11, 12, 13, 14, 15]]
KW = dict(num_beams=3, max_seq_len=64, block_size=8)
TOL = {"none": 2e-5, "int8": 5e-4}


@pytest.fixture(scope="module")
def models():
    """quant -> (JAX cfg, JAX params, port cfg, port params, JAX results
    by configuration)."""
    out = {}
    for quant in ("none", "int8"):
        q = (JQuant() if quant == "none" else
             JQuant(algo=JAlgo.INT8_MIX, num_outliers=8, kv_cache=JKV.INT8))
        jcfg = JConfig(vocab_size=96, hidden_size=64, intermediate_size=96,
                       num_layers=2, num_heads=4, num_kv_heads=2,
                       head_dim=16, max_position_embeddings=128,
                       dtype=jnp.float32, quant=q)
        jp = jllama.init_random_params(jcfg, jax.random.PRNGKey(0))
        cfg = ModelConfig.from_dict(jcfg.to_dict())
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                               device="cpu")
        out[quant] = (jcfg, jp, cfg, tp, {})
    return out


def _jax(m, fn, prompts, n, **kw):
    jcfg, jp, _, _, cache = m
    key = (fn, tuple(map(tuple, prompts)), n, repr(sorted(kw.items())))
    if key not in cache:
        cache[key] = getattr(jbeam, fn)(jp, jcfg, prompts, n, **kw)
    return cache[key]


def _port(m, fn, prompts, n, **kw):
    _, _, cfg, tp, _ = m
    return getattr(tbeam, fn)(tp, cfg, prompts, n, device="cpu", **kw)


def _same(got, want, tol, peak=True):
    assert got.sequences == want.sequences
    np.testing.assert_allclose(got.scores, want.scores, rtol=tol, atol=tol)
    if peak:
        assert got.peak_blocks == want.peak_blocks


def test_fork_and_ensure_exclusive_match_jax():
    """The same script on both managers: ref counts, free lists, copy
    pairs and block lists agree after every operation."""
    managers = (jkv.BlockManager(num_blocks=12, block_size=4),
                tkv.BlockManager(num_blocks=12, block_size=4))
    script = [("add_sequence", 0, 10), ("fork", 0, 1), ("fork", 0, 2),
              ("extend", 1, 3), ("ensure_exclusive", 1, 10),
              ("ensure_exclusive", 1, 10), ("ensure_exclusive", 2, 9),
              ("free_sequence", 0), ("ensure_exclusive", 2, 5),
              ("fork", 2, 3), ("free_sequence", 2),
              ("ensure_exclusive", 3, 5), ("free_sequence", 1),
              ("free_sequence", 3)]
    for op, *args in script:
        got = [getattr(bm, op)(*args) for bm in managers]
        if op == "ensure_exclusive":
            assert got[0] == got[1]
        j, t = managers
        assert j.free == t.free
        np.testing.assert_array_equal(np.asarray(j.ref_counts),
                                      t.ref_counts)
        assert {s: (q.blocks, q.bases, q.length) for s, q in j.seqs.items()} \
            == {s: (q.blocks, q.bases, q.length) for s, q in t.seqs.items()}
    assert managers[1].num_free == 11
    managers[1].add_sequence(4, 3)
    with pytest.raises(ValueError, match="not covered"):
        managers[1].ensure_exclusive(4, 40)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_tie_order_matches_jax(k):
    """Rows full of equal values, among them the -1e9 a finished beam's
    score is absorbed into in f32: values and indices of jax.lax.top_k."""
    rng = np.random.default_rng(k)
    x = rng.integers(-3, 3, (6, 40)).astype(np.float32)
    x[0] = 0.0
    x[1] = np.float32(-7.25) + np.float32(-1e9)
    x[2, ::3] = 5.0
    x[3] = np.where(np.arange(40) % 7 == 0, -1e9, -1e9 + -11.5)
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = tbeam._top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_copy_pages_reads_every_source_first():
    """Two lanes swap pages (each source is the other's destination) and
    padding copies row 0 onto itself: the JAX gather-then-set result."""
    rng = np.random.default_rng(1)
    pools = {"k": rng.integers(-127, 128, (6, 2, 4, 8), dtype=np.int8),
             "k_scale": rng.random((6, 2, 4), dtype=np.float32)}
    src, dst = np.array([2, 3, 0, 0]), np.array([3, 2, 0, 0])
    want = jbeam._copy_pages({n: jnp.asarray(p) for n, p in pools.items()},
                             jnp.asarray(src), jnp.asarray(dst))
    got = {n: torch.from_numpy(p.copy()) for n, p in pools.items()}
    tbeam._copy_pages(got, torch.from_numpy(src), torch.from_numpy(dst))
    for n in pools:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    np.testing.assert_array_equal(got["k"][3].numpy(), pools["k"][2])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_attention_paged_tail_matches_jax(models, quant):
    """One layer's burst attention at tail slot 2 of 4 over a pool prefix
    (ragged prefix lengths, a recycled table order, PAD_POS padding): the
    output within 1e-5 relative of JAX's, the new token's tail entries
    equal (int8 codes bit for bit)."""
    jcfg, _, cfg, _, _ = models[quant]
    rng = np.random.default_rng(7)
    b, hq, hkv, d, bs, nblk, kmax, tidx = 4, 4, 2, 16, 8, 9, 4, 2
    pools = {"k": rng.standard_normal((nblk, hkv, bs, d), np.float32),
             "v": rng.standard_normal((nblk, hkv, bs, d), np.float32)}
    tail = {"k": rng.standard_normal((b, kmax, hkv, d), np.float32),
            "v": rng.standard_normal((b, kmax, hkv, d), np.float32)}
    if quant == "int8":
        for src in (pools, tail):
            for n in ("k", "v"):
                src[n + "_scale"] = (rng.random(src[n].shape[:-1],
                                                np.float32) * 0.02 + 1e-3)
                src[n] = rng.integers(-127, 128, src[n].shape,
                                      dtype=np.int8)
    table = np.array([[3, 1, 1, 1], [2, 5, 6, 6], [7, 8, 4, 4],
                      [1, 1, 1, 1]], np.int32)
    bpos = np.array([[0, 8, 999999, 999999], [0, 8, 16, 999999],
                     [0, 8, 16, 999999], [0, 999999, 999999, 999999]],
                    np.int32)
    prefix = np.array([13, 20, 24, 3], np.int32)
    q = rng.standard_normal((b, 1, hq, d), np.float32)
    nk = rng.standard_normal((b, 1, hkv, d), np.float32)
    nv = rng.standard_normal((b, 1, hkv, d), np.float32)
    jcaches = {n: jnp.asarray(a) for n, a in pools.items()}
    jcaches.update({f"tail_{n}": jnp.asarray(a) for n, a in tail.items()})
    jcaches["tail_idx"] = jnp.int32(tidx)
    want, jnew = jcommon._attention_paged_tail(
        jcfg, jnp.asarray(q), jnp.asarray(nk), jnp.asarray(nv), jcaches,
        jnp.asarray(table), jnp.asarray((prefix + tidx)[:, None]),
        jnp.asarray(prefix), block_pos=jnp.asarray(bpos), use_kernels=False)
    t = {n: torch.from_numpy(a.copy()) for n, a in tail.items()}
    got = tcommon._attention_paged_tail(
        cfg, torch.from_numpy(q), torch.from_numpy(nk), torch.from_numpy(nv),
        {n: torch.from_numpy(a) for n, a in pools.items()}, t, tidx,
        torch.from_numpy(table), torch.from_numpy(prefix),
        block_pos=torch.from_numpy(bpos))
    want = np.asarray(want)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel
    for n in tail:
        np.testing.assert_allclose(t[n].numpy(),
                                   np.asarray(jnew[f"tail_{n}"]),
                                   rtol=1e-6, atol=0)
        if n in ("k", "v") and quant == "int8":
            np.testing.assert_array_equal(t[n].numpy(),
                                          np.asarray(jnew[f"tail_{n}"]))


@pytest.mark.parametrize("burst", [1, 4, 8])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_paged_beam_search_matches_jax(models, quant, burst):
    m = models[quant]
    want = _jax(m, "paged_beam_search", PROMPTS, 10, burst=burst, **KW)
    got = _port(m, "paged_beam_search", PROMPTS, 10, burst=burst, **KW)
    _same(got, want, TOL[quant])


# eos 5 ends beams inside a burst (gen_len must match the per-step
# loop's early stop); a 16-step burst for a 5-token budget
EDGES = {"eos": (PROMPTS, 12, dict(burst=4, eos_token_id=5)),
         "long_burst": (PROMPTS[:2], 5, dict(burst=16, num_beams=2))}


@pytest.mark.parametrize("case", sorted(EDGES))
def test_paged_beam_search_edges_match_jax(models, case):
    prompts, n, kw = EDGES[case]
    kw = dict(KW, **kw)
    m = models["none"]
    want = _jax(m, "paged_beam_search", prompts, n, **kw)
    got = _port(m, "paged_beam_search", prompts, n, **kw)
    _same(got, want, TOL["none"])
    step = _port(m, "paged_beam_search", prompts, n, **dict(kw, burst=1))
    assert step.sequences == got.sequences


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dense_beam_search_matches_jax(models, quant):
    m = models[quant]
    kw = dict(num_beams=3, max_seq_len=64)
    want = _jax(m, "beam_search", PROMPTS, 10, **kw)
    got = _port(m, "beam_search", PROMPTS, 10, **kw)
    _same(got, want, TOL[quant], peak=False)


def _jax_last_token_penalty(logits, history):
    rows = jnp.arange(logits.shape[0])
    return logits.at[rows, jnp.clip(history[:, -1], 0)].add(-3.0)


def _torch_last_token_penalty(logits, history):
    idx = history[:, -1:].long().clamp(min=0)
    return logits.scatter_add(1, idx, torch.full(idx.shape, -3.0))


def _controls(base, control, framework):
    """(paged_beam_search / beam_search kwargs) of one control, built
    from the unconstrained best hypothesis of request 0."""
    g = base.sequences[0][len(PROMPTS[0]):]
    if control == "min_new_tokens":
        return dict(eos_token_id=g[0], min_new_tokens=[5, 5, 5])
    if control == "bad_words":
        return dict(bad_words=[[[g[0]]], [[g[1], g[2]], [g[0]]], None])
    if control == "stop_sequences":
        return dict(stop_sequences=[[[g[2]]], [[g[1], g[2]]], None])
    fn = (_jax_last_token_penalty if framework == "jax"
          else _torch_last_token_penalty)
    return dict(logits_processors=(("last", fn),),
                proc_masks=np.array([[True], [False], [True]]))


@pytest.mark.parametrize("control", ["min_new_tokens", "bad_words",
                                     "stop_sequences", "processor"])
def test_controls_match_jax(models, control):
    """Each control on JAX's burst path against the port's burst, per-step
    and dense paths; the control visibly changes request 0's output."""
    m = models["none"]
    base = _jax(m, "paged_beam_search", PROMPTS, 10, burst=4, **KW)
    want = _jax(m, "paged_beam_search", PROMPTS, 10, burst=4, **KW,
                **_controls(base, control, "jax"))
    kw = _controls(base, control, "torch")
    got = _port(m, "paged_beam_search", PROMPTS, 10, burst=4, **KW, **kw)
    _same(got, want, TOL["none"])
    step = _port(m, "paged_beam_search", PROMPTS, 10, **KW, **kw)
    dense = _port(m, "beam_search", PROMPTS, 10, num_beams=3,
                  max_seq_len=64, **kw)
    for other in (step, dense):
        _same(other, want, TOL["none"], peak=False)
    assert want.sequences[0] != base.sequences[0]


def test_lora_ids_raise(models):
    """Beams over runtime LoRA adapters, ported: with a random adapter
    attached, every route (dense, paged step by step, paged bursts) gives
    the same sequences for ids [1, 0, 0]; the lanes of id 0 are the base
    model's and the adapter's lane differs from it (the JAX comparison is
    tests/test_torch_lora.py's)."""
    from mixq_tensorrt_llm_tpu_torch.convert.lora import attach_lora
    _, _, cfg, tp, _ = models["none"]
    gen = torch.Generator().manual_seed(0)
    stack = {}
    for mod, (nin, nout) in (("qkv_proj", (64, cfg.qkv_out)),
                             ("down_proj", (96, 64))):
        a = torch.randn((2, 2, nin, 4), generator=gen) * 0.3
        b = torch.randn((2, 2, 4, nout), generator=gen) * 0.3
        a[:, 0] = 0
        b[:, 0] = 0
        stack[mod] = {"A": a.bfloat16(), "B": b.bfloat16()}
    lp = dict(tp, layers=[{m: dict(v) for m, v in lay.items()}
                          for lay in tp["layers"]])
    attach_lora(lp, stack)
    ids = [1, 0, 0]
    base = tbeam.beam_search(tp, cfg, PROMPTS, 6, num_beams=3,
                             max_seq_len=64, device="cpu")
    outs = [tbeam.beam_search(lp, cfg, PROMPTS, 6, num_beams=3,
                              max_seq_len=64, lora_ids=ids, device="cpu")]
    for burst in (1, 4):
        outs.append(tbeam.paged_beam_search(lp, cfg, PROMPTS, 6, **KW,
                                            burst=burst, lora_ids=ids,
                                            device="cpu"))
    for o in outs:
        assert o.sequences == outs[0].sequences
        np.testing.assert_allclose(o.scores, outs[0].scores, rtol=2e-5,
                                   atol=2e-5)
    assert outs[0].sequences[1:] == base.sequences[1:]
    assert outs[0].scores[0] != base.scores[0]
