"""Port parity, ReDrafter decoding: the same inputs through the JAX
package and through the port on the CPU (the tiny configs of
tests/test_redrafter.py, f32 for the token-exact checks).

- ``drafter_logits``, ``beam_search_draft`` (RNN and not, and under ties:
  jax.lax.top_k's order, the lower index first) and ``drafter_from_hf``
  against JAX's;
- ``redrafter_generate`` with a random RNN drafter and with an oracle in
  beam 0 and in beam 1: tokens and stats identical to JAX's on
  f32; on int8_mix / int8 KV identical up to a first flip after
  len(prompt) + 4 (tests/test_medusa.py's allowance);
- verify rows written at slots offset from their positions reproduce the
  sequential decode's logits (JAX tests/test_redrafter.py:160-196) within
  1e-5, not bit for bit: torch's f32 products block differently with the
  number of rows.
The JAX results are built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import redrafter as jred
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import redrafter as tred

PROMPT = list(range(1, 9))


def _jcfg(quant=JQuant()):
    return JConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, quant=quant,
                   dtype=jnp.float32)


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tp):
    """Port params -> the JAX package's tree (layers stacked), leaf for
    leaf: the same model on both sides without JAX's slower eager init."""
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


def _both(jcfg, seed=0):
    """(JAX params, JAX config, port params, port config): one random
    model, made by the port and handed to JAX leaf for leaf."""
    cfg = ModelConfig.from_dict(jcfg.to_dict())
    tp = tllama.init_random_params(cfg, seed=seed, device="cpu")
    return _to_jax(tp), jcfg, tp, cfg


@pytest.fixture(scope="module")
def models():
    return {"f32": _both(_jcfg()),
            "int8": _both(_jcfg(JQuant(algo=JAlgo.INT8_MIX, num_outliers=4,
                                       kv_cache=JKV.INT8)))}


@pytest.fixture(scope="module")
def drafters(models):
    """Random drafters as JAX makes them: RNN at exit 2H, non-RNN with an
    input projection to 48."""
    jcfg = models["f32"][1]
    out = {}
    for name, kw in (("rnn", dict(is_rnn=True)),
                     ("plain", dict(is_rnn=False, exit_dim=48))):
        jd = jred.init_random_drafter(jcfg, jax.random.PRNGKey(1), **kw)
        out[name] = (jd, _to_torch(jd))
    return out


def _first_flip(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# ---------------------------------------------------------------------------
# the drafter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["rnn", "plain"])
def test_drafter_logits_match_jax(drafters, name):
    jd, td = drafters[name]
    x = np.random.default_rng(0).normal(size=(3, 128)).astype(np.float32)
    np.testing.assert_allclose(
        tred.drafter_logits(td, torch.from_numpy(x)).numpy(),
        np.asarray(jred.drafter_logits(jd, jnp.asarray(x))),
        atol=1e-5, rtol=1e-5)


def _draft_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(96, 64)).astype(np.float32),
            rng.normal(size=(64,)).astype(np.float32))


@pytest.mark.parametrize("name", ["rnn", "plain"])
@pytest.mark.parametrize("beams,length", [(4, 3), (2, 4)])
def test_beam_search_draft_matches_jax(drafters, name, beams, length):
    jd, td = drafters[name]
    embed, hidden = _draft_inputs()
    want = np.asarray(jred.beam_search_draft(
        jd, jnp.asarray(embed), jnp.asarray(hidden), jnp.int32(5), beams,
        length))
    got = tred.beam_search_draft(td, torch.from_numpy(embed),
                                 torch.from_numpy(hidden), 5, beams, length)
    np.testing.assert_array_equal(got.numpy(), want)


def test_beam_search_draft_ties_follow_lax_top_k(drafters):
    """A drafter whose head is zero: every continuation ties, so the beams
    take the lowest flat indices, in jax.lax.top_k's order, in both."""
    jd, td = drafters["rnn"]
    jd = dict(jd, lm_head={"w": jnp.zeros_like(jd["lm_head"]["w"])})
    td = dict(td, lm_head={"w": torch.zeros_like(td["lm_head"]["w"])})
    embed, hidden = _draft_inputs(1)
    want = np.asarray(jred.beam_search_draft(
        jd, jnp.asarray(embed), jnp.asarray(hidden), jnp.int32(3), 4, 3))
    got = tred.beam_search_draft(td, torch.from_numpy(embed),
                                 torch.from_numpy(hidden), 3, 4, 3)
    np.testing.assert_array_equal(got.numpy(), want)
    # each step all K*V candidates tie: beam 0's lowest tokens win
    assert got[:, :-1].tolist() == [[0, 0]] * 4
    assert got[:, -1].tolist() == [0, 1, 2, 3]


def test_drafter_from_hf_matches_jax():
    """A ReDrafter-format state dict (drafter. prefix; input_proj, two
    ResBlocks, lm_head, the RNN) loads as in JAX; bare keys too."""
    rng = np.random.default_rng(0)
    h, v, e = 16, 32, 24

    def r(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    body = {"input_proj.weight": r(e, 2 * h), "input_proj.bias": r(e),
            "layers.0.linear.weight": r(e, e), "layers.0.linear.bias": r(e),
            "layers.1.linear.weight": r(e, e), "layers.1.linear.bias": r(e),
            "lm_head.weight": r(v, e), "rnn_w.weight": r(h, h),
            "rnn_u.weight": r(h, h), "rnn_u.bias": r(h)}
    for pre in ("drafter.", ""):
        sd = {pre + k: a for k, a in body.items()}
        want = jred.drafter_from_hf(sd)
        got = tred.drafter_from_hf(
            {k: torch.from_numpy(a) for k, a in sd.items()}, device="cpu")
        assert jax.tree.structure(want) == jax.tree.structure(
            jax.tree.map(lambda t: 0, got))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# redrafter_generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(models, drafters):
    out = {}
    for kind, name in (("f32", "rnn"), ("int8", "rnn")):
        jp, jcfg = models[kind][:2]
        out[kind, name] = jred.redrafter_generate(
            jp, jcfg, drafters[name][0], PROMPT, 10)
    return out


@pytest.mark.parametrize("kind,name", [("f32", "rnn"), ("int8", "rnn")])
def test_random_drafter_matches_jax(models, drafters, jax_runs, kind, name):
    _, _, tp, cfg = models[kind]
    want, ws = jax_runs[kind, name]
    got, gs = tred.redrafter_generate(tp, cfg, drafters[name][1], PROMPT,
                                      10, device="cpu")
    assert gs.tokens == 10 and len(got) == len(PROMPT) + 10
    if kind == "f32":
        assert got == want and gs.steps == ws.steps
    else:
        assert _first_flip(got, want) >= len(PROMPT) + 4, (got, want)


def _greedy(tp, cfg, n):
    from mixq_tensorrt_llm_tpu_torch.runtime.session import \
        GenerationSession
    sess = GenerationSession(tp, cfg, max_seq_len=len(PROMPT) + n,
                             prefill_buckets=(len(PROMPT),),
                             use_flash_prefill=False, device="cpu")
    return sess.generate([PROMPT], max_new_tokens=n).sequences[0]


@pytest.mark.parametrize("beam", [0, 1])
def test_oracle_matches_jax(models, beam):
    """The greedy continuation proposed in beam 0, or in beam 1 (its rows
    at slots offset by draft_len from their positions): every step accepts
    the whole beam, in both packages, with JAX's tokens and steps."""
    jp, jcfg, tp, cfg = models["f32"]
    n, lc = 12, 3
    want_seq = _greedy(tp, cfg, n + lc + 1)
    gen = want_seq[len(PROMPT):]

    def oracle(hidden, next_tok, step):
        start = (step - 1) * (lc + 1) + 1      # after the committed root
        row = (gen[start:start + lc] + [0] * lc)[:lc]
        beams = np.zeros((3, lc), np.int32)
        beams[beam] = row
        return beams

    want, ws = jred.redrafter_generate(jp, jcfg, None, PROMPT, n,
                                       num_beams=3, draft_len=lc,
                                       draft_fn=oracle)
    got, gs = tred.redrafter_generate(tp, cfg, None, PROMPT, n, num_beams=3,
                                      draft_len=lc, draft_fn=oracle,
                                      device="cpu")
    assert got == want == want_seq[:len(PROMPT) + n]
    assert (gs.steps, gs.tokens) == (ws.steps, ws.tokens)
    assert gs.tokens_per_step > lc


def test_verify_rows_match_decode_logits(models):
    """Rows at slots s0+3.. with their true positions s0.. (rope_pos) and
    a causal mask over them reproduce the sequential decode's logits
    within 1e-5 (the JAX test holds it bit for bit; torch's f32 products
    block differently for 1 and 3 rows)."""
    _, _, tp, cfg = models["f32"]
    s0 = len(PROMPT)
    cache = tcommon.init_kv_cache(cfg, 1, 32, device="cpu")
    lg, _ = tcommon.forward(tp, cfg, torch.tensor([PROMPT]),
                            torch.arange(s0)[None], cache,
                            torch.tensor([s0]))
    toks, truth = [int(lg[0, -1].argmax())], []
    for j in range(3):
        lgj, _ = tcommon.forward(tp, cfg, torch.tensor([[toks[-1]]]),
                                 torch.tensor([[s0 + j]]), cache,
                                 torch.tensor([s0 + j + 1]))
        truth.append(lgj[0, 0])
        toks.append(int(lgj[0, 0].argmax()))
    mask = torch.zeros((1, 1, 3, 32), dtype=torch.bool)
    mask[..., :s0] = True
    mask[0, 0, :, s0 + 3:s0 + 6] = torch.tril(torch.ones(3, 3,
                                                         dtype=torch.bool))
    out, _ = tcommon.forward(tp, cfg, torch.tensor([toks[:3]]),
                             torch.arange(3)[None] + s0 + 3, cache,
                             torch.tensor([s0 + 6]), attn_mask=mask,
                             rope_pos=torch.arange(3)[None] + s0)
    for j in range(3):
        np.testing.assert_allclose(out[0, j].numpy(), truth[j].numpy(),
                                   atol=1e-5, rtol=1e-5)
