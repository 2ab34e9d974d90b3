"""Port parity, Medusa decoding and the dense forward's verification
options: the same inputs through the JAX package and through the port
on the CPU (the tiny configs of tests/test_medusa.py, f32 for the
token-exact checks).

- ``forward(attn_mask=..., rope_pos=..., return_hidden=...)`` against
  JAX's within 1e-5 on f32, and a given mask turning ``full_prefill``'s
  causal route off;
- ``build_tree``, ``head_logits``, ``heads_from_hf`` against JAX's, and
  the candidates' order under ties (jax.lax.top_k's: the lower index
  first);
- ``medusa_generate`` with random and with oracle heads: tokens and
  stats identical to JAX's on f32; on int8_mix / int8 KV identical up to
  a first flip that comes after len(prompt) + 4 (tests/test_medusa.py's
  allowance: the S = 1 baseline and the 11-row verify round
  differently).
The JAX results are built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import common as jcommon
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu.runtime import medusa as jmed
from mixq_tensorrt_llm_tpu_torch.models import common as tcommon
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import medusa as tmed

PROMPT = list(range(1, 9))


def _jcfg(quant=JQuant(), dtype=jnp.float32):
    return JConfig(vocab_size=96, hidden_size=64, intermediate_size=128,
                   num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                   max_position_embeddings=128, quant=quant, dtype=dtype)


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
def heads(models):
    jcfg = models["f32"][1]
    jh = jmed.init_random_heads(jcfg, jax.random.PRNGKey(1), num_heads=4)
    return jh, _to_torch(jh)


def _first_flip(a, b):
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


# ---------------------------------------------------------------------------
# forward's verification options
# ---------------------------------------------------------------------------

def _tree_inputs(smax=32, s0=8, r=5, seed=0):
    """A prefilled-history shape: rows at slots s0+3.. with true positions
    s0.., a random ancestor-style mask over them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 96, (1, r)).astype(np.int32)
    slots = (np.arange(r) + s0 + 3)[None].astype(np.int32)
    pos = (np.arange(r) + s0)[None].astype(np.int32)
    mask = np.zeros((1, 1, r, smax), bool)
    mask[..., :s0] = True
    blk = np.tril(rng.random((r, r)) < 0.6) | np.eye(r, dtype=bool)
    mask[0, 0, :, s0 + 3:s0 + 3 + r] = blk
    return tokens, slots, pos, mask


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_forward_mask_rope_hidden_match_jax(models, kind):
    """A prefill, then rows at offset slots with their true positions for
    RoPE and a given mask: logits, the returned pre-norm hidden and the
    cache against JAX's (1e-5 on f32; 1e-3 of the largest logit on int8
    KV, whose quantized rows may round apart)."""
    jp, jcfg, tp, cfg = models[kind]
    smax, s0 = 32, 8
    tokens, slots, pos, mask = _tree_inputs(smax, s0)
    prompt = np.asarray(PROMPT, np.int32)[None]
    jc = jcommon.init_kv_cache(jcfg, 1, smax)
    _, jc = jcommon.forward(jp, jcfg, jnp.asarray(prompt),
                            jnp.arange(s0)[None], jc,
                            jnp.full((1,), s0, jnp.int32))
    jl, jc, jh = jcommon.forward(
        jp, jcfg, jnp.asarray(tokens), jnp.asarray(slots), jc,
        jnp.full((1,), s0 + 8, jnp.int32), attn_mask=jnp.asarray(mask),
        rope_pos=jnp.asarray(pos), return_hidden=True)
    tc = tcommon.init_kv_cache(cfg, 1, smax, device="cpu")
    tcommon.forward(tp, cfg, torch.from_numpy(prompt),
                    torch.arange(s0)[None], tc, torch.tensor([s0]))
    tl, tc, th = tcommon.forward(
        tp, cfg, torch.from_numpy(tokens), torch.from_numpy(slots), tc,
        torch.tensor([s0 + 8]), attn_mask=torch.from_numpy(mask),
        rope_pos=torch.from_numpy(pos), return_hidden=True)
    tol = 1e-5 if kind == "f32" else 1e-3 * float(np.abs(jl).max())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                               rtol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=tol,
                               rtol=1e-5)
    assert th.shape == (1, 5, cfg.hidden_size)
    if kind == "f32":
        np.testing.assert_allclose(tc.k.numpy(), np.asarray(jc.k),
                                   atol=1e-5, rtol=1e-5)


def test_rope_pos_and_mask_change_the_result(models):
    """Controls: RoPE by slot (rope_pos dropped) and a causal-by-slot mask
    in place of the given one each move the logits far beyond 1e-5."""
    _, _, tp, cfg = models["f32"]
    smax, s0 = 32, 8
    tokens, slots, pos, mask = _tree_inputs(smax, s0)

    def run(**kw):
        c = tcommon.init_kv_cache(cfg, 1, smax, device="cpu")
        tcommon.forward(tp, cfg, torch.tensor([PROMPT]),
                        torch.arange(s0)[None], c, torch.tensor([s0]))
        return tcommon.forward(tp, cfg, torch.from_numpy(tokens),
                               torch.from_numpy(slots), c,
                               torch.tensor([s0 + 8]), **kw)[0]

    want = run(attn_mask=torch.from_numpy(mask),
               rope_pos=torch.from_numpy(pos))
    no_rope = run(attn_mask=torch.from_numpy(mask))
    causal = run(rope_pos=torch.from_numpy(pos))
    for other in (no_rope, causal):
        assert float((other - want).abs().max()) > 1e-3


def test_mask_turns_full_prefill_off(models):
    """With a mask given, full_prefill's causal route is not taken: a
    mask that hides every earlier row gives the logits of each token
    alone, unlike the causal prefill."""
    _, _, tp, cfg = models["f32"]
    s = 6
    tok = torch.tensor([PROMPT[:s]])
    pos = torch.arange(s)[None]
    eye = torch.zeros((1, 1, s, 16), dtype=torch.bool)
    eye[0, 0, torch.arange(s), torch.arange(s)] = True

    def run(**kw):
        c = tcommon.init_kv_cache(cfg, 1, 16, device="cpu")
        return tcommon.forward(tp, cfg, tok, pos, c, torch.tensor([s]),
                               full_prefill=True, **kw)[0]

    alone = torch.cat([
        tcommon.forward(tp, cfg, tok[:, i:i + 1], pos[:, i:i + 1],
                        tcommon.init_kv_cache(cfg, 1, 16, device="cpu"),
                        torch.tensor([16]), attn_mask=eye[:, :, i:i + 1])[0]
        for i in range(s)], dim=1)
    masked = run(attn_mask=eye)
    np.testing.assert_allclose(masked.numpy(), alone.numpy(), atol=1e-5)
    assert float((run() - masked).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# tree, heads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("choices", [None, [(0,), (0, 0), (1,)],
                                     [(0,), (0, 0), (0, 0, 0), (0, 0, 0, 0)]])
def test_build_tree_matches_jax(choices):
    want = jmed.build_tree(choices or jmed.DEFAULT_CHOICES)
    got = tmed.build_tree(choices or tmed.DEFAULT_CHOICES)
    for f in ("depths", "parents", "branch", "topks"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.num_heads == want.num_heads
    assert got.num_nodes == want.num_nodes


def test_head_logits_match_jax(heads):
    jh, th = heads
    hid = np.random.default_rng(0).normal(size=(2, 64)).astype(np.float32)
    want = np.asarray(jmed.head_logits(jh, jnp.asarray(hid)))
    got = tmed.head_logits(th, torch.from_numpy(hid)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_heads_from_hf_matches_jax():
    """A Medusa-format state dict (two ResBlocks a head, bare keys for one
    head prefix and medusa_head. for the other) loads as in JAX."""
    rng = np.random.default_rng(0)
    h, v, k, nl = 16, 32, 3, 2
    sd = {}
    for head in range(k):
        pre = "medusa_head." if head % 2 else ""
        for l in range(nl):
            sd[f"{pre}{head}.{l}.linear.weight"] = rng.normal(
                size=(h, h)).astype(np.float32)
            sd[f"{pre}{head}.{l}.linear.bias"] = rng.normal(
                size=(h,)).astype(np.float32)
        sd[f"{pre}{head}.{nl}.weight"] = rng.normal(
            size=(v, h)).astype(np.float32)
    want = jmed.heads_from_hf(sd, num_heads=k, num_layers=nl)
    got = tmed.heads_from_hf({n: torch.from_numpy(a) for n, a in sd.items()},
                             num_heads=k, num_layers=nl, device="cpu")
    for path in (("blocks", "w"), ("blocks", "b"), ("lm_head", "w")):
        np.testing.assert_array_equal(got[path[0]][path[1]].numpy(),
                                      np.asarray(want[path[0]][path[1]]))
    hid = rng.normal(size=(1, h)).astype(np.float32)
    np.testing.assert_allclose(
        tmed.head_logits(got, torch.from_numpy(hid)).numpy(),
        np.asarray(jmed.head_logits(want, jnp.asarray(hid))), atol=1e-5,
        rtol=1e-5)


def test_candidates_under_ties_follow_lax_top_k(models):
    """Heads whose logits tie everywhere: every node's token comes from
    the lowest indices, as jax.lax.top_k orders them, so both packages
    build the same tree tokens and emit the same output."""
    jp, jcfg, tp, cfg = models["f32"]

    def flat(hidden, step):
        out = np.zeros((4, 1, cfg.vocab_size), np.float32)
        out[:, 0, 7:] = 1.0          # ties among 7.. above 0..6
        return out

    want, ws = jmed.medusa_generate(jp, jcfg, None, PROMPT, 6,
                                    head_logits_fn=flat)
    got, gs = tmed.medusa_generate(tp, cfg, None, PROMPT, 6,
                                   head_logits_fn=flat, device="cpu")
    assert got == want and (gs.steps, gs.tokens) == (ws.steps, ws.tokens)
    from mixq_tensorrt_llm_tpu_torch.runtime.beam import _top_k
    x = torch.from_numpy(flat(None, 1)[:, 0])
    np.testing.assert_array_equal(
        _top_k(x, 3)[1].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(x.numpy()), 3)[1]))


# ---------------------------------------------------------------------------
# medusa_generate
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_runs(models, heads):
    """JAX's medusa_generate: random heads on both configs, and the
    oracle on f32."""
    jh = heads[0]
    out = {}
    for kind in ("f32", "int8"):
        jp, jcfg = models[kind][:2]
        out[kind] = jmed.medusa_generate(jp, jcfg, jh, PROMPT, 10)
    return out


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_random_heads_match_jax(models, heads, jax_runs, kind):
    _, _, tp, cfg = models[kind]
    want, ws = jax_runs[kind]
    got, gs = tmed.medusa_generate(tp, cfg, heads[1], PROMPT, 10,
                                   device="cpu")
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


@pytest.mark.parametrize("choices",
                         [[(0,), (0, 0), (0, 0, 0), (0, 0, 0, 0)]])
def test_oracle_heads_match_jax(models, choices):
    """Oracle heads proposing the greedy continuation: full paths are
    accepted (tokens and steps equal to JAX's, about n / 5 steps), and
    the tokens equal the port's own greedy session's."""
    jp, jcfg, tp, cfg = models["f32"]
    n = 12
    want_seq = _greedy(tp, cfg, n + 8)
    gen = want_seq[len(PROMPT):]
    heads_n = tmed.build_tree(choices or tmed.DEFAULT_CHOICES).num_heads

    def oracle(hidden, step):
        # every step commits the root and the full chain: before step s
        # the root is gen[(s-1)*(K+1)], the heads propose what follows it
        base = (step - 1) * (heads_n + 1) + 1
        out = np.zeros((heads_n, 1, cfg.vocab_size), np.float32)
        for h in range(heads_n):
            out[h, 0, gen[base + h] if base + h < len(gen) else 0] = 100.0
        return out

    want, ws = jmed.medusa_generate(jp, jcfg, None, PROMPT, n,
                                    choices=choices,
                                    head_logits_fn=oracle)
    got, gs = tmed.medusa_generate(tp, cfg, None, PROMPT, n,
                                   choices=choices,
                                   head_logits_fn=oracle,
                                   device="cpu")
    assert got == want == want_seq[:len(PROMPT) + n]
    assert (gs.steps, gs.tokens) == (ws.steps, ws.tokens)
    assert gs.steps <= 3 and gs.tokens_per_step >= 4.0
