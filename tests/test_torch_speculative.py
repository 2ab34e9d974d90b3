"""Port parity, speculative decoding over the dense cache: the same
inputs through the JAX package and through the port on the CPU (the
tiny configs of tests/test_speculative.py, f32 for the token-exact
checks).

- ``speculative_generate`` and greedy ``speculative_generate_batched``:
  tokens and SpecStats identical to JAX's;
- ``_accept_resample`` against JAX's where its result is certain (every
  draft accepted where p >= q, a rejection where p is 0 at a draft token,
  a one-hot residual), the stochastic rule by tests/test_speculative.py's
  Monte Carlo check (the first emitted token distributed as p_0), and
  the same tokens from the same seed (torch.Generator draws cannot equal
  jax.random's, so stochastic tokens are not compared with JAX's);
- the Executor's dense-cache draft, ``run_speculative(paged_draft=False)``:
  tokens and ``spec_rounds`` identical to the JAX Executor's.
The JAX results are built once per module."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.quant import QuantConfig as JQuant
from mixq_tensorrt_llm_tpu.runtime import speculative as jspec
from mixq_tensorrt_llm_tpu.runtime.scheduler import Executor as JExecutor
from mixq_tensorrt_llm_tpu_torch.models import llama as tllama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.runtime import speculative as tspec
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor


def _jcfg(layers, quant=JQuant()):
    return JConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                   num_layers=layers, num_heads=4, num_kv_heads=2,
                   head_dim=16, max_position_embeddings=128, quant=quant,
                   dtype=jnp.float32)


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
    """f32 models of tests/test_speculative.py's shapes: a 3-layer target
    and a 1-layer draft."""
    return {"target": _both(_jcfg(3), 0), "draft": _both(_jcfg(1), 1)}


def _args(models, draft="draft"):
    jt, jtc, tt, ttc = models["target"]
    jd, jdc, td, tdc = models[draft]
    return (jt, jtc, jd, jdc), (tt, ttc, td, tdc)


# ---------------------------------------------------------------------------
# speculative_generate, speculative_generate_batched (greedy)
# ---------------------------------------------------------------------------

def test_single_sequence_matches_jax(models):
    """A 1-layer draft, with an eos that greedy decoding emits."""
    ja, ta = _args(models)
    prompt, n, gamma = [1, 2], 6, 3
    eos = tspec.speculative_generate(*ta, prompt, n, gamma=gamma,
                                     max_seq_len=64, device="cpu")[0][4]
    want, ws = jspec.speculative_generate(*ja, prompt, n, gamma=gamma,
                                          eos_token_id=eos, max_seq_len=64)
    got, gs = tspec.speculative_generate(*ta, prompt, n, gamma=gamma,
                                         eos_token_id=eos, max_seq_len=64,
                                         device="cpu")
    assert got == want
    assert (gs.proposed, gs.accepted) == (ws.proposed, ws.accepted)
    assert got[-1] == eos and eos not in got[len(prompt):-1]


def test_batched_greedy_matches_jax(models):
    """Three ragged prompts, one of which meets an eos that greedy
    decoding emits."""
    ja, ta = _args(models)
    prompts, n = [[5, 6, 7], [1, 2], [3, 4, 5, 6, 7]], 8
    kw = dict(gamma=3, temperature=0.0, max_seq_len=64)
    eos = tspec.speculative_generate_batched(
        *ta, prompts, n, device="cpu", **kw)[0][0][len(prompts[0]) + 3]
    want, ws = jspec.speculative_generate_batched(*ja, prompts, n,
                                                  eos_token_id=eos, **kw)
    got, gs = tspec.speculative_generate_batched(*ta, prompts, n,
                                                 eos_token_id=eos,
                                                 device="cpu", **kw)
    assert got == want
    assert (gs.proposed, gs.accepted) == (ws.proposed, ws.accepted)


# ---------------------------------------------------------------------------
# _accept_resample
# ---------------------------------------------------------------------------

def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _certain_cases():
    """(p, q, draft tokens) whose accept count and emitted token are
    certain: p = q (all accepted, the bonus one-hot), a draft token with
    p = 0 at slot j (rejected there; the residual one-hot), and p >= q
    at every draft token."""
    rng = np.random.default_rng(0)
    b, g, v = 4, 3, 8
    q = _softmax(rng.normal(size=(b, g, v)))
    toks = rng.integers(0, v, (b, g)).astype(np.int32)
    cases = []
    # p == q on the drafts, a one-hot bonus row
    p = np.concatenate([q, np.eye(v, dtype=np.float32)[[2, 5, 0, 7]][:, None]],
                       axis=1)
    cases.append((p, q, toks))
    # rejection at slot j: p puts 0 on the draft token there; the residual
    # max(p - q, 0) is one-hot at a token q gives no mass
    p = np.zeros((b, g + 1, v), np.float32)
    q2 = q.copy()
    for i in range(b):
        j = i % g
        for s in range(g + 1):
            if s < j:                      # accepted: p == q there
                p[i, s] = q2[i, s]
            elif s == j:                   # p one-hot away from the draft
                other = (toks[i, j] + 1) % v
                q2[i, j] = 0.0
                q2[i, j, toks[i, j]] = 1.0
                p[i, s, other] = 1.0
            else:
                p[i, s] = 1.0 / v
    cases.append((p, q2, toks))
    # p >= q at every draft token: all accepted
    p = np.full((b, g + 1, v), 0.0, np.float32)
    q3 = np.full((b, g, v), 1.0 / v, np.float32)
    for i in range(b):
        for s in range(g):
            p[i, s, toks[i, s]] = 1.0
        p[i, g, 3] = 1.0
    cases.append((p, q3, toks))
    return cases


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("greedy", [False, True])
def test_accept_resample_certain_cases_match_jax(case, greedy):
    p, q, toks = _certain_cases()[case]
    jn, jx = jspec._accept_resample(jnp.asarray(p), jnp.asarray(q),
                                    jnp.asarray(toks),
                                    jax.random.PRNGKey(0), greedy=greedy)
    gen = torch.Generator().manual_seed(0)
    tn, tx = tspec._accept_resample(torch.from_numpy(p), torch.from_numpy(q),
                                    torch.from_numpy(toks), gen,
                                    greedy=greedy)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    if case == 1 and not greedy:
        assert tn.tolist() == [0, 1, 2, 0]


def test_accept_resample_distribution():
    """The Leviathan rule's first emitted token (the draft's x_1 if
    accepted, else the residual draw) is distributed as the target's p_0
    (200000 trials, tests/test_speculative.py's atol)."""
    v, g, trials = 8, 3, 200_000
    gen = torch.Generator().manual_seed(0)
    p = torch.softmax(torch.randn((g + 1, v), generator=gen) * 1.5, -1)
    q = torch.softmax(torch.randn((g, v), generator=gen) * 1.5, -1)
    toks = torch.multinomial(q, trials, replacement=True,
                             generator=gen).T.int()          # (N, G)
    n, extra = tspec._accept_resample(p.expand(trials, -1, -1),
                                      q.expand(trials, -1, -1), toks, gen)
    first = torch.where(n >= 1, toks[:, 0], extra)
    hist = torch.bincount(first.long(), minlength=v).double() / trials
    np.testing.assert_allclose(hist.numpy(), p[0].double().numpy(),
                               atol=6e-3)


def test_stochastic_same_seed_and_self_draft(models):
    """The same seed gives the same tokens; draft == target accepts
    nearly everything (p == q up to rounding); eos ends a lane."""
    _, ta = _args(models, "target")
    kw = dict(gamma=4, temperature=1.0, max_seq_len=64, device="cpu")
    a, sa = tspec.speculative_generate_batched(*ta, [[5, 6, 7]], 10, seed=3,
                                               **kw)
    b, sb = tspec.speculative_generate_batched(*ta, [[5, 6, 7]], 10, seed=3,
                                               **kw)
    assert a == b and sa == sb and len(a[0]) == 13
    assert sa.acceptance_rate > 0.9
    _, td = _args(models)
    outs, _ = tspec.speculative_generate_batched(
        *td, [[1, 2], [3, 4, 5]], 8, gamma=2, temperature=0.8,
        eos_token_id=42, max_seq_len=64, seed=1, device="cpu")
    for p_len, o in zip((2, 3), outs):
        gen = o[p_len:]
        assert 1 <= len(gen) <= 8 and 42 not in gen[:-1]


# ---------------------------------------------------------------------------
# the Executor's dense-cache draft
# ---------------------------------------------------------------------------

KW = dict(max_batch=3, max_seq_len=64, block_size=8, prefill_chunk=8)
MIXED = [([3, 1, 4], 8, None), ([2, 7], 5, None), ([5, 6, 7, 8], 11, None)]


def _serve_spec(ex, requests, dp, dcfg, gamma, rounds):
    ids = [ex.submit(p, max_new_tokens=n, eos_token_id=e)
           for p, n, e in requests]
    done = ex.run_speculative(dp, dcfg, gamma=gamma, paged_draft=False,
                              rounds_per_call=rounds)
    return [done[r].generated for r in ids]


@pytest.mark.parametrize("target,draft,reqs,gamma,rounds,mb", [
    ("target", "draft", MIXED, 3, 8, 3),
])
def test_dense_draft_matches_jax_executor(models, target, draft, reqs,
                                          gamma, rounds, mb):
    """paged_draft=False: the draft over a dense cache, prefilled with
    full_prefill, gamma greedy steps, the paged verify. Tokens and
    spec_rounds equal the JAX Executor's (which paces the dense draft by
    the host) for a mixed batch served device-paced. The requests are
    tests/test_torch_executor_speculative.py's; its test_rejections holds
    the dense draft's tokens and rounds equal to the paged draft's."""
    jp, jcfg, tp, cfg = models[target]
    jd, jdcfg, td, tdcfg = models[draft]
    kw = dict(KW, max_batch=mb)
    jex = JExecutor(jp, jcfg, seed=0, **kw)
    want = _serve_spec(jex, reqs, jd, jdcfg, gamma, rounds)
    tex = Executor(tp, cfg, seed=0, device="cpu", **kw)
    got = _serve_spec(tex, reqs, td, tdcfg, gamma, rounds)
    assert got == want
    assert tex.spec_rounds == jex.spec_rounds
    assert tex.spec_accepted <= tex.spec_proposed
