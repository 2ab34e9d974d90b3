"""Draft-model speculative decoding over the dense KV cache.
Counterpart of runtime/speculative.py.

A small draft model proposes gamma tokens autoregressively, the target
verifies them all in one (gamma+1)-row forward, and the standard
accept/resample rule keeps the output distribution equal to the
target's. Both caches keep absolute positions, so a rejected slot is
simply overwritten by the next iteration (``kv_valid_len`` masks it).

- ``speculative_generate``: one sequence, greedy (the longest prefix where
  draft == target argmax; the output equals target-only greedy).
- ``speculative_generate_batched``: B sequences, greedy
  (``temperature <= 0``) or stochastic (the Leviathan rule,
  ``_accept_resample``). Each iteration is a draft pass (a 2-token
  catch-up forward, then gamma - 1 one-token steps), one target verify
  with the accept/resample on the device, and ONE host readback.

Randomness comes from an explicit ``torch.Generator`` seeded with
``seed``: the stochastic tokens are distributed as the JAX package's, not
drawn equal to them (jax.random draws cannot be reproduced).

On the card the draft's one- and two-token forwards take the weight-only
GEMM (K4), a verify of more than 4 rows the mixed path (K1 -> K2);
attention over the dense cache is the masked torch route, as the JAX
package leaves it to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models.common import ModelConfig
from .scheduler import read_back


@dataclasses.dataclass
class SpecStats:
    proposed: int = 0
    accepted: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted / self.proposed if self.proposed else 0.0


def _full(n: int, v: int, dev) -> torch.Tensor:
    return torch.full((n,), v, dtype=torch.int32, device=dev)


def _check_rewindable(*cfgs: ModelConfig) -> None:
    """A rejected draft's slots are rewound by lowering ``kv_valid_len``,
    which a recurrent state cannot undo: refuse those models (the JAX
    package runs them and keeps the rejected tokens in the state)."""
    for cfg in cfgs:
        if cfg.arch in mcommon.RECURRENT_ARCHS:
            raise NotImplementedError(
                f"{cfg.arch} carries recurrent state: speculative decoding "
                "rewinds rejected drafts, which a recurrent state cannot")


def speculative_generate(
    target_params: Dict, target_cfg: ModelConfig,
    draft_params: Dict, draft_cfg: ModelConfig,
    prompt: Sequence[int], max_new_tokens: int, gamma: int = 4,
    eos_token_id: Optional[int] = None, max_seq_len: int = 2048,
    device: DeviceLike = "cuda",
):
    """Greedy speculative decoding for a single sequence.

    Returns (tokens including the prompt, SpecStats). The output is that
    of greedy decoding with the target alone."""
    assert target_cfg.vocab_size == draft_cfg.vocab_size
    _check_rewindable(target_cfg, draft_cfg)
    dev = resolve_device(device)
    prompt = list(prompt)
    n0 = len(prompt)
    t_cache = mcommon.init_kv_cache(target_cfg, 1, max_seq_len, device=dev)
    d_cache = mcommon.init_kv_cache(draft_cfg, 1, max_seq_len, device=dev)

    def run(params, cfg, cache, tokens, start):
        s = len(tokens)
        tok = torch.as_tensor(np.asarray(tokens, np.int32), device=dev)[None]
        pos = (start + torch.arange(s, dtype=torch.int32, device=dev))[None]
        logits, _ = mcommon.forward(params, cfg, tok, pos, cache,
                                    _full(1, start + s, dev))
        return logits[0]

    t_logits = run(target_params, target_cfg, t_cache, prompt, 0)
    run(draft_params, draft_cfg, d_cache, prompt, 0)

    out = list(prompt)
    stats = SpecStats()
    out.append(int(t_logits[n0 - 1].argmax()))

    while len(out) - n0 < max_new_tokens:
        if eos_token_id is not None and out[-1] == eos_token_id:
            break
        base = len(out)          # tokens known good so far
        g = min(gamma, max_new_tokens - (len(out) - n0),
                max_seq_len - base - 1)
        if g <= 0:
            break
        # the draft proposes g tokens autoregressively from the newest
        draft_tokens: List[int] = []
        tok = out[-1]
        for j in range(g):
            d_logits = run(draft_params, draft_cfg, d_cache, [tok],
                           base - 1 + j)
            tok = int(d_logits[0].argmax())
            draft_tokens.append(tok)
        # the target verifies [newest] + drafts in one forward
        t_logits = run(target_params, target_cfg, t_cache,
                       [out[-1]] + draft_tokens, base - 1)
        preds = t_logits.argmax(-1).tolist()   # prediction after each row

        stats.proposed += g
        n_accept = 0
        for j in range(g):
            if draft_tokens[j] != preds[j]:
                break
            n_accept += 1
            if eos_token_id is not None and draft_tokens[j] == eos_token_id:
                break
        stats.accepted += n_accept
        # the target's own prediction after the last accepted token comes
        # free from the same verify
        new_tokens = draft_tokens[:n_accept] + [preds[n_accept]]
        room = max_new_tokens - (len(out) - n0)
        out.extend(new_tokens[:room])
        if eos_token_id is not None and eos_token_id in new_tokens[:room]:
            break

    if eos_token_id is not None and eos_token_id in out[n0:]:
        out = out[: n0 + out[n0:].index(eos_token_id) + 1]
    return out, stats


# ---------------------------------------------------------------------------
# Batched stochastic speculative sampling
# ---------------------------------------------------------------------------

def _categorical(probs: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of ``probs`` (N, V); int32 (N,)."""
    return torch.multinomial(probs.float(), 1,
                             generator=generator)[:, 0].int()


def _accept_resample(p: torch.Tensor, q: torch.Tensor,
                     draft_toks: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     greedy: bool = False):
    """The Leviathan accept/resample rule over a batch (JAX
    runtime/speculative.py:159-196).

    p (B, G+1, V) target probabilities after each verify row; q (B, G, V)
    the draft's proposal distributions; draft_toks (B, G) drawn from q.
    x_j is accepted with probability min(1, p_j(x_j) / q_j(x_j)); at the
    first rejection a draw of norm(max(p_j - q_j, 0)) is emitted; when
    all G are accepted, a bonus draw of p_G. The emitted prefix is
    distributed exactly as the target's. Greedy: accept while the draft
    equals the target's argmax; the correction is that argmax.
    Returns (n_accept (B,) int32, extra token (B,) int32)."""
    b, g, _ = q.shape
    idx = draft_toks.long()[..., None]
    px = torch.gather(p[:, :g], 2, idx)[..., 0]
    qx = torch.gather(q, 2, idx)[..., 0]
    if greedy:
        acc = draft_toks.long() == p[:, :g].argmax(-1)
    else:
        u = torch.rand((b, g), generator=generator, device=p.device)
        acc = u * qx < px                    # u < p/q without the divide
    n = torch.cumprod(acc.int(), dim=-1).sum(-1).int()          # (B,)
    rows = torch.arange(b, device=p.device)
    p_n = p[rows, n.long()]                                       # (B, V)
    if greedy:
        return n, p_n.argmax(-1).int()
    q_n = q[rows, torch.clamp(n, max=g - 1).long()]
    q_n = torch.where((n < g)[:, None], q_n, 0.0)   # all accepted: p_G
    resid = torch.clamp(p_n - q_n, min=0.0)
    s = resid.sum(-1, keepdim=True)
    resid = torch.where(s > 1e-9, resid / torch.clamp(s, min=1e-9), p_n)
    return n, _categorical(resid, generator)


def speculative_generate_batched(
    target_params: Dict, target_cfg: ModelConfig,
    draft_params: Dict, draft_cfg: ModelConfig,
    prompts: Sequence[Sequence[int]], max_new_tokens: int, gamma: int = 4,
    temperature: float = 1.0, eos_token_id: Optional[int] = None,
    max_seq_len: int = 2048, seed: int = 0, device: DeviceLike = "cuda",
):
    """Speculative sampling over a batch of prompts.

    temperature <= 0 is greedy (argmax accept; the output equals
    target-only greedy decoding); otherwise the tokens are distributed as
    temperature sampling from the target alone. Returns (token lists
    including the prompts, SpecStats).

    The catch-up row re-feeds out[-2] to the draft: after a round that
    accepted every draft, the bonus token's predecessor was never fed to
    the draft, so its KV slot is a hole; re-feeding is idempotent for a
    slot already written (causal KV depends only on earlier positions)."""
    assert target_cfg.vocab_size == draft_cfg.vocab_size
    _check_rewindable(target_cfg, draft_cfg)
    dev = resolve_device(device)
    b, g = len(prompts), gamma
    greedy = temperature <= 0.0
    n0s = [len(p) for p in prompts]
    max_prompt = max(n0s)
    assert max_prompt + max_new_tokens + g + 1 <= max_seq_len, \
        "need gamma+1 slack below max_seq_len for the verify window"
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    t_cache = mcommon.init_kv_cache(target_cfg, b, max_seq_len, device=dev)
    d_cache = mcommon.init_kv_cache(draft_cfg, b, max_seq_len, device=dev)
    toks = np.zeros((b, max_prompt), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    toks_t = torch.as_tensor(toks, device=dev)
    lens = torch.as_tensor(np.asarray(n0s, np.int32), device=dev)
    pos0 = torch.arange(max_prompt, dtype=torch.int32,
                        device=dev)[None].expand(b, max_prompt)

    def warp(logits):
        return logits if greedy else \
            logits.float() / max(temperature, 1e-4)

    def pick(logits):
        if greedy:
            return logits.argmax(-1).int()
        return _categorical(torch.softmax(warp(logits), -1), gen)

    # prefill: the target's head on each lane's last prompt position only
    last, _ = mcommon.forward(target_params, target_cfg, toks_t, pos0,
                              t_cache, lens, last_pos=lens - 1)
    first = pick(last[:, 0])
    mcommon.forward(draft_params, draft_cfg, toks_t, pos0, d_cache, lens,
                    last_pos=torch.zeros_like(lens))

    def draft(win, base):
        """win (B, 2) = [out[-2], out[-1]] at base-2, base-1; returns the
        gamma proposals (B, G) and their distributions (B, G, V)."""
        pos2 = torch.stack([base - 2, base - 1], dim=1)
        logits, _ = mcommon.forward(draft_params, draft_cfg, win, pos2,
                                    d_cache, base)
        tok = pick(logits[:, 1])
        props, qs = [tok], [torch.softmax(warp(logits[:, 1]), -1)]
        for j in range(1, g):
            lg, _ = mcommon.forward(draft_params, draft_cfg, tok[:, None],
                                    (base - 1 + j)[:, None], d_cache,
                                    base + j)
            tok = pick(lg[:, 0])
            props.append(tok)
            qs.append(torch.softmax(warp(lg[:, 0]), -1))
        return torch.stack(props, 1), torch.stack(qs, 1)

    def verify(last_tok, props, q_probs, base):
        vin = torch.cat([last_tok[:, None], props], dim=1)
        pos = base[:, None] - 1 + torch.arange(g + 1, dtype=torch.int32,
                                               device=dev)[None]
        logits, _ = mcommon.forward(target_params, target_cfg, vin, pos,
                                    t_cache, base + g)
        p = torch.softmax(warp(logits), -1)
        return _accept_resample(p, q_probs, props, gen, greedy=greedy)

    out = [list(p) for p in prompts]
    (first_np,) = read_back(first)
    done = np.zeros((b,), bool)
    for i in range(b):
        out[i].append(int(first_np[i]))
        if eos_token_id is not None and out[i][-1] == eos_token_id:
            done[i] = True
    stats = SpecStats()

    while True:
        active = [i for i in range(b)
                  if not done[i] and len(out[i]) - n0s[i] < max_new_tokens]
        if not active:
            break
        base = torch.as_tensor(np.asarray([len(o) for o in out], np.int32),
                               device=dev)
        win = torch.as_tensor(np.asarray([[o[-2], o[-1]] for o in out],
                                         np.int32), device=dev)
        props, q_probs = draft(win, base)
        n, extra = verify(win[:, 1], props, q_probs, base)
        draft_np, n_np, extra_np = read_back(props, n, extra)
        for i in active:
            room = max_new_tokens - (len(out[i]) - n0s[i])
            new = list(draft_np[i, :n_np[i]]) + [int(extra_np[i])]
            stats.proposed += g
            stats.accepted += int(n_np[i])
            for t in new[:room]:
                out[i].append(int(t))
                if eos_token_id is not None and t == eos_token_id:
                    done[i] = True
                    break

    for i in range(b):
        gen_i = out[i][n0s[i]:]
        if eos_token_id is not None and eos_token_id in gen_i:
            out[i] = out[i][: n0s[i] + gen_i.index(eos_token_id) + 1]
    return out, stats
