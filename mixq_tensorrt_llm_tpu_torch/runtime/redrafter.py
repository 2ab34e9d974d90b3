"""ReDrafter decoding: recurrent drafter beams verified in one forward.
Counterpart of runtime/redrafter.py.

A drafter (input projection, silu ResBlocks, a vocab head; optionally an
RNN over the token embeddings) beam-searches ``num_beams`` candidate
continuations of ``draft_len`` tokens from the base model's last hidden
state. One verify forward then runs the whole beam block, [true token |
beam 0 | ... | beam K-1], 1 + K * draft_len rows, under a static mask
(each candidate sees the history, the true token and its own beam's
prefix) with the candidates' true positions for RoPE. Acceptance is the
greedy walk per beam (the longest prefix matching the target's argmax
chain), so the output equals plain greedy decoding whatever the drafter
proposes. The accepted rows' KV is compacted to consecutive slots
(``medusa.compact``).

On the card the verify's 17 rows (4 beams x 4) take the mixed path
(K1 -> K2), the prefill K14; the drafter and the masked dense attention
are plain torch, as in the JAX package. ReDrafter is greedy only, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models.common import ModelConfig
from .beam import _top_k
from .medusa import _hf_tensor, ancestor_mask, compact, prefill, tree_verify
from .scheduler import read_back


def init_random_drafter(cfg: ModelConfig, generator: torch.Generator,
                        exit_dim: int = 0, num_layers: int = 1,
                        is_rnn: bool = True,
                        device: DeviceLike = "cuda") -> Dict:
    """A random drafter with the reference's parameters (input 2H ->
    exit_dim ResBlocks -> vocab head; rnn_w without a bias, rnn_u with
    one), f32, drawn from ``generator`` (a CPU generator)."""
    dev = resolve_device(device)
    h, v = cfg.hidden_size, cfg.vocab_size
    exit_dim = exit_dim or 2 * h

    def randn(*shape):
        return (torch.randn(shape, generator=generator) * 0.02).to(dev)

    def zeros(*shape):
        return torch.zeros(shape, device=dev)

    p: Dict = {"blocks": {"w": randn(num_layers, exit_dim, exit_dim),
                          "b": zeros(num_layers, exit_dim)},
               "lm_head": {"w": randn(exit_dim, v)}}
    if exit_dim != 2 * h:
        p["input_proj"] = {"w": randn(2 * h, exit_dim), "b": zeros(exit_dim)}
    if is_rnn:
        p["rnn_w"] = {"w": randn(h, h)}
        p["rnn_u"] = {"w": randn(h, h), "b": zeros(h)}
    return p


def drafter_from_hf(sd, device: DeviceLike = "cuda") -> Dict:
    """A ReDrafter checkpoint's state dict -> drafter (the reference's
    names: input_proj, layers.{i}.linear, lm_head, rnn_u / rnn_w, under
    ``drafter.`` or bare)."""
    dev = resolve_device(device)
    pre = ("drafter.", "")

    def get(key, transpose=False):
        x = _hf_tensor(sd, key, pre)
        return (x.T if transpose else x).to(dev)

    def has(key):
        return any(p + key in sd for p in pre)

    n = 0
    while has(f"layers.{n}.linear.weight"):
        n += 1
    out: Dict = {
        "blocks": {
            "w": torch.stack([get(f"layers.{l}.linear.weight", True)
                              for l in range(n)]),
            "b": torch.stack([get(f"layers.{l}.linear.bias")
                              for l in range(n)])},
        "lm_head": {"w": get("lm_head.weight", True)}}
    if has("input_proj.weight"):
        out["input_proj"] = {"w": get("input_proj.weight", True),
                             "b": get("input_proj.bias")}
    if has("rnn_w.weight"):
        out["rnn_w"] = {"w": get("rnn_w.weight", True)}
        out["rnn_u"] = {"w": get("rnn_u.weight", True),
                        "b": get("rnn_u.bias")}
    return out


def drafter_logits(drafter: Dict, x2h: torch.Tensor) -> torch.Tensor:
    """x2h (..., 2H) = [base hidden | token embedding] -> (..., V) f32."""
    x = x2h.float()
    if "input_proj" in drafter:
        x = x @ drafter["input_proj"]["w"].float() + drafter["input_proj"]["b"]
    bw = drafter["blocks"]["w"].float()
    bb = drafter["blocks"]["b"].float()
    for l in range(bw.shape[0]):
        x = x + torch.nn.functional.silu(x @ bw[l] + bb[l])
    return x @ drafter["lm_head"]["w"].float()


def beam_search_draft(drafter: Dict, embed_w: torch.Tensor,
                      hidden: torch.Tensor, init_token: int, num_beams: int,
                      candidate_length: int) -> torch.Tensor:
    """The reference's _beam_search_candidates. hidden (H,) is the base
    model's hidden at the true token ``init_token``. A non-RNN drafter sums
    the token embeddings; an RNN drafter runs e_t = rnn_w(emb) +
    rnn_u(e_{t-1}). Among equal scores the lower index comes first, as in
    jax.lax.top_k. Returns (num_beams, candidate_length) int32 draft
    tokens, the true token excluded."""
    dev = hidden.device
    h = hidden.float()
    k, v = num_beams, embed_w.shape[0]
    is_rnn = "rnn_w" in drafter
    scores = torch.tensor([0.0] + [-5e4] * (k - 1), device=dev)
    last = torch.full((k,), int(init_token), dtype=torch.long, device=dev)
    prev_emb = torch.zeros((k, h.shape[-1]), device=dev)
    tokens = torch.zeros((k, candidate_length), dtype=torch.int32,
                         device=dev)
    for i in range(candidate_length):
        cur = embed_w[last].float()                          # (K, H)
        if is_rnn:
            e = cur @ drafter["rnn_w"]["w"].float()
            if i > 0:
                e = e + prev_emb @ drafter["rnn_u"]["w"].float() \
                    + drafter["rnn_u"]["b"]
            prev_emb = e
        else:
            prev_emb = cur + prev_emb
        x2h = torch.cat([h.expand(k, -1), prev_emb], dim=-1)
        lp = torch.log_softmax(drafter_logits(drafter, x2h), dim=-1)
        scores, idx = _top_k((lp + scores[:, None]).reshape(k * v), k)
        beam_src = idx // v
        new_tok = idx % v
        tokens = tokens[beam_src]
        tokens[:, i] = new_tok.int()
        prev_emb = prev_emb[beam_src]
        last = new_tok
    return tokens


@dataclass
class ReDrafterStats:
    steps: int = 0
    tokens: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.tokens / max(self.steps, 1)


def redrafter_generate(params: Dict, cfg: ModelConfig,
                       drafter: Optional[Dict],
                       prompt: Sequence[int], max_new_tokens: int,
                       num_beams: int = 4, draft_len: int = 4,
                       max_seq_len: int = 0,
                       draft_fn: Optional[Callable] = None,
                       device: DeviceLike = "cuda"
                       ) -> Tuple[List[int], ReDrafterStats]:
    """Greedy ReDrafter decoding of one sequence.

    draft_fn(hidden (1, H), next_tok, step) -> (num_beams, draft_len)
    replaces the drafter (an oracle in tests). Returns (prompt +
    generated tokens, stats)."""
    dev = resolve_device(device)
    k, lc = num_beams, draft_len
    n = k * lc                              # candidate rows
    s0 = len(prompt)
    smax = max_seq_len or s0 + max_new_tokens + n + 2
    assert smax >= s0 + max_new_tokens + n + 1
    cache = mcommon.init_kv_cache(cfg, 1, smax, device=dev)
    # row 0 the true token; row 1 + b*lc + j beam b's candidate j, which
    # sees its beam's earlier candidates; depth j + 1
    parents_of_row = [[]] + [[1 + bm * lc + i for i in range(j)]
                             for bm in range(k) for j in range(lc)]
    anc = torch.as_tensor(ancestor_mask(parents_of_row), device=dev)
    depths = np.concatenate(
        [[0], np.tile(np.arange(1, lc + 1), k)]).astype(np.int32)

    logits, hidden = prefill(params, cfg, cache, prompt)
    committed: List[int] = list(prompt)
    next_tok = int(read_back(logits.argmax()[None])[0][0])
    t = s0
    stats = ReDrafterStats()

    while len(committed) - s0 < max_new_tokens:
        stats.steps += 1
        # the drafter reads the base model's last pre-final-norm hidden
        if draft_fn is not None:
            beams = np.asarray(draft_fn(hidden, next_tok, stats.steps),
                               np.int32)
        else:
            (beams,) = read_back(beam_search_draft(
                drafter, params["embed"]["w"], hidden[0], next_tok, k, lc))
        rows = np.concatenate([[next_tok], beams.reshape(-1)])[None].astype(
            np.int32)
        logits, hidden_all = tree_verify(params, cfg, cache, rows, depths,
                                         anc, t)
        (lg,) = read_back(logits[0].argmax(-1))

        # greedy acceptance: the longest beam prefix on the argmax chain
        best_m, best_b = 0, 0
        for bm in range(k):
            m, expect = 0, lg[0]
            while m < lc and beams[bm, m] == expect:
                expect = lg[1 + bm * lc + m]
                m += 1
            if m > best_m:
                best_m, best_b = m, bm
        path = [0] + [1 + best_b * lc + j for j in range(best_m)]
        accepted = [next_tok] + [int(beams[best_b, j])
                                 for j in range(best_m)]
        bonus = int(lg[path[-1]])

        room = max_new_tokens - (len(committed) - s0)
        accepted = accepted[:room]
        path = path[:len(accepted)]
        compact(cache, path, t, n + 1)
        committed.extend(accepted)
        stats.tokens += len(accepted)
        t += len(accepted)
        next_tok = bonus
        hidden = hidden_all[:, path[len(accepted) - 1]]

    return committed, stats
