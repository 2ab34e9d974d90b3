"""Token sampling: greedy / temperature / top-k / top-p with repetition
penalty, bad words, logits processors and a suppressed token. Counterpart
of runtime/sampler.py: the static ``sample`` (one SamplingConfig for the
batch, the GenerationSession's), ``apply_repetition_penalty``,
``pack_bad_words``, ``ban_bad_words``, and the per-lane SamplingParams,
batch_params and sample_batched (the Executor's).

Greedy lanes take ``torch.argmax``, which returns the first maximum like
``jnp.argmax``. Stochastic draws come from an explicit ``torch.Generator``
on the logits' device; the bits differ from JAX's for the same seed. As in
the JAX package, ``sample_batched`` computes the greedy and the sampled
token of every lane and picks per lane: it reads nothing back from the
device, so the Executor's captured CUDA graphs run it as they run the
model.
Logits processors are torch callables ``(logits (B, V), history (B, W))
-> logits``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 1.0
    top_k: int = 0               # 0 = disabled
    top_p: float = 1.0           # 1.0 = disabled
    greedy: bool = True
    repetition_penalty: float = 1.0   # > 1 discourages repeats (HF)

    @property
    def is_greedy(self) -> bool:
        return self.greedy or self.temperature == 0.0


class SamplingParams(NamedTuple):
    """Per-lane sampling parameters as (B,) tensors."""

    temperature: torch.Tensor        # f32
    top_k: torch.Tensor              # i64, 0 = off
    top_p: torch.Tensor              # f32, 1.0 = off
    greedy: torch.Tensor             # bool
    repetition_penalty: torch.Tensor  # f32, 1.0 = off


def batch_params(configs, device="cpu") -> SamplingParams:
    """List of SamplingConfig (None = defaults) -> SamplingParams."""
    cs = [c if c is not None else SamplingConfig() for c in configs]

    def t(vals, dtype):
        return torch.as_tensor(np.array(vals), dtype=dtype, device=device)

    return SamplingParams(
        temperature=t([c.temperature for c in cs], torch.float32),
        top_k=t([c.top_k for c in cs], torch.int64),
        top_p=t([c.top_p for c in cs], torch.float32),
        greedy=t([c.is_greedy for c in cs], torch.bool),
        repetition_penalty=t([c.repetition_penalty for c in cs],
                             torch.float32))


def _seen(history: torch.Tensor, b: int, v: int) -> torch.Tensor:
    """(B, V) bool: the token ids in history (B, W), -1 padded."""
    idx = torch.where(history < 0, v, history).long()
    seen = torch.zeros((b, v + 1), dtype=torch.bool, device=history.device)
    seen.scatter_(1, idx, True)
    return seen[:, :v]


def _apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                              penalty: torch.Tensor) -> torch.Tensor:
    """history (B, W) int, -1 padded; penalty (B,). Seen tokens' positive
    logits are divided by the penalty, negative ones multiplied."""
    seen = _seen(history, *logits.shape)
    pen = penalty[:, None]
    penalized = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen & (pen != 1.0), penalized, logits)


def apply_repetition_penalty(logits: torch.Tensor, history: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """HF-style penalty over a token-history window (B, W), -1 padded, one
    ``penalty`` for the batch."""
    pen = torch.full((logits.shape[0],), penalty, dtype=torch.float32,
                     device=logits.device)
    return _apply_repetition_penalty(logits, history, pen)


BW_PAD = -2   # bad-words pad: never equals a token id or the -1 history pad


def pack_bad_words(bad_words, device="cpu") -> torch.Tensor:
    """List of token-id sequences -> (N, L) int64, RIGHT-aligned, BW_PAD
    padded, L >= 2, as the JAX package packs them."""
    words = [list(w) for w in (bad_words or [])]
    width = max([len(w) for w in words] + [2])
    out = np.full((len(words), width), BW_PAD, np.int64)
    for i, w in enumerate(words):
        if not w:
            raise ValueError("empty bad word")
        out[i, width - len(w):] = w
    return torch.from_numpy(out).to(device)


def ban_bad_words(logits: torch.Tensor, history: torch.Tensor,
                  bad_words: torch.Tensor) -> torch.Tensor:
    """Mask the final token of every bad word whose prefix matches the tail
    of the history. logits (B, V); history (B, W) right-aligned, -1 padded;
    bad_words (N, L) shared or (B, N, L) per lane, as pack_bad_words makes
    them. Single-token words are always banned; a row whose last slot is
    BW_PAD is unused."""
    if bad_words.dim() == 2:
        bad_words = bad_words[None]
    b, v = logits.shape
    n, width = bad_words.shape[1], bad_words.shape[2]
    if n == 0:
        return logits
    w = history.shape[1]
    if width - 1 > w:
        raise ValueError("history window shorter than a bad word's prefix")
    tail = history[:, w - (width - 1):].long()          # (B, L-1)
    prefix = bad_words[:, :, :-1]                       # (B|1, N, L-1)
    ok = (prefix == BW_PAD) | (tail[:, None, :] == prefix)
    match = ok.all(dim=-1) & (bad_words[:, :, -1] != BW_PAD)   # (B, N)
    last = bad_words[:, :, -1].clamp(0, v - 1)          # (B|1, N)
    onehot = torch.nn.functional.one_hot(last, v).bool()  # (B|1, N, V)
    ban = (match[..., None] & onehot).any(dim=1)         # (B, V)
    return torch.where(ban, -torch.inf, logits)


def sample(logits: torch.Tensor, generator: torch.Generator,
           config: SamplingConfig, history: Optional[torch.Tensor] = None,
           suppress_token: Optional[torch.Tensor] = None,
           suppress_flag: Optional[torch.Tensor] = None,
           bad_words: Optional[torch.Tensor] = None,
           processors: tuple = ()) -> torch.Tensor:
    """logits (B, V) f32 -> token ids (B,) int64, one config for the batch:
    ``sample_batched`` with every lane given ``config``. suppress_token and
    suppress_flag are scalar tensors; bad_words is packed (N, L)."""
    b = logits.shape[0]
    if suppress_token is not None:
        suppress_token = suppress_token.expand(b)
        suppress_flag = suppress_flag.expand(b)
    return sample_batched(logits, generator,
                          batch_params([config] * b, logits.device), history,
                          suppress_token, suppress_flag, bad_words,
                          processors)


def sample_batched(logits: torch.Tensor, generator: torch.Generator,
                   params: SamplingParams,
                   history: Optional[torch.Tensor] = None,
                   suppress_token: Optional[torch.Tensor] = None,
                   suppress_flag: Optional[torch.Tensor] = None,
                   bad_words: Optional[torch.Tensor] = None,
                   processors: tuple = ()) -> torch.Tensor:
    """logits (B, V) f32 -> tokens (B,) int64, every parameter per lane.

    history: optional (B, W) recent tokens (repetition penalty, bad words,
    processors); suppress_token/suppress_flag (B,): the token's logit goes
    to -inf where the flag is not 0 (the min_new_tokens eos ban);
    bad_words: packed (N, L) shared or (B, N, L) per lane; processors run
    on the raw logits first."""
    b, v = logits.shape
    for f in processors:
        logits = f(logits, history)
    if history is not None:
        logits = _apply_repetition_penalty(logits, history,
                                           params.repetition_penalty)
    if bad_words is not None and bad_words.shape[-2] > 0:
        logits = ban_bad_words(logits, history, bad_words)
    if suppress_token is not None:
        hit = torch.arange(v, device=logits.device)[None, :] == \
            suppress_token[:, None]
        logits = torch.where(hit & (suppress_flag[:, None] != 0),
                             -torch.inf, logits)
    greedy_tok = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(params.temperature, min=1e-6)[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    top_k = params.top_k[:, None]
    kth = torch.gather(sorted_desc, 1, torch.clamp(top_k - 1, 0, v - 1))
    scaled = torch.where((top_k > 0) & (scaled < kth), -torch.inf, scaled)
    # top-p runs after top-k on the surviving distribution
    rank = torch.arange(v, device=logits.device)[None, :]
    sorted_masked = torch.where((top_k > 0) & (rank >= top_k), -torch.inf,
                                sorted_desc)
    cum = torch.cumsum(torch.softmax(sorted_masked, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < params.top_p[:, None], dim=-1)
    cutoff = torch.gather(sorted_masked, 1,
                          torch.clamp(cutoff_idx, 0, v - 1)[:, None])
    scaled = torch.where((params.top_p[:, None] < 1.0) & (scaled < cutoff),
                         -torch.inf, scaled)
    # torch.multinomial's one-sample draw, written out: argmax of p / q
    # with q ~ Exp(1) from the same generator gives its tokens bit for bit,
    # without its validity checks, which read the device
    probs = torch.softmax(scaled, dim=-1)
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    sampled = torch.argmax(probs / q, dim=-1)
    return torch.where(params.greedy, greedy_tok, sampled)
