"""Perplexity evaluation (WikiText-2 style block PPL).
Counterpart of mixq_tensorrt_llm_tpu/eval/ppl.py.

The token stream is cut into fixed-length blocks, scored with teacher
forcing in batches through the dense forward; PPL = exp(total_nll /
total_tokens). The reference's headline workload (32 blocks x 512 tokens
at batch 8). The JAX package pads a short last batch with zero rows and
subtracts their score (its jit needs one shape); here the short batch is
scored at its own size, which gives the same total.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..models import common as mcommon
from ..models.common import ModelConfig


@dataclasses.dataclass
class PPLResult:
    ppl: float
    total_tokens: int
    total_nll: float
    blocks: int
    elapsed_s: float

    @property
    def blocks_per_s(self) -> float:
        return self.blocks / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / self.elapsed_s if self.elapsed_s else 0.0


def block_nll(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
              full_prefill: bool = True) -> torch.Tensor:
    """tokens (B, S) on the params' device -> the teacher-forced summed NLL
    over positions 1..S-1 (an f32 scalar, left on the device)."""
    b, s = tokens.shape
    dev = tokens.device
    cache = mcommon.init_kv_cache(cfg, b, s, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    lens = torch.full((b,), s, dtype=torch.int32, device=dev)
    logits, _ = mcommon.forward(params, cfg, tokens, pos, cache, lens,
                                full_prefill=full_prefill)
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    tgt = tokens[:, 1:].long()
    return -torch.gather(logp, -1, tgt[..., None])[..., 0].sum()


def evaluate_ppl(params: Dict, cfg: ModelConfig, token_stream: Sequence[int],
                 seq_len: int = 512, batch_size: int = 8,
                 max_blocks: Optional[int] = None,
                 full_prefill: bool = True) -> PPLResult:
    """Block perplexity over a flat token stream, on the params' device.

    full_prefill=True attends over the fresh K/V (K14 on the card for MHA);
    full_prefill=False attends through the dense KV cache, the only way the
    KV-cache quantization error reaches the score (use it to gate int8 KV,
    as the reference's int8-KV ppl runs read the quantized cache)."""
    toks = np.asarray(token_stream, np.int32)
    n_blocks = len(toks) // seq_len
    if max_blocks:
        n_blocks = min(n_blocks, max_blocks)
    if n_blocks <= 0:
        raise ValueError("token stream shorter than one block")
    blocks = torch.from_numpy(toks[: n_blocks * seq_len].reshape(
        n_blocks, seq_len)).to(params["embed"]["w"].device)

    t0 = time.perf_counter()
    nlls = [block_nll(params, cfg, blocks[i: i + batch_size], full_prefill)
            for i in range(0, n_blocks, batch_size)]
    total_nll = float(sum(float(x) for x in nlls))
    elapsed = time.perf_counter() - t0

    total_tokens = n_blocks * (seq_len - 1)
    return PPLResult(ppl=float(np.exp(total_nll / total_tokens)),
                     total_tokens=total_tokens, total_nll=total_nll,
                     blocks=n_blocks, elapsed_s=elapsed)


def tokenize_corpus(texts: Iterable[str], tokenizer) -> List[int]:
    """Concatenate texts into one token stream (the wikitext2 convention:
    '\n\n'.join of the raw rows)."""
    joined = "\n\n".join(texts)
    return tokenizer(joined, add_special_tokens=False)["input_ids"]
