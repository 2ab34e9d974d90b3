"""GenerationSession: static-batch generation over the dense KV cache.
Counterpart of runtime/session.py.

A batch of prompts is padded to a length bucket and prefilled in one
``models.common.forward`` call with ``full_prefill`` (on the card, K14 for
MHA models at buckets of 128 tokens and more), then decoded one token a
step over the dense cache, which is updated in place. PyTorch runs eagerly,
so the buckets only bound the padding here (JAX compiles once per bucket).

The session runs on the card unless ``device="cpu"`` is asked for, where
every kernel takes its plain version. ``num_beams > 1`` runs paged beam
search (runtime/beam.py: host-paced steps, block sharing across beams)
through a BeamEngine the session keeps for its params.

The recurrent-state models (models/mamba.py, models/recurrentgemma.py)
run through the same calls: ``init_kv_cache`` gives their state, which
each forward updates in place (pads leave it untouched). Beam search
refuses them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import common as mcommon
from ..models.common import ModelConfig
from .sampler import SamplingConfig, pack_bad_words, sample


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"sequence length {n} exceeds max bucket {buckets[-1]}")


@dataclasses.dataclass
class GenerationOutput:
    sequences: List[List[int]]          # prompt + generated, per sequence
    num_prompt_tokens: List[int]
    num_generated: List[int]
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    # per-sequence log-softmax of each emitted token
    logprobs: Optional[List[List[float]]] = None
    # prompt-position logits, (prompt_len, vocab) f32 tensors, on request
    context_logits: Optional[list] = None

    @property
    def decode_tokens_per_s(self) -> float:
        n = sum(self.num_generated)
        return n / self.decode_time_s if self.decode_time_s > 0 else 0.0


class GenerationSession:
    """Static-batch generation: prompts padded to a length bucket (powers
    of two up to ``max_seq_len``, which is always a bucket), one prefill
    forward, then one decode forward a token."""

    HISTORY_WINDOW = 64   # repetition-penalty and bad-word lookback

    def __init__(self, params, cfg: ModelConfig, max_seq_len: int = 2048,
                 prefill_buckets: Optional[Sequence[int]] = None,
                 use_flash_prefill: bool = True,
                 device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_seq_len = max_seq_len
        self.use_flash_prefill = use_flash_prefill
        buckets = tuple(
            b for b in (prefill_buckets or
                        (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192))
            if b <= max_seq_len)
        if not buckets or buckets[-1] < max_seq_len:
            buckets = buckets + (max_seq_len,)   # prompts up to the cap fit
        self.prefill_buckets = buckets
        self._beams = None        # the BeamEngine of generate(num_beams>1)
        self._beam_procs = None   # (ids, (name, fn) pairs, the callables)

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prefill(self, tokens: torch.Tensor, cache: mcommon.KVCache,
                 lens: torch.Tensor, full_logits: bool):
        """-> (each lane's logits at its last prompt position (B, V), the
        whole (B, S, V) logits or None)."""
        b, s = tokens.shape
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None].expand(b, s)
        last = (lens - 1).long()
        logits, _ = mcommon.forward(
            self.params, self.cfg, tokens, pos, cache, lens,
            full_prefill=self.use_flash_prefill,
            last_pos=None if full_logits else last)
        if full_logits:
            return logits[torch.arange(b, device=self.device), last], logits
        return logits[:, 0], None

    def generate(self, prompts: Sequence[Sequence[int]], max_new_tokens: int,
                 sampling: SamplingConfig = SamplingConfig(),
                 eos_token_id: Optional[int] = None,
                 min_new_tokens: int = 0,
                 stop_sequences: Optional[Sequence[Sequence[int]]] = None,
                 num_beams: int = 1, length_penalty: float = 1.0,
                 bad_words: Optional[Sequence[Sequence[int]]] = None,
                 logits_processors: Sequence = (),
                 return_context_logits: bool = False,
                 seed: int = 0) -> GenerationOutput:
        """Generate completions for a batch of token-id prompts.

        min_new_tokens bans eos until that many tokens exist;
        stop_sequences are token-id suffixes that end a sequence; bad_words
        are token-id sequences that may never be generated; logits
        processors are torch callables ``(logits (B, V), history (B, W))
        -> logits`` run on the raw logits before sampling (history
        right-aligned, -1 padded); return_context_logits returns each
        prompt's (prompt_len, V) logits. Draws come from a
        ``torch.Generator`` seeded with ``seed``.

        num_beams > 1 switches to deterministic beam search over the paged
        pool with block sharing across beams (``_generate_beams``); the
        controls and processors apply inside the beam step, ``sampling``,
        ``seed`` and ``return_context_logits`` do not."""
        if num_beams > 1:
            if self.cfg.arch in mcommon.RECURRENT_ARCHS:
                # beam search runs over the paged pool, which has nothing
                # to page for a recurrent state (the JAX package's paged
                # forward refuses it)
                raise NotImplementedError(
                    f"{self.cfg.arch} carries recurrent state: beam search "
                    "(num_beams > 1) runs on the paged path, which it does "
                    "not take")
            return self._generate_beams(
                prompts, max_new_tokens, num_beams, length_penalty,
                eos_token_id, min_new_tokens, stop_sequences, bad_words,
                logits_processors)
        dev = self.device
        b = len(prompts)
        lens_list = [len(p) for p in prompts]
        max_prompt = max(lens_list)
        if max_prompt + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"prompt ({max_prompt}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds max_seq_len ({self.max_seq_len})")
        bucket = _bucket(max_prompt, self.prefill_buckets)

        tokens = np.zeros((b, bucket), np.int32)
        for i, p in enumerate(prompts):
            tokens[i, :len(p)] = p
        lens = self._t(np.asarray(lens_list, np.int32))
        cache = mcommon.init_kv_cache(self.cfg, b, self.max_seq_len,
                                      device=dev)

        w = self.HISTORY_WINDOW
        history = np.full((b, w), -1, np.int64)
        for i, p in enumerate(prompts):
            tail = list(p)[-w:]
            history[i, w - len(tail):] = tail   # right-aligned, like decode
        eos_tok = torch.tensor(eos_token_id if eos_token_id is not None
                               else -1, device=dev)
        bw = pack_bad_words(bad_words, device=dev) if bad_words else None
        procs = tuple(logits_processors)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)

        def step_sample(logits, ban: int):
            tok = sample(logits, gen, sampling, history=self._t(history),
                         suppress_token=eos_tok,
                         suppress_flag=torch.tensor(ban, device=dev),
                         bad_words=bw, processors=procs)
            lp = torch.log_softmax(logits, dim=-1).gather(
                1, tok[:, None])[:, 0]
            return tok, lp

        self._sync()
        t0 = time.perf_counter()
        # the range closes after the synchronize, so a profile can tell
        # every kernel the prefill queued from decode's
        with torch.profiler.record_function("phase::prefill"):
            last_logits, ctx_logits = self._prefill(
                self._t(tokens), cache, lens, return_context_logits)
            cur, lp0 = step_sample(last_logits,
                                   1 if min_new_tokens > 1 else 0)
            self._sync()
        t1 = time.perf_counter()

        def push_history(tok_np):
            history[:, :-1] = history[:, 1:]
            history[:, -1] = tok_np

        generated = np.zeros((b, max_new_tokens), np.int64)
        logprobs = np.zeros((b, max_new_tokens), np.float32)
        generated[:, 0] = cur.cpu().numpy()
        logprobs[:, 0] = lp0.cpu().numpy()
        push_history(generated[:, 0])
        finished = np.zeros((b,), bool)

        def update_finished(step):
            if eos_token_id is not None and step + 1 > min_new_tokens:
                finished[generated[:, step] == eos_token_id] = True
            if stop_sequences:
                for i in range(b):
                    if finished[i]:
                        continue
                    gen_i = generated[i, :step + 1].tolist()
                    for ss in stop_sequences:
                        if len(gen_i) >= len(ss) and \
                                gen_i[-len(ss):] == list(ss):
                            finished[i] = True
                            break

        update_finished(0)
        cur_lens = lens
        steps = 1
        for step in range(1, max_new_tokens):
            if finished.all():
                break
            logits, _ = mcommon.forward(
                self.params, self.cfg, cur[:, None], cur_lens[:, None],
                cache, cur_lens + 1)
            cur, lp = step_sample(logits[:, 0],
                                  1 if step + 1 <= min_new_tokens else 0)
            cur_lens = cur_lens + 1
            generated[:, step] = cur.cpu().numpy()
            logprobs[:, step] = lp.cpu().numpy()
            push_history(generated[:, step])
            update_finished(step)
            steps += 1
        self._sync()
        t2 = time.perf_counter()

        sequences, n_gen, lps = [], [], []
        for i, p in enumerate(prompts):
            gen_i = generated[i, :steps].tolist()
            if eos_token_id is not None and eos_token_id in gen_i:
                gen_i = gen_i[:gen_i.index(eos_token_id) + 1]
            if stop_sequences:
                for ss in stop_sequences:
                    ls = list(ss)
                    for end in range(len(ls), len(gen_i) + 1):
                        if gen_i[end - len(ls):end] == ls:
                            gen_i = gen_i[:end]
                            break
                    else:
                        continue
                    break
            sequences.append(list(p) + gen_i)
            n_gen.append(len(gen_i))
            lps.append(logprobs[i, :len(gen_i)].tolist())
        ctx = None
        if return_context_logits:
            ctx = [ctx_logits[i, :lens_list[i]] for i in range(b)]
        return GenerationOutput(sequences, lens_list, n_gen,
                                prefill_time_s=t1 - t0,
                                decode_time_s=t2 - t1, logprobs=lps,
                                context_logits=ctx)

    def _generate_beams(self, prompts, max_new_tokens: int, num_beams: int,
                        length_penalty: float, eos_token_id, min_new_tokens,
                        stop_sequences, bad_words,
                        logits_processors) -> GenerationOutput:
        """runtime.beam.paged_beam_search over the session's BeamEngine
        (the pool kept between calls), one step a call. The same processor
        callables across calls keep the same (name, fn) pairs, so the
        memoized beam programs are reused."""
        from .beam import BeamEngine, paged_beam_search
        if self._beams is None or self._beams.params is not self.params \
                or self._beams.cfg != self.cfg:
            self._beams = BeamEngine(self.params, self.cfg, self.device)
        b = len(prompts)
        pkey = tuple(id(f) for f in logits_processors)
        if self._beam_procs is None or self._beam_procs[0] != pkey:
            self._beam_procs = (pkey, tuple(
                (f"p{i}", f) for i, f in enumerate(logits_processors)),
                list(logits_processors))
        procs = self._beam_procs[1]
        res = paged_beam_search(
            self.params, self.cfg, [list(p) for p in prompts],
            max_new_tokens, num_beams=num_beams,
            length_penalty=length_penalty, eos_token_id=eos_token_id,
            max_seq_len=self.max_seq_len,
            min_new_tokens=[min_new_tokens] * b,
            bad_words=[bad_words] * b, stop_sequences=[stop_sequences] * b,
            logits_processors=procs,
            proc_masks=np.ones((b, len(procs)), bool) if procs else None,
            engine=self._beams)
        return GenerationOutput(
            sequences=res.sequences,
            num_prompt_tokens=[len(p) for p in prompts],
            num_generated=[len(s) - len(p)
                           for s, p in zip(res.sequences, prompts)])

    def score_logits(self, tokens: np.ndarray,
                     lens: np.ndarray) -> torch.Tensor:
        """Full-sequence logits (B, S, V) f32 for PPL evaluation; tokens
        (B, S) padded, lens (B,). Masked attention over the cache (no
        full_prefill), as the JAX package's."""
        b, s = tokens.shape
        cache = mcommon.init_kv_cache(self.cfg, b, s, device=self.device)
        pos = torch.arange(s, dtype=torch.int32,
                           device=self.device)[None].expand(b, s)
        logits, _ = mcommon.forward(
            self.params, self.cfg, self._t(np.asarray(tokens, np.int32)), pos,
            cache, self._t(np.asarray(lens, np.int32)))
        return logits
