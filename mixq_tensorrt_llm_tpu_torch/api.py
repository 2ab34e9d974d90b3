"""High-level LLM API over a checkpoint directory. Counterpart of api.py.

    llm = LLM("/path/to/checkpoint")            # runs on the CUDA card
    out = llm.generate_tokens([[1, 2, 3]], max_new_tokens=32)

The directory is in the checkpoint format both packages write
(``convert/checkpoint.py``: config.json + model.safetensors). Quantizing a
Hugging Face directory on load, speculative decoding, Medusa, ReDrafter
and perplexity evaluation are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Union

from .device import DeviceLike, resolve_device
from .runtime.sampler import SamplingConfig
from .runtime.session import GenerationOutput, GenerationSession


def _is_our_checkpoint(path: str) -> bool:
    cfg = os.path.join(path, "config.json")
    if not os.path.exists(cfg):
        return False
    with open(cfg) as f:
        d = json.load(f)
    return "quant" in d and "arch" in d


def _try_tokenizer(path: str):
    """A tokenizer saved in ``path``, or None (also when ``transformers``
    is not installed). Local files only."""
    try:
        from transformers import AutoTokenizer
        return AutoTokenizer.from_pretrained(path, local_files_only=True)
    except Exception:
        return None


@dataclasses.dataclass
class LLM:
    """llm = LLM("/path/to/checkpoint"); llm.generate(...)"""

    model: str                     # a checkpoint directory
    max_seq_len: int = 2048
    tokenizer: Optional[object] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if not _is_our_checkpoint(self.model):
            # the JAX package quantizes a Hugging Face directory here
            # (_ensure_quantized), with its quant / kv_cache_quant /
            # act_scales_path / cache_dir fields
            raise NotImplementedError(
                f"{self.model} is not a checkpoint directory of this "
                "package; quantizing a Hugging Face model on load "
                "(convert/hf.py) is not ported yet (ROADMAP queue 1)")
        from .convert.checkpoint import load_checkpoint
        self.params, self.cfg = load_checkpoint(self.model,
                                                device=self.device)
        if self.tokenizer is None:
            self.tokenizer = _try_tokenizer(self.model)
        self.session = GenerationSession(self.params, self.cfg,
                                         max_seq_len=self.max_seq_len,
                                         device=self.device)

    # ------------------------------------------------------------------
    def generate(self, prompts: Union[str, Sequence[str]],
                 max_new_tokens: int = 64,
                 sampling: SamplingConfig = SamplingConfig(),
                 bad_words: Optional[Sequence[str]] = None,
                 seed: int = 0) -> Union[str, List[str]]:
        """Text in, text out (needs a tokenizer). bad_words are strings
        that may never be generated (tokenized without special tokens)."""
        if self.tokenizer is None:
            raise ValueError("no tokenizer found; pass tokenizer= or use "
                             "generate_tokens()")
        single = isinstance(prompts, str)
        if single:
            prompts = [prompts]
        token_lists = [self.tokenizer(p)["input_ids"] for p in prompts]
        eos = getattr(self.tokenizer, "eos_token_id", None)
        bw = [self.tokenizer(w, add_special_tokens=False)["input_ids"]
              for w in bad_words] if bad_words else None
        out = self.session.generate(token_lists, max_new_tokens,
                                    sampling=sampling, eos_token_id=eos,
                                    bad_words=bw, seed=seed)
        texts = [self.tokenizer.decode(seq[len(tl):],
                                       skip_special_tokens=True)
                 for seq, tl in zip(out.sequences, token_lists)]
        return texts[0] if single else texts

    def generate_tokens(self, prompts: Sequence[Sequence[int]],
                        max_new_tokens: int = 64,
                        sampling: SamplingConfig = SamplingConfig(),
                        eos_token_id: Optional[int] = None,
                        num_beams: int = 1,
                        bad_words: Optional[Sequence[Sequence[int]]] = None,
                        stop_sequences: Optional[
                            Sequence[Sequence[int]]] = None,
                        logits_processors: Sequence = (),
                        seed: int = 0) -> GenerationOutput:
        """Token ids in, GenerationOutput out (GenerationSession.generate;
        num_beams > 1 runs paged beam search with block sharing across
        beams)."""
        return self.session.generate(list(prompts), max_new_tokens,
                                     sampling=sampling,
                                     eos_token_id=eos_token_id,
                                     num_beams=num_beams,
                                     bad_words=bad_words,
                                     stop_sequences=stop_sequences,
                                     logits_processors=logits_processors,
                                     seed=seed)

    def generate_speculative(self, draft: "LLM",
                             prompts: Sequence[Sequence[int]],
                             max_new_tokens: int = 64, gamma: int = 4,
                             temperature: float = 1.0,
                             eos_token_id: Optional[int] = None,
                             seed: int = 0):
        raise NotImplementedError(
            "batched speculative decoding over the session "
            "(runtime/speculative.py) is not ported yet (ROADMAP queue 1); "
            "the Executor's run_speculative is (make_executor)")

    def make_executor(self, max_batch: int = 8, block_size: int = 64,
                      prefill_chunk: int = 256,
                      sampling: SamplingConfig = SamplingConfig(),
                      seed: int = 0, **kw):
        """Continuous-batching Executor over this model (paged KV) on the
        LLM's device; extra kwargs go to the Executor."""
        from .runtime.scheduler import Executor
        return Executor(self.params, self.cfg, max_batch=max_batch,
                        max_seq_len=self.max_seq_len, block_size=block_size,
                        prefill_chunk=prefill_chunk, sampling=sampling,
                        seed=seed, device=self.device, **kw)
