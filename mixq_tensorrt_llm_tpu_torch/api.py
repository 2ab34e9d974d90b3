"""High-level LLM API: load or quantize, then generate or evaluate.
Counterpart of api.py.

    llm = LLM("/path/to/hf-dir", quant="int8_mix")     # on the CUDA card
    out = llm.generate_tokens([[1, 2, 3]], max_new_tokens=32)

``model`` is a checkpoint directory in the format both packages write
(``convert/checkpoint.py``: config.json + model.safetensors), or a Hugging
Face directory (any dense decoder family, models/registry.py), quantized
on first use into a cache directory keyed by its path and QuantConfig
(``_ensure_quantized``; the default base is ``~/.cache/mixq_tpu_torch``)
and loaded from there after.
Beside generation through the session: speculative sampling with a draft
LLM, Medusa and ReDrafter (runtime/speculative.py, medusa.py,
redrafter.py), all on the LLM's device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional, Sequence, Union

from .device import DeviceLike, resolve_device
from .quant.config import KVCacheQuantAlgo, QuantAlgo, QuantConfig
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
    """llm = LLM("/path/to/hf-or-ckpt", quant="int8_mix"); llm.generate(...)

    quant / kv_cache_quant / act_scales_path apply to a Hugging Face
    directory only (a checkpoint carries its own QuantConfig); no quant
    keeps the float model."""

    model: str
    quant: Union[str, QuantConfig, None] = None
    kv_cache_quant: str = "none"
    max_seq_len: int = 2048
    act_scales_path: Optional[str] = None
    cache_dir: Optional[str] = None
    tokenizer: Optional[object] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if isinstance(self.quant, str):
            self.quant = QuantConfig(
                algo=QuantAlgo(self.quant),
                kv_cache=KVCacheQuantAlgo(self.kv_cache_quant))
        from .convert.checkpoint import load_checkpoint
        if _is_our_checkpoint(self.model):
            ckpt_dir = self.model
        else:
            ckpt_dir = self._ensure_quantized(self.model)
        self.params, self.cfg = load_checkpoint(ckpt_dir, device=self.device)
        self._ckpt_dir = ckpt_dir
        if self.tokenizer is None:
            self.tokenizer = (_try_tokenizer(self.model)
                              or _try_tokenizer(ckpt_dir))
        self.session = GenerationSession(self.params, self.cfg,
                                         max_seq_len=self.max_seq_len,
                                         device=self.device)

    def _ensure_quantized(self, hf_dir: str) -> str:
        """The cache directory of ``hf_dir`` under this QuantConfig (the JAX
        package's key: sha1 of the absolute path and ``quant.to_json()``),
        quantized on this LLM's device when it holds no checkpoint yet."""
        from .convert.hf import quantize_hf_model

        quant = self.quant or QuantConfig()
        key = hashlib.sha1(
            f"{os.path.abspath(hf_dir)}|{quant.to_json()}".encode()
        ).hexdigest()[:12]
        base = self.cache_dir or os.path.join(
            os.path.expanduser("~"), ".cache", "mixq_tpu_torch")
        out = os.path.join(base, key)
        if not os.path.exists(os.path.join(out, "model.safetensors")):
            quantize_hf_model(hf_dir, out, quant,
                              act_scales_path=self.act_scales_path,
                              device=self.device)
        return out

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
        """Batched speculative sampling with ``draft`` proposing gamma
        tokens a round (temperature <= 0: greedy, equal to target-only
        greedy decoding). Returns (token lists with the prompts,
        SpecStats)."""
        from .runtime.speculative import speculative_generate_batched
        return speculative_generate_batched(
            self.params, self.cfg, draft.params, draft.cfg,
            [list(p) for p in prompts], max_new_tokens, gamma=gamma,
            temperature=temperature, eos_token_id=eos_token_id,
            max_seq_len=self.max_seq_len, seed=seed, device=self.device)

    def generate_medusa(self, heads, prompt: Sequence[int],
                        max_new_tokens: int = 64, choices=None):
        """Greedy Medusa decoding: the heads' candidates verified in one
        forward over a static token tree. The output equals plain greedy
        decoding. Returns (tokens, MedusaStats)."""
        from .runtime.medusa import medusa_generate
        return medusa_generate(self.params, self.cfg, heads, list(prompt),
                               max_new_tokens, choices=choices,
                               max_seq_len=self.max_seq_len,
                               device=self.device)

    def generate_redrafter(self, drafter, prompt: Sequence[int],
                           max_new_tokens: int = 64, num_beams: int = 4,
                           draft_len: int = 4):
        """Greedy ReDrafter decoding: the drafter's num_beams beams of
        draft_len tokens verified in one forward over a static beam block.
        The output equals plain greedy decoding. Returns (tokens,
        ReDrafterStats)."""
        from .runtime.redrafter import redrafter_generate
        return redrafter_generate(self.params, self.cfg, drafter,
                                  list(prompt), max_new_tokens,
                                  num_beams=num_beams, draft_len=draft_len,
                                  max_seq_len=self.max_seq_len,
                                  device=self.device)

    def evaluate_ppl(self, token_stream: Sequence[int], seq_len: int = 512,
                     batch_size: int = 8, max_blocks: Optional[int] = None):
        """Block perplexity of this model (eval/ppl.py, full_prefill)."""
        from .eval.ppl import evaluate_ppl
        return evaluate_ppl(self.params, self.cfg, token_stream,
                            seq_len=seq_len, batch_size=batch_size,
                            max_blocks=max_blocks)

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
