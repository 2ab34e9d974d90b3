"""Port parity for eval/: block perplexity (eval/ppl.py), ROUGE
(eval/rouge.py) and MMLU scoring (eval/mmlu.py) against the JAX package.

The models are tiny f32 Llamas the JAX package initialises and saves; the
port loads the same checkpoint on the CPU. Blocks are shorter than 128
tokens, so both packages attend with the masked route (f32). Total NLL
agrees within 1e-4 relative: the same f32 math in another summation
order, with the float linears' bf16 rounding of their inputs (both
packages) now and then going the other way. The JAX package pads a short
last batch with zero rows and subtracts them; the port scores it at its
own size, and the totals agree all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mixq_tensorrt_llm_tpu.api import LLM as JLLM
from mixq_tensorrt_llm_tpu.convert.checkpoint import save_checkpoint
from mixq_tensorrt_llm_tpu.eval import mmlu as jmmlu
from mixq_tensorrt_llm_tpu.eval import ppl as jppl
from mixq_tensorrt_llm_tpu.eval import rouge as jrouge
from mixq_tensorrt_llm_tpu.models import ModelConfig as JConfig
from mixq_tensorrt_llm_tpu.models import llama as jllama
from mixq_tensorrt_llm_tpu.quant import (KVCacheQuantAlgo as JKV,
                                         QuantAlgo as JAlgo,
                                         QuantConfig as JQuant)
from mixq_tensorrt_llm_tpu_torch.api import LLM
from mixq_tensorrt_llm_tpu_torch.convert import load_checkpoint
from mixq_tensorrt_llm_tpu_torch.eval import mmlu as tmmlu
from mixq_tensorrt_llm_tpu_torch.eval import ppl as tppl
from mixq_tensorrt_llm_tpu_torch.eval import rouge as trouge

NLL_RTOL = 1e-4
V = 256


def _acts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {f"model.layers.{i}.{m}": (rng.permutation(n) + 1).astype(
        np.float32) for i in range(cfg.num_layers)
        for m, n in (("self_attn.q_proj", cfg.hidden_size),
                     ("self_attn.o_proj", cfg.hidden_size),
                     ("mlp.gate_proj", cfg.hidden_size),
                     ("mlp.down_proj", cfg.intermediate_size))}


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """{name: checkpoint dir}: the float model, and int8_mix with int8 KV."""
    out = {}
    for name, quant in (("float", JQuant()),
                        ("int8_mix", JQuant(algo=JAlgo.INT8_MIX,
                                            num_outliers=8,
                                            kv_cache=JKV.INT8))):
        cfg = JConfig(vocab_size=V, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=256, dtype=jnp.float32,
                      quant=quant)
        params = jllama.init_random_params(cfg, jax.random.PRNGKey(7),
                                           act_scales=_acts(cfg))
        d = str(tmp_path_factory.mktemp(name))
        save_checkpoint(d, params, cfg)
        out[name] = d
    return out


def _stream(seed=0, n=5 * 32 + 7):
    return np.random.default_rng(seed).integers(0, V, n).tolist()


@pytest.mark.parametrize("name,full_prefill,batch", [
    ("float", True, 2), ("float", False, 2), ("float", True, 8),
    ("int8_mix", True, 2), ("int8_mix", False, 2)])
def test_evaluate_ppl_matches_jax(ckpts, name, full_prefill, batch):
    """5 blocks of 32 tokens (batch 2: a short last batch; batch 8: one
    batch smaller than the batch size)."""
    from mixq_tensorrt_llm_tpu.convert.checkpoint import \
        load_checkpoint as jload
    jp, jcfg = jload(ckpts[name])
    tp, tcfg = load_checkpoint(ckpts[name], device="cpu")
    toks = _stream()
    want = jppl.evaluate_ppl(jp, jcfg, toks, seq_len=32, batch_size=batch,
                             full_prefill=full_prefill)
    got = tppl.evaluate_ppl(tp, tcfg, toks, seq_len=32, batch_size=batch,
                            full_prefill=full_prefill)
    assert (got.blocks, got.total_tokens) == (want.blocks,
                                              want.total_tokens) == (5, 155)
    assert abs(got.total_nll - want.total_nll) <= NLL_RTOL * want.total_nll
    assert abs(got.ppl - want.ppl) <= 2 * NLL_RTOL * want.ppl * np.log(
        want.ppl)
    assert got.blocks_per_s > 0 and got.tokens_per_s > 0
    capped = tppl.evaluate_ppl(tp, tcfg, toks, seq_len=32, batch_size=batch,
                               max_blocks=3, full_prefill=full_prefill)
    assert capped.blocks == 3
    with pytest.raises(ValueError, match="shorter"):
        tppl.evaluate_ppl(tp, tcfg, toks[:31], seq_len=32)


def test_int8_kv_reaches_the_score(ckpts):
    """full_prefill=False reads the int8 cache, so its score differs from
    the fresh-K/V one, as in the JAX package."""
    tp, tcfg = load_checkpoint(ckpts["int8_mix"], device="cpu")
    toks = _stream(1)
    a = tppl.evaluate_ppl(tp, tcfg, toks, seq_len=32, batch_size=4)
    b = tppl.evaluate_ppl(tp, tcfg, toks, seq_len=32, batch_size=4,
                          full_prefill=False)
    assert a.total_nll != b.total_nll


ROUGE_CASES = [
    (["the cat sat on the mat"], ["the cat is on the mat"]),
    (["A quick brown fox.", "nothing in common", ""],
     ["the quick brown fox jumps", "entirely different words", "empty"]),
    (["repeat repeat repeat words words", "Numbers 1 2 3 and 45"],
     ["repeat words repeat", "numbers 1 2 3 4 5"]),
]


@pytest.mark.parametrize("case", range(len(ROUGE_CASES)))
def test_rouge_scores_equal_jax(case):
    hyps, refs = ROUGE_CASES[case]
    assert trouge.rouge_scores(hyps, refs) == jrouge.rouge_scores(hyps, refs)


def _tokenizer(d):
    transformers = pytest.importorskip("transformers")
    from tokenizers import Tokenizer, models, pre_tokenizers
    vocab = {f"w{i}": i for i in range(V - 6)}
    vocab.update({"A": V - 6, "B": V - 5, "C": V - 4, "D": V - 3,
                  "<unk>": V - 2, "</s>": V - 1})
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>",
        eos_token="</s>").save_pretrained(d)


def test_mmlu_matches_jax(ckpts, tmp_path):
    """Tiny CSVs of two subjects (one with dev shots): the same prediction
    for every question and the same accuracies."""
    _tokenizer(ckpts["float"])
    rng = np.random.default_rng(3)

    def rows(n):
        return [[" ".join(f"w{x}" for x in rng.integers(0, 200, 6))]
                + [f"w{x}" for x in rng.integers(0, 200, 4)]
                + ["ABCD"[int(rng.integers(4))]] for _ in range(n)]

    import csv
    for name, n in (("algebra_test", 6), ("algebra_dev", 2),
                    ("anatomy_test", 5)):
        with open(tmp_path / f"{name}.csv", "w", newline="") as f:
            csv.writer(f).writerows(rows(n))
    preds = {}
    for side, llm in (("jax", JLLM(ckpts["float"], max_seq_len=256)),
                      ("torch", LLM(ckpts["float"], max_seq_len=256,
                                    device="cpu"))):
        seen = []
        score = llm.session.score_logits

        def record(tokens, lens, score=score, seen=seen):
            out = score(tokens, lens)
            seen.append(int(np.argmax(np.asarray(
                out[0, int(lens[0]) - 1], np.float32)[[V - 6, V - 5, V - 4,
                                                       V - 3]])))
            return out

        llm.session.score_logits = record
        mod = jmmlu if side == "jax" else tmmlu
        preds[side] = (mod.evaluate_mmlu(llm, str(tmp_path), k_shot=2,
                                         max_input_len=200), seen)
    assert preds["torch"] == preds["jax"]
    assert len(preds["torch"][1]) == 11
    assert set(preds["torch"][0]) == {"algebra", "anatomy", "average"}
