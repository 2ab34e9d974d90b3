"""Command-line entry points. Counterpart of cli.py.

    python -m mixq_tensorrt_llm_tpu_torch.cli <cmd> ...

``quantize`` (HF directory -> checkpoint), ``generate``, ``eval-ppl``,
``summarize``, ``eval-mmlu`` and ``serve`` (the HTTP server, serve.py),
with the JAX package's flags. Each runs on the CUDA card. ``--model``
takes a checkpoint directory or a Hugging Face one, quantized on first
use under ``--quant`` (``api.LLM``).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _add_quantize(sub):
    p = sub.add_parser("quantize", help="HF model dir -> quantized checkpoint")
    p.add_argument("--model_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--qformat", default="int8_mix",
                   choices=["none", "w8a16", "w4a16", "w4a16_g", "int8_mix",
                            "int4_mix", "fp8", "int8_lr"])
    p.add_argument("--kv_cache_dtype", default="none",
                   choices=["none", "int8", "fp8"])
    p.add_argument("--num_outliers", type=int, default=128)
    p.add_argument("--group_size", type=int, default=128,
                   help="rows per scale group (w4a16_g)")
    p.add_argument("--act_scales", default=None,
                   help=".pt/.npz act_scales artifact (reference-compatible)")
    p.add_argument("--calib_file", default=None,
                   help="text file for calibration (needs the model's "
                        "tokenizer, through transformers)")
    p.add_argument("--calib_samples", type=int, default=32)
    p.add_argument("--calib_seq_len", type=int, default=512)
    p.add_argument("--lora_dir", default=None,
                   help="PEFT adapter dir merged into base weights before "
                        "quantization")
    return p


def _tokenizer_or_exit(path: str, why: str):
    from .api import _try_tokenizer
    tok = _try_tokenizer(path)
    if tok is None:
        sys.exit(f"mixq-torch: {why} needs a tokenizer in {path} and the "
                 "transformers package")
    return tok


def _cmd_quantize(args):
    from .convert import hf
    from .quant.config import KVCacheQuantAlgo, QuantAlgo, QuantConfig

    quant = QuantConfig(algo=QuantAlgo(args.qformat),
                        kv_cache=KVCacheQuantAlgo(args.kv_cache_dtype),
                        num_outliers=args.num_outliers,
                        group_size=args.group_size)
    calib_batches = None
    if args.calib_file and quant.algo.is_mix and not args.act_scales:
        tok = _tokenizer_or_exit(args.model_dir, "--calib_file")
        with open(args.calib_file) as f:
            ids = tok(f.read(), add_special_tokens=False)["input_ids"]
        n = args.calib_seq_len
        calib_batches = [np.asarray(ids[i * n:(i + 1) * n], np.int32)[None]
                         for i in range(args.calib_samples)
                         if len(ids) >= (i + 1) * n]
    cfg = hf.quantize_hf_model(args.model_dir, args.output_dir, quant,
                               act_scales_path=args.act_scales,
                               calib_batches=calib_batches,
                               lora_dir=args.lora_dir)
    print(f"wrote {args.output_dir} ({cfg.arch}, {cfg.num_layers} layers, "
          f"{quant.algo.value})")


def _add_generate(sub):
    p = sub.add_parser("generate", help="generate text from a checkpoint")
    p.add_argument("--model", required=True,
                   help="checkpoint dir or HF dir (auto-quantized)")
    p.add_argument("--quant", default=None)
    p.add_argument("--prompt", action="append", required=True)
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--max_seq_len", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--top_k", type=int, default=0)
    p.add_argument("--top_p", type=float, default=1.0)
    p.add_argument("--num_beams", type=int, default=1,
                   help="beam search over the paged KV pool "
                        "(reference run.py --num_beams)")
    p.add_argument("--bad_words", action="append", default=None,
                   help="string that may never be generated; repeatable "
                        "(reference run.py --bad_words)")
    p.add_argument("--stop_words", action="append", default=None,
                   help="string suffix that ends generation; repeatable "
                        "(reference run.py --stop_words)")
    p.add_argument("--output_logprobs", action="store_true",
                   help="print per-token log-probs "
                        "(reference --output_log_probs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run_profiling", action="store_true",
                   help="print prefill/decode timing breakdown "
                        "(reference run.py --run_profiling)")
    return p


def _llm(args, max_seq_len: int):
    from . import api
    llm = api.LLM(args.model, quant=args.quant, max_seq_len=max_seq_len)
    if llm.tokenizer is None:
        sys.exit(f"mixq-torch {args.cmd}: no tokenizer in {args.model} (it "
                 "needs one, and the transformers package)")
    return llm


def _cmd_generate(args):
    from .runtime.sampler import SamplingConfig

    llm = _llm(args, args.max_seq_len)
    sampling = SamplingConfig(greedy=args.temperature == 0.0,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p)
    token_lists = [llm.tokenizer(p)["input_ids"] for p in args.prompt]

    def tok_nosp(w):
        return llm.tokenizer(w, add_special_tokens=False)["input_ids"]

    bw = [tok_nosp(w) for w in args.bad_words] if args.bad_words else None
    stops = [tok_nosp(w) for w in args.stop_words] if args.stop_words else None
    out = llm.generate_tokens(token_lists,
                              max_new_tokens=args.max_new_tokens,
                              sampling=sampling, seed=args.seed,
                              num_beams=args.num_beams,
                              bad_words=bw, stop_sequences=stops,
                              eos_token_id=llm.tokenizer.eos_token_id)
    for i, (prompt, seq, tl) in enumerate(zip(args.prompt, out.sequences,
                                              token_lists)):
        print(f"--- prompt: {prompt!r}")
        print(llm.tokenizer.decode(seq[len(tl):], skip_special_tokens=True))
        if args.output_logprobs and out.logprobs is not None:
            print(json.dumps({"logprobs":
                              [round(x, 4) for x in out.logprobs[i]]}))
    if args.run_profiling:
        print(json.dumps({
            "prefill_s": round(out.prefill_time_s, 4),
            "decode_s": round(out.decode_time_s, 4),
            "generated_tokens": sum(out.num_generated),
            "decode_tok_s": round(out.decode_tokens_per_s, 1),
        }))


def _add_eval(sub):
    p = sub.add_parser("eval-ppl", help="block perplexity on a text file")
    p.add_argument("--model", required=True)
    p.add_argument("--quant", default=None)
    p.add_argument("--text_file", required=True)
    p.add_argument("--seq_len", type=int, default=512)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_blocks", type=int, default=None)
    return p


def _cmd_eval(args):
    llm = _llm(args, max(args.seq_len, 512))
    with open(args.text_file) as f:
        ids = llm.tokenizer(f.read(), add_special_tokens=False)["input_ids"]
    res = llm.evaluate_ppl(ids, seq_len=args.seq_len,
                           batch_size=args.batch_size,
                           max_blocks=args.max_blocks)
    print(json.dumps({
        "ppl": round(res.ppl, 4), "blocks": res.blocks,
        "tokens": res.total_tokens,
        "blocks_per_s": round(res.blocks_per_s, 2),
        "tokens_per_s": round(res.tokens_per_s, 1),
    }))


def _add_summarize(sub):
    p = sub.add_parser(
        "summarize",
        help="ROUGE eval on a jsonl of {article, highlights} records "
             "(reference summarize.py equivalent; bring your own "
             "CNN/DailyMail-style file)")
    p.add_argument("--model", required=True)
    p.add_argument("--quant", default=None)
    p.add_argument("--data_file", required=True,
                   help="jsonl with 'article' and 'highlights' fields")
    p.add_argument("--max_samples", type=int, default=20)
    p.add_argument("--max_input_len", type=int, default=896)
    p.add_argument("--output_len", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--rouge1_threshold", type=float, default=None,
                   help="exit non-zero if rouge1 falls below this "
                        "(reference --tensorrt_llm_rouge1_threshold)")
    p.add_argument("--enc_dec", action="store_true",
                   help="model is a T5-family encoder-decoder (not ported "
                        "yet: models/t5.py)")
    return p


def _cmd_summarize(args):
    from .eval.rouge import rouge_scores

    if args.enc_dec:
        sys.exit("mixq-torch summarize --enc_dec: encoder-decoder models are "
                 "not ported yet; they come with models/t5.py")
    llm = _llm(args, args.max_input_len + args.output_len)
    records = _read_jsonl(args.data_file, args.max_samples)
    prompt_tmpl = "Summarize the following article:\n\n{}\n\nSummary:"
    hyps, refs = [], []
    for i in range(0, len(records), args.batch_size):
        chunk = records[i: i + args.batch_size]
        prompts = [llm.tokenizer(prompt_tmpl.format(r["article"])
                                 )["input_ids"][: args.max_input_len]
                   for r in chunk]
        out = llm.generate_tokens(prompts, max_new_tokens=args.output_len,
                                  eos_token_id=llm.tokenizer.eos_token_id)
        for r, seq, p in zip(chunk, out.sequences, prompts):
            hyps.append(llm.tokenizer.decode(seq[len(p):],
                                             skip_special_tokens=True))
            refs.append(r["highlights"])
    scores = rouge_scores(hyps, refs)
    print(json.dumps({k: round(v, 3) for k, v in scores.items()}))
    if (args.rouge1_threshold is not None
            and scores["rouge1"] < args.rouge1_threshold):
        sys.exit(f"rouge1 {scores['rouge1']:.2f} below threshold "
                 f"{args.rouge1_threshold}")


def _read_jsonl(path: str, max_samples: int) -> list:
    records = []
    with open(path) as f:
        for line in f:
            if line.strip():
                records.append(json.loads(line))
            if len(records) >= max_samples:
                break
    return records


def _add_mmlu(sub):
    p = sub.add_parser("eval-mmlu",
                       help="MMLU accuracy over a dir of <subject>_test.csv "
                            "(+ optional _dev.csv for few-shot)")
    p.add_argument("--model", required=True)
    p.add_argument("--quant", default=None)
    p.add_argument("--data_dir", required=True)
    p.add_argument("--k_shot", type=int, default=5)
    p.add_argument("--max_questions", type=int, default=None)
    p.add_argument("--max_input_len", type=int, default=2048)
    return p


def _cmd_mmlu(args):
    from .eval.mmlu import evaluate_mmlu

    llm = _llm(args, args.max_input_len)
    acc = evaluate_mmlu(llm, args.data_dir, k_shot=args.k_shot,
                        max_questions_per_subject=args.max_questions,
                        max_input_len=args.max_input_len)
    print(json.dumps({k: round(v, 4) for k, v in acc.items()}))


def _add_serve(sub):
    p = sub.add_parser("serve", help="HTTP serving (continuous batching)")
    p.add_argument("--model", required=True,
                   help="checkpoint dir or HF dir (auto-quantized)")
    p.add_argument("--quant", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_seq_len", type=int, default=2048)
    p.add_argument("--block_size", type=int, default=64)
    p.add_argument("--prefill_chunk", type=int, default=256)
    p.add_argument("--snapshot_path", default=None,
                   help="crash-resume: restore pending work from this JSON "
                        "at start and keep writing snapshots while serving")
    p.add_argument("--max_queue_size", type=int, default=0,
                   help="admission backpressure: answer HTTP 503 while this "
                        "many requests are queued (0 = unbounded)")
    p.add_argument("--warmup", action="store_true",
                   help="make the decode rungs (CUDA graphs on the card) "
                        "and build the kernels before accepting traffic. "
                        "The JAX package's --cache_dir (its persistent XLA "
                        "cache) has no counterpart: kernels build once into "
                        "build/kernels/ and the graphs are captured here")
    p.add_argument("--burst", type=int, default=1,
                   help="decode in k-step rungs (one host readback a "
                        "burst; streams flush a burst at a time)")
    return p


def _cmd_serve(args):
    from . import api
    from .serve import run_server

    llm = api.LLM(args.model, quant=args.quant, max_seq_len=args.max_seq_len)
    run_server(llm, host=args.host, port=args.port,
               max_batch=args.max_batch, block_size=args.block_size,
               prefill_chunk=args.prefill_chunk,
               snapshot_path=args.snapshot_path,
               max_queue_size=args.max_queue_size, warmup=args.warmup,
               burst=args.burst)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="mixq-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_quantize(sub)
    _add_generate(sub)
    _add_eval(sub)
    _add_summarize(sub)
    _add_mmlu(sub)
    _add_serve(sub)
    args = parser.parse_args(argv)
    {"quantize": _cmd_quantize,
     "generate": _cmd_generate,
     "eval-ppl": _cmd_eval,
     "summarize": _cmd_summarize,
     "eval-mmlu": _cmd_mmlu,
     "serve": _cmd_serve}[args.cmd](args)


if __name__ == "__main__":
    main()
