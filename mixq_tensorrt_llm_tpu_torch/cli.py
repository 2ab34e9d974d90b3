"""Command-line entry point. Counterpart of cli.py.

    python -m mixq_tensorrt_llm_tpu_torch.cli serve --model <dir> [--port N]

``serve`` runs the HTTP server (serve.py) over an ``LLM`` on a checkpoint
directory of this package's format. The JAX package's other subcommands
exit with the module whose port brings them (ROADMAP queue 1).
"""

from __future__ import annotations

import argparse
import sys

# subcommand -> the module whose port brings it
UNPORTED = {
    "quantize": "convert/hf.py (quantizing a Hugging Face model)",
    "generate": "cli.py generate over LLM, with eval/ and utils/",
    "eval-ppl": "eval/ppl.py",
    "summarize": "eval/rouge.py and eval/summarize.py",
    "eval-mmlu": "eval/mmlu.py",
}


def _add_serve(sub):
    p = sub.add_parser("serve", help="HTTP serving (continuous batching)")
    p.add_argument("--model", required=True,
                   help="a checkpoint directory (convert/checkpoint.py)")
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
    from .api import LLM
    from .serve import run_server

    llm = LLM(args.model, max_seq_len=args.max_seq_len)
    run_server(llm, host=args.host, port=args.port,
               max_batch=args.max_batch, block_size=args.block_size,
               prefill_chunk=args.prefill_chunk,
               snapshot_path=args.snapshot_path,
               max_queue_size=args.max_queue_size, warmup=args.warmup,
               burst=args.burst)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in UNPORTED:
        sys.exit(f"mixq-torch {argv[0]}: not ported yet; it comes with "
                 f"{UNPORTED[argv[0]]} (ROADMAP queue 1)")
    parser = argparse.ArgumentParser(prog="mixq-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    _add_serve(sub)
    for name, module in UNPORTED.items():
        sub.add_parser(name, help=f"not ported yet ({module})")
    _cmd_serve(parser.parse_args(argv))


if __name__ == "__main__":
    main()
