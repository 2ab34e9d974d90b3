"""HTTP serving front end over the continuous-batching Executor.
Counterpart of serve.py.

A stdlib ThreadingHTTPServer accepts requests while one stepper thread
drives ``Executor.step_serving``: requests batch together between steps.

  POST /generate  {"prompt": str | [int], "max_new_tokens": int,
                   "eos": bool, "min_new_tokens": int,
                   "temperature"/"top_k"/"top_p"/"greedy"/
                   "repetition_penalty": sampling overrides,
                   "bad_words": [str | [int]],
                   "stop": [[int]]}
       -> {"text", "tokens", "logprobs", "stats"}
  POST /generate_stream  the same body -> chunked JSON lines, one per
                   token ({"token": id, "text": piece}), then a final
                   {"done": true, "generated_tokens", "tokens", "logprobs"}
  GET  /health     -> {"status": "ok", "kv": ..., "compiles_since_warmup",
                       ...}
  GET  /result?id=N  pop a finished request's output (requests resumed
                   from a snapshot, whose client died with the previous
                   process)

A full queue (``max_queue_size``) answers 503, a bad body 400, a request
past its timeout 504, a failed stepper 500. Crash-resume: with
``snapshot_path`` the server restores pending work at start and writes a
snapshot every ``snapshot_interval_s`` while work is in flight and at
shutdown.

Every device operation runs in the stepper thread (its CUDA device set
there), after ``warmup`` on the caller's thread; the HTTP handler threads
touch host state only, under the server's lock, so none of them runs
CUDA work while a rung is captured. The server uses only
``llm.make_executor`` and ``llm.tokenizer``: any object with those two
serves.

Start: python -m mixq_tensorrt_llm_tpu_torch.cli serve --model <dir>
"""

from __future__ import annotations

import itertools
import json
import os
import queue
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .runtime.sampler import SamplingConfig
from .runtime.scheduler import QueueFullError
from .utils import compile_watch


class InferenceServer:
    def __init__(self, llm, max_batch: int = 8, block_size: int = 64,
                 prefill_chunk: int = 256, snapshot_path=None,
                 snapshot_interval_s: float = 30.0,
                 max_queue_size: int = 0, warmup: bool = False,
                 burst: int = 1):
        self.llm = llm
        self.burst = burst
        self.executor = llm.make_executor(max_batch=max_batch,
                                          block_size=block_size,
                                          prefill_chunk=prefill_chunk,
                                          max_queue_size=max_queue_size)
        if warmup:
            # make the rungs (every pow2 burst rung with burst > 1) and
            # build the kernels before the first request
            t0 = time.time()
            c0 = compile_watch.compile_count()
            h0 = compile_watch.cache_hit_count()
            self.executor.warmup(burst=burst)
            print(f"[serve] warmup {time.time() - t0:.1f}s: "
                  f"{compile_watch.compile_count() - c0} programs made, "
                  f"{compile_watch.cache_hit_count() - h0} kernel libraries "
                  "loaded", flush=True)
        self.snapshot_path = snapshot_path
        self._snapshot_interval = snapshot_interval_s
        self._last_snapshot = 0.0
        if snapshot_path is not None and os.path.exists(snapshot_path):
            with open(snapshot_path) as f:
                self.executor.restore(json.load(f))
        self.error = None        # the stepper's exception, if it died
        self._lock = threading.Lock()
        self._events = {}
        self._stop = threading.Event()
        self._stepper = threading.Thread(target=self._step_loop, daemon=True)
        self._stepper.start()

    def _step_loop(self):
        dev = getattr(self.executor, "device", None)
        if dev is not None and dev.type == "cuda":
            import torch
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            with self._lock:
                try:
                    # burst > 1: decode in k-step rungs (and behind prefill
                    # chunks); streams flush a burst at a time
                    worked = (self.executor.step_serving(self.burst)
                              if self.executor.has_work else 0)
                except Exception as e:   # wake every waiter: they fail
                    traceback.print_exc()
                    self.error = e
                    self._stop.set()
                    for ev in self._events.values():
                        ev.set()
                    return
                for rid in list(self.executor.finished):
                    ev = self._events.get(rid)
                    if ev is not None:
                        ev.set()
                # mid-prefill steps produce 0 tokens; the state still
                # needs saving while there is work
                if (self.snapshot_path is not None
                        and (worked or self.executor.has_work)
                        and time.monotonic() - self._last_snapshot
                        > self._snapshot_interval):
                    self._write_snapshot()
            if not worked:
                time.sleep(0.005)

    def _write_snapshot(self):
        """Atomic snapshot write (tmp + rename); caller holds _lock."""
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.executor.snapshot(), f)
        os.replace(tmp, self.snapshot_path)
        self._last_snapshot = time.monotonic()

    def _check_stepper(self):
        if self.error is not None:
            raise RuntimeError(f"the stepper failed: {self.error!r}")

    def _prep(self, prompt, use_eos: bool):
        """(token ids, eos id) from a string or token-list prompt."""
        if isinstance(prompt, str):
            if self.llm.tokenizer is None:
                raise ValueError("no tokenizer: send token ids")
            ids = self.llm.tokenizer(prompt)["input_ids"]
        else:
            ids = list(prompt)
        eos = (getattr(self.llm.tokenizer, "eos_token_id", None)
               if use_eos else None)
        return ids, eos

    def _tokenize_words(self, words):
        """Strings tokenize (no special tokens); token-id lists pass."""
        if not words:
            return words
        if any(isinstance(w, str) for w in words) and \
                self.llm.tokenizer is None:
            raise ValueError("no tokenizer: send bad words as token ids")
        return [self.llm.tokenizer(w, add_special_tokens=False)["input_ids"]
                if isinstance(w, str) else list(w) for w in words]

    def _submit(self, prompt, max_new_tokens, use_eos, sampling,
                min_new_tokens, bad_words, stop_sequences, on_token=None):
        """Queue a request under the lock; returns (id, its event)."""
        ids, eos = self._prep(prompt, use_eos)
        bad_words = self._tokenize_words(bad_words)
        ev = threading.Event()
        with self._lock:
            self._check_stepper()
            rid = self.executor.submit(
                ids, max_new_tokens=max_new_tokens, eos_token_id=eos,
                sampling=sampling, min_new_tokens=min_new_tokens,
                bad_words=bad_words, stop_sequences=stop_sequences,
                on_token=on_token)
            self._events[rid] = ev
        return rid, ev

    def _pop(self, rid):
        with self._lock:
            self._events.pop(rid, None)
            self._check_stepper()
            return self.executor.finished.pop(rid)

    def _text(self, tokens):
        return (self.llm.tokenizer.decode(tokens, skip_special_tokens=True)
                if self.llm.tokenizer else None)

    def generate(self, prompt, max_new_tokens: int = 64,
                 use_eos: bool = True, timeout: float = 600.0,
                 sampling=None, min_new_tokens: int = 0,
                 bad_words=None, stop_sequences=None) -> dict:
        rid, ev = self._submit(prompt, max_new_tokens, use_eos, sampling,
                               min_new_tokens, bad_words, stop_sequences)
        if not ev.wait(timeout):
            raise TimeoutError(f"request {rid} timed out")
        req = self._pop(rid)
        return {
            "text": self._text(req.generated),
            "tokens": req.generated,
            "logprobs": [round(x, 6) for x in req.logprobs],
            "stats": {
                "prompt_tokens": len(req.prompt),
                "generated_tokens": len(req.generated),
                "ttft_s": round(req.first_token_time - req.submit_time, 4),
                "total_s": round(req.finish_time - req.submit_time, 4),
            },
        }

    def generate_stream(self, prompt, max_new_tokens: int = 64,
                        use_eos: bool = True, timeout: float = 600.0,
                        sampling=None, min_new_tokens: int = 0,
                        bad_words=None, stop_sequences=None):
        """Yield one dict a generated token, then a summary dict. Tokens
        flow through the request's on_token callback (the stepper thread)
        into a queue this thread drains."""
        q: "queue.Queue" = queue.Queue()
        rid, ev = self._submit(prompt, max_new_tokens, use_eos, sampling,
                               min_new_tokens, bad_words, stop_sequences,
                               on_token=lambda req, tok: q.put(tok))
        t0 = time.perf_counter()
        while True:
            try:
                tok = q.get(timeout=0.05)
            except queue.Empty:
                if ev.is_set() and q.empty():
                    break   # finished and drained
                if time.perf_counter() - t0 > timeout:
                    raise TimeoutError(f"request {rid} stalled")
                continue
            yield {"token": int(tok), "text": self._text([tok])}
        req = self._pop(rid)
        yield {"done": True, "generated_tokens": len(req.generated),
               "tokens": req.generated,
               "logprobs": [round(x, 6) for x in req.logprobs]}

    def result(self, rid: int):
        """Pop a finished request's output (for requests resumed from a
        snapshot, whose HTTP client is gone); None if unknown or still
        running."""
        with self._lock:
            req = self.executor.finished.pop(rid, None)
        if req is None:
            return None
        return {"text": self._text(req.generated), "tokens": req.generated,
                "logprobs": [round(x, 6) for x in req.logprobs]}

    def health(self) -> dict:
        with self._lock:
            ex = self.executor
            st = ex.get_latest_iteration_stats(20)
            payload = {"status": "ok" if self.error is None else "failed",
                       "active": ex.num_active, "queued": len(ex.queue),
                       "prefilling": len(ex.prefilling),
                       "kv": ex.get_kv_cache_stats(),
                       # 0: no serving shape slipped past warmup (None
                       # before warmup)
                       "compiles_since_warmup": ex.compiles_since_warmup,
                       "cache_loads_since_warmup":
                           ex.cache_loads_since_warmup}
            if st:
                dt = sum(x.step_time_s for x in st)
                payload.update(
                    kv_cache_usage=round(st[-1].kv_cache_usage, 4),
                    recent_tokens_per_s=round(
                        sum(x.tokens_produced for x in st)
                        / max(dt, 1e-9), 1),
                    last_step_ms=round(st[-1].step_time_s * 1e3, 2))
        return payload

    def shutdown(self, timeout: float = 30.0):
        """Stop the stepper (joined within ``timeout`` s) and write the
        snapshot, if any."""
        self._stop.set()
        self._stepper.join(timeout=timeout)
        if self.snapshot_path is not None:
            with self._lock:
                self._write_snapshot()


def _sampling(body: dict):
    keys = ("temperature", "top_k", "top_p", "greedy", "repetition_penalty")
    if not any(k in body for k in keys):
        return None
    over = {k: body[k] for k in keys if k in body}
    # a sampling knob implies stochastic unless told otherwise
    over.setdefault("greedy", False)
    return SamplingConfig(**over)


def make_handler(server: InferenceServer):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):   # quiet
            pass

        def _json(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._json(200, server.health())
            elif self.path.startswith("/result"):
                from urllib.parse import parse_qs, urlparse
                q = parse_qs(urlparse(self.path).query)
                try:
                    rid = int(q["id"][0])
                except (KeyError, ValueError):
                    self._json(400, {"error": "need ?id=<req_id>"})
                    return
                out = server.result(rid)
                if out is None:
                    self._json(404, {"error": f"no finished result {rid}"})
                else:
                    self._json(200, out)
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path not in ("/generate", "/generate_stream"):
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("the body must be a JSON object")
                kw = dict(
                    max_new_tokens=int(body.get("max_new_tokens", 64)),
                    use_eos=bool(body.get("eos", True)),
                    sampling=_sampling(body),
                    min_new_tokens=int(body.get("min_new_tokens", 0)),
                    bad_words=body.get("bad_words"),
                    stop_sequences=body.get("stop"))
                if self.path == "/generate_stream":
                    items = server.generate_stream(body.get("prompt", ""),
                                                   **kw)
                    first = next(items)   # submit errors answer as JSON
                    self.send_response(200)
                    self.send_header("Content-Type",
                                     "application/jsonlines")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for item in itertools.chain([first], items):
                        line = (json.dumps(item) + "\n").encode()
                        self.wfile.write(b"%x\r\n%s\r\n"
                                         % (len(line), line))
                        self.wfile.flush()
                    self.wfile.write(b"0\r\n\r\n")
                    return
                self._json(200, server.generate(body.get("prompt", ""),
                                                **kw))
            except QueueFullError as e:
                self._json(503, {"error": str(e)})       # backpressure
            except (ValueError, KeyError, TypeError, AssertionError) as e:
                self._json(400, {"error": str(e)})
            except TimeoutError as e:
                self._json(504, {"error": str(e)})
            except RuntimeError as e:
                self._json(500, {"error": str(e)})

    return Handler


def run_server(llm, host: str = "127.0.0.1", port: int = 8000,
               max_batch: int = 8, block_size: int = 64,
               prefill_chunk: int = 256, snapshot_path=None,
               max_queue_size: int = 0, warmup: bool = False,
               burst: int = 1) -> None:
    srv = InferenceServer(llm, max_batch=max_batch, block_size=block_size,
                          prefill_chunk=prefill_chunk,
                          snapshot_path=snapshot_path,
                          max_queue_size=max_queue_size, warmup=warmup,
                          burst=burst)
    httpd = ThreadingHTTPServer((host, port), make_handler(srv))
    print(f"serving on http://{host}:{port} "
          f"(POST /generate, POST /generate_stream, GET /health)",
          flush=True)
    try:
        httpd.serve_forever()
    finally:
        srv.shutdown()
