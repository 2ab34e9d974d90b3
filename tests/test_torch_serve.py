"""The port's HTTP front end (serve.py) on the CPU: an InferenceServer over
a tiny f32 int8_mix Llama on 127.0.0.1, port 0. /generate and concurrent
requests give the Executor's greedy tokens, /generate_stream's lines
equal the final tokens, bad words hold over HTTP, a bad body answers
400, a full queue 503, a snapshot written by a crashed process is
resumed and served through /result, and a burst-4 server gives the
burst-1 server's tokens (the cases of the JAX package's test_serve.py
that apply). `cli serve` passes its flags to LLM and run_server, and
the CLI's unported subcommands exit naming their module.
Every network wait and thread join is bounded."""

import functools
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from unittest import mock

import pytest
import torch

from mixq_tensorrt_llm_tpu_torch import cli
from mixq_tensorrt_llm_tpu_torch.convert import hf
from mixq_tensorrt_llm_tpu_torch.models import llama
from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
from mixq_tensorrt_llm_tpu_torch.quant.config import QuantAlgo, QuantConfig
from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
from mixq_tensorrt_llm_tpu_torch.serve import InferenceServer, make_handler

WAIT = 60          # seconds, for every request and join
KW = dict(max_seq_len=64, max_batch=2, block_size=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=64, dtype=torch.float32,
                      quant=QuantConfig(algo=QuantAlgo.INT8_MIX,
                                        num_outliers=4))
    return llama.init_random_params(cfg, seed=0, device="cpu"), cfg


class FakeLLM:
    """What the server needs of an LLM: make_executor and tokenizer."""
    tokenizer = None

    def __init__(self, model, **over):
        self.params, self.cfg = model
        self.over = over

    def make_executor(self, **kw):
        kw = {**kw, **KW, **self.over}
        return Executor(self.params, self.cfg, seed=0, device="cpu", **kw)


def _executor_tokens(model, prompts, n, **submit_kw):
    ex = FakeLLM(model).make_executor()
    ids = [ex.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    done = ex.run()
    return [done[r].generated for r in ids]


@pytest.fixture(scope="module")
def server(model):
    srv = InferenceServer(FakeLLM(model))
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    srv.shutdown(timeout=WAIT)
    t.join(timeout=WAIT)


def _post(url, payload, path="/generate", raw=None):
    req = urllib.request.Request(
        url + path, raw if raw is not None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        body = r.read().decode()
    if path == "/generate_stream":
        return [json.loads(line) for line in body.splitlines() if line]
    return json.loads(body)


def _error(url, payload, path="/generate", raw=None):
    try:
        _post(url, payload, path, raw)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())["error"]
    raise AssertionError("expected an HTTP error")


def test_health(server):
    with urllib.request.urlopen(server + "/health", timeout=WAIT) as r:
        h = json.loads(r.read())
    assert h["status"] == "ok" and h["compiles_since_warmup"] is None
    kv = h["kv"]
    assert kv["free_num_blocks"] + kv["used_num_blocks"] \
        + kv["cached_num_blocks"] == kv["max_num_blocks"]


def test_generate_tokens(server, model):
    out = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 5,
                         "eos": False})
    assert out["tokens"] == _executor_tokens(model, [[1, 2, 3]], 5)[0]
    assert len(out["logprobs"]) == 5
    assert out["stats"]["prompt_tokens"] == 3
    assert out["stats"]["ttft_s"] >= 0 and out["text"] is None


def test_concurrent_requests_batch(server, model):
    prompts = [[10 + i, 20 + i] for i in range(4)]
    results = {}

    def go(i):
        results[i] = _post(server, {"prompt": prompts[i],
                                    "max_new_tokens": 6, "eos": False})

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
    assert sorted(results) == [0, 1, 2, 3]
    assert [results[i]["tokens"] for i in range(4)] == \
        _executor_tokens(model, prompts, 6)


def test_bad_requests(server):
    code, err = _error(server, {"prompt": [1] * 100, "max_new_tokens": 50})
    assert code == 400 and "max_seq_len" in err
    assert _error(server, None, raw=b"{not json")[0] == 400
    assert _error(server, None, raw=b"[1, 2]")[0] == 400
    code, err = _error(server, {"prompt": "text, no tokenizer"})
    assert code == 400 and "tokenizer" in err
    code, _ = _error(server, {"prompt": [1], "max_new_tokens": 2,
                              "bad_words": [list(range(70))]},
                     path="/generate_stream")
    assert code == 400
    for path in ("/result", "/result?id=x"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(server + path, timeout=WAIT)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(server + "/result?id=12345", timeout=WAIT)
    assert e.value.code == 404


def test_sampling_and_bad_words_fields(server, model):
    base = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                          "eos": False})
    tok = base["tokens"][1]
    out = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                         "eos": False, "bad_words": [[tok]]})
    assert tok not in out["tokens"]
    assert out["tokens"] == _executor_tokens(model, [[1, 2, 3]], 6,
                                             bad_words=[[tok]])[0]
    out2 = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                          "eos": False, "temperature": 2.0, "top_k": 20})
    assert len(out2["tokens"]) == 6


def test_generate_stream_tokens(server):
    base = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                          "eos": False})
    lines = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                           "eos": False}, path="/generate_stream")
    toks = [line["token"] for line in lines if "token" in line]
    assert toks == base["tokens"] == lines[-1]["tokens"]
    assert lines[-1]["done"] and lines[-1]["generated_tokens"] == 6


def test_stream_with_bad_words(server):
    base = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                          "eos": False})
    tok = base["tokens"][1]
    lines = _post(server, {"prompt": [1, 2, 3], "max_new_tokens": 6,
                           "eos": False, "bad_words": [[tok]]},
                  path="/generate_stream")
    toks = [line["token"] for line in lines if "token" in line]
    assert tok not in toks and len(toks) == 6 and toks == lines[-1]["tokens"]


def test_queue_full_answers_503(model):
    """A server whose queue holds max_queue_size requests (its stepper
    stopped, so they stay queued) answers 503; /health reports them."""
    srv = InferenceServer(FakeLLM(model), max_queue_size=2)
    srv.shutdown(timeout=WAIT)
    for p in ([1, 2], [3]):
        srv.executor.submit(p, max_new_tokens=2)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        for path in ("/generate", "/generate_stream"):
            code, err = _error(url, {"prompt": [4], "max_new_tokens": 2},
                               path=path)
            assert code == 503 and "queue full" in err
        with urllib.request.urlopen(url + "/health", timeout=WAIT) as r:
            assert json.loads(r.read())["queued"] == 2
    finally:
        httpd.shutdown()
        t.join(timeout=WAIT)


def test_snapshot_restore_cycle(model, tmp_path):
    """A server started with snapshot_path resumes a crashed process's
    pending work exactly and serves it through /result; shutdown writes
    a snapshot with nothing pending."""
    want = _executor_tokens(model, [[4, 5, 6]], 8)[0]
    old = FakeLLM(model).make_executor()
    rid = old.submit([4, 5, 6], max_new_tokens=8)
    while old.has_work:
        old.step()
        live = [r for r in old.slots if r is not None]
        if live and len(live[0].generated) >= 3:
            break
    path = str(tmp_path / "snap.json")
    with open(path, "w") as f:
        json.dump(old.snapshot(), f)
    srv = InferenceServer(FakeLLM(model), snapshot_path=path,
                          snapshot_interval_s=0.0)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(srv))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        out = None
        for _ in range(WAIT * 50):
            try:
                with urllib.request.urlopen(f"{url}/result?id={rid}",
                                            timeout=WAIT) as r:
                    out = json.loads(r.read())
                break
            except urllib.error.HTTPError as e:
                assert e.code == 404
                threading.Event().wait(0.02)
        assert out is not None and out["tokens"] == want
    finally:
        httpd.shutdown()
        t.join(timeout=WAIT)
        srv.shutdown(timeout=WAIT)
    with open(path) as f:
        assert json.load(f)["pending"] == []


def test_burst_server_matches_single_step(model):
    """burst 4: decode in rungs of 4 (and behind prefill chunks); the
    greedy tokens equal the burst-1 server's."""
    prompts = [[3, 1, 4, 1], [2] * 9, [7] * 17, [5, 6]]

    def drive(burst):
        srv = InferenceServer(FakeLLM(model, max_batch=4), burst=burst)
        out = {}

        def go(i):
            out[i] = srv.generate(prompts[i], max_new_tokens=10,
                                  use_eos=False, timeout=WAIT)["tokens"]
        try:
            threads = [threading.Thread(target=go, args=(i,))
                       for i in range(len(prompts))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
        finally:
            srv.shutdown(timeout=WAIT)
        assert srv.executor.decode_steps > 0
        return [out[i] for i in range(len(prompts))], srv.executor

    four, ex4 = drive(4)
    one, _ = drive(1)
    assert four == one
    assert ex4.decode_steps > ex4.decode_calls      # bursts ran


def test_stepper_failure_answers_500(model):
    """A stepper that raises wakes every waiter, which fails with 500
    instead of waiting out its timeout."""
    srv = InferenceServer(FakeLLM(model))

    def boom(*a, **k):
        raise RuntimeError("device lost")
    srv.executor.step_serving = boom
    with pytest.raises(RuntimeError, match="device lost"):
        srv.generate([1, 2], max_new_tokens=2, timeout=WAIT)
    srv.shutdown(timeout=WAIT)
    assert srv.health()["status"] == "failed"


@pytest.mark.parametrize("argv,module", [
    (["summarize", "--model", "m", "--data_file", "d", "--enc_dec"],
     "models/t5.py"),
    (["quantize", "--model_dir", "{hf}", "--output_dir", "{out}",
      "--lora_dir", "{adapter}", "--qformat", "w8a16"], "convert/lora.py"),
])
def test_cli_unported_subcommands_name_their_module(argv, module, tmp_path):
    """Every subcommand is ported; what still raises names its module
    (T5's summarize). `quantize --lora_dir` came with convert/lora.py: it
    now merges the adapter, so layer 0's qkv weights differ from a plain
    quantization's and layer 1's do not (the JAX comparison is
    tests/test_torch_lora.py's)."""
    patch = mock.patch.object(hf, "quantize_hf_model", functools.partial(
        hf.quantize_hf_model, device="cpu"))
    if module == "convert/lora.py":
        from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import (
            read_safetensors, write_safetensors)
        from mixq_tensorrt_llm_tpu_torch.tools.random_hf import (
            LLAMA2_7B_HF, write_random_llama)
        paths = {k: str(tmp_path / k) for k in ("hf", "out", "adapter",
                                                "plain")}
        write_random_llama(paths["hf"], dict(
            LLAMA2_7B_HF, vocab_size=64, hidden_size=64,
            intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            torch_dtype="float32"), device="cpu")
        (tmp_path / "adapter").mkdir()
        (tmp_path / "adapter" / "adapter_config.json").write_text(
            json.dumps({"r": 2, "lora_alpha": 4}))
        gen = torch.Generator().manual_seed(0)
        key = "base_model.model.model.layers.0.self_attn.q_proj.lora_"
        write_safetensors(paths["adapter"] + "/adapter_model.safetensors",
                          {key + "A.weight": torch.randn((2, 64),
                                                         generator=gen),
                           key + "B.weight": torch.randn((64, 2),
                                                         generator=gen)})
        with patch:
            cli.main([a.format(**paths) for a in argv])
            cli.main([a.format(**paths) for a in argv[:4] + argv[6:]]
                     + ["--output_dir", paths["plain"]])
        got, plain = (read_safetensors(paths[d] + "/model.safetensors")
                      for d in ("out", "plain"))
        qkv = [n for n in got if "qkv_proj" in n and "qweight" in n]
        assert qkv and not torch.equal(got[qkv[0]][0], plain[qkv[0]][0])
        assert torch.equal(got[qkv[0]][1], plain[qkv[0]][1])
        return
    with pytest.raises((SystemExit, NotImplementedError)) as e:
        with patch:
            cli.main(argv)
    assert module in str(e.value)


def test_cli_serve_builds_the_server(monkeypatch):
    """`cli serve` parses its flags into LLM's and run_server's kwargs."""
    from mixq_tensorrt_llm_tpu_torch import api, serve
    seen = {}

    def fake_llm(model_dir, **kw):
        seen["llm"] = (model_dir, kw)
        return "llm"

    monkeypatch.setattr(api, "LLM", fake_llm)
    monkeypatch.setattr(serve, "run_server",
                        lambda llm, **kw: seen.update(server=(llm, kw)))
    cli.main(["serve", "--model", "ckpt", "--port", "0", "--max_batch",
              "4", "--max_seq_len", "512", "--max_queue_size", "3",
              "--warmup", "--burst", "16", "--snapshot_path", "s.json"])
    assert seen["llm"] == ("ckpt", dict(quant=None, max_seq_len=512))
    assert seen["server"] == ("llm", dict(
        host="127.0.0.1", port=0, max_batch=4, block_size=64,
        prefill_chunk=256, snapshot_path="s.json", max_queue_size=3,
        warmup=True, burst=16))
    with pytest.raises(SystemExit):
        cli.main(["serve", "--model", "ckpt", "--device", "cpu"])


def test_concurrent_clients_stress(model):
    """More client threads than cores submit at once with a short switch
    interval: every request gets its own prompt's tokens, no id repeats,
    and no event or finished request is left behind."""
    import os
    import sys
    n = (os.cpu_count() or 4) + 2
    prompts = [[(3 * i + j) % 120 + 1 for j in range(2 + i % 5)]
               for i in range(n)]
    want = {}
    for i in range(0, n, 2):
        want.update(zip(range(i, i + 2),
                        _executor_tokens(model, prompts[i:i + 2], 4)))
    srv = InferenceServer(FakeLLM(model))
    out, errors = {}, []

    def go(i):
        try:
            out[i] = srv.generate(prompts[i], max_new_tokens=4,
                                  use_eos=False, timeout=WAIT)
        except Exception as e:   # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        srv.shutdown(timeout=WAIT)
    assert not errors and sorted(out) == list(range(n))
    assert all(out[i]["tokens"] == want[i] for i in range(n))
    assert not srv._events and not srv.executor.finished
    assert srv.executor._next_id == n
