"""The port's CLI end to end on the CPU: quantize -> generate -> eval-ppl ->
summarize -> eval-mmlu through ``cli.main`` on a tiny Hugging Face
directory with an in-process WordLevel tokenizer, and ``serve --quant`` up
to a stubbed ``run_server``.

The CLI runs on the card; here ``api.LLM`` and ``convert.hf.
quantize_hf_model`` are bound to ``device="cpu"``. The perplexity is held
against the JAX package's CLI over the same directory within 1e-2: each
package quantizes its own bf16 checkpoint (its own bf16 calibration), so
the two models differ in bf16 roundings.
"""

import csv
import functools
import json
import os

import numpy as np
import pytest
import torch

from mixq_tensorrt_llm_tpu import cli as jcli
from mixq_tensorrt_llm_tpu_torch import api, cli
from mixq_tensorrt_llm_tpu_torch.convert import hf as thf
from mixq_tensorrt_llm_tpu_torch.convert.checkpoint import read_safetensors

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    from tokenizers import Tokenizer, models, pre_tokenizers
    d = tmp_path_factory.mktemp("cli_model")
    cfg = transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        head_dim=16, max_position_embeddings=256, rms_norm_eps=1e-5)
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(cfg).save_pretrained(str(d))
    vocab = {f"w{i}": i for i in range(250)}
    vocab.update({"A": 250, "B": 251, "C": 252, "D": 253, "<unk>": 254,
                  "</s>": 255})
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tk, unk_token="<unk>",
        eos_token="</s>").save_pretrained(str(d))
    return str(d)


@pytest.fixture
def on_cpu(monkeypatch, tmp_path):
    """The CLI's LLM and quantizer on the CPU; HOME (LLM's default cache)
    under tmp_path."""
    monkeypatch.setattr(api, "LLM", functools.partial(api.LLM, device="cpu"))
    monkeypatch.setattr(thf, "quantize_hf_model", functools.partial(
        thf.quantize_hf_model, device="cpu"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    return tmp_path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_data")
    (d / "calib.txt").write_text(" ".join(f"w{i % 200}" for i in range(4000)))
    (d / "text.txt").write_text(" ".join(f"w{(7 * i) % 150}"
                                         for i in range(3000)))
    return d


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _quantize(main, model_dir, out, corpus):
    main(["quantize", "--model_dir", model_dir, "--output_dir", str(out),
          "--qformat", "int8_mix", "--num_outliers", "8", "--calib_file",
          str(corpus / "calib.txt"), "--calib_samples", "2",
          "--calib_seq_len", "64"])


def test_cli_pipeline(model_dir, corpus, on_cpu, capsys):
    ckpt = on_cpu / "ckpt"
    _quantize(cli.main, model_dir, ckpt, corpus)
    assert "wrote" in capsys.readouterr().out
    files = set(os.listdir(ckpt))
    assert {"config.json", "model.safetensors", "act_scales.npz",
            "tokenizer.json"} <= files
    assert read_safetensors(str(ckpt / "model.safetensors"))[
        "layers.qkv_proj.qweight"].dtype == torch.int8

    cli.main(["generate", "--model", str(ckpt), "--prompt", "w1 w2 w3",
              "--prompt", "w9", "--max_new_tokens", "4", "--max_seq_len",
              "64", "--output_logprobs", "--run_profiling", "--bad_words",
              "w5", "--stop_words", "w7 w8"])
    out = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("--- prompt") for line in out) == 2
    assert len(json.loads(out[2])["logprobs"]) >= 1
    assert json.loads(out[-1])["generated_tokens"] >= 2
    cli.main(["generate", "--model", str(ckpt), "--prompt", "w1 w2",
              "--max_new_tokens", "3", "--max_seq_len", "64",
              "--num_beams", "2"])
    assert "--- prompt" in capsys.readouterr().out

    ppl_args = ["eval-ppl", "--text_file", str(corpus / "text.txt"),
                "--seq_len", "64", "--batch_size", "3", "--max_blocks",
                "8"]
    cli.main(ppl_args + ["--model", str(ckpt)])
    got = _last_json(capsys)
    assert got["blocks"] == 8 and got["tokens"] == 8 * 63
    jckpt = on_cpu / "jckpt"
    _quantize(jcli.main, model_dir, jckpt, corpus)
    capsys.readouterr()
    jcli.main(ppl_args + ["--model", str(jckpt)])
    want = _last_json(capsys)
    assert abs(got["ppl"] - want["ppl"]) <= 1e-2 * want["ppl"]

    data = on_cpu / "cnn.jsonl"
    with open(data, "w") as f:
        for i in range(3):
            f.write(json.dumps({
                "article": " ".join(f"w{(i + j) % 100}" for j in range(40)),
                "highlights": " ".join(f"w{(i + j) % 50}" for j in range(8)),
            }) + "\n")
    summ = ["summarize", "--model", str(ckpt), "--data_file", str(data),
            "--max_samples", "3", "--max_input_len", "48", "--output_len",
            "8", "--batch_size", "2"]
    cli.main(summ)
    res = _last_json(capsys)
    assert set(res) == {"rouge1", "rouge2", "rougeL"}
    assert all(0 <= v <= 100 for v in res.values())
    with pytest.raises(SystemExit, match="below threshold"):
        cli.main(summ + ["--rouge1_threshold", "101"])

    mmlu = on_cpu / "mmlu"
    mmlu.mkdir()
    rng = np.random.default_rng(0)
    with open(mmlu / "astronomy_test.csv", "w", newline="") as f:
        csv.writer(f).writerows(
            [[" ".join(f"w{x}" for x in rng.integers(0, 200, 5))]
             + [f"w{x}" for x in rng.integers(0, 200, 4)] + ["ABCD"[i % 4]]
             for i in range(4)])
    cli.main(["eval-mmlu", "--model", str(ckpt), "--data_dir", str(mmlu),
              "--k_shot", "0", "--max_input_len", "64"])
    acc = _last_json(capsys)
    assert set(acc) == {"astronomy", "average"}
    assert acc["average"] in (0.0, 0.25, 0.5, 0.75, 1.0)


@pytest.mark.parametrize("qformat", ["fp8", "int8_lr"])
def test_cli_fp8_and_int8_lr_formats(model_dir, on_cpu, capsys, qformat):
    """quantize --qformat fp8 | int8_lr --kv_cache_dtype fp8, then
    generate: the checkpoint equals the JAX CLI's (fp8 weights byte for
    byte, int8 weights and scales exactly, the low-rank factors as u @ v
    within 1e-3 relative RMS), and it serves over an e4m3 KV cache."""
    args = ["quantize", "--model_dir", model_dir, "--qformat", qformat,
            "--kv_cache_dtype", "fp8"]
    cli.main(args + ["--output_dir", str(on_cpu / "t")])
    jcli.main(args + ["--output_dir", str(on_cpu / "j")])
    capsys.readouterr()
    got = read_safetensors(str(on_cpu / "t" / "model.safetensors"))
    want = read_safetensors(str(on_cpu / "j" / "model.safetensors"))
    assert set(got) == set(want)
    with open(on_cpu / "t" / "config.json") as f:
        assert json.load(f)["quant"]["kv_cache"] == "fp8"
    for k in sorted(got):
        if "lr_u" in k or "lr_v" in k:
            continue
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      want[k].float().numpy(), err_msg=k)
    if qformat == "fp8":
        assert "layers.qkv_proj.qweight@e4m3" in got
    else:
        for mod in ("qkv_proj", "o_proj", "gate_up_proj"):
            uv = [(t[f"layers.{mod}.lr_u"].float()
                   @ t[f"layers.{mod}.lr_v"].float()) for t in (got, want)]
            assert float(((uv[0] - uv[1]) ** 2).mean().sqrt()
                         / (uv[1] ** 2).mean().sqrt()) <= 1e-3
    cli.main(["generate", "--model", str(on_cpu / "t"), "--prompt",
              "w1 w2 w3", "--prompt", "w9", "--max_new_tokens", "4",
              "--max_seq_len", "64"])
    out = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("--- prompt") for line in out) == 2


def test_cli_quantizes_an_hf_dir_on_load(model_dir, corpus, on_cpu, capsys):
    """--model an HF directory with --quant: LLM quantizes it into its
    cache under HOME (no act_scales: outliers fall back to ones), then
    loads from there."""
    cli.main(["eval-ppl", "--model", model_dir, "--quant", "w8a16",
              "--text_file", str(corpus / "text.txt"), "--seq_len", "64",
              "--max_blocks", "2"])
    assert _last_json(capsys)["blocks"] == 2
    cache = on_cpu / "home" / ".cache" / "mixq_tpu_torch"
    (key,) = os.listdir(cache)
    assert os.path.exists(cache / key / "model.safetensors")


def test_cli_serve_quant(monkeypatch):
    """`serve --quant` hands the quant to LLM and the rest to run_server."""
    from mixq_tensorrt_llm_tpu_torch import serve
    seen = {}

    def fake_llm(model_dir, **kw):
        seen["llm"] = (model_dir, kw)
        return "llm"

    monkeypatch.setattr(api, "LLM", fake_llm)
    monkeypatch.setattr(serve, "run_server",
                        lambda llm, **kw: seen.update(server=(llm, kw)))
    cli.main(["serve", "--model", "hf", "--quant", "int8_mix", "--port",
              "0", "--max_seq_len", "256"])
    assert seen["llm"] == ("hf", dict(quant="int8_mix", max_seq_len=256))
    assert seen["server"][0] == "llm"
