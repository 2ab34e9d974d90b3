"""The port stands alone: importing mixq_tensorrt_llm_tpu_torch and every
one of its modules pulls in neither jax nor the JAX package (nor the
safetensors package, which the card machine lacks), and its entry
points default to the CUDA card instead of quietly using the CPU."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import mixq_tensorrt_llm_tpu_torch as port

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    # a fresh interpreter: this test process has jax loaded by conftest.py
    names = sorted(m.name for m in pkgutil.walk_packages(
        port.__path__, prefix="mixq_tensorrt_llm_tpu_torch."))
    assert "mixq_tensorrt_llm_tpu_torch.runtime.scheduler" in names
    code = (
        "import importlib, sys\n"
        f"for n in {['mixq_tensorrt_llm_tpu_torch'] + names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mixq_tensorrt_llm_tpu' or m == 'safetensors'"
        " or m.startswith('mixq_tensorrt_llm_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_default_to_the_card():
    from mixq_tensorrt_llm_tpu_torch.models.common import ModelConfig
    from mixq_tensorrt_llm_tpu_torch.runtime.scheduler import Executor
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Executor({"layers": []}, ModelConfig(num_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.resolve_device()
    assert port.resolve_device("cpu") == torch.device("cpu")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
