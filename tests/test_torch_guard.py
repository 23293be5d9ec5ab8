"""Rules of the port that no differential test shows: it imports nothing of
JAX or of the JAX package, its engine never falls back from CUDA to the
CPU, and CPU tensors never launch a kernel."""

import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.serving import EngineConfig, LampEngine

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "src")

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
assert not bad, bad
import torch
assert torch.backends.cuda.matmul.allow_tf32 is False
assert torch.backends.cudnn.allow_tf32 is False
"""


def test_port_imports_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=_SRC)
    proc = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 20


def test_engine_without_cuda_raises_instead_of_running(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("gpt2"))
    params = transformer.init_params(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LampEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg, 0)          # default device is CUDA
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--reduced", "--num-requests", "1"])


def test_engine_rejects_params_on_another_device():
    cfg = reduced(get_config("gpt2"))
    params = transformer.init_params(cfg, 0, device="meta")
    with pytest.raises(ValueError, match="params are on"):
        LampEngine(cfg, params, EngineConfig(device="cpu"))


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--reduced", "--num-requests", "3", "--device",
                       "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3 requests" in out and "LAMP recompute rate" in out
