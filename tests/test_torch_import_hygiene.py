"""The PyTorch port stands alone: ``paddle_tpu_torch`` and
``chip_smoke.py`` import no ``jax`` and no ``paddle_tpu`` module, and
the port's entry points refuse to fall back to the CPU when no GPU is
present and the caller did not ask for the CPU. Checked in fresh
interpreters (this test process has JAX loaded by conftest)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, json, pkgutil, sys
import torch
import paddle_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                              "paddle_tpu_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "jax" or m.startswith("jax.")
                or m == "jaxlib" or m.startswith("jaxlib.")
                or m == "paddle_tpu" or m.startswith("paddle_tpu."))
result = {"modules": mods, "leaked": leaked,
          "cuda": torch.cuda.is_available(), "refused": {}}
if not torch.cuda.is_available():
    from paddle_tpu_torch.inference.serving import ServingEngine
    from paddle_tpu_torch.models.gpt import gpt2_tiny, init_params
    from paddle_tpu_torch.kernels import paged_attention as pa
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.api import TrainStep
    from paddle_tpu_torch.models.bert import (
        BertForSequenceClassification, bert_tiny)
    from paddle_tpu_torch.tools import bench_bert, numerics_check
    import tempfile
    cpu_model = GPTForCausalLM(gpt2_tiny(), device="cpu")
    for name, call in (("engine", lambda: ServingEngine(gpt2_tiny())),
                       ("init_params", lambda: init_params(gpt2_tiny())),
                       ("engine_cuda", lambda: ServingEngine(
                           gpt2_tiny(), device="cuda")),
                       ("engine_quant", lambda: ServingEngine(
                           gpt2_tiny(), kv_dtype="int8",
                           weight_dtype="int8")),
                       ("model", lambda: GPTForCausalLM(gpt2_tiny())),
                       ("train_step", lambda: TrainStep(
                           cpu_model, lambda m, i, y: m.loss(i, y),
                           AdamW())),
                       ("bert", lambda: BertForSequenceClassification(
                           bert_tiny())),
                       ("bench_bert", lambda: bench_bert.run(8, pack=4)),
                       ("numerics_check", lambda: numerics_check.self_drive(
                           tempfile.mkdtemp()))):
        try:
            call()
            result["refused"][name] = False
        except RuntimeError:
            result["refused"][name] = True
print(json.dumps(result))
"""


def _run(code, cwd):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    res = _run(_PROBE, ROOT)
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert "paddle_tpu_torch.inference.serving" in out["modules"]
    assert "paddle_tpu_torch.kernels.paged_attention" in out["modules"]
    assert "paddle_tpu_torch.kernels.flash_attention" in out["modules"]
    assert "paddle_tpu_torch.kernels.fused_ce" in out["modules"]
    assert "paddle_tpu_torch.tools.bench_gpt_pretrain" in out["modules"]
    assert "paddle_tpu_torch.parallel.api" in out["modules"]
    for name in ("kernels.packed_flash", "nn.transformer", "models.bert",
                 "tools.bench_bert", "quantization", "quantization.kv",
                 "quantization.weights", "observability",
                 "observability.registry", "observability.exporters",
                 "observability.step_logger", "observability.tracing",
                 "observability.compile_tracker", "observability.ledger",
                 "observability.anatomy", "profiler",
                 "tools.bench_serving", "observability.slo",
                 "observability.journal", "observability.numerics",
                 "kernels.tensor_health", "tools.numerics_check"):
        assert f"paddle_tpu_torch.{name}" in out["modules"]
    assert out["leaked"] == []
    if not out["cuda"]:
        assert out["refused"] == {"engine": True, "init_params": True,
                                  "engine_cuda": True, "engine_quant": True,
                                  "model": True,
                                  "train_step": True, "bert": True,
                                  "bench_bert": True,
                                  "numerics_check": True}


def test_chip_smoke_fails_without_a_gpu_or_without_the_port(tmp_path):
    """Alone in a directory (or on a machine without CUDA) the script
    exits non-zero and prints no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_ctypes_binding_matches_the_c_prototype():
    """The wrapper's argtypes must list the C entry's parameters in
    order: a pointer declared as an int would be cut to 32 bits."""
    import ctypes
    import re

    from paddle_tpu_torch.kernels import paged_attention as pa
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "paged_attention.cu")) as f:
        text = f.read()
    sig = re.search(r'extern "C" int paged_attention_forward\((.*?)\)',
                    text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else ctypes.c_int
             for p in params]
    assert kinds == pa.ARGTYPES


def test_tensor_health_binding_matches_the_c_prototype():
    """The tensor_health wrapper's argtypes list the C entry's
    parameters in order (pointers as c_void_p)."""
    import ctypes
    import re

    from paddle_tpu_torch.kernels import _build
    from paddle_tpu_torch.kernels import tensor_health as th
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "tensor_health.cu")) as f:
        text = f.read()
    sig = re.search(r'extern "C" int tensor_health\((.*?)\)', text,
                    re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    kinds = [ctypes.c_void_p if "*" in p else
             ctypes.c_float if p.startswith("float") else ctypes.c_int
             for p in params]
    assert kinds == th.ARGTYPES
    assert "tensor_health" in _build.SOURCES
    assert int(re.search(r"kMaxTensors = (\d+);", text).group(1)) == \
        th._MAX_TENSORS
    assert int(re.search(r"kChunk = (\d+);", text).group(1)) == th._CHUNK


@pytest.fixture
def no_nvcc(monkeypatch):
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")


def test_build_raises_without_nvcc(no_nvcc, tmp_path, monkeypatch):
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()
