"""Build and load the port's CUDA kernels.

Each ``kernels/csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface and loaded with
``ctypes`` — no PyTorch headers, so a build takes seconds. Libraries go
to ``kernels/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt and an unchanged one is
reused. Nothing is built when a module is imported: the first launch
builds, or a caller (``chip_smoke.py``) builds every source at once with
:func:`build_all`, one ``nvcc`` per source, all started together.
``defines`` (``-D`` flags, for a source's test hooks) build a variant
beside the plain library, under its own name. :func:`launch_context` is
the device context the wrappers launch in.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "find_nvcc", "build_all", "load", "launch_context"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("paged_attention", "flash_attention", "fused_ce", "packed_flash",
           "tensor_health")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs = {}
build_log = {}   # name -> {"seconds": float, "ptxas": str, "path": str}


def find_nvcc():
    """``nvcc`` from ``torch.utils.cpp_extension.CUDA_HOME``, else from
    ``PATH``; raises when neither has one."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError("nvcc not found (neither CUDA_HOME/bin nor PATH); "
                       "the CUDA kernels cannot be built")


def _key(name, defines):
    return " ".join((name, *defines))


def _target(name, defines=()):
    """The source and its library path, keyed by the source, the shared
    headers (``csrc/*.cuh``), the flags and the defines."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *defines)).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES, defines=()):
    """Compile every named source that is not built yet, one ``nvcc``
    process each, all running at once. Returns ``build_log`` (keyed by
    the name, followed by the defines if any); raises with the
    compiler's output if any build fails."""
    nvcc = None
    procs = {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in names:
        src, out = _target(name, defines)
        if out.exists():
            build_log.setdefault(_key(name, defines), {"seconds": 0.0, "ptxas": "",
                                        "path": str(out)})
            continue
        nvcc = nvcc or find_nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{err}")
            continue
        os.replace(tmp, out)
        build_log[_key(name, defines)] = {"seconds": time.perf_counter() - t0,
                           "ptxas": err, "path": str(out)}
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return build_log


def load(name, defines=()):
    """The ``ctypes`` handle of kernel library ``name`` (built with
    ``defines``), built on first use."""
    key = _key(name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build_all((name,), tuple(defines))
            lib = ctypes.CDLL(build_log[key]["path"])
            _libs[key] = lib
        return lib


def launch_context(dev):
    """The CUDA device context for a launch on ``dev``: none when ``dev``
    is the current device already (entering one costs microseconds a
    call, in a serving loop that waits on the host)."""
    import torch
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)
