"""Device policy of the PyTorch/CUDA port.

The port's entry points (``ServingEngine``, the kernel wrappers, the
weight builders) run on CUDA by default. They run on the CPU only when
the caller asks for it with ``device="cpu"``, as the CPU tests do. With
no GPU and no explicit ``device="cpu"`` they raise: a serving engine
that quietly moved to the CPU would report CPU numbers under a GPU's
name.

Float32 stays float32: PyTorch would otherwise run float32
convolutions through cuDNN in TF32 (about three decimal digits), and a
later change of its matmul default would do the same to the products.
The port is held against the JAX reference at float32 tolerances, so
both switches are pinned off here, once, for the whole package.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None):
    """``None`` -> the current CUDA device, raising when there is none;
    anything else -> ``torch.device(device)``, raising for a CUDA
    device on a machine without CUDA. Never falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; the port runs on the GPU "
                "by default — pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
