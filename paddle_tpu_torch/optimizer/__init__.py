"""Optimizers and LR schedulers of the port (``paddle_tpu/optimizer``):
``AdamW``, ``Momentum`` and the schedulers of ``lr.py``."""
from . import lr  # noqa: F401
from .optimizer import AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["lr", "AdamW", "Momentum", "Optimizer"]
