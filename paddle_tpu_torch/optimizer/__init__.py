"""Optimizers and LR schedulers of the port (``paddle_tpu/optimizer``):
``AdamW`` and the schedulers of ``lr.py``."""
from . import lr  # noqa: F401
from .optimizer import AdamW, Optimizer  # noqa: F401

__all__ = ["lr", "AdamW", "Optimizer"]
