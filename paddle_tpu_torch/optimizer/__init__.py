"""Optimizers and LR schedulers of the port (``paddle_tpu/optimizer``):
``Adam``, ``AdamW``, ``Momentum`` and the schedulers of ``lr.py``."""
from . import lr  # noqa: F401
from .optimizer import Adam, AdamW, Momentum, Optimizer  # noqa: F401

__all__ = ["lr", "Adam", "AdamW", "Momentum", "Optimizer"]
