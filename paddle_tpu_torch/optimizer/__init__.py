"""Optimizers and LR schedulers of the port (``paddle_tpu/optimizer``):
the nine eager optimizers with their decays (``optimizer.py``) and the
schedulers of ``lr.py``."""
from . import lr  # noqa: F401
from .optimizer import (SGD, Adadelta, Adagrad, Adam,  # noqa: F401
                        AdamDelta, Adamax, AdamW, L1Decay, L2Decay, Lamb,
                        Momentum, Optimizer, RMSProp)

__all__ = ["lr", "SGD", "Adadelta", "Adagrad", "Adam", "AdamDelta",
           "Adamax", "AdamW", "L1Decay", "L2Decay", "Lamb", "Momentum",
           "Optimizer", "RMSProp"]
