"""Neural-network layers of the port (``paddle_tpu/nn``), as far as the
GPT training step needs them."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                     RowParallelLinear)

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RowParallelLinear"]
