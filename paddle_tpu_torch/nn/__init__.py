"""Neural-network layers of the port (``paddle_tpu/nn``), as far as the
GPT and BERT training steps need them."""
from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .layers import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                     RowParallelLinear, load_named_state)
from .transformer import (MultiHeadAttention,  # noqa: F401
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "Dropout", "Embedding",
           "LayerNorm", "Linear", "RowParallelLinear", "load_named_state",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer"]
