"""Neural-network layers of the port (``paddle_tpu/nn``), as far as the
GPT, BERT and ResNet training steps need them. ``Sequential`` is
``torch.nn.Sequential``: its children are named ``"0"``, ``"1"``, ... as
the reference's are."""
from torch.nn import Sequential  # noqa: F401

from . import functional  # noqa: F401
from .clip import ClipGradByGlobalNorm  # noqa: F401
from .conv import Conv2D  # noqa: F401
from .layers import (Dropout, Embedding, LayerNorm, Linear,  # noqa: F401
                     ReLU, RowParallelLinear, load_named_state)
from .loss import CrossEntropyLoss, MSELoss  # noqa: F401
from .norm import BatchNorm1D, BatchNorm2D  # noqa: F401
from .pooling import AdaptiveAvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (MultiHeadAttention, Transformer,  # noqa: F401
                          TransformerDecoder, TransformerDecoderLayer,
                          TransformerEncoder, TransformerEncoderLayer)

__all__ = ["functional", "ClipGradByGlobalNorm", "Conv2D", "Dropout",
           "Embedding", "LayerNorm", "Linear", "ReLU", "RowParallelLinear",
           "load_named_state", "BatchNorm1D", "BatchNorm2D",
           "AdaptiveAvgPool2D", "MaxPool2D", "Sequential",
           "MultiHeadAttention", "TransformerEncoder",
           "TransformerEncoderLayer", "TransformerDecoder",
           "TransformerDecoderLayer", "Transformer", "CrossEntropyLoss",
           "MSELoss"]
