"""Functional ops of the port (``paddle_tpu/nn/functional``), as far as
the GPT, BERT and ResNet training steps need them."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (add, dropout, embedding, gelu,  # noqa: F401
                     layer_norm, linear, matmul, relu, tanh)
from .conv import conv2d  # noqa: F401
from .loss import (cross_entropy, fused_linear_cross_entropy,  # noqa: F401
                   mse_loss)
from .norm import batch_norm  # noqa: F401
from .pooling import (adaptive_avg_pool2d, avg_pool2d,  # noqa: F401
                      max_pool2d)

__all__ = ["scaled_dot_product_attention", "add", "dropout", "embedding",
           "gelu", "relu", "tanh", "layer_norm", "linear", "matmul", "conv2d",
           "batch_norm", "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d",
           "cross_entropy", "fused_linear_cross_entropy", "mse_loss"]
