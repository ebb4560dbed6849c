"""Functional ops of the port (``paddle_tpu/nn/functional``), as far as
the GPT and BERT training steps need them."""
from .attention import scaled_dot_product_attention  # noqa: F401
from .common import (dropout, embedding, gelu, layer_norm,  # noqa: F401
                     linear, matmul, relu, tanh)
from .loss import cross_entropy, fused_linear_cross_entropy  # noqa: F401

__all__ = ["scaled_dot_product_attention", "dropout", "embedding", "gelu",
           "relu", "tanh", "layer_norm", "linear", "matmul",
           "cross_entropy", "fused_linear_cross_entropy"]
