"""Models of the port (``gpt.py`` <- ``paddle_tpu/models/gpt.py``)."""
from .gpt import (GPTConfig, GPTForCausalLM, gpt2_medium,  # noqa: F401
                  gpt2_small, gpt2_tiny)

__all__ = ["GPTConfig", "GPTForCausalLM", "gpt2_medium", "gpt2_small",
           "gpt2_tiny"]
