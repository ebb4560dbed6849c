"""Vision models of the port (``paddle_tpu/vision``)."""
from . import models  # noqa: F401

__all__ = ["models"]
