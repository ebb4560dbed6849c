"""The train step of the port (``paddle_tpu/parallel``)."""
from .api import TrainStep  # noqa: F401

__all__ = ["TrainStep"]
