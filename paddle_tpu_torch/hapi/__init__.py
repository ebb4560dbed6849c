"""The high-level API of the port (``paddle_tpu/hapi``): ``Model`` and
the core callbacks (``model.py``), the rest of the callbacks
(``callbacks.py``), ``summary`` and ``flops`` (``summary.py``)."""
from .model import (  # noqa: F401
    Model, Callback, ProgBarLogger, ModelCheckpoint, EarlyStopping,
    LRScheduler,
)
from . import callbacks  # noqa: F401
from .summary import flops, summary  # noqa: F401
