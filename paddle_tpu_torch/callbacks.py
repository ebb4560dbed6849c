"""``paddle_tpu_torch.callbacks`` — the re-export of ``hapi.callbacks``
(``paddle_tpu/callbacks.py``)."""
from .hapi.callbacks import (  # noqa: F401
    Callback, ProgBarLogger, ModelCheckpoint, VisualDL, LRScheduler,
    EarlyStopping, ReduceLROnPlateau, TelemetryCallback, NumericsCallback,
)

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "VisualDL",
           "LRScheduler", "EarlyStopping", "ReduceLROnPlateau",
           "TelemetryCallback", "NumericsCallback"]
