"""Serving stack of the port: ``sampler.py``, ``scheduler.py``,
``faults.py``, ``serving.py`` and ``speculative.py``, each the
counterpart of the same file under ``paddle_tpu/inference/``."""
from .faults import FAULT_KINDS, FaultInjector, InjectedFault, ReplicaDown
from .scheduler import QueueFullError
from .serving import (Completion, Request, ServingEngine,
                      record_quant_logit_err)
from .speculative import truncate_draft

__all__ = ["FAULT_KINDS", "FaultInjector", "InjectedFault", "ReplicaDown",
           "QueueFullError", "ServingEngine", "Request", "Completion",
           "truncate_draft", "record_quant_logit_err"]
