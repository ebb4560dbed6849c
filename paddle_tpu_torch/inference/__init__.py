"""Serving stack of the port: ``sampler.py``, ``scheduler.py``,
``faults.py``, ``serving.py``, ``speculative.py``, ``router.py`` (the
fleet router) and ``autoscale.py`` (the autoscaler), each the
counterpart of the same file under ``paddle_tpu/inference/``."""
from .faults import FAULT_KINDS, FaultInjector, InjectedFault, ReplicaDown
from .scheduler import QueueFullError, RequestQueue
from .serving import (Completion, Request, ServingEngine,
                      record_quant_logit_err)
from .speculative import truncate_draft
from .router import EngineReplica, FleetRouter, ReplicaDeadError
from .autoscale import AutoscaleController, AutoscalePolicy

__all__ = ["FAULT_KINDS", "FaultInjector", "InjectedFault", "ReplicaDown",
           "QueueFullError", "RequestQueue", "ServingEngine", "Request",
           "Completion", "truncate_draft", "record_quant_logit_err",
           "EngineReplica", "FleetRouter", "ReplicaDeadError",
           "AutoscaleController", "AutoscalePolicy"]
