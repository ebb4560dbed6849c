"""Distributed helpers of the port (``paddle_tpu/distributed``):
``utils_recompute``; ``env`` (the process environment), ``collective``
(the collectives over ``torch.distributed``) and ``spawn`` (one process
a rank, the backend rule), which tensor-parallel serving
(``inference/tp.py``) stands on."""
