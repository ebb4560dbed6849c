"""Distributed helpers of the port (``paddle_tpu/distributed``): only
``utils_recompute`` so far."""
