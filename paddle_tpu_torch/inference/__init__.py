"""Serving stack of the port: ``sampler.py``, ``scheduler.py`` and
``serving.py``, each the counterpart of the same file under
``paddle_tpu/inference/``."""
