"""Hand-written CUDA kernels of the port and their plain PyTorch
versions (``paged_attention.py``, ``flash_attention.py``, ``fused_ce.py``
and ``packed_flash.py``, each porting
``paddle_tpu/kernels/<name>_pallas.py``; and ``tensor_health.py``, the
numerics pass that the reference leaves to XLA's fusion). Sources live in
``csrc/``; ``_build.py`` compiles them at first use."""
