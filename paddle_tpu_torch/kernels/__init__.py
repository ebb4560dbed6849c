"""Hand-written CUDA kernels of the port and their plain PyTorch
versions (``paged_attention.py`` <- ``paddle_tpu/kernels/
paged_attention_pallas.py``). Sources live in ``csrc/``; ``_build.py``
compiles them at first use."""
