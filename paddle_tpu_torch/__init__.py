"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The JAX package ``paddle_tpu`` is the reference; this package is its
counterpart for one NVIDIA H100. It imports ``torch`` and numpy, never
``jax`` and nothing of ``paddle_tpu``. The layout mirrors the reference
so that each module sits where its counterpart does:

- ``models/gpt.py``            <- ``paddle_tpu/models/gpt.py``
- ``models/bert.py``           <- ``paddle_tpu/models/bert.py``
- ``inference/sampler.py``     <- ``paddle_tpu/inference/sampler.py``
- ``inference/scheduler.py``   <- ``paddle_tpu/inference/scheduler.py``
- ``inference/serving.py``     <- ``paddle_tpu/inference/serving.py``
- ``quantization/kv.py``, ``quantization/weights.py`` <- their
  namesakes in ``paddle_tpu/quantization``
- ``kernels/paged_attention.py`` (+ ``kernels/csrc/paged_attention.cu``)
  <- ``paddle_tpu/kernels/paged_attention_pallas.py``
- ``kernels/flash_attention.py`` (+ ``kernels/csrc/flash_attention.cu``)
  <- ``paddle_tpu/kernels/flash_attention_pallas.py``
- ``kernels/fused_ce.py`` (+ ``kernels/csrc/fused_ce.cu``)
  <- ``paddle_tpu/kernels/fused_ce_pallas.py``
- ``kernels/packed_flash.py`` (+ ``kernels/csrc/packed_flash.cu``)
  <- ``paddle_tpu/kernels/packed_flash_pallas.py``
- ``amp/``                     <- ``paddle_tpu/amp/__init__.py``
  (``auto_cast`` O1/O2, ``decorate``, ``GradScaler``)
- ``io/``, ``metric/``         <- ``paddle_tpu/io``, ``paddle_tpu/metric``
- ``hapi/``                    <- ``paddle_tpu/hapi`` (``Model``, the
  callbacks, ``summary``/``flops``); ``callbacks.py`` <- its namesake
- ``nn/``                      <- ``paddle_tpu/nn`` (layers, functional
  ops, ``clip.py``, ``transformer.py`` <- ``nn/layer/transformer.py``,
  ``conv.py``, ``norm.py``, ``pooling.py`` <- their ``nn/layer``
  namesakes, ``functional/{conv,norm,pooling}.py``) and the one-device
  ``mp_layers``
- ``vision/models/resnet.py``  <- ``paddle_tpu/vision/models/resnet.py``
- ``distributed/utils_recompute.py`` <- its namesake
- ``optimizer/``               <- ``paddle_tpu/optimizer`` (the nine
  eager optimizers, their optax mapping for ``TrainStep``, ``lr.py``)
- ``parallel/api.py``          <- ``paddle_tpu/parallel/api.py``
  (``TrainStep``)
- ``observability/``           <- ``paddle_tpu/observability`` (its
  serving half: registry, exporters, step logger, tracing, the
  graph-capture census in ``compile_tracker.py``, the ledger, anatomy)
- ``profiler/``                <- ``paddle_tpu/profiler``
- ``tools/``                   <- ``tools/bench_gpt_pretrain.py``,
  ``tools/bench_bert.py``, ``tools/bench_serving.py`` (its single-engine
  path), and ``bench.py`` as ``tools/bench_resnet.py``

The slices ported so far are GPT-2 generation through the paged serving
engine (over float, int8 or fp8 KV pools, with float or int8 weights),
the single-device GPT-2 training step (with and without the fused head +
CE), the BERT-base fine-tune, unpacked and sequence-packed, ResNet-50
training as ``bench.py`` runs it, and mixed precision with the
high-level training API (O1/O2 autocast in bf16 or float16, loss
scaling, the eager optimizers, ``Model.fit``).
Entry points run on CUDA unless the caller passes ``device="cpu"`` (see
``device.py``).
"""
from . import device  # noqa: F401  (pins the TF32 switches off)
from .device import resolve_device  # noqa: F401
from . import observability  # noqa: F401
from . import amp  # noqa: F401
from . import io  # noqa: F401
from . import metric  # noqa: F401
from . import callbacks  # noqa: F401
from .hapi.model import Model  # noqa: F401
from .hapi.summary import flops, summary  # noqa: F401

__all__ = ["resolve_device", "observability", "amp", "io", "metric",
           "callbacks", "Model", "summary", "flops"]
