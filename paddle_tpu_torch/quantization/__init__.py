"""Quantization for serving — port of the serving surface of
``paddle_tpu/quantization``: per-page int8/fp8 KV pools (``kv.py``) and
weight-only int8 (``weights.py``). The reference's QAT and PTQ layers are
not ported."""
from .kv import (  # noqa: F401
    FP8_MAX, KV_QUANT_DTYPES, QMAX, dequantize_per_page, page_scale_shape,
    quantize_per_page)
from .weights import (  # noqa: F401
    cast_params, dequantize_params, params_nbytes, quantize_weights_int8)
