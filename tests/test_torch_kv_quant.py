"""Per-page KV quantization of the PyTorch port
(paddle_tpu_torch/quantization/kv.py) against the JAX reference
(paddle_tpu/quantization/kv.py) on seeded numpy inputs.

Tolerance: none. The port keeps the reference's order of operations
(abs-max over (PS, HD) per head, ``max(amax, eps) / qmax``, ``x / s``,
round half to even and clip, or clip and cast to float8_e4m3fn), so
codes, scales and dequantized values are bit-identical to the
reference's, for int8 and fp8, per head and per page, on all-zero pages
and under requantization."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.quantization import kv as J
from paddle_tpu_torch.quantization import kv as T

torch.set_num_threads(2)


def _pages(seed, shape=(7, 8, 4, 16)):
    """Pages whose heads differ by five decades, page 0 all zero."""
    rng = np.random.RandomState(seed)
    head = np.array([1e-3, 1.0, 30.0, 0.05])[None, None, :, None]
    x = (rng.randn(*shape) * head).astype(np.float32)
    x[0] = 0.0
    return x


def _np_codes(q):
    """Codes as comparable numpy bytes (fp8 by its bit pattern)."""
    if isinstance(q, torch.Tensor):
        return (q.view(torch.uint8) if q.dtype == torch.float8_e4m3fn
                else q).numpy()
    a = np.asarray(q)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and \
        a.dtype != np.int8 else a


@pytest.mark.parametrize("axis,keepdims", [(-1, False), (0, True),
                                           ((0, 2), False), ((1, 3), True)])
def test_symmetric_int8_bit_identical(axis, keepdims):
    x = _pages(1)
    qj, sj = J.symmetric_int8(jnp.asarray(x), axis, keepdims=keepdims)
    qt, st = T.symmetric_int8(torch.from_numpy(x), axis, keepdims=keepdims)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("per_head", [True, False])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantize_and_dequantize_bit_identical(fmt, per_head, seed):
    x = _pages(seed)
    qj, sj = J.quantize_per_page(jnp.asarray(x), per_head=per_head,
                                 dtype=fmt)
    qt, st = T.quantize_per_page(torch.from_numpy(x), per_head=per_head,
                                 dtype=fmt)
    assert qt.dtype == T.STORAGE[fmt]
    assert tuple(st.shape) == T.page_scale_shape(7, 4, per_head)
    np.testing.assert_array_equal(_np_codes(qt), _np_codes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    dj = J.dequantize_per_page(qj, sj, per_head=per_head)
    dt = T.dequantize_per_page(qt, st, per_head=per_head)
    assert dt.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_dequantize_to_bf16_bit_identical(fmt):
    x = _pages(3)
    qj, sj = J.quantize_per_page(jnp.asarray(x), dtype=fmt)
    qt, st = T.quantize_per_page(torch.from_numpy(x), dtype=fmt)
    dj = np.asarray(J.dequantize_per_page(qj, sj, dtype=jnp.bfloat16)
                    .astype(jnp.float32))
    dt = T.dequantize_per_page(qt, st, dtype=torch.bfloat16)
    assert dt.dtype == torch.bfloat16
    np.testing.assert_array_equal(dt.float().numpy(), dj)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_all_zero_page_gives_zero_codes_and_the_floor_scale(fmt):
    z = np.zeros((2, 8, 4, 16), np.float32)
    qj, sj = J.quantize_per_page(jnp.asarray(z), dtype=fmt)
    qt, st = T.quantize_per_page(torch.from_numpy(z), dtype=fmt)
    assert bool((qt.float() == 0).all()) and bool(torch.isfinite(st).all())
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(_np_codes(qt), _np_codes(qj))


@pytest.mark.parametrize("per_head", [True, False])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_requantizing_dequantized_pages_snaps_as_the_reference(fmt,
                                                               per_head):
    """Grid values requantize to the same codes (the copy-on-write and
    prefix-cache parity relies on it), and the scales come back as the
    reference's do, bit for bit."""
    x = _pages(4)
    qt, st = T.quantize_per_page(torch.from_numpy(x), per_head=per_head,
                                 dtype=fmt)
    d = T.dequantize_per_page(qt, st, per_head=per_head)
    q2, s2 = T.quantize_per_page(d, per_head=per_head, dtype=fmt)
    np.testing.assert_array_equal(_np_codes(q2), _np_codes(qt))
    np.testing.assert_allclose(s2.numpy(), st.numpy(), rtol=1e-6)
    qj, sj = J.quantize_per_page(jnp.asarray(d.numpy()), per_head=per_head,
                                 dtype=fmt)
    np.testing.assert_array_equal(_np_codes(q2), _np_codes(qj))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(sj))


def test_fp8_abs_max_maps_onto_the_format_max():
    qt, _ = T.quantize_per_page(torch.from_numpy(_pages(5)), dtype="fp8")
    assert float(qt.float().abs().max()) == T.FP8_MAX


def test_constants_and_shapes_match_the_reference():
    assert (T.QMAX, T.FP8_MAX, T.KV_QUANT_DTYPES, T._EPS) == \
        (J.QMAX, J.FP8_MAX, J.KV_QUANT_DTYPES, J._EPS)
    for per_head in (True, False):
        assert T.page_scale_shape(9, 3, per_head) == \
            J.page_scale_shape(9, 3, per_head)


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="quantization dtype"):
        T.quantize_per_page(torch.zeros(1, 8, 4, 16), dtype="fp4")
