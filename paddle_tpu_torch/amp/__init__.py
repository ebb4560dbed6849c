"""AMP autocast — port of ``paddle_tpu/amp/__init__.py`` (``auto_cast``)
and of the cast rule in ``paddle_tpu/ops/registry.py:89-114``.

Under ``auto_cast(level="O1")`` an op on the white list casts every
floating input to the low dtype (bf16 by default), an op on the black
list casts them to float32, and any other op runs in its inputs' dtype.
The lists are the reference's own; ``level="O2"`` (everything low but
the black list, with ``decorate``) is not ported yet and raises. The
port's functional ops that carry a listed name call :func:`cast_inputs`
with it (``linear_op``, ``matmul_v2``, ``flash_attention``,
``softmax_with_cross_entropy``); the rest follow their inputs.

``torch.autocast`` is not used: its lists differ from the reference's
(it returns ``layer_norm`` in float32, where the reference keeps the
input dtype with float32 statistics, ``nn/functional/norm.py:90-105``),
so the dtypes at op boundaries would differ.

The state is the process's, as the reference's tracer state is; the
context manager restores it on exit. :func:`snapshot` and
:func:`restored` let a recompute replay run under the state its forward
saw (``distributed/utils_recompute.py``). ``GradScaler`` and
``decorate`` are not ported (bf16 needs no loss scaling).
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "cast_inputs",
           "autocast_dtype", "snapshot", "restored"]

# op white/black lists (the reference's, amp/__init__.py:22-34)
WHITE_LIST = {
    "matmul_v2", "mm", "conv1d", "conv2d", "conv3d", "conv1d_transpose",
    "conv2d_transpose", "conv3d_transpose", "linear_op", "einsum",
    "flash_attention", "packed_flash_attention", "rnn_op",
}
BLACK_LIST = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "reduce_mean",
    "reduce_sum", "softmax_op", "log_softmax_op",
    "softmax_with_cross_entropy", "cross_entropy", "bce_op", "bce_logits_op",
    "nll_loss_op", "kl_div_op", "reduce_prod", "cumsum", "p_norm",
    "frobenius_norm",
    "mse_loss_op", "l1_loss_op",
}
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16}


class _State:
    level = "O0"
    dtype = "bfloat16"
    white = frozenset()
    black = frozenset()


_state = _State()


def snapshot():
    """The current autocast state, for :func:`restored`."""
    return (_state.level, _state.dtype, _state.white, _state.black)


@contextlib.contextmanager
def restored(snap):
    """Run under the autocast state ``snap`` (from :func:`snapshot`)."""
    prev = snapshot()
    _state.level, _state.dtype, _state.white, _state.black = snap
    try:
        yield
    finally:
        _state.level, _state.dtype, _state.white, _state.black = prev


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    snap = snapshot()
    if enable:
        if level == "O2":
            raise NotImplementedError(
                "auto_cast(level='O2') is not ported to paddle_tpu_torch "
                "yet")
        if dtype not in _DTYPES:
            raise ValueError(f"unsupported autocast dtype {dtype!r}")
        white = set(WHITE_LIST)
        black = set(BLACK_LIST)
        if custom_white_list:
            white |= set(custom_white_list)
            black -= set(custom_white_list)
        if custom_black_list:
            black |= set(custom_black_list)
            white -= set(custom_black_list)
        snap = (level, dtype, frozenset(white), frozenset(black))
    with restored(snap):
        yield


def autocast_dtype():
    """The low dtype under ``O1``/``O2`` autocast, else ``None``: for an
    op on neither list that casts its operands itself, as the reference's
    ``fused_linear_cross_entropy`` reads the tracer's AMP level and dtype
    (``nn/functional/loss.py:167-169``)."""
    if _state.level in ("O1", "O2"):
        return _DTYPES[_state.dtype]
    return None


def cast_inputs(op_name, *args):
    """``args`` as op ``op_name`` sees them under the current autocast
    state: floating tensors cast per the rule, anything else as is."""
    if _state.level != "O1":
        return args
    if op_name in _state.white:
        target = _DTYPES[_state.dtype]
    elif op_name in _state.black:
        target = torch.float32
    else:
        return args
    return tuple(a.to(target) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() and a.dtype != target else a
                 for a in args)
