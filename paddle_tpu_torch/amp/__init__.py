"""AMP — port of ``paddle_tpu/amp/__init__.py`` (``auto_cast``,
``decorate``, ``GradScaler``) and of the cast rule in
``paddle_tpu/ops/registry.py:89-114``.

The cast rule. Under ``auto_cast(level="O1")`` an op on the white list
casts every floating input to the low dtype (bf16 by default), an op on
the black list casts them to float32, and any other op runs in its
inputs' dtype. Under ``level="O2"`` every op casts its floating inputs to
the low dtype except the black-listed ones (float32); ``cast`` and
``assign`` are exempt at both levels. The lists are the reference's own.
The port has no op registry: its functional ops call :func:`cast_inputs`
with the reference's op name (``linear_op``, ``matmul_v2``,
``flash_attention``, ``elementwise_add``, ``layer_norm_op``,
``embedding_op``, ``dropout_op``, ``gelu_op``, ``softmax_with_cross_entropy``,
...), so each op sees the dtypes the reference's registry gives it.

``torch.autocast`` is not used: its lists differ from the reference's
(it returns ``layer_norm`` in float32, where the reference keeps the
input dtype with float32 statistics, ``nn/functional/norm.py:90-105``),
so the dtypes at op boundaries would differ.

The state is the process's, as the reference's tracer state is; the
context manager restores it on exit. :func:`snapshot` and
:func:`restored` let a recompute replay run under the state its forward
saw (``distributed/utils_recompute.py``).

:func:`decorate` (``:69-83``) casts every floating parameter of the
models to the low dtype once, at O2 (pure low-precision training: no
master weights; the eager optimizers update in float32 and cast back).

:class:`GradScaler` (``:87-277``) is the dynamic loss-scale state
machine: ``scale``, ``unscale_`` (at most once per optimizer and step),
``step``, ``minimize``, ``update``; ``incr_every_n_steps`` good steps
multiply the scale by ``incr_ratio``, ``decr_every_n_nan_or_inf``
found-inf steps in a row multiply it by ``decr_ratio`` (never below
1.0). The unscale and the finite check are one device pass: one
``torch._foreach_mul_`` over the gradients and one found-inf scalar from
one launch of the ``tensor_health`` kernel (its NaN and Inf counts; the
plain version on the CPU), OR-ed across optimizers on the device; the
one host sync is in :meth:`GradScaler.update` (and in :meth:`step`,
which must know whether to step). The telemetry is the reference's: the
``amp_loss_scale{scaler=}`` gauge and the ``amp_found_inf_total``
counter on the port's metrics registry, and a bounded scale history in
``state_dict()``.

Arguments the reference accepts and ignores are refused when set to
anything but their default (``decorate(master_weight=, save_dtype=)``,
ROADMAP caveat 17).
"""
from __future__ import annotations

import collections
import contextlib

import torch

__all__ = ["WHITE_LIST", "BLACK_LIST", "auto_cast", "amp_guard",
           "cast_inputs", "autocast_dtype", "snapshot", "restored",
           "decorate", "amp_decorate", "GradScaler", "AmpScaler"]

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
_EXEMPT = ("cast", "assign")


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


def _low(dtype):
    if dtype not in _DTYPES:
        raise ValueError(f"unsupported autocast dtype {dtype!r}")
    return _DTYPES[dtype]


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16"):
    snap = snapshot()
    if enable:
        if level not in ("O0", "O1", "O2"):
            raise ValueError(f"unknown AMP level {level!r}")
        _low(dtype)
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


amp_guard = auto_cast


def autocast_dtype():
    """The low dtype under ``O1``/``O2`` autocast, else ``None``: for an
    op on neither list that casts its operands itself, as the reference's
    ``fused_linear_cross_entropy`` reads the tracer's AMP level and dtype
    (``nn/functional/loss.py:167-169``)."""
    if _state.level in ("O1", "O2"):
        return _DTYPES[_state.dtype]
    return None


def cast_target(op_name):
    """The dtype op ``op_name``'s floating inputs are cast to under the
    current autocast state, or ``None`` where they keep theirs."""
    if _state.level not in ("O1", "O2") or op_name in _EXEMPT:
        return None
    if op_name in _state.black:
        return torch.float32
    if _state.level == "O2" or op_name in _state.white:
        return _DTYPES[_state.dtype]
    return None


def cast_inputs(op_name, *args):
    """``args`` as op ``op_name`` sees them under the current autocast
    state: floating tensors cast per the rule, anything else as is."""
    target = cast_target(op_name)
    if target is None:
        return args
    return tuple(a.to(target) if isinstance(a, torch.Tensor)
                 and a.is_floating_point() and a.dtype != target else a
                 for a in args)


# -- decorate (amp/__init__.py:69-83) -----------------------------------------

def decorate(models, optimizers=None, level="O1", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """At ``level="O2"``, cast every floating parameter of ``models`` (a
    module or a list of them) to ``dtype`` once, in place (the same
    ``Parameter`` objects, so an optimizer built over them keeps them).
    Returns ``models``, or ``(models, optimizers)`` when optimizers are
    given. ``master_weight`` and ``save_dtype`` are refused when set: the
    reference accepts and ignores them."""
    if master_weight is not None:
        raise NotImplementedError(
            "decorate(master_weight=...) is accepted and ignored by the "
            "reference; paddle_tpu_torch refuses it (ROADMAP caveat 17)")
    if save_dtype is not None:
        raise NotImplementedError(
            "decorate(save_dtype=...) is accepted and ignored by the "
            "reference; paddle_tpu_torch refuses it (ROADMAP caveat 17)")
    if level == "O2":
        low = _low(dtype)
        items = models if isinstance(models, (list, tuple)) else [models]
        with torch.no_grad():
            for m in items:
                for p in m.parameters():
                    if p.is_floating_point():
                        p.data = p.data.to(low)
    if optimizers is None:
        return models
    return models, optimizers


amp_decorate = decorate


# -- GradScaler (amp/__init__.py:87-277) --------------------------------------

def _found_inf(grads):
    """A 0-d bool tensor on the gradients' device: True when any holds a
    NaN or an Inf (one ``tensor_health`` launch over the list)."""
    from ..kernels.tensor_health import tensor_health
    st = tensor_health(list(grads))
    return (st["nan"].sum() + st["inf"].sum()) > 0


class GradScaler:
    """Dynamic loss scaling (reference ``GradScaler``; ``AmpScaler`` is
    the same class)."""

    _scaler_ids = iter(range(1 << 62))  # "scaler" label for the gauge

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15,
                 incr_ratio=2.0, decr_ratio=0.5, incr_every_n_steps=1000,
                 decr_every_n_nan_or_inf=2, use_dynamic_loss_scaling=True,
                 registry=None):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        # a Python bool, or a 0-d bool tensor on the device once an
        # unscale ran (OR-ed across optimizers; read in step()/update())
        self._found_inf = False
        # at most one unscale per optimizer per step; cleared in update()
        self._unscaled_ids = set()
        self._registry = registry
        self._update_idx = 0
        self._scale_history = collections.deque(maxlen=64)
        self._scale_history.append((0, self._scale))
        self._g_scale = self._m_found = None
        self._scaler_id = str(next(GradScaler._scaler_ids))
        if enable:
            self._bind_metrics()

    def _bind_metrics(self):
        """Lazy registry binding — never raises (telemetry must not
        take down a training loop)."""
        if self._g_scale is not None or self._registry is False:
            return
        try:
            from ..observability import get_registry
            reg = self._registry if self._registry is not None \
                else get_registry()
            self._g_scale = reg.gauge(
                "amp_loss_scale", "current dynamic loss scale",
                labels=("scaler",))
            self._m_found = reg.counter(
                "amp_found_inf_total",
                "unscale passes that found a nonfinite gradient")
            self._m_found.inc(0)  # the family exists on an all-finite run
            self._g_scale.labels(scaler=self._scaler_id).set(self._scale)
        except Exception:
            self._g_scale = self._m_found = None

    def close(self):
        """Retire this scaler's ``amp_loss_scale{scaler=}`` series (the
        shared ``amp_found_inf_total`` keeps its total). Safe to call more
        than once; the scaler stays usable but stops publishing."""
        if self._g_scale is not None:
            try:
                self._g_scale.remove(scaler=self._scaler_id)
            except Exception:
                pass
        self._g_scale = self._m_found = None
        self._registry = False  # _bind_metrics stays off

    def notify_found_inf(self):
        """An external found-inf (the train step's numerics pass saw a
        nonfinite gradient where ``unscale_`` never runs): the next
        ``update()`` reacts as to a found-inf step."""
        self._found_inf = True

    def scale(self, var):
        """``var * scale`` (the reference's ``scale`` op: under O2 it
        casts its input to the low dtype first)."""
        if not self._enable:
            return var
        (var,) = cast_inputs("scale", var)
        return var * self._scale

    def unscale_(self, optimizer):
        """Divide the gradients of ``optimizer``'s parameters by the scale
        in place (in float32, rounded back to each gradient's dtype) and
        OR whether any is nonfinite into the step's found-inf, on the
        device. A second call for the same optimizer before ``update()``
        does nothing."""
        if not self._enable or id(optimizer) in self._unscaled_ids:
            return
        self._unscaled_ids.add(id(optimizer))
        grads = [p.grad for p in optimizer._params() if p.grad is not None]
        if not grads:
            return
        with torch.no_grad():
            torch._foreach_mul_(grads, 1.0 / self._scale)
            found = _found_inf(grads)
        if isinstance(self._found_inf, torch.Tensor):
            found = found | self._found_inf.to(found.device)
        elif self._found_inf:
            found = torch.ones_like(found)
        self._found_inf = found

    def step(self, optimizer):
        if not self._enable:
            optimizer.step()
            return
        self.unscale_(optimizer)
        if not bool(self._found_inf):
            optimizer.step()

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        self._unscaled_ids.clear()
        if not self._enable:
            return
        self._update_idx += 1
        found = bool(self._found_inf)  # the one host sync of a step
        old_scale = self._scale
        if self._dynamic:
            if found:
                self._bad_steps += 1
                self._good_steps = 0
                if self._bad_steps >= self._decr_every_n:
                    self._scale = max(self._scale * self._decr_ratio, 1.0)
                    self._bad_steps = 0
            else:
                self._good_steps += 1
                self._bad_steps = 0
                if self._good_steps >= self._incr_every_n_steps:
                    self._scale *= self._incr_ratio
                    self._good_steps = 0
        self._found_inf = False
        self._bind_metrics()
        if found and self._m_found is not None:
            self._m_found.inc()
        if self._g_scale is not None:
            self._g_scale.labels(scaler=self._scaler_id).set(self._scale)
        if self._scale != old_scale:
            self._scale_history.append((self._update_idx, self._scale))

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_init_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale = float(v)

    def state_dict(self):
        return {"scale": self._scale, "incr_ratio": self._incr_ratio,
                "decr_ratio": self._decr_ratio,
                "good_steps": self._good_steps, "bad_steps": self._bad_steps,
                "scale_history": [list(t) for t in self._scale_history]}

    def load_state_dict(self, sd):
        self._scale = sd.get("scale", self._scale)
        self._good_steps = sd.get("good_steps", 0)
        self._bad_steps = sd.get("bad_steps", 0)
        hist = sd.get("scale_history")
        if hist:
            self._scale_history.clear()
            self._scale_history.extend(tuple(t) for t in hist)
            self._update_idx = int(hist[-1][0])


AmpScaler = GradScaler
