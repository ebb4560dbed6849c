"""Batch norm — port of ``paddle_tpu/nn/functional/norm.py``
(``batch_norm`` ``:56-81``, the train op ``:37-53``, the inference op
``:17-34`` and ``_ema_assign`` ``:84-87``).

The reference's conventions, which are not torch's:

- ``use_global_stats=None`` means "not training": the running
  statistics normalise when it is true, the batch's otherwise, whatever
  ``training`` says.
- The running statistics move as ``old * momentum + batch * (1 -
  momentum)`` with ``momentum=0.9``: the old value carries the weight
  (torch's ``momentum=0.1`` weights the new one).
- The running variance takes the **biased** batch variance (``jnp.var``);
  torch's running update takes the unbiased one, ``n / (n - 1)`` larger,
  2x with two values a channel.
- Statistics and affine run in float32 and the output keeps ``x``'s
  dtype (bf16 after a white-listed conv under O1); the op is on neither
  autocast list, and the running statistics stay float32.

So the port calls ``torch.native_batch_norm`` without running statistics
(it normalises with the batch's, computes in float32 for a bf16 ``x``
with float32 weight and bias, and differentiates through the batch
mean and variance) and makes the running update itself, in place under
``no_grad``. The batch variance comes back from the op's saved inverse
deviation, ``var = invstd^-2 - eps`` (clamped at 0), not from a second
reduction: a second pass would read the activation once more (and first
copy a bf16 one to float32). Its relative error stays near float32's
rounding while ``var`` is not far below ``eps`` (1e-5); a channel whose
values are all equal reads ~1e-12 instead of 0. Channels-last formats
(``NHWC``, ``NLC``) move the channel axis to 1 as a view and back.
"""
from __future__ import annotations

import torch

__all__ = ["batch_norm"]


def _channel_view(x, data_format):
    """``(x with its channels on axis 1, channel_last)``."""
    channel_last = not data_format.startswith("NC") and x.dim() > 1
    return (x.movedim(-1, 1) if channel_last else x), channel_last


@torch.no_grad()
def _ema_assign(running, batch, momentum):
    running.copy_(running * momentum + batch.to(running.dtype)
                  * (1.0 - momentum))


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-05,
               data_format="NCHW", use_global_stats=None):
    if use_global_stats is None:
        use_global_stats = not training
    xc, channel_last = _channel_view(x, data_format)
    eps = float(epsilon)
    if use_global_stats:
        out = torch.native_batch_norm(xc, weight, bias, running_mean,
                                      running_var, False, 0.0, eps)[0]
    else:
        out, mean, invstd = torch.native_batch_norm(
            xc, weight, bias, None, None, True, 0.0, eps)
        if running_mean is not None:
            with torch.no_grad():
                var = (invstd.detach().float().pow(-2) - eps).clamp_(min=0)
                _ema_assign(running_mean, mean.detach(), float(momentum))
                _ema_assign(running_var, var, float(momentum))
    return out.movedim(1, -1) if channel_last else out
