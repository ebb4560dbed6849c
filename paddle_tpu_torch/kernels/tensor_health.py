"""Tensor health statistics over a list of tensors — the port's
counterpart of the reduction the reference fuses into its compiled train
step (``paddle_tpu/observability/numerics.py:66-98``, ``tensor_stats``
and ``stats_tree``). No Pallas kernel computes it: XLA fuses the
reference's five reductions into one pass a tensor, and an eager
PyTorch step has no such fusion, so the port adds one hand kernel.

For each tensor, after widening every element to float32:

- ``nan``, ``inf`` — int32 counts of NaN and of +-Inf;
- ``absmax`` — float32 max ``|x|``, NaN when the tensor holds a NaN (the
  reference's ``jnp.max`` propagates it), 0 for an empty tensor;
- ``sq_sum`` — float32 sum of ``x * x``;
- ``zero_frac`` — the exact-zero fraction, the exact count divided by
  ``numel`` in float64 and rounded once to float32 (the reference's
  float32 mean may differ in the last bit), NaN for an empty tensor (the
  mean of nothing). The reference refuses empty tensors (``jnp.max`` of
  nothing raises); the port defines them so.

- :func:`tensor_stats_ref` / :func:`tensor_health_ref` — the plain
  PyTorch version, one tensor / a list (stacked ``[n]`` per stat).
- :func:`tensor_health` — the dispatcher: CPU tensors go to the plain
  version; CUDA tensors launch ``csrc/tensor_health.cu`` (one launch pair
  for up to 160 tensors; float32, bfloat16 and float16, contiguous) or
  raise.
  There is no fallback.

The module attribute ``launches`` counts kernel launches (one a launch
pair; :func:`reset_launches` zeroes it), so a run can show that its
path went through the kernel. Nothing here syncs with the host.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import launch_context

__all__ = ["STAT_NAMES", "tensor_stats_ref", "tensor_health_ref",
           "tensor_health", "reset_launches"]

#: the per-tensor statistics, in the reference's order
STAT_NAMES = ("nan", "inf", "absmax", "sq_sum", "zero_frac")

launches = 0          # launch pairs since reset_launches()

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_TENSORS = 160    # csrc/tensor_health.cu kMaxTensors
_CHUNK = 8192         # csrc/tensor_health.cu kChunk
# tensor_health(ptrs, numels, dtypes, n, p_cnt, p_f, total, out_nan,
#   out_inf, out_absmax, out_sq, out_zero_frac, stream): the three host
#   tables and every device pointer as c_void_p
ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int]
            + [ctypes.c_void_p] * 6)
_fn = None


def reset_launches():
    global launches
    launches = 0


def tensor_stats_ref(t):
    """One tensor's statistics as a dict of 0-d tensors on its device
    (the plain version)."""
    x = t.detach().float()
    n = x.numel()
    nan = torch.isnan(x).sum(dtype=torch.int64).to(torch.int32)
    inf = torch.isinf(x).sum(dtype=torch.int64).to(torch.int32)
    if n == 0:
        absmax = torch.zeros((), device=x.device)
    else:
        absmax = x.abs().max()            # propagates NaN
    sq = x.square().sum()
    zeros = (x == 0).sum(dtype=torch.int64)
    zero_frac = (zeros.double() / n).float() if n else \
        torch.full((), float("nan"), device=x.device)
    return {"nan": nan, "inf": inf, "absmax": absmax, "sq_sum": sq,
            "zero_frac": zero_frac}


def tensor_health_ref(tensors):
    """The plain version over a list: ``{stat: [n]}``."""
    per = [tensor_stats_ref(t) for t in tensors]
    if not per:
        return _empty(torch.device("cpu"))
    return {s: torch.stack([p[s] for p in per]) for s in STAT_NAMES}


def _empty(dev):
    return {"nan": torch.zeros(0, dtype=torch.int32, device=dev),
            "inf": torch.zeros(0, dtype=torch.int32, device=dev),
            "absmax": torch.zeros(0, device=dev),
            "sq_sum": torch.zeros(0, device=dev),
            "zero_frac": torch.zeros(0, device=dev)}


def _kernel_fn():
    global _fn
    if _fn is None:
        from ._build import load
        fn = load("tensor_health").tensor_health
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(tensors, dev):
    for i, t in enumerate(tensors):
        if t.device != dev:
            raise ValueError(f"tensor {i} is on {t.device}, tensor 0 on "
                             f"{dev}")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"tensor {i}: unsupported dtype {t.dtype} "
                            "(float32, bfloat16 or float16)")
        if not t.is_contiguous():
            raise ValueError(f"tensor {i} must be contiguous")


def _launch(tensors, dev):
    global launches
    _check(tensors, dev)
    n = len(tensors)
    cnt = torch.empty((2, n), dtype=torch.int32, device=dev)
    f = torch.empty((3, n), dtype=torch.float32, device=dev)
    fn = _kernel_fn()
    with launch_context(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for g0 in range(0, n, _MAX_TENSORS):
            group = tensors[g0:g0 + _MAX_TENSORS]
            k = len(group)
            numels = [t.numel() for t in group]
            total = sum(-(-m // _CHUNK) for m in numels)
            p_cnt = torch.empty(3 * total, dtype=torch.int32, device=dev)
            p_f = torch.empty(2 * total, dtype=torch.float32, device=dev)
            ptrs = (ctypes.c_void_p * k)(*[t.data_ptr() for t in group])
            nums = (ctypes.c_longlong * k)(*numels)
            codes = (ctypes.c_int * k)(*[_DTYPE_CODE[t.dtype]
                                         for t in group])

            def at(t, row):
                return t[row, g0:].data_ptr()
            rc = fn(ptrs, nums, codes, k,
                    p_cnt.data_ptr() if total else None,
                    p_f.data_ptr() if total else None, total,
                    at(cnt, 0), at(cnt, 1), at(f, 0), at(f, 1), at(f, 2),
                    stream)
            if rc != 0:
                raise RuntimeError(f"tensor_health kernel launch failed: "
                                   f"CUDA error {rc}")
            launches += 1
    return {"nan": cnt[0], "inf": cnt[1], "absmax": f[0], "sq_sum": f[1],
            "zero_frac": f[2]}


def tensor_health(tensors):
    """``{stat: [n]}`` for the list ``tensors`` (see the module
    docstring). CPU tensors run the plain version; CUDA tensors launch
    the CUDA kernel, building it on first use, or raise."""
    tensors = list(tensors)
    if not tensors:
        return _empty(torch.device("cpu"))
    dev = tensors[0].device
    if dev.type == "cpu":
        return tensor_health_ref(tensors)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _launch(tensors, dev)
