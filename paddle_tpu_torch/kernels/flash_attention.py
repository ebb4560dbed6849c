"""Flash attention, forward and backward — port of
``paddle_tpu/kernels/flash_attention_pallas.py`` (the six Pallas kernel
bodies) and of its router ``paddle_tpu/kernels/flash_attention.py``.

Exact softmax attention over ``[B, L, H, D]`` tensors (the reference's
layout, ``flash_attention_pallas.py:511``), optionally causal, with the
reference's ``custom_vjp`` contract (``:427-508``): the forward saves
``(q, k, v, out, lse)`` with ``lse`` in float32 as ``[B*H, Lq]`` in the
scaled domain (``m + log l``, ``:88-91``); the backward computes
``delta = rowsum(dO * O)`` in float32 (``:452``) and then dq, and dk/dv,
from ``P = exp(S * scale - lse)`` and ``dS = P * (dP - delta)``.

Masking, for every shape (the Pallas wrapper refuses unaligned lengths
and causal ``Lq != Lk``, and the reference then answers through
``_sdpa_reference``; this module answers them itself, the same way):

- the ragged tail: columns ``>= Lk`` take no part;
- causal aligns bottom-right: row ``i`` sees columns ``<= i + Lk - Lq``;
- a causal row that sees no column (``i + Lk - Lq < 0``, only when
  ``Lq > Lk``) is what ``_sdpa_reference``'s ``-1e30`` mask makes of it:
  uniform weights over all ``Lk`` columns (the mean of V), with no
  gradient to q or k. Here its scores count as 0, so its ``lse`` is
  ``log Lk`` and the backward's ``P`` is ``1 / Lk``.

Pieces:

- plain PyTorch versions: :func:`flash_attention_fwd_ref` -> ``(out,
  lse)``; :func:`flash_attention_bwd_dq_ref`,
  :func:`flash_attention_bwd_dkv_ref` (given ``delta``); and
  :func:`flash_attention_bwd_ref`, ``(q, k, v, out, lse, do)`` ->
  ``(dq, dk, dv)``;
- the wrappers :func:`flash_attention_fwd`, :func:`flash_attention_bwd_dq`
  and :func:`flash_attention_bwd_dkv`: a CPU tensor runs the plain
  version; a CUDA tensor launches the hand-written kernel of
  ``csrc/flash_attention.cu`` or raises (no fallback). Each kernel has
  its launch counter (``fwd_launches``, ``dq_launches``,
  ``dkv_launches``; :func:`reset_launches`);
- two designs of each kernel: the wgmma/TMA one for bfloat16 with
  16-byte aligned tensors at ``D`` = 64 or 128 (forward) and ``D`` = 64
  (dq and dk/dv; at 128 dk/dv's accumulators overflow the registers) —
  every GPT-2 and BERT-base shape — and the CUDA-core one for the rest
  (float32, whose 1e-4 parity TF32 tensor cores would break, float16,
  which the wgmma/TMA designs do not take, and other head sizes).
  :func:`hopper_fwd` (forward) and :func:`hopper_bwd` (dq
  and dk/dv) are the predicates that pick, by dtype, shape and alignment
  alone; ``fwd_launches``,
  ``dq_launches`` and ``dkv_launches`` count both designs and
  ``fwd_hopper_launches``, ``dq_hopper_launches`` and
  ``dkv_hopper_launches`` the wgmma/TMA ones;
- :func:`flash_attention`, the differentiable entry, through the
  ``torch.autograd.Function`` :class:`FlashAttention`;
- :func:`use_plain`, a context manager that makes the wrappers take the
  plain versions on CUDA too. It is for comparisons (``chip_smoke.py``,
  the card tests); nothing on the main path enters it.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from ._build import launch_context

__all__ = ["flash_attention", "FlashAttention", "flash_attention_fwd",
           "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
           "flash_attention_fwd_ref", "flash_attention_bwd_dq_ref",
           "flash_attention_bwd_dkv_ref", "flash_attention_bwd_ref",
           "attention_delta", "use_plain", "reset_launches", "hopper_fwd",
           "hopper_bwd"]

fwd_launches = 0      # kernel launches since the last reset_launches()
fwd_hopper_launches = 0   # of those, the wgmma/TMA forward's
dq_launches = 0
dq_hopper_launches = 0    # of those, the wgmma/TMA dq's
dkv_launches = 0
dkv_hopper_launches = 0   # of those, the wgmma/TMA dk/dv's

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128          # the kernels' shared-memory plans cover D <= 128
_MAX_GRID_Y = 65535   # q (or k) tiles of 64 rows ride on grid.y
_plain = False        # set only inside use_plain()

# every pointer and the stream as c_void_p, or ctypes would pass a
# 32-bit int and cut the address; the ints are B, H, Lq, Lk, D
_DIMS = [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# flash_attention_forward(dtype, q, k, v, out, lse, B, H, Lq, Lk, D,
#   scale, causal, stream), and flash_attention_forward_hopper alike
FWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 5 + _DIMS
# flash_attention_backward_dq(dtype, q, k, v, dout, lse, delta, dq, ...),
# and flash_attention_backward_dq_hopper alike
DQ_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 7 + _DIMS
# flash_attention_backward_dkv(dtype, q, k, v, dout, lse, delta, dk, dv,
#   ...), and flash_attention_backward_dkv_hopper alike
DKV_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + _DIMS
_HOPPER_D = (64, 128)  # the wgmma forward's 64-column, 128-byte boxes
_HOPPER_BWD_D = 64     # the wgmma backward's (dk/dv at 128 would spill)
_fns = {}


def reset_launches():
    global fwd_launches, fwd_hopper_launches, dq_launches, dkv_launches, \
        dq_hopper_launches, dkv_hopper_launches
    fwd_launches = fwd_hopper_launches = dq_launches = dkv_launches = 0
    dq_hopper_launches = dkv_hopper_launches = 0


def hopper_fwd(q, k, v):
    """True when the forward of these tensors takes the wgmma/TMA kernel:
    bfloat16, head size 64 or 128, and q, k, v 16-byte aligned (so is the
    output, a fresh tensor). Everything else takes the CUDA-core kernel."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in _HOPPER_D
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def hopper_bwd(q, k, v, do):
    """True when dq and dk/dv of these tensors take the wgmma/TMA kernels:
    bfloat16, head size 64, and q, k, v, do 16-byte aligned (so are the
    outputs, fresh tensors). Everything else, head size 128 included,
    takes the CUDA-core kernels."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] == _HOPPER_BWD_D
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v, do)))


@contextlib.contextmanager
def use_plain():
    """Inside, the wrappers run the plain versions on CUDA tensors too
    (for kernel-vs-plain comparisons; no kernel launches, no counts)."""
    global _plain
    prev, _plain = _plain, True
    try:
        yield
    finally:
        _plain = prev


def _default_scale(q, scale):
    return 1.0 / math.sqrt(q.shape[-1]) if scale is None else float(scale)


# -- plain versions -------------------------------------------------------------

def _scores(q, k, causal, scale):
    """Scaled scores ``[B, H, Lq, Lk]`` in float32 under the module's
    masking rule, and the mask of entries that carry gradient."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if not causal:
        return s, None
    lq, lk = q.shape[1], k.shape[1]
    i = torch.arange(lq, device=q.device)[:, None]
    j = torch.arange(lk, device=q.device)[None, :]
    live = j <= i + (lk - lq)
    dead = (i + (lk - lq) < 0).expand(lq, lk)  # rows that see nothing
    s = torch.where(live, s, torch.where(dead, torch.zeros((), device=s.device),
                                         torch.full((), -math.inf,
                                                    device=s.device)))
    return s, live


def _lse_bhl(lse, q):
    B, Lq, H, _ = q.shape
    return lse.reshape(B, H, Lq)


def flash_attention_fwd_ref(q, k, v, causal=False, scale=None):
    """Plain forward: ``(out [B, Lq, H, D] in q's dtype, lse [B*H, Lq]
    float32)``. A row with no column at all (``Lk == 0``) gives zeros
    and ``lse = -inf``."""
    scale = _default_scale(q, scale)
    B, Lq, H, D = q.shape
    s, _ = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)                          # [B, H, Lq]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse.reshape(B * H, Lq).contiguous()


def attention_delta(out, do):
    """``delta = rowsum(dO * O)`` in float32, as ``[B*H, Lq]``."""
    B, Lq, H, _ = out.shape
    d = (do.float() * out.float()).sum(-1)                    # [B, Lq, H]
    return d.transpose(1, 2).reshape(B * H, Lq).contiguous()


def _probs_and_ds(q, k, v, do, lse, delta, causal, scale):
    s, live = _scores(q, k, causal, scale)
    p = torch.exp(s - _lse_bhl(lse, q)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - _lse_bhl(delta, q)[..., None]) * scale
    if live is not None:
        ds = torch.where(live, ds, torch.zeros((), device=ds.device))
    return p, ds


def flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal=False,
                               scale=None):
    """Plain dq ``[B, Lq, H, D]`` in q's dtype."""
    scale = _default_scale(q, scale)
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal=False,
                                scale=None):
    """Plain ``(dk, dv)``, each ``[B, Lk, H, D]`` in k's / v's dtype."""
    scale = _default_scale(q, scale)
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_ref(q, k, v, out, lse, do, causal=False,
                            scale=None):
    """Plain backward by the lse formula: ``(dq, dk, dv)``."""
    delta = attention_delta(out, do)
    dq = flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)
    dk, dv = flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                         scale)
    return dq, dk, dv


# -- the CUDA kernels -----------------------------------------------------------

def _kernel_fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load
        fn = getattr(load("flash_attention"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, **more):
    dev = q.device
    named = dict(q=q, k=k, v=v, **more)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype} (float32, "
                        "bfloat16 or float16)")
    for name in ("k", "v", "do"):
        if name in named and named[name].dtype != q.dtype:
            raise TypeError(f"{name} is {named[name].dtype}, q {q.dtype}")
    for name in ("lse", "delta"):
        if name in named and named[name].dtype != torch.float32:
            raise TypeError(f"{name} must be float32")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError("q, k, v must be [B, L, H, D] with k and v alike")
    B, Lq, H, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, H, D):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if "do" in named and named["do"].shape != q.shape:
        raise ValueError("do must have q's shape")
    for name in ("lse", "delta"):
        if name in named and named[name].shape != (B * H, Lq):
            raise ValueError(f"{name} must be [B*H, Lq] = [{B * H}, {Lq}]")
    if D > _MAX_D:
        raise ValueError(f"head_dim {D} > {_MAX_D}")
    if max(Lq, k.shape[1]) > 64 * _MAX_GRID_Y:
        raise ValueError("sequence too long for the kernels' grid")


def _dims(q, k, scale, causal):
    B, Lq, H, D = q.shape
    return (B, H, Lq, k.shape[1], D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_if(rc, what):
    if rc != 0:
        raise RuntimeError(f"flash_attention {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _launch_fwd(q, k, v, causal, scale):
    global fwd_launches, fwd_hopper_launches
    _check(q, k, v)
    B, Lq, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, Lq, dtype=torch.float32, device=q.device)
    if out.numel() == 0 or k.shape[1] == 0:
        return out.zero_(), lse.fill_(-math.inf)
    hopper = hopper_fwd(q, k, v)
    fn = _kernel_fn("flash_attention_forward_hopper" if hopper
                    else "flash_attention_forward", FWD_ARGTYPES)
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(),
                *_dims(q, k, scale, causal))
    _raise_if(rc, "wgmma forward" if hopper else "forward")
    fwd_launches += 1
    fwd_hopper_launches += hopper
    return out, lse


def _launch_dq(q, k, v, do, lse, delta, causal, scale):
    global dq_launches, dq_hopper_launches
    _check(q, k, v, do=do, lse=lse, delta=delta)
    dq = torch.empty_like(q)
    if dq.numel() == 0 or k.shape[1] == 0:
        return dq.zero_()
    hopper = hopper_bwd(q, k, v, do)
    fn = _kernel_fn("flash_attention_backward_dq_hopper" if hopper
                    else "flash_attention_backward_dq", DQ_ARGTYPES)
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *_dims(q, k, scale, causal))
    _raise_if(rc, "wgmma backward dq" if hopper else "backward dq")
    dq_launches += 1
    dq_hopper_launches += hopper
    return dq


def _launch_dkv(q, k, v, do, lse, delta, causal, scale):
    global dkv_launches, dkv_hopper_launches
    _check(q, k, v, do=do, lse=lse, delta=delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0 or q.shape[1] == 0:
        return dk.zero_(), dv.zero_()
    hopper = hopper_bwd(q, k, v, do)
    fn = _kernel_fn("flash_attention_backward_dkv_hopper" if hopper
                    else "flash_attention_backward_dkv", DKV_ARGTYPES)
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_dims(q, k, scale, causal))
    _raise_if(rc, "wgmma backward dk/dv" if hopper else "backward dk/dv")
    dkv_launches += 1
    dkv_hopper_launches += hopper
    return dk, dv


def _on_kernel(q):
    """True for a CUDA tensor outside use_plain(); False for a CPU one."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return not _plain


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Forward ``(out, lse)``; see :func:`flash_attention_fwd_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_fwd(q, k, v, causal, scale)
    return flash_attention_fwd_ref(q, k, v, causal, scale)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal=False,
                           scale=None):
    """dq; see :func:`flash_attention_bwd_dq_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_dq(q, k, v, do, lse, delta, causal, scale)
    return flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, causal, scale)


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal=False,
                            scale=None):
    """``(dk, dv)``; see :func:`flash_attention_bwd_dkv_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_dkv(q, k, v, do, lse, delta, causal, scale)
    return flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta, causal,
                                       scale)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's custom VJP: the forward
    keeps ``(q, k, v, out, lse)``; the backward runs the dq and the
    dk/dv kernels (no atomics, so it is deterministic)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_attention_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(out, do)
        dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, ctx.causal,
                                    ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, scale=None):
    """q ``[B, Lq, H, D]``, k and v ``[B, Lk, H, D]`` -> ``[B, Lq, H,
    D]``, differentiable in q, k and v."""
    return FlashAttention.apply(q, k, v, bool(causal),
                                _default_scale(q, scale))
