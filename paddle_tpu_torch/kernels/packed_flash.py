"""Packed (segment-id) flash attention, forward and backward — port of
``paddle_tpu/kernels/packed_flash_pallas.py`` (``_fwd_kernel`` ``:55``,
``_bwd_dq_kernel`` ``:96``, ``_bwd_dkv_kernel`` ``:132``, the wrapper
``:293``, ``SegmentIds`` ``:320`` and ``segment_relative_positions``
``:341``).

Several sequences packed into one row: ``q``, ``k``, ``v`` ``[B, L, H,
D]`` and integer ``segment_ids [B, L]``; a token attends only to tokens
with its own id and, with ``causal``, to columns at or before its own.
The reference's arithmetic (``_seg_causal_mask``, ``:41-52``):

- masked scores are ``-1e30``, not ``-inf``; softmax statistics are in
  float32 and ``lse = m + log l`` (``l == 0 -> 1``, ``:91-93``) is kept
  as ``[B*H, L]`` float32;
- the forward scales q in its own dtype before the product (``:59``);
  the backward takes q in float32 and scales the product (``:114-116``);
- ``delta = rowsum(dO * O)`` in float32 is computed outside the kernels
  (``:281-283``; :func:`~.flash_attention.attention_delta`), then
  ``P = exp(S - lse)``, ``dS = P * (dP - delta) * scale``.

The reference's wrapper refuses ``L > 2048`` and lengths that are not a
multiple of 128 (``:302-307``), and its caller then answers through a
dense ``[L, L]`` mask (``nn/functional/attention.py:62-74``). The port's
kernels take every L and every ``D <= 128`` and raise on anything else;
there is no fallback.

Pieces:

- :class:`SegmentIds` and :func:`segment_relative_positions`, the packing
  contract BERT reads;
- plain PyTorch versions: :func:`packed_flash_fwd_ref` -> ``(out, lse)``,
  :func:`packed_flash_bwd_dq_ref` and :func:`packed_flash_bwd_dkv_ref`
  (given ``delta``);
- the wrappers :func:`packed_flash_fwd`, :func:`packed_flash_bwd_dq` and
  :func:`packed_flash_bwd_dkv`: a CPU tensor runs the plain version; a
  CUDA tensor launches the hand-written kernel of ``csrc/packed_flash.cu``
  or raises. Each kernel has its launch counter (``fwd_launches``,
  ``dq_launches``, ``dkv_launches``; :func:`reset_launches`);
- two designs of the forward: the wgmma/TMA one
  (``packed_flash_fwd_hopper_kernel``, the flash forward's body with
  segment ids) for bfloat16 at ``D`` = 64 or 128, 16-byte aligned q, k,
  v and ``L <= 16384`` — every BERT shape — and the CUDA-core one for the
  rest (float32, whose 1e-4 parity TF32 tensor cores would break,
  float16, which the wgmma/TMA designs do not take, other head sizes,
  longer rows). :func:`hopper_fwd` is the predicate that
  picks, by dtype, shape and alignment alone; ``fwd_launches`` counts
  both designs and ``fwd_hopper_launches`` the wgmma/TMA one;
- two designs of dq and of dk/dv: the wgmma/TMA ones
  (``packed_flash_dq_hopper_kernel`` and ``packed_flash_dkv_hopper_kernel``,
  the flash backward's bodies with segment ids) for bfloat16 at ``D`` =
  64, ``L <= 16384`` and 16-byte aligned q, k, v, do — every BERT shape —
  and the CUDA-core ones for the rest (float32, float16, ``D`` = 128,
  whose dk/dv accumulators would spill, other head sizes, longer rows).
  :func:`hopper_bwd` picks; ``dq_launches`` and ``dkv_launches`` count
  both designs and ``dq_hopper_launches`` and ``dkv_hopper_launches`` the
  wgmma/TMA ones;
- :func:`packed_flash_attention`, the differentiable entry, through the
  ``torch.autograd.Function`` :class:`PackedFlashAttention`;
- :func:`use_plain`, a context manager that makes the wrappers take the
  plain versions on CUDA too, for comparisons only.
"""
from __future__ import annotations

import contextlib
import ctypes
import math

import torch

from ._build import launch_context
from .flash_attention import attention_delta
from .flash_attention import hopper_bwd as _flash_hopper_bwd

__all__ = ["SegmentIds", "segment_relative_positions",
           "packed_flash_attention", "PackedFlashAttention",
           "packed_flash_fwd", "packed_flash_bwd_dq", "packed_flash_bwd_dkv",
           "packed_flash_fwd_ref", "packed_flash_bwd_dq_ref",
           "packed_flash_bwd_dkv_ref", "use_plain", "reset_launches",
           "hopper_fwd", "hopper_bwd"]

NEG_INF = -1e30       # the reference's mask value (:34)
fwd_launches = 0      # kernel launches since the last reset_launches()
fwd_hopper_launches = 0   # of those, the wgmma/TMA forward's
dq_launches = 0
dq_hopper_launches = 0    # of those, the wgmma/TMA dq's
dkv_launches = 0
dkv_hopper_launches = 0   # of those, the wgmma/TMA dk/dv's

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_D = 128          # the kernels' shared-memory plans cover D <= 128
_MAX_GRID_Y = 65535   # q (or k) tiles of 64 rows ride on grid.y
_HOPPER_D = (64, 128)  # the wgmma forward's 64-column, 128-byte boxes
_HOPPER_MAX_L = 64 * 256  # their lists of live tiles hold 256 tiles
_plain = False        # set only inside use_plain()

# every pointer and the stream as c_void_p, or ctypes would pass a 32-bit
# int and cut the address; the ints are B, H, L, D
_DIMS = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
# packed_flash_forward(dtype, q, k, v, seg, out, lse, B, H, L, D, scale,
#   causal, stream), and packed_flash_forward_hopper alike
FWD_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 6 + _DIMS
# packed_flash_backward_dq(dtype, q, k, v, seg, dout, lse, delta, dq, ...),
# and packed_flash_backward_dq_hopper alike
DQ_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 8 + _DIMS
# packed_flash_backward_dkv(dtype, q, k, v, seg, dout, lse, delta, dk, dv,
#   ...), and packed_flash_backward_dkv_hopper alike
DKV_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 9 + _DIMS
_fns = {}


class SegmentIds:
    """An attention mask given as packed segment ids ``[B, L]``:
    :func:`~paddle_tpu_torch.nn.functional.scaled_dot_product_attention`
    routes it to the packed kernels instead of a dense ``[L, L]`` mask.

    ``start_positions`` (optional, int ``[B, P]``): each packed segment's
    first token, for models that pool per sequence (BERT's CLS gather).
    ``dense=True`` keeps the packing semantics (reset positions,
    per-segment pooling) but expresses the mask densely, through the
    plain ``_sdpa_reference`` route — the reference's XLA route."""

    def __init__(self, ids, start_positions=None, dense=False):
        self.ids = ids
        self.start_positions = start_positions
        self.dense = dense


def segment_relative_positions(segment_ids):
    """Position ids that restart at each segment boundary: ``pos[i] = i -
    (first index of i's segment)``, for segments contiguous along the
    row. int ``[B, L]`` -> int32 ``[B, L]`` on the ids' device."""
    sid = torch.as_tensor(segment_ids).to(torch.int32)
    b, L = sid.shape
    idx = torch.arange(L, dtype=torch.int32, device=sid.device)[None]
    is_start = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                     device=sid.device),
                          sid[:, 1:] != sid[:, :-1]], dim=1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=1).values
    return idx - start


def reset_launches():
    global fwd_launches, fwd_hopper_launches, dq_launches, dkv_launches, \
        dq_hopper_launches, dkv_hopper_launches
    fwd_launches = fwd_hopper_launches = dq_launches = dkv_launches = 0
    dq_hopper_launches = dkv_hopper_launches = 0


def hopper_fwd(q, k, v, segment_ids):
    """True when the forward of these tensors takes the wgmma/TMA kernel:
    bfloat16, head size 64 or 128, ``L <= 16384`` (the kernel's list of
    live key tiles), and q, k, v 16-byte aligned (so is the output, a
    fresh tensor). Everything else takes the CUDA-core kernel. The ids
    are read with plain loads: any int32 ``[B, L]``."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in _HOPPER_D
            and q.shape[1] <= _HOPPER_MAX_L
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def hopper_bwd(q, k, v, do, segment_ids):
    """True when dq and dk/dv of these tensors take the wgmma/TMA kernels:
    bfloat16, head size 64, ``L <= 16384`` (the kernels' lists of live
    tiles), and q, k, v, do 16-byte aligned (so are the outputs, fresh
    tensors). Everything else, head size 128 included, takes the CUDA-core
    kernels. The ids are read with plain loads: any int32 ``[B, L]``."""
    return q.shape[1] <= _HOPPER_MAX_L and _flash_hopper_bwd(q, k, v, do)


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

def _keep(seg, causal):
    """``[B, 1, L, L]``: entries that take part."""
    keep = seg[:, None, :, None] == seg[:, None, None, :]
    if causal:
        L = seg.shape[1]
        keep = keep & torch.ones(L, L, dtype=torch.bool,
                                 device=seg.device).tril()
    return keep


def _masked(s, seg, causal):
    return torch.where(_keep(seg, causal), s,
                       torch.full((), NEG_INF, device=s.device))


def _bhl(t, q):
    B, L, H, _ = q.shape
    return t.reshape(B, H, L)


def packed_flash_fwd_ref(q, k, v, segment_ids, causal=False, scale=None):
    """Plain forward: ``(out [B, L, H, D] in q's dtype, lse [B*H, L]
    float32)``."""
    scale = _default_scale(q, scale)
    B, L, H, _ = q.shape
    qs = (q.float() * scale).to(q.dtype).float()          # (:59)
    s = _masked(torch.einsum("bqhd,bkhd->bhqk", qs, k.float()),
                segment_ids, causal)
    lse = torch.logsumexp(s, dim=-1)                      # [B, H, L]
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse.reshape(B * H, L).contiguous()


def _probs_and_ds(q, k, v, segment_ids, do, lse, delta, causal, scale):
    s = _masked(torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
                * scale, segment_ids, causal)
    p = torch.exp(s - _bhl(lse, q)[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - _bhl(delta, q)[..., None]) * scale


def packed_flash_bwd_dq_ref(q, k, v, segment_ids, do, lse, delta,
                            causal=False, scale=None):
    """Plain dq ``[B, L, H, D]`` in q's dtype."""
    scale = _default_scale(q, scale)
    _, ds = _probs_and_ds(q, k, v, segment_ids, do, lse, delta, causal,
                          scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def packed_flash_bwd_dkv_ref(q, k, v, segment_ids, do, lse, delta,
                             causal=False, scale=None):
    """Plain ``(dk, dv)``, each ``[B, L, H, D]`` in k's / v's dtype."""
    scale = _default_scale(q, scale)
    p, ds = _probs_and_ds(q, k, v, segment_ids, do, lse, delta, causal,
                          scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


# -- the CUDA kernels -----------------------------------------------------------

def _kernel_fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load
        fn = getattr(load("packed_flash"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k, v, seg, **more):
    dev = q.device
    named = dict(q=q, k=k, v=v, segment_ids=seg, **more)
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
    if seg.dtype != torch.int32:
        raise TypeError(f"segment_ids must be int32, not {seg.dtype}")
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError("q, k, v must be [B, L, H, D] and alike")
    B, L, H, D = q.shape
    if seg.shape != (B, L):
        raise ValueError(f"segment_ids must be [B, L] = [{B}, {L}]")
    if "do" in named and named["do"].shape != q.shape:
        raise ValueError("do must have q's shape")
    for name in ("lse", "delta"):
        if name in named and named[name].shape != (B * H, L):
            raise ValueError(f"{name} must be [B*H, L] = [{B * H}, {L}]")
    if D > _MAX_D:
        raise ValueError(f"head_dim {D} > {_MAX_D}")
    if L > 64 * _MAX_GRID_Y:
        raise ValueError("sequence too long for the kernels' grid")


def _dims(q, scale, causal):
    B, L, H, D = q.shape
    return (B, H, L, D, float(scale), int(bool(causal)),
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_if(rc, what):
    if rc != 0:
        raise RuntimeError(f"packed_flash {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _launch_fwd(q, k, v, seg, causal, scale):
    global fwd_launches, fwd_hopper_launches
    _check(q, k, v, seg)
    hopper = hopper_fwd(q, k, v, seg)
    fn = _kernel_fn("packed_flash_forward_hopper" if hopper
                    else "packed_flash_forward", FWD_ARGTYPES)
    B, L, H, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B * H, L, dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), seg.data_ptr(), out.data_ptr(),
                lse.data_ptr(), *_dims(q, scale, causal))
    _raise_if(rc, "wgmma forward" if hopper else "forward")
    fwd_launches += 1
    fwd_hopper_launches += hopper
    return out, lse


def _launch_dq(q, k, v, seg, do, lse, delta, causal, scale):
    global dq_launches, dq_hopper_launches
    _check(q, k, v, seg, do=do, lse=lse, delta=delta)
    hopper = hopper_bwd(q, k, v, do, seg)
    fn = _kernel_fn("packed_flash_backward_dq_hopper" if hopper
                    else "packed_flash_backward_dq", DQ_ARGTYPES)
    dq = torch.empty_like(q)
    if dq.numel() == 0:
        return dq
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dq.data_ptr(), *_dims(q, scale, causal))
    _raise_if(rc, "wgmma backward dq" if hopper else "backward dq")
    dq_launches += 1
    dq_hopper_launches += hopper
    return dq


def _launch_dkv(q, k, v, seg, do, lse, delta, causal, scale):
    global dkv_launches, dkv_hopper_launches
    _check(q, k, v, seg, do=do, lse=lse, delta=delta)
    hopper = hopper_bwd(q, k, v, do, seg)
    fn = _kernel_fn("packed_flash_backward_dkv_hopper" if hopper
                    else "packed_flash_backward_dkv", DKV_ARGTYPES)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel() == 0:
        return dk, dv
    with launch_context(q.device):
        rc = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
                v.data_ptr(), seg.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                *_dims(q, scale, causal))
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


def packed_flash_fwd(q, k, v, segment_ids, causal=False, scale=None):
    """Forward ``(out, lse)``; see :func:`packed_flash_fwd_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_fwd(q, k, v, segment_ids, causal, scale)
    return packed_flash_fwd_ref(q, k, v, segment_ids, causal, scale)


def packed_flash_bwd_dq(q, k, v, segment_ids, do, lse, delta, causal=False,
                        scale=None):
    """dq; see :func:`packed_flash_bwd_dq_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_dq(q, k, v, segment_ids, do, lse, delta, causal,
                          scale)
    return packed_flash_bwd_dq_ref(q, k, v, segment_ids, do, lse, delta,
                                   causal, scale)


def packed_flash_bwd_dkv(q, k, v, segment_ids, do, lse, delta, causal=False,
                         scale=None):
    """``(dk, dv)``; see :func:`packed_flash_bwd_dkv_ref`."""
    scale = _default_scale(q, scale)
    if _on_kernel(q):
        return _launch_dkv(q, k, v, segment_ids, do, lse, delta, causal,
                           scale)
    return packed_flash_bwd_dkv_ref(q, k, v, segment_ids, do, lse, delta,
                                    causal, scale)


class PackedFlashAttention(torch.autograd.Function):
    """``packed_flash_attention`` with the reference's custom VJP
    (``:259-290``): the forward keeps ``(q, k, v, segment_ids, out,
    lse)``; the backward runs the dq and the dk/dv kernels (no atomics,
    so it is deterministic) and gives the ids no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = packed_flash_fwd(q, k, v, segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, segment_ids, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(out, do)
        dq = packed_flash_bwd_dq(q, k, v, seg, do, lse, delta, ctx.causal,
                                 ctx.scale)
        dk, dv = packed_flash_bwd_dkv(q, k, v, seg, do, lse, delta,
                                      ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


def packed_flash_attention(q, k, v, segment_ids, causal=False, scale=None):
    """q, k, v ``[B, L, H, D]`` and integer ``segment_ids [B, L]`` (on q's
    device) -> ``[B, L, H, D]``, differentiable in q, k and v. The ids are
    taken as int32 (one ``[B, L]`` copy when they are not already)."""
    seg = torch.as_tensor(segment_ids, device=q.device).to(
        torch.int32).contiguous()
    return PackedFlashAttention.apply(q, k, v, seg, bool(causal),
                                      _default_scale(q, scale))
