"""Fused LM head + softmax cross entropy, forward and backward — port of
``paddle_tpu/kernels/fused_ce_pallas.py`` (``_fwd_kernel`` ``:62``,
``_bwd_dh_kernel`` ``:101``, ``_bwd_dw_kernel`` ``:129``).

Per-token NLL of ``softmax(h @ wᵀ)`` against integer labels, for the tied
head's layout: ``h [T, d]``, ``w [V, d]``, ``labels [T]``. The logits
``s = h @ wᵀ`` are accumulated in float32 (the reference's
``preferred_element_type``) and never stored whole on the card:

- forward: ``lse = m + log l`` over the vocabulary, with ``l == 0 -> 1``
  (``:94-98``), and ``nll = lse - s[label]``. A label outside ``[0, V)``
  picks no column, so its ``nll`` is the ``lse``; the caller masks it;
- backward, with ``dl = (softmax(s) - onehot(label)) * g`` recomputed:
  ``dh = dl @ w`` in h's dtype and ``dw = dlᵀ @ h`` in w's dtype
  (``:117-122``, ``:146-151``);
- the shared-dl backward (``_bwd_dh_kernel_sharep`` ``:158``,
  ``_bwd_dw_kernel_sharep`` ``:189``), taken when the module flag
  :data:`_SHARE_P` is set, as the reference's ``_SHARE_P`` (``:264``): the
  dh pass also stores dl as bfloat16 ``[T, V]`` (bf16 whatever h's dtype,
  as the reference's ``:285``), and the dw pass computes ``dlᵀ @ h`` from
  it, products of the bf16-rounded dl summed in float32 (``:203-205``),
  without recomputing the logits.

Pieces:

- plain PyTorch versions :func:`fused_ce_fwd_ref` -> ``(nll, lse)``,
  :func:`fused_ce_bwd_dh_ref`, :func:`fused_ce_bwd_dw_ref`,
  :func:`fused_ce_bwd_dh_sharep_ref` -> ``(dh, dl)`` and
  :func:`fused_ce_bwd_dw_sharep_ref`;
- the wrappers :func:`fused_ce_fwd`, :func:`fused_ce_bwd_dh`,
  :func:`fused_ce_bwd_dw`, :func:`fused_ce_bwd_dh_sharep` and
  :func:`fused_ce_bwd_dw_sharep`: a CPU tensor runs the plain version; a
  CUDA tensor launches the hand-written kernel of ``csrc/fused_ce.cu`` or
  raises (no fallback). Each kernel has its launch counter
  (``fwd_launches``, ``dh_launches``, ``dw_launches``,
  ``dh_sharep_launches``, ``dw_sharep_launches``; :func:`reset_launches`);
- two designs of the dw_sharep kernel: the wgmma/TMA GEMM for bfloat16 h
  with ``d`` a multiple of 8 and h 16-byte aligned, and the ``wmma`` /
  CUDA-core one for the rest (float32 and other widths).
  :func:`hopper_dw_sharep` is the one predicate that picks;
  ``dw_sharep_launches`` counts both and ``dw_sharep_hopper_launches`` the
  wgmma/TMA one;
- two designs of each recomputing kernel, dw, dh and the shared-dl
  pair's dh pass: on wgmma/TMA for bfloat16 h and w with ``d`` a multiple
  of 8, both 16-byte aligned (a CTA a 64-row block of the output, vocab
  rows for dw and tokens for dh, the logits' two halves over d summed in a
  fixed order, dl rounded to bf16 before the second product; dh_sharep
  stores those bf16 dl tiles, so its dh is dh's bit for bit), and the
  ``wmma`` / CUDA-core one for the rest;
- two designs of the forward, by the same rule: on wgmma/TMA (a CTA's 64
  tokens of h resident, w streamed in [128 vocab x 64 d] boxes through a
  ring fed by a producer warp, two consumer warpgroups on alternate
  128-vocab tiles, each keeping a running ``(m, l, target)`` in registers,
  the two merged in one order), and the ``wmma`` / CUDA-core one for the
  rest. :func:`hopper_recompute` is the one predicate that picks for all
  four; ``fwd_launches``, ``dw_launches``, ``dh_launches`` and
  ``dh_sharep_launches`` count both designs and ``fwd_hopper_launches``,
  ``dw_hopper_launches``, ``dh_hopper_launches`` and
  ``dh_sharep_hopper_launches`` the wgmma/TMA one;
- :class:`FusedSoftmaxCE`, the ``torch.autograd.Function`` with the
  reference's ``custom_vjp`` contract (``:361-380``): the forward saves
  ``(h, w, labels, lse)``; the backward returns ``dh`` and ``dw`` and no
  gradient for the labels. With :data:`_SHARE_P` set and both gradients
  needed it runs the shared-dl pair (dl lives only until dw is done); when
  only one gradient is needed dl would have no reader, so it runs the
  recomputing kernel of that one. :func:`fused_softmax_ce` is its public
  entry (``:383``);
- :func:`use_plain`, a context manager that makes the wrappers take the
  plain versions on CUDA too, for comparisons only.

What is not ported: the reference's block-size knobs (``PD_CE_BT``,
``PD_CE_BV``, ``PD_CE_BV_BWD``) and its padding of T and V to block
multiples. The CUDA kernels take any T and V and mask their own tails.
Both forward kernels split the vocabulary across the grid so that any T
fills the card (the C side picks the split count from the design's tile
height and the device's SM count); each split writes its running ``(m,
l, target)`` and :func:`_combine` merges them here, a reduction over a
few ``[T]`` rows.
"""
from __future__ import annotations

import contextlib
import ctypes

import torch

__all__ = ["fused_softmax_ce", "FusedSoftmaxCE", "fused_ce_fwd",
           "fused_ce_bwd_dh", "fused_ce_bwd_dw", "fused_ce_bwd_dh_sharep",
           "fused_ce_bwd_dw_sharep", "fused_ce_fwd_ref",
           "fused_ce_bwd_dh_ref", "fused_ce_bwd_dw_ref",
           "fused_ce_bwd_dh_sharep_ref", "fused_ce_bwd_dw_sharep_ref",
           "use_plain", "reset_launches", "hopper_dw_sharep",
           "hopper_recompute"]

fwd_launches = 0      # kernel launches since the last reset_launches()
fwd_hopper_launches = 0         # of those, the wgmma/TMA kernel's
dh_launches = 0
dh_hopper_launches = 0          # of those, the wgmma/TMA kernel's
dw_launches = 0
dw_hopper_launches = 0          # of those, the wgmma/TMA kernel's
dh_sharep_launches = 0
dh_sharep_hopper_launches = 0   # of those, the wgmma/TMA kernel's
dw_sharep_launches = 0
dw_sharep_hopper_launches = 0   # of those, the wgmma/TMA kernel's

# The reference's module flag (fused_ce_pallas.py:264): share the dl tiles
# between the two backward kernels. No entry point sets it; a caller sets
# it and restores it.
_SHARE_P = False

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 768           # the kernels' register accumulators cover d <= 768
_plain = False        # set only inside use_plain()

# every pointer and the stream as c_void_p, or ctypes would pass a 32-bit
# int and cut the address
# fused_ce_forward / _forward_hopper(dtype, h, w, labels, m_part, l_part,
#   t_part, T, V, d, nsplit, stream)
FWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_void_p])
# fused_ce_backward_dh / _dh_hopper / _dw / _dw_hopper(dtype, h, w, labels,
#   lse, g, out, T, V, d, stream)
BWD_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
# fused_ce_backward_dh_sharep / _dh_sharep_hopper(dtype, h, w, labels, lse,
#   g, dh, dl, ldd, T, V, d, stream)
DH_SHAREP_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# fused_ce_backward_dw_sharep(dtype, h, dl, dw, ldd, T, V, d, stream), and
# fused_ce_backward_dw_sharep_hopper with the same arguments
DW_SHAREP_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# fused_ce_forward_splits / _forward_hopper_splits(dtype, T, V, device) ->
#   the forward's split count
SPLITS_ARGTYPES = [ctypes.c_int] * 4
_fns = {}


def reset_launches():
    global fwd_launches, fwd_hopper_launches, dh_launches, dh_hopper_launches
    global dw_launches, dw_hopper_launches, dh_sharep_launches
    global dh_sharep_hopper_launches, dw_sharep_launches
    global dw_sharep_hopper_launches
    fwd_launches = fwd_hopper_launches = 0
    dh_launches = dh_hopper_launches = 0
    dw_launches = dw_hopper_launches = 0
    dh_sharep_launches = dh_sharep_hopper_launches = 0
    dw_sharep_launches = dw_sharep_hopper_launches = 0


def hopper_recompute(h, w):
    """True when the forward, the recomputing dh and dw over these h and w,
    and the shared-dl pair's dh pass take their wgmma/TMA kernels: both
    bfloat16,
    ``d`` a multiple of 8 (16-byte rows for TMA) and both 16-byte aligned.
    Everything else takes the ``wmma`` / CUDA-core kernels."""
    return (h.dtype == torch.bfloat16 and w.dtype == torch.bfloat16
            and h.shape[-1] % 8 == 0 and h.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


def hopper_dw_sharep(h):
    """True when dw_sharep over this h takes the wgmma/TMA kernel:
    bfloat16, ``d`` a multiple of 8 (16-byte rows for TMA) and h 16-byte
    aligned; the dl buffer is aligned by construction (:func:`_dl_rows`).
    Everything else takes the ``wmma`` / CUDA-core kernel."""
    return (h.dtype == torch.bfloat16 and h.shape[-1] % 8 == 0
            and h.data_ptr() % 16 == 0)


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


# -- plain versions -------------------------------------------------------------

def _logits(h, w):
    return h.float() @ w.float().t()


def _picks(labels, V, device):
    """``[T, V]`` one-hot of the labels; a label outside ``[0, V)``
    picks nothing."""
    return labels.long()[:, None] == torch.arange(V, device=device)[None, :]


def fused_ce_fwd_ref(h, w, labels):
    """Plain forward: ``(nll, lse)``, each float32 ``[T]``."""
    s = _logits(h, w)
    lse = torch.logsumexp(s, dim=-1)
    target = torch.where(_picks(labels, w.shape[0], s.device), s,
                         torch.zeros((), device=s.device)).sum(-1)
    return lse - target, lse


def _dlogits(h, w, labels, lse, g):
    s = _logits(h, w)
    p = torch.exp(s - lse.float()[:, None])
    return (p - _picks(labels, w.shape[0], s.device).float()) \
        * g.float()[:, None]


def fused_ce_bwd_dh_ref(h, w, labels, lse, g):
    """Plain ``dh = dl @ w`` ``[T, d]`` in h's dtype."""
    return (_dlogits(h, w, labels, lse, g) @ w.float()).to(h.dtype)


def fused_ce_bwd_dw_ref(h, w, labels, lse, g):
    """Plain ``dw = dlᵀ @ h`` ``[V, d]`` in w's dtype."""
    return (_dlogits(h, w, labels, lse, g).t() @ h.float()).to(w.dtype)


def fused_ce_bwd_dh_sharep_ref(h, w, labels, lse, g):
    """Plain shared-dl dh pass: ``(dh, dl)``, dh as
    :func:`fused_ce_bwd_dh_ref` (from the float32 dl) and dl bfloat16
    ``[T, V]``."""
    dl = _dlogits(h, w, labels, lse, g)
    return (dl @ w.float()).to(h.dtype), dl.to(torch.bfloat16)


def fused_ce_bwd_dw_sharep_ref(h, dl):
    """Plain shared-dl dw pass: ``dw = dlᵀ @ h`` ``[V, d]`` in h's dtype
    (w's), the bf16 dl's products summed in float32."""
    return (dl.float().t() @ h.float()).to(h.dtype)


# -- the CUDA kernels -----------------------------------------------------------

def _kernel_fn(name, argtypes):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load
        fn = getattr(load("fused_ce"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(h, w, labels, **rows):
    dev = h.device
    named = dict(h=h, w=w, labels=labels, **rows)
    for name, t in named.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, h on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {h.dtype} (float32 or bfloat16)")
    if w.dtype != h.dtype:
        raise TypeError(f"w is {w.dtype}, h {h.dtype}")
    if labels.dtype != torch.int32:
        raise TypeError("labels must be int32 here (the wrappers convert)")
    if h.dim() != 2 or w.dim() != 2 or h.shape[1] != w.shape[1]:
        raise ValueError(f"h [T, d] and w [V, d] expected, got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    T, d = h.shape
    if labels.shape != (T,):
        raise ValueError(f"labels must be [T] = [{T}]")
    for name, t in rows.items():
        if t.dtype != torch.float32 or t.shape != (T,):
            raise ValueError(f"{name} must be float32 [T] = [{T}]")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"hidden size {d} outside the kernels' 1..{MAX_D}")
    if w.shape[0] < 1:
        raise ValueError("empty vocabulary")
    if max(T, w.shape[0]) * d >= 2 ** 31:
        raise ValueError("too many rows for the kernels' int indices")


def _labels32(labels):
    return labels.to(torch.int32).contiguous()


def _raise_if(rc, what):
    if rc != 0:
        raise RuntimeError(f"fused_ce {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _combine(m, l, t):
    """``(nll, lse)`` from per-split running max, sum and target logit,
    each ``[splits, T]``; a split that saw no column holds ``(-inf, 0,
    0)``."""
    M = m.amax(0)
    L = (l * torch.exp(m - M)).sum(0)
    lse = M + torch.log(torch.where(L == 0, torch.ones_like(L), L))
    return lse - t.sum(0), lse


def _launch_fwd(h, w, labels, nsplit=None):
    """The forward kernel (the wgmma/TMA design where
    :func:`hopper_recompute` admits h and w); ``nsplit`` overrides the
    vocab split count the C side picks (for timing the split against one
    split)."""
    global fwd_launches, fwd_hopper_launches
    labels = _labels32(labels)
    _check(h, w, labels)
    T, d = h.shape
    V = w.shape[0]
    if T == 0:
        e = torch.empty(0, dtype=torch.float32, device=h.device)
        return e, e.clone()
    hopper = hopper_recompute(h, w)
    entry = "fused_ce_forward" + ("_hopper" if hopper else "")
    ns = nsplit or _kernel_fn(f"{entry}_splits", SPLITS_ARGTYPES)(
        _DTYPE_CODE[h.dtype], T, V, h.device.index)
    if ns < 1:
        raise RuntimeError("fused_ce forward: no split count for this device")
    parts = torch.empty(3, ns, T, dtype=torch.float32, device=h.device)
    fn = _kernel_fn(entry, FWD_ARGTYPES)
    with torch.cuda.device(h.device):
        rc = fn(_DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(),
                labels.data_ptr(), parts[0].data_ptr(), parts[1].data_ptr(),
                parts[2].data_ptr(), T, V, d, ns, _stream(h))
    _raise_if(rc, "forward" + (" (wgmma)" if hopper else ""))
    fwd_launches += 1
    fwd_hopper_launches += hopper
    return _combine(*parts)


def _check_dl(h, dl):
    """What the dw_sharep kernel takes: h ``[T, d]`` as :func:`_check`
    wants it, and dl bfloat16 ``[T, V]`` on h's device with contiguous
    columns."""
    if dl.device != h.device:
        raise ValueError(f"dl is on {dl.device}, h on {h.device}")
    if h.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {h.dtype} (float32 or bfloat16)")
    if dl.dtype != torch.bfloat16:
        raise TypeError(f"dl must be bfloat16, not {dl.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError("h must be a contiguous [T, d]")
    if dl.dim() != 2 or dl.shape[0] != h.shape[0]:
        raise ValueError(f"dl must be [T, V] with T = {h.shape[0]}, got "
                         f"{tuple(dl.shape)}")
    T, d = h.shape
    V = dl.shape[1]
    if V < 1:
        raise ValueError("empty vocabulary")
    if T > 1 and dl.stride(1) != 1:
        raise ValueError("dl's columns must be contiguous")
    if not 1 <= d <= MAX_D:
        raise ValueError(f"hidden size {d} outside the kernels' 1..{MAX_D}")
    if max(T, V) * d >= 2 ** 31:
        raise ValueError("too many rows for the kernels' int indices")


def _dl_rows(T, V, device):
    """A bf16 ``[T, ldd]`` buffer for dl, ``ldd`` = V rounded up to 8
    (16-byte rows for the kernels' 16-byte stores and loads)."""
    return torch.empty(T, -(-V // 8) * 8, dtype=torch.bfloat16,
                       device=device)


def _dl_for_kernel(dl):
    """``(tensor, ldd)``: dl as it is when its rows are 16-byte aligned
    (the view dh_sharep returns, or V a multiple of 8), else a copy into
    such rows."""
    T, V = dl.shape
    ldd = dl.stride(0) if T > 1 else -(-V // 8) * 8
    if ldd % 8 == 0 and ldd >= V and dl.data_ptr() % 16 == 0:
        return dl, ldd
    buf = _dl_rows(T, V, dl.device)
    buf[:, :V] = dl
    return buf, buf.stride(0)


def _launch_bwd(which, h, w, labels, lse, g):
    global dh_launches, dh_hopper_launches, dw_launches, dw_hopper_launches
    labels = _labels32(labels)
    g = g.float().contiguous()
    _check(h, w, labels, lse=lse, g=g)
    T, d = h.shape
    out = torch.empty_like(h if which == "dh" else w)
    if T == 0:
        return out.zero_()
    hopper = hopper_recompute(h, w)
    entry = f"fused_ce_backward_{which}" + ("_hopper" if hopper else "")
    fn = _kernel_fn(entry, BWD_ARGTYPES)
    with torch.cuda.device(h.device):
        rc = fn(_DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                out.data_ptr(), T, w.shape[0], d, _stream(h))
    _raise_if(rc, f"backward {which}" + (" (wgmma)" if hopper else ""))
    if which == "dh":
        dh_launches += 1
        dh_hopper_launches += hopper
    else:
        dw_launches += 1
        dw_hopper_launches += hopper
    return out


def _launch_dh_sharep(h, w, labels, lse, g):
    """The shared-dl dh kernel: ``(dh, dl)``, dl the ``[:, :V]`` view of
    a ``[T, V rounded up to 8]`` bf16 buffer whose tail columns the kernel
    fills with zeros."""
    global dh_sharep_launches, dh_sharep_hopper_launches
    labels = _labels32(labels)
    g = g.float().contiguous()
    _check(h, w, labels, lse=lse, g=g)
    T, d = h.shape
    V = w.shape[0]
    dh = torch.empty_like(h)
    buf = _dl_rows(T, V, h.device)
    if T == 0:
        return dh, buf[:, :V]
    hopper = hopper_recompute(h, w)
    fn = _kernel_fn("fused_ce_backward_dh_sharep"
                    + ("_hopper" if hopper else ""), DH_SHAREP_ARGTYPES)
    with torch.cuda.device(h.device):
        rc = fn(_DTYPE_CODE[h.dtype], h.data_ptr(), w.data_ptr(),
                labels.data_ptr(), lse.data_ptr(), g.data_ptr(),
                dh.data_ptr(), buf.data_ptr(), buf.stride(0), T, V, d,
                _stream(h))
    _raise_if(rc, "backward dh_sharep" + (" (wgmma)" if hopper else ""))
    dh_sharep_launches += 1
    dh_sharep_hopper_launches += hopper
    return dh, buf[:, :V]


def _launch_dw_sharep(h, dl):
    global dw_sharep_launches, dw_sharep_hopper_launches
    _check_dl(h, dl)
    T, d = h.shape
    V = dl.shape[1]
    dw = torch.empty(V, d, dtype=h.dtype, device=h.device)
    if T == 0:
        return dw.zero_()
    dl, ldd = _dl_for_kernel(dl)
    hopper = hopper_dw_sharep(h)
    fn = _kernel_fn("fused_ce_backward_dw_sharep_hopper" if hopper
                    else "fused_ce_backward_dw_sharep", DW_SHAREP_ARGTYPES)
    with torch.cuda.device(h.device):
        rc = fn(_DTYPE_CODE[h.dtype], h.data_ptr(), dl.data_ptr(),
                dw.data_ptr(), ldd, T, V, d, _stream(h))
    _raise_if(rc, "backward dw_sharep (wgmma)" if hopper
              else "backward dw_sharep")
    dw_sharep_launches += 1
    dw_sharep_hopper_launches += hopper
    return dw


def _on_kernel(h):
    """True for a CUDA tensor outside use_plain(); False for a CPU one."""
    if h.device.type == "cpu":
        return False
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    return not _plain


def fused_ce_fwd(h, w, labels):
    """Forward ``(nll, lse)``; see :func:`fused_ce_fwd_ref`."""
    if _on_kernel(h):
        return _launch_fwd(h, w, labels)
    return fused_ce_fwd_ref(h, w, labels)


def fused_ce_bwd_dh(h, w, labels, lse, g):
    """``dh``; see :func:`fused_ce_bwd_dh_ref`."""
    if _on_kernel(h):
        return _launch_bwd("dh", h, w, labels, lse, g)
    return fused_ce_bwd_dh_ref(h, w, labels, lse, g)


def fused_ce_bwd_dw(h, w, labels, lse, g):
    """``dw``; see :func:`fused_ce_bwd_dw_ref`."""
    if _on_kernel(h):
        return _launch_bwd("dw", h, w, labels, lse, g)
    return fused_ce_bwd_dw_ref(h, w, labels, lse, g)


def fused_ce_bwd_dh_sharep(h, w, labels, lse, g):
    """``(dh, dl)``; see :func:`fused_ce_bwd_dh_sharep_ref`."""
    if _on_kernel(h):
        return _launch_dh_sharep(h, w, labels, lse, g)
    return fused_ce_bwd_dh_sharep_ref(h, w, labels, lse, g)


def fused_ce_bwd_dw_sharep(h, dl):
    """``dw`` from a stored dl; see :func:`fused_ce_bwd_dw_sharep_ref`."""
    if _on_kernel(h):
        return _launch_dw_sharep(h, dl)
    return fused_ce_bwd_dw_sharep_ref(h, dl)


class FusedSoftmaxCE(torch.autograd.Function):
    """Per-token NLL with the reference's custom VJP: the forward keeps
    ``(h, w, labels, lse)``; the backward runs the dh and dw kernels, or
    with :data:`_SHARE_P` the shared-dl pair (no atomics, so it is
    deterministic), and gives the labels no gradient."""

    @staticmethod
    def forward(ctx, h, w, labels):
        h, w, labels = h.contiguous(), w.contiguous(), _labels32(labels)
        nll, lse = fused_ce_fwd(h, w, labels)
        ctx.save_for_backward(h, w, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        h, w, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        if _SHARE_P and ctx.needs_input_grad[0] and ctx.needs_input_grad[1]:
            dh, dl = fused_ce_bwd_dh_sharep(h, w, labels, lse, g)
            return dh, fused_ce_bwd_dw_sharep(h, dl), None
        dh = dw = None
        if ctx.needs_input_grad[0]:
            dh = fused_ce_bwd_dh(h, w, labels, lse, g)
        if ctx.needs_input_grad[1]:
            dw = fused_ce_bwd_dw(h, w, labels, lse, g)
        return dh, dw, None


def fused_softmax_ce(hidden, weight, labels):
    """Per-token NLL of ``softmax(hidden @ weightᵀ)`` against ``labels``
    (``fused_ce_pallas.py:383``): hidden ``[..., d]`` (leading dims are the
    tokens), weight ``[V, d]``, labels int ``[...]``. Returns float32 NLL
    with the labels' shape, differentiable in hidden and weight."""
    lead = labels.shape
    d = hidden.shape[-1]
    nll = FusedSoftmaxCE.apply(hidden.reshape(-1, d), weight,
                               labels.reshape(-1))
    return nll.reshape(lead)

