"""Ragged paged attention — port of
``paddle_tpu/kernels/paged_attention_pallas.py``.

One function serves every attention shape the serving engine
dispatches: each sequence slot contributes ``(kv_len, q_len)`` — decode
is ``q_len = 1``, a chunked-prefill row is ``q_len = C`` — over a paged
K/V pool addressed through per-slot block tables.

The pools are float32 or bfloat16, or quantized: int8 or
``float8_e4m3fn`` codes with per-page-per-head float32 scales
``k_scale``/``v_scale`` ``[num_pages, NH]`` (``quantization/kv.py``),
dequantized as each page is read.

- :func:`ragged_paged_attention_ref` — the plain PyTorch version (the
  semantics of the Pallas docstring, ``paged_attention_pallas.py:114``).
- :func:`ragged_paged_attention` — the dispatcher: a CPU tensor goes to
  the plain version; a CUDA tensor launches the hand-written kernel
  ``csrc/paged_attention.cu`` (replacing the TPU kernels ``_kernel`` at
  ``paged_attention_pallas.py:37`` and, over quantized pools,
  ``_kernel_quant`` at ``:102``) or raises. There is no fallback.
  Two designs: over the pools that :func:`split_kv` admits (float32 /
  bfloat16 with a head size a multiple of 8, int8 or float8 with one a
  multiple of 16, 16-byte aligned pools), the split-KV kernels (the
  extent cut into splits of whole pages, each split's partial softmax in
  a workspace this wrapper allocates, merged in split order by a second
  kernel; codes widened with their page scales as each stage is read);
  over the pools it does not admit, the first design.
- :func:`paged_decode_attention` — the ``q_len = 1`` entry
  (``paged_attention_pallas.py:219``).

A head offset ``h0`` reads heads ``h0 .. h0 + NH - 1`` of pools that
hold more heads than q (``[NP, PS, PNH, HD]``, scales ``[NP, PNH]``): a
tensor-parallel rank's heads of a replicated pool
(``inference/tp.py``; the reference's ``ragged_paged_attention_sharded``,
``paged_attention_pallas.py:187-216``, runs the kernel on each chip's
head shard). Every C entry takes it with the pool's own head count
``PNH`` as its stride: nothing is copied. Pools whose heads are q's are
the case ``PNH = NH``, ``h0 = 0``.

The module attributes ``launches`` (float pools, both designs),
``split_launches`` (of those, the split-KV design's), ``quant_launches``
(quantized pools, both designs) and ``quant_split_launches`` (of those,
the split-KV design's) count kernel launches (read them as
``paged_attention.launches``; :func:`reset_launches` zeroes them), so a
run can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import launch_context

__all__ = ["ragged_paged_attention", "ragged_paged_attention_ref",
           "paged_decode_attention", "reset_launches", "byte_view",
           "split_kv", "split_plan"]

launches = 0          # launches over float pools since reset_launches()
split_launches = 0    # of those, the split-KV design's
quant_launches = 0    # launches over int8/fp8 pools since reset_launches()
quant_split_launches = 0   # of those, the split-KV design's

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_POOL_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
              torch.float8_e4m3fn: 3}
_QUANT_POOLS = (torch.int8, torch.float8_e4m3fn)
_MAX_HD = 256         # the kernel's shared-memory plan covers HD <= 256
# paged_attention_forward(q_dtype, kv_dtype, q, k_pool, v_pool, k_scale,
#   v_scale, block_tables, kv_lens, q_lens, out, S, QB, NH, HD, PS, MP,
#   PNH, h0, scale, stream): every pointer and the stream as c_void_p, or
#   ctypes would pass a 32-bit int and cut the address. PNH is the pools'
#   head count and h0 the first of q's heads in them
ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
            + [ctypes.c_float, ctypes.c_void_p])
# paged_attention_forward_split(q_dtype, kv_dtype, q, k_pool, v_pool,
#   block_tables, kv_lens, q_lens, out, ws, S, QB, NH, HD, PS, MP, SL,
#   nsplit, PNH, h0, scale, stream)
SPLIT_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                  + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
# paged_attention_forward_split_quant(q_dtype, kv_dtype, q, k_pool, v_pool,
#   k_scale, v_scale, block_tables, kv_lens, q_lens, out, ws, S, QB, NH,
#   HD, PS, MP, SL, nsplit, PNH, h0, scale, stream)
SPLIT_QUANT_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                        + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p])
# the pools routed to the split design and the head sizes it takes: whole
# 16-byte units of a head's page row (8 bf16 / 4 f32 values, 16 int8 or
# float8 codes). The card holds every launch over each pool kind to the
# plain version on the same pages inside the serving engine's own steps
# (chip_smoke.py ``run_parity_phase``)
_SPLIT_UNIT = {torch.float32: 8, torch.bfloat16: 8, torch.int8: 16,
               torch.float8_e4m3fn: 16}
_SMS = 132            # the H100's SMs: the split aims at 4 blocks of each
_SPLIT_POS = 128      # positions a split, before the grid asks for more
_MIN_SPLIT_POS = 32   # splits shrink to fill the card, no further
_MAX_SPLITS = 64      # the workspace's and the merge kernel's bound:
                      # longer splits past this
_fns = {}


def reset_launches():
    global launches, split_launches, quant_launches, quant_split_launches
    launches = split_launches = quant_launches = quant_split_launches = 0


def split_kv(q, k_pool, v_pool=None, k_scale=None, v_scale=None):
    """True when these tensors take the split-KV kernels: a head's page
    row of whole 16-byte units (a head size that is a multiple of 8 over
    float32 or bfloat16 pools, of 16 over int8 or float8 codes) up to 256,
    16-byte aligned pools and, over codes, 4-byte aligned scales (read a
    float at a time). q may be either float type, at any alignment.
    Everything else takes the first design."""
    pools = (k_pool,) if v_pool is None else (k_pool, v_pool)
    scales = tuple(t for t in (k_scale, v_scale) if t is not None)
    unit = _SPLIT_UNIT.get(k_pool.dtype)
    HD = q.shape[-1]
    return (unit is not None and HD % unit == 0 and unit <= HD <= _MAX_HD
            and all(t.data_ptr() % 16 == 0 for t in pools)
            and all(t.data_ptr() % 4 == 0 for t in scales))


def split_plan(S, QB, NH, PS, MP):
    """``(SL, nsplit)``: the split length in positions (whole pages) and
    the number of splits over the extent ``MP * PS``. From the extent, not
    the live lengths (reading those would wait for the card): 128
    positions, halved while the grid (splits x row tiles of 16 x heads x
    slots) holds fewer than 4 blocks an SM, down to 32 (or one page), and
    lengthened while there are more than 64 splits (the workspace)."""
    T = MP * PS
    pages = max(1, _SPLIT_POS // PS)
    blocks = S * NH * -(-QB // 16)
    while (pages > 1 and pages * PS > _MIN_SPLIT_POS
           and blocks * -(-T // (pages * PS)) < 4 * _SMS):
        pages //= 2
    while -(-T // (pages * PS)) > _MAX_SPLITS:
        pages *= 2
    SL = pages * PS
    return SL, max(1, -(-T // SL))


def _check_scales(k_pool, k_scale, v_scale):
    """Both scales or neither, and scales exactly when the pool is
    quantized."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    quantized = k_pool.dtype in _QUANT_POOLS
    if quantized and k_scale is None:
        raise ValueError(f"a {k_pool.dtype} pool needs k_scale and v_scale")
    if not quantized and k_scale is not None:
        raise ValueError(f"scales given for an unquantized {k_pool.dtype} "
                         "pool")


def byte_view(pool):
    """A ``uint8`` view of a float8 pool, the pool itself otherwise:
    indexing is not implemented for every float8 kernel, so float8 pages
    are gathered and scattered as bytes."""
    if pool.dtype == torch.float8_e4m3fn:
        return pool.view(torch.uint8)
    return pool


def _limits(kv_lens, q_lens, QB, T):
    """Per-row exclusive causal limit ``[S, QB]``: row ``j`` of a slot
    with extent ``L`` and ``q_len`` ``n`` attends positions
    ``< min(L, L - n + 1 + j)``; padding rows (``j >= n``) attend the
    full extent."""
    L = kv_lens.to(torch.int64).clamp(max=T)[:, None]
    n = q_lens.to(torch.int64)[:, None]
    j = torch.arange(QB, device=kv_lens.device)[None, :]
    return torch.where(j < n, torch.minimum(L, L - n + 1 + j), L)


def ragged_paged_attention_ref(q, k_pool, v_pool, block_tables, kv_lens,
                               q_lens, scale=None, k_scale=None,
                               v_scale=None, h0=0):
    """Plain PyTorch ragged paged attention.

    q ``[S, QB, NH, HD]``; pools ``[NP, PS, NH, HD]``; block_tables
    ``[S, MP]`` int; kv_lens, q_lens ``[S]`` int. Row ``j`` of slot
    ``s`` sits at position ``kv_lens[s] - q_lens[s] + j`` and attends
    causally through itself; padding rows attend the full extent (finite
    output, to be discarded); a row with nothing to attend (``kv_len``
    0) gives zeros. An int8 or float8 pool needs its scales
    ``[NP, NH]`` f32 (both or neither): each gathered page is
    dequantized as ``code.float() * scale[page, head]``. With ``h0``
    the pools hold ``PNH`` heads and q's read heads ``h0 .. h0 + NH -
    1`` (scales ``[NP, PNH]``). Computes in float32, returns q's
    dtype."""
    _check_scales(k_pool, k_scale, v_scale)
    S, QB, NH, HD = q.shape
    heads = slice(h0, h0 + NH)
    PS = k_pool.shape[1]
    MP = block_tables.shape[1]
    T = MP * PS
    if scale is None:
        scale = 1.0 / HD ** 0.5
    bt = block_tables.to(torch.int64)
    k = byte_view(k_pool)[bt].view(k_pool.dtype)[..., heads, :].float()
    v = byte_view(v_pool)[bt].view(v_pool.dtype)[..., heads, :].float()
    if k_scale is not None:                               # [S,MP,PS,NH,HD]
        k = k * k_scale[bt][:, :, None, heads, None]
        v = v * v_scale[bt][:, :, None, heads, None]
    k = k.reshape(S, T, NH, HD)
    v = v.reshape(S, T, NH, HD)
    sc = torch.einsum("sqhd,sthd->shqt", q.float(), k) * scale
    ok = torch.arange(T, device=q.device)[None, None, :] < \
        _limits(kv_lens, q_lens, QB, T)[:, :, None]          # [S, QB, T]
    sc = sc.masked_fill(~ok[:, None], float("-inf"))
    live = ok.any(-1)                                          # [S, QB]
    p = torch.softmax(sc, dim=-1)
    p = torch.where(live[:, None, :, None], p,
                    torch.zeros((), device=p.device))
    out = torch.einsum("shqt,sthd->sqhd", p, v)
    return out.to(q.dtype)


def _kernel_fn(name="paged_attention_forward", argtypes=ARGTYPES):
    fn = _fns.get(name)
    if fn is None:
        from ._build import load
        fn = getattr(load("paged_attention"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(q, k_pool, v_pool, block_tables, kv_lens, q_lens, k_scale=None,
           v_scale=None, h0=0):
    _check_scales(k_pool, k_scale, v_scale)
    dev = q.device
    scales = () if k_scale is None else (("k_scale", k_scale),
                                         ("v_scale", v_scale))
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("kv_lens", kv_lens),
                    ("q_lens", q_lens), *scales):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    if q.dtype not in _DTYPE_CODE or k_pool.dtype not in _POOL_CODE:
        raise TypeError(f"unsupported dtypes q={q.dtype} "
                        f"pool={k_pool.dtype} (q float32 or bfloat16; "
                        "pools those, int8 or float8_e4m3fn)")
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("k_pool and v_pool must share a dtype")
    for name, t in (("block_tables", block_tables), ("kv_lens", kv_lens),
                    ("q_lens", q_lens)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("q and the pools must be 4-D")
    S, QB, NH, HD = q.shape
    PNH = k_pool.shape[2]
    if k_pool.shape != v_pool.shape or k_pool.shape[3] != HD or \
            not 0 <= h0 <= PNH - NH:
        raise ValueError(f"pool shapes {tuple(k_pool.shape)}/"
                         f"{tuple(v_pool.shape)} do not match q "
                         f"{tuple(q.shape)} at head offset {h0}")
    if block_tables.dim() != 2 or block_tables.shape[0] != S:
        raise ValueError(f"block_tables {tuple(block_tables.shape)} must "
                         f"be [{S}, pages_per_slot]")
    if kv_lens.shape != (S,) or q_lens.shape != (S,):
        raise ValueError("kv_lens and q_lens must be [S]")
    for name, t in scales:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.shape != (k_pool.shape[0], PNH):
            raise ValueError(f"{name} {tuple(t.shape)} must be "
                             f"[{k_pool.shape[0]}, {PNH}] (pages, heads)")
    if HD > _MAX_HD:
        raise ValueError(f"head_dim {HD} > {_MAX_HD}")


def _launch_split(q, k_pool, v_pool, block_tables, kv_lens, q_lens,
                  scale, k_scale=None, v_scale=None, h0=0):
    global launches, split_launches, quant_launches, quant_split_launches
    S, QB, NH, HD = q.shape
    PS, MP, PNH = k_pool.shape[1], block_tables.shape[1], k_pool.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    quant = k_scale is not None
    fn = (_kernel_fn("paged_attention_forward_split_quant",
                     SPLIT_QUANT_ARGTYPES) if quant else
          _kernel_fn("paged_attention_forward_split", SPLIT_ARGTYPES))
    SL, nsplit = split_plan(S, QB, NH, PS, MP)
    # the splits' partials: acc [S*QB*NH*nsplit, HD], then m and l
    ws = (torch.empty(S * QB * NH * nsplit * (HD + 2), dtype=torch.float32,
                      device=q.device) if nsplit > 1 else None)
    scales = (k_scale.data_ptr(), v_scale.data_ptr()) if quant else ()
    with launch_context(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], _POOL_CODE[k_pool.dtype],
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), *scales,
                block_tables.data_ptr(), kv_lens.data_ptr(),
                q_lens.data_ptr(), out.data_ptr(),
                None if ws is None else ws.data_ptr(), S, QB, NH, HD, PS, MP,
                SL, nsplit, PNH, h0, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention split-KV kernel launch failed: "
                           f"CUDA error {rc}")
    if quant:
        quant_launches += 1
        quant_split_launches += 1
    else:
        launches += 1
        split_launches += 1
    return out


def _launch(q, k_pool, v_pool, block_tables, kv_lens, q_lens, scale,
            k_scale, v_scale, h0=0):
    global launches, quant_launches
    _check(q, k_pool, v_pool, block_tables, kv_lens, q_lens, k_scale,
           v_scale, h0)
    if split_kv(q, k_pool, v_pool, k_scale, v_scale):
        return _launch_split(q, k_pool, v_pool, block_tables, kv_lens,
                             q_lens, scale, k_scale, v_scale, h0)
    S, QB, NH, HD = q.shape
    PNH = k_pool.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with launch_context(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], _POOL_CODE[k_pool.dtype],
                q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                None if k_scale is None else k_scale.data_ptr(),
                None if v_scale is None else v_scale.data_ptr(),
                block_tables.data_ptr(), kv_lens.data_ptr(),
                q_lens.data_ptr(), out.data_ptr(), S, QB, NH, HD,
                k_pool.shape[1], block_tables.shape[1],
                PNH, h0, float(scale), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {rc}")
    if k_scale is None:
        launches += 1
    else:
        quant_launches += 1
    return out


def ragged_paged_attention(q, k_pool, v_pool, block_tables, kv_lens,
                           q_lens, scale=None, k_scale=None, v_scale=None,
                           h0=0):
    """Ragged paged attention (see :func:`ragged_paged_attention_ref`
    for the semantics, ``h0`` included). A CPU ``q`` runs the plain
    version; a CUDA ``q`` launches the CUDA kernel, building it on first
    use, or raises."""
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    if q.device.type == "cpu":
        return ragged_paged_attention_ref(q, k_pool, v_pool, block_tables,
                                          kv_lens, q_lens, scale, k_scale,
                                          v_scale, h0)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch(q, k_pool, v_pool, block_tables, kv_lens, q_lens, scale,
                   k_scale, v_scale, h0)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths,
                           scale=None, k_scale=None, v_scale=None, h0=0):
    """The ``q_len = 1`` row of the ragged kernel. q ``[S, NH, HD]``;
    lengths ``[S]`` int32 (attend pool positions ``< lengths[s]``; 0 =
    inactive slot, zeros). Returns ``[S, NH, HD]``."""
    out = ragged_paged_attention(
        q.unsqueeze(1), k_pool, v_pool, block_tables, lengths,
        torch.ones_like(lengths), scale=scale, k_scale=k_scale,
        v_scale=v_scale, h0=h0)
    return out[:, 0]
