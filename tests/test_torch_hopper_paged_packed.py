"""The Hopper redesigns of the ragged paged-attention kernel over float
and int8 pools (``paddle_tpu_torch/kernels/csrc/paged_attention.cu``
``ragged_paged_attention_split_kernel`` and its merge kernel) and of the
packed (segment-id) flash forward (``csrc/packed_flash.cu``
``packed_flash_fwd_hopper_kernel``, the body of ``csrc/flash_fwd_hopper.cuh``
with segment ids), on the CPU.

- Routing: ``paged_attention.split_kv`` (float32 / bfloat16 pools with a
  head size a multiple of 8, int8 and float8 pools with one a multiple of
  16, up to 256, 16-byte aligned pools, 4-byte aligned scales) and
  ``packed_flash.hopper_fwd`` (bfloat16, D 64 / 128, L <= 16384, 16-byte
  aligned q, k, v) on every shape ``chip_smoke.py`` and the card tests
  (``tests/test_torch_cuda.py``) run, and the alignment of every input;
  ``split_plan``'s split of the extent at the serving shapes.
- The ctypes prototypes of the three new C entries.
- A CUDA tensor without the library raises on every route, runs no plain
  version and counts no launch.
- The profilers' classes for the new kernel names.
- The split-KV algorithm (partials of each split of whole pages, merged in
  split order), modelled in PyTorch, against the JAX engine's gather path
  (the reference's Pallas ragged kernel is no oracle on this JAX, ROADMAP
  caveat 1) on the decode, prefill and mixed layouts, with splits that
  cut a slot's extent inside its run of pages and a slot shorter than one
  split: float32, within 2e-5. Over int8 and float8 pools quantized by
  the JAX package's ``quantize_per_page``, the same model with each page
  widened by its scale (one float32 multiply, bit-identical to the JAX
  ``dequantize_per_page``) against the engine's quantized gather path,
  within 2e-5 as well: both sides read the same dequantized values.
- The packed forward's schedule (the CTA's list of live 64-key tiles, each
  warpgroup's online softmax in base 2 over the tiles live for its rows,
  P rounded to bfloat16 before P V), modelled in PyTorch, against the
  Pallas ``_fwd_kernel`` in interpret mode on pack 4, uneven ids, an id in
  two places and causal, within the bfloat16 limit 2e-2; the list holds 2
  of 8 tiles a CTA at pack 4, and never leaves out a tile with a live
  pair.

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ctypes
import importlib.util
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.kernels.packed_flash_pallas as P
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import packed_flash as pf
from paddle_tpu_torch.kernels import paged_attention as pa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (S, QB, NH, HD, PS, MP) of every ragged call over float pools the card
# runs: chip_smoke's serving shapes (which the card tests also run), the
# card tests' mixed case and its HD=128 variant, and the tiny engine
_TINY_HD = 64 // 4   # gpt2_tiny: hidden 64, 4 heads
PAGED_SHAPES = {
    **{f"smoke_{n}": (len(kv), qb, chip_smoke.NH, chip_smoke.HD,
                      chip_smoke.PS, chip_smoke.MP)
       for n, (kv, _, qb) in chip_smoke.RAGGED_SHAPES.items()},
    "card_mixed": (4, 8, 4, 16, 8, 4),
    "card_hd128": (4, 20, 2, 128, 16, 2),
    "card_engine_decode": (4, 1, 4, _TINY_HD, 8, 16),
}
# (B, H, L, D) of every packed forward the card runs
PACKED_SHAPES = {
    **{f"smoke_{n}": (c[0], c[1], c[2], c[3])
       for n, c in chip_smoke.PACKED_CASES.items()},
    **{f"card_{n}": (c[0], c[1], c[2], c[3])
       for n, c in _CARD.PF_CASES.items()},
    "bert_pack4": (16, 12, 512, 64),
}


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PAGED_SHAPES))
def test_split_kv_route_for_every_shape_the_card_runs(case):
    S, QB, NH, HD, PS, MP = PAGED_SHAPES[case]
    for q_dtype in (torch.float32, torch.bfloat16):
        q = _empty((S, QB, NH, HD), q_dtype)
        for pool_dtype, want in ((torch.float32, True),
                                 (torch.bfloat16, True),
                                 (torch.int8, True),
                                 (torch.float8_e4m3fn, True)):
            pool = _empty((2, PS, NH, HD), pool_dtype)
            sc = (_empty((2, NH), torch.float32),) * 2 \
                if pool_dtype in (torch.int8, torch.float8_e4m3fn) else ()
            assert pa.split_kv(q, pool, pool, *sc) is want, (case, pool_dtype)


def test_the_card_runs_the_split_design_at_every_float_shape():
    """Every shape above has a head size the design takes over float
    pools and over int8 and float8 pools (whole 16-code units), so no
    launch of the card's serving takes the first design."""
    assert all(HD % 16 == 0 and HD <= 256
               for _, _, _, HD, _, _ in PAGED_SHAPES.values())


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.float8_e4m3fn])
@pytest.mark.parametrize("HD", [8, 24, 40, 272])
def test_code_pools_off_whole_16_code_units_keep_the_first_design(pool_dtype,
                                                                  HD):
    """A code row of HD bytes is whole 16-byte units only when HD is a
    multiple of 16 (HD 8 and 24 are whole units of bf16, not of codes)."""
    q = _empty((2, 1, 2, HD), torch.bfloat16)
    pool = _empty((3, 8, 2, HD), pool_dtype)
    sc = _empty((3, 2), torch.float32)
    assert not pa.split_kv(q, pool, pool, sc, sc)


@pytest.mark.parametrize("pool_dtype", [torch.int8, torch.float8_e4m3fn])
def test_code_pools_and_scales_unaligned_keep_the_first_design(pool_dtype):
    """A code pool one byte into its storage cannot take 16-byte copies;
    a scale not on a 4-byte boundary cannot be read as a float."""
    shape = (3, 8, 2, 64)
    n = math.prod(shape)
    raw = torch.empty(n + 16, dtype=torch.uint8)
    off = raw[1:n + 1].view(pool_dtype).view(shape)
    pool = _empty(shape, pool_dtype)
    sc = _empty((3, 2), torch.float32)
    odd_sc = torch.empty(3 * 2 * 4 + 4, dtype=torch.uint8)[2:26]
    assert odd_sc.data_ptr() % 4 != 0
    q = _empty((2, 1, 2, 64), torch.float32)
    # aligned: both code kinds on the split design
    assert pa.split_kv(q, pool, pool, sc, sc)
    assert not pa.split_kv(q, off, pool, sc, sc)
    assert not pa.split_kv(q, pool, off, sc, sc)
    assert not pa.split_kv(q, pool, pool, odd_sc, sc)
    assert not pa.split_kv(q, pool, pool, sc, odd_sc)


@pytest.mark.parametrize("HD", [4, 12, 20, 260])
def test_head_sizes_off_whole_units_take_the_first_design(HD):
    q = _empty((2, 1, 2, HD), torch.float32)
    pool = _empty((3, 8, 2, HD), torch.float32)
    assert not pa.split_kv(q, pool, pool)


def test_split_kv_sees_the_pools_alignment_and_not_q_s():
    """A pool 2 bytes into its storage is not 16-byte aligned (the
    kernel's copies are 16 bytes); q is read a value at a time."""
    shape = (3, 8, 2, 64)
    n = math.prod(shape)
    raw = torch.empty(n + 8, dtype=torch.bfloat16)
    off = raw[1:n + 1].view(shape)
    pool = _empty(shape, torch.bfloat16)
    q = _empty((2, 1, 2, 64), torch.bfloat16)
    q_off = torch.empty(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    assert pa.split_kv(q, pool, pool) and pa.split_kv(q_off, pool, pool)
    assert not pa.split_kv(q, off, pool) and not pa.split_kv(q, pool, off)
    assert not pa.split_kv(q, off)


@pytest.mark.parametrize("case", list(PACKED_SHAPES))
def test_packed_forward_route_for_every_shape_the_card_runs(case):
    B, H, L, D = PACKED_SHAPES[case]
    seg = _empty((B, L), torch.int32)
    for dtype, want in ((torch.bfloat16, D in (64, 128)),
                        (torch.float32, False)):
        q = _empty((B, L, H, D), dtype)
        assert pf.hopper_fwd(q, q, q, seg) is want, (case, dtype)


def test_the_card_runs_both_packed_forward_routes_in_bf16():
    """The card's bf16 cases reach the wgmma forward and, at a head size
    it does not serve (d40), the CUDA-core forward's bf16 instantiation."""
    assert {D in (64, 128) for _, _, _, D in PACKED_SHAPES.values()} == \
        {True, False}


def test_packed_forward_route_sees_alignment_and_length():
    q = _empty((1, 128, 2, 64), torch.bfloat16)
    seg = _empty((1, 128), torch.int32)
    off = torch.empty(q.numel() + 8, dtype=torch.bfloat16)[1:q.numel() + 1] \
        .view(q.shape)
    assert pf.hopper_fwd(q, q, q, seg)
    for args in ((off, q, q), (q, off, q), (q, q, off)):
        assert not pf.hopper_fwd(*args, seg)
    # the segment ids are read with plain loads: any alignment
    seg_off = torch.empty(129, dtype=torch.int32)[1:].view(1, 128)
    assert pf.hopper_fwd(q, q, q, seg_off)
    # the list of live key tiles holds 256 tiles: L <= 16384
    for L, want in ((16384, True), (16385, False)):
        big = torch.empty((1, L, 1, 64), dtype=torch.bfloat16)
        assert pf.hopper_fwd(big, big, big, _empty((1, L), torch.int32)) \
            is want


def test_split_plan_at_the_serving_shapes():
    """The decode shape: 128-position splits, so its 8 slots' extents
    (47-590) give 26 live (slot, split) pairs, 312 blocks over 12 heads.
    The prefill chunk (one slot, 32 rows): splits shrink to 32 positions
    to fill the card. Every split is whole pages, covers the extent, and
    there are at most 64 of them."""
    def plan(shape):
        kv, q_lens, QB = chip_smoke.RAGGED_SHAPES[shape]
        return pa.split_plan(len(kv), QB, chip_smoke.NH, chip_smoke.PS,
                             chip_smoke.MP), kv
    (SL, n), kv = plan("decode")
    assert (SL, n) == (128, 8)
    assert sum(-(-L // SL) for L in kv) * chip_smoke.NH == 312
    assert plan("prefill")[0] == (32, 32)
    assert plan("mixed")[0] == (128, 8)
    for S, QB, NH, PS, MP in ((8, 1, 12, 16, 64), (1, 32, 12, 16, 64),
                              (4, 8, 4, 8, 4), (2, 1, 2, 12, 9),
                              (1, 1, 1, 16, 4096), (3, 5, 2, 256, 3)):
        SL, n = pa.split_plan(S, QB, NH, PS, MP)
        assert SL % PS == 0 and n * SL >= MP * PS > (n - 1) * SL
        assert n <= 64


# -- the C entries ------------------------------------------------------------

def _c_params(source, name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           source)) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


def test_ctypes_bindings_match_the_c_prototypes_of_the_new_entries():
    """A pointer declared as an int would be cut to 32 bits. The packed
    entry takes its old counterpart's arguments, so the wrapper binds
    both with one argtypes list."""
    assert _c_params("paged_attention.cu",
                     "paged_attention_forward_split") == pa.SPLIT_ARGTYPES
    assert _c_params("paged_attention.cu",
                     "paged_attention_forward_split_quant") \
        == pa.SPLIT_QUANT_ARGTYPES
    assert _c_params("paged_attention.cu",
                     "paged_attention_forward") == pa.ARGTYPES
    for name in ("packed_flash_forward_hopper", "packed_flash_forward"):
        assert _c_params("packed_flash.cu", name) == pf.FWD_ARGTYPES


def test_the_stall_hook_keys_a_variant_and_sits_in_the_shared_body():
    _, plain = _build._target("packed_flash")
    _, hooked = _build._target("packed_flash", ("-DPACKED_FWD_STALL_WG=0",))
    assert plain != hooked
    body = open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                             "flash_fwd_hopper.cuh")).read()
    assert "PACKED_FWD_STALL_WG" in body and "FLASH_FWD_STALL_WG" in body
    for src in ("flash_attention.cu", "packed_flash.cu"):
        text = open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                                 src)).read()
        assert '#include "flash_fwd_hopper.cuh"' in text


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrapper sees of a
    CUDA tensor, on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


@pytest.fixture
def no_library(tmp_path, monkeypatch):
    """No nvcc and no built library; the names of the C entries asked for
    are recorded."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    asked = []
    for mod in (pa, pf):
        monkeypatch.setattr(mod, "_fns", {})
        real = mod._kernel_fn

        def spy(*args, real=real, **kw):
            asked.append(args[0] if args else "paged_attention_forward")
            return real(*args, **kw)
        monkeypatch.setattr(mod, "_kernel_fn", spy)
    return asked


@pytest.mark.parametrize("pool,HD,entry", [
    (torch.float32, 16, "paged_attention_forward_split"),
    (torch.bfloat16, 64, "paged_attention_forward_split"),
    (torch.float32, 12, "paged_attention_forward"),
    (torch.int8, 16, "paged_attention_forward_split_quant"),
    (torch.float8_e4m3fn, 64, "paged_attention_forward_split_quant"),
    (torch.int8, 24, "paged_attention_forward"),
    (torch.float8_e4m3fn, 40, "paged_attention_forward")],
    ids=["f32", "bf16", "f32_hd12", "int8", "fp8", "int8_hd24", "fp8_hd40"])
def test_a_cuda_tensor_raises_on_every_paged_route(no_library, monkeypatch,
                                                   pool, HD, entry):
    monkeypatch.setattr(pa, "ragged_paged_attention_ref", None)
    S, QB, NH, PS, MP = 2, 1, 2, 8, 2
    q = _fake(torch.randn(S, QB, NH, HD))
    kp = _fake(torch.zeros(5, PS, NH, HD, dtype=pool))
    bt = _fake(torch.zeros(S, MP, dtype=torch.int32))
    lens = _fake(torch.ones(S, dtype=torch.int32))
    scales = {}
    if pool in (torch.int8, torch.float8_e4m3fn):
        sc = _fake(torch.ones(5, NH))
        scales = dict(k_scale=sc, v_scale=sc)
    pa.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        pa.ragged_paged_attention(q, kp, kp, bt, lens, lens, **scales)
    assert no_library == [entry]
    assert (pa.launches, pa.split_launches, pa.quant_launches,
            pa.quant_split_launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("dtype,D,entry", [
    (torch.bfloat16, 64, "packed_flash_forward_hopper"),
    (torch.bfloat16, 40, "packed_flash_forward"),
    (torch.float32, 64, "packed_flash_forward")],
    ids=["bf16", "bf16_d40", "f32"])
def test_a_cuda_tensor_raises_on_either_packed_forward_route(
        no_library, monkeypatch, dtype, D, entry):
    monkeypatch.setattr(pf, "packed_flash_fwd_ref", None)
    q = _fake(torch.randn(1, 64, 2, D).to(dtype))
    seg = _fake(torch.zeros(1, 64, dtype=torch.int32))
    pf.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        pf.packed_flash_fwd(q, q, q, seg)
    assert no_library == [entry]
    assert (pf.fwd_launches, pf.fwd_hopper_launches) == (0, 0)


def test_profilers_class_the_new_kernels():
    """``tools/profile_torch_serve.py`` and ``profile_train`` sort device
    time by substrings of the kernel names (demangled or not)."""
    spec = importlib.util.spec_from_file_location(
        "profile_torch_serve", os.path.join(ROOT, "tools",
                                            "profile_torch_serve.py"))
    serve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(serve)
    from paddle_tpu_torch.tools.profile_train import kernel_class
    for name in (
            "void (anonymous namespace)::ragged_paged_attention_split_kernel"
            "<__nv_bfloat16, __nv_bfloat16, 1, true>(__nv_bfloat16 const*)",
            "void (anonymous namespace)::ragged_paged_attention_merge_kernel"
            "<__nv_bfloat16>(float const*, int const*)",
            "_ZN51_GLOBAL__N__a82eed02_18_paged_attention_cu_0ecd5e0035ragged_"
            "paged_attention_split_kernelI13__nv_bfloat16S1_Li1ELb1EEEvPKT_",
            "void (anonymous namespace)::ragged_paged_attention_kernel"
            "<__nv_bfloat16, signed char>(__nv_bfloat16 const*)",
            "void (anonymous namespace)::ragged_paged_attention_split_kernel"
            "<__nv_bfloat16, signed char, 1, 4, true>(__nv_bfloat16 const*)",
            "void (anonymous namespace)::ragged_paged_attention_split_kernel"
            "<float, __nv_fp8_e4m3, 2, 8, false>(float const*)",
            "_ZN51_GLOBAL__N__a82eed02_18_paged_attention_cu_0ecd5e0035ragged_"
            "paged_attention_split_kernelI13__nv_bfloat16aLi1ELi4ELb1EEEv"):
        assert serve.kernel_class(name) == "paged_attention", name
    for name, cls in (
            ("void (anonymous namespace)::packed_flash_fwd_hopper_kernel<64>"
             "(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
             "packed_flash_fwd"),
            ("_ZN48_GLOBAL__N__2c884570_15_packed_flash_cu_53b4e2ca30packed_"
             "flash_fwd_hopper_kernelILi64EEEv14CUtensorMap_stS1_S1_P",
             "packed_flash_fwd"),
            ("void (anonymous namespace)::flash_attention_fwd_hopper_kernel"
             "<64>(CUtensorMap_st, CUtensorMap_st, CUtensorMap_st)",
             "flash_attention_fwd"),
            ("void (anonymous namespace)::fused_ce_dw_hopper_kernel<true>"
             "(CUtensorMap_st, CUtensorMap_st, int const*, float const*)",
             "fused_ce_dw"),
            ("_ZN44_GLOBAL__N__d87d6159_11_fused_ce_cu_d501686025fused_ce_dw_"
             "hopper_kernelILb0EEEv14CUtensorMap_stS1_PKiPKfS5_P13__nv_"
             "bfloat16iii", "fused_ce_dw")):
        assert kernel_class(name) == cls, name


# -- the split-KV algorithm, modelled -----------------------------------------

def split_kv_model(q, k_pool, v_pool, bt, kv_lens, q_lens, scale, SL):
    """What ``ragged_paged_attention_split_kernel`` and its merge compute,
    in float32:
    the extent cut into splits of ``SL`` positions (whole pages); each
    split's partial softmax (max m, sum l, acc = P V) over the positions
    below each row's causal limit; then, for each row, its live splits
    merged in split order: ``sum_i acc_i 2^.. / sum_i l_i ..`` with the
    common max, zeros for a row that attends nothing."""
    S, QB, NH, HD = q.shape
    PS, MP = k_pool.shape[1], bt.shape[1]
    T = MP * PS
    assert SL % PS == 0
    nsplit = -(-T // SL)
    idx = bt.long()
    k = k_pool[idx].reshape(S, T, NH, HD).float()
    v = v_pool[idx].reshape(S, T, NH, HD).float()
    lim = pa._limits(kv_lens, q_lens, QB, T).clamp(min=0)
    lim = torch.where(kv_lens[:, None] > 0, lim, torch.zeros_like(lim))
    qs = q.float() * scale
    parts = []
    for i in range(nsplit):
        p0, p1 = i * SL, min((i + 1) * SL, T)
        sc = torch.einsum("sqhd,sthd->sqht", qs, k[:, p0:p1])
        ok = torch.arange(p0, p1)[None, None, :] < lim[:, :, None]
        sc = sc.masked_fill(~ok[:, :, None, :], -math.inf)
        m = sc.amax(-1)
        p = torch.exp(sc - torch.where(m == -math.inf, torch.zeros(()),
                                       m)[..., None])
        parts.append((m, p.sum(-1),
                      torch.einsum("sqht,sthd->sqhd", p, v[:, p0:p1])))
    n = -(-lim // SL)                                     # [S, QB]
    M = torch.full((S, QB, NH), -math.inf)
    for i, (m, _, _) in enumerate(parts):
        M = torch.where((i < n)[..., None], torch.maximum(M, m), M)
    lt = torch.zeros(S, QB, NH)
    acc = torch.zeros(S, QB, NH, HD)
    for i, (m, l, a) in enumerate(parts):                 # split order
        w = torch.where((i < n)[..., None], torch.exp(m - M),
                        torch.zeros(()))
        lt = lt + w * l
        acc = acc + w[..., None] * a
    out = torch.where(lt[..., None] > 0, acc / lt.clamp(min=1e-30)[..., None],
                      torch.zeros(()))
    return out.to(q.dtype)


def jax_gather_attention(q, kf, vf, bt, kv_lens, q_lens, k_scale=None,
                         v_scale=None):
    """The reference engine's off-TPU ragged attention
    (inference/serving.py ``mixed_attn``'s ``one`` under ``jax.vmap``; at
    q_len 1 it is ``ragged_attn_one``), rebuilt from its jnp ops: gather
    the slot's pages (over a quantized pool with their scales, dequantized
    by ``dequantize_per_page`` as its ``gather_kv`` does), mask each row's
    positions at its limit to -1e30, softmax."""
    from paddle_tpu.quantization.kv import dequantize_per_page
    S, QB, NH, HD = q.shape
    T = bt.shape[1] * kf.shape[1]
    scale = 1.0 / HD ** 0.5

    def gather(pool, scales, bt_row):
        pages = jnp.asarray(pool)[bt_row]
        if scales is not None:
            pages = dequantize_per_page(pages, jnp.asarray(scales)[bt_row])
        return pages.reshape(T, NH, HD)

    def one(qr, bt_row, kv_len, qn):
        kk = gather(kf, k_scale, bt_row)
        vv = gather(vf, v_scale, bt_row)
        s = jnp.einsum("qhd,thd->qht", qr, kk) * scale
        jj = jnp.arange(QB)
        limit = jnp.where(jj < qn, kv_len - qn + 1 + jj, kv_len)
        ok = jnp.arange(T)[None, None, :] < limit[:, None, None]
        s = jnp.where(ok, s, -1e30)
        return jnp.einsum("qht,thd->qhd", jax.nn.softmax(s, axis=-1), vv)

    return np.asarray(jax.vmap(one)(jnp.asarray(q), jnp.asarray(bt),
                                    jnp.asarray(kv_lens),
                                    jnp.asarray(q_lens)))


def _layout(name, rng, NP=21, PS=8, NH=3, HD=16, MP=5):
    """decode: four slots of one row (extents across pages, one of 5
    positions); prefill: one slot's 8-row chunk at the tail of 30
    positions; mixed: a decode row, a full 8-row chunk, a 4-row k+1 row,
    an idle slot."""
    S, QB, kv, ql = {"decode": (4, 1, [27, 5, 12, 33], [1, 1, 1, 1]),
                     "prefill": (1, 8, [30], [8]),
                     "mixed": (4, 8, [27, 8, 12, 0], [1, 8, 4, 1])}[name]
    q = rng.randn(S, QB, NH, HD).astype(np.float32)
    kf = rng.randn(NP, PS, NH, HD).astype(np.float32)
    vf = rng.randn(NP, PS, NH, HD).astype(np.float32)
    bt = rng.permutation(np.arange(1, NP))[:S * MP].reshape(S, MP) \
        .astype(np.int32)
    return q, kf, vf, bt, np.array(kv, np.int32), np.array(ql, np.int32)


@pytest.mark.parametrize("split", ["one_page", "two_pages", "three_pages",
                                   "whole_extent", "plan"])
@pytest.mark.parametrize("layout", ["decode", "prefill", "mixed"])
def test_split_kv_model_matches_the_jax_engine_gather_path(layout, split):
    case = _layout(layout, np.random.RandomState(21))
    q, kf, vf, bt, kv, ql = case
    S, QB, NH, HD = q.shape
    PS, MP = kf.shape[1], bt.shape[1]
    SL = {"one_page": PS, "two_pages": 2 * PS, "three_pages": 3 * PS,
          "whole_extent": MP * PS,
          "plan": pa.split_plan(S, QB, NH, PS, MP)[0]}[split]
    # the splits cut some slot inside its run of pages, and one slot
    # (5 or 8 positions) is shorter than a split of two pages or more
    tq, tk, tv, tbt, tkv, tql = (torch.from_numpy(a) for a in case)
    out = split_kv_model(tq, tk, tv, tbt, tkv, tql, HD ** -0.5, SL).numpy()
    ref = jax_gather_attention(*case)
    live = kv > 0   # the gather path averages an idle slot, the port zeros it
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    assert np.all(out[~live] == 0)
    plain = pa.ragged_paged_attention_ref(tq, tk, tv, tbt, tkv, tql).numpy()
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


def _quantized(kf, vf, fmt):
    """The pools quantized by the JAX package's ``quantize_per_page``
    (each page and head first scaled by 10^U(-2, 1), so a wrong scale
    index shows): the codes and scales for the port (fp8 codes carried as
    bytes) and the same arrays for the JAX side."""
    from paddle_tpu.quantization.kv import quantize_per_page
    rng = np.random.RandomState(7)
    out = []
    for x in (kf, vf):
        mag = 10.0 ** rng.uniform(-2, 1, (x.shape[0], 1, x.shape[2], 1))
        codes, sc = quantize_per_page(jnp.asarray(x * mag.astype(np.float32)),
                                      dtype=fmt)
        raw = np.array(codes)
        t = (torch.from_numpy(raw.view(np.uint8)).view(torch.float8_e4m3fn)
             if fmt == "fp8" else torch.from_numpy(raw))
        out.append((t, torch.from_numpy(np.array(sc)), codes, sc))
    return out


@pytest.mark.parametrize("split", ["one_page", "two_pages", "whole_extent",
                                   "plan"])
@pytest.mark.parametrize("layout", ["decode", "prefill", "mixed"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_split_kv_model_matches_the_jax_engine_gather_path(fmt, layout,
                                                                 split):
    """What the split kernel does over a code pool: the split's pages'
    scales read once, each staged code widened to float32 times its page's
    scale, then the float split-KV algorithm. The widened values are the
    JAX ``dequantize_per_page``'s bit for bit, so the model meets the
    engine's quantized gather path (``jax_gather_attention`` with scales)
    at the float model's 2e-5."""
    q, kf, vf, bt, kv, ql = _layout(layout, np.random.RandomState(23), HD=32)
    (tk, tks, jk, jks), (tv, tvs, jv, jvs) = _quantized(kf, vf, fmt)
    S, QB, NH, HD = q.shape
    PS, MP = kf.shape[1], bt.shape[1]
    SL = {"one_page": PS, "two_pages": 2 * PS, "whole_extent": MP * PS,
          "plan": pa.split_plan(S, QB, NH, PS, MP)[0]}[split]
    # the staged values: one float32 multiply a code, as dequantize_per_page
    wk = pa.byte_view(tk).view(tk.dtype).float() * tks[:, None, :, None]
    wv = pa.byte_view(tv).view(tv.dtype).float() * tvs[:, None, :, None]
    from paddle_tpu.quantization.kv import dequantize_per_page
    np.testing.assert_array_equal(wk.numpy(),
                                  np.asarray(dequantize_per_page(jk, jks)))
    tq, tbt, tkv, tql = (torch.from_numpy(a) for a in (q, bt, kv, ql))
    out = split_kv_model(tq, wk, wv, tbt, tkv, tql, HD ** -0.5, SL).numpy()
    ref = jax_gather_attention(q, jk, jv, bt, kv, ql, k_scale=jks,
                               v_scale=jvs)
    live = kv > 0
    np.testing.assert_allclose(out[live], ref[live], rtol=2e-5, atol=2e-5)
    assert np.all(out[~live] == 0)
    plain = pa.ragged_paged_attention_ref(tq, tk, tv, tbt, tkv, tql,
                                          k_scale=tks, v_scale=tvs).numpy()
    np.testing.assert_allclose(out, plain, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("layout", ["decode", "prefill", "mixed"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_plain_version_is_the_float_plain_over_dequantized_pages(
        fmt, layout):
    """The plain version over code pools is one float32 computation, the
    same as over float pools: each page dequantized with its scales
    (one float32 multiply a code), then the float plain version, bit for
    bit. Kernel and plain version over codes are held to the float
    pools' limits, not to each other's bits."""
    q, kf, vf, bt, kv, ql = _layout(layout, np.random.RandomState(29), HD=32)
    (tk, tks, _, _), (tv, tvs, _, _) = _quantized(kf, vf, fmt)
    wk = pa.byte_view(tk).view(tk.dtype).float() * tks[:, None, :, None]
    wv = pa.byte_view(tv).view(tv.dtype).float() * tvs[:, None, :, None]
    tq, tbt, tkv, tql = (torch.from_numpy(a) for a in (q, bt, kv, ql))
    plain = pa.ragged_paged_attention_ref(tq, tk, tv, tbt, tkv, tql,
                                          k_scale=tks, v_scale=tvs)
    assert plain.dtype == torch.float32
    assert torch.equal(plain, pa.ragged_paged_attention_ref(
        tq, wk, wv, tbt, tkv, tql))


# -- the packed forward's schedule, modelled ----------------------------------

BM, BN = 128, 64   # HopperFwd: q rows a CTA, keys a tile


def cta_tile_list(ids, q0, L, causal):
    """``list_tiles`` of one CTA of q rows [q0, q0 + 128): the 64-key
    tiles that can hold a live pair for one of its two warpgroups, each
    with the set of warpgroups it is live for."""
    lo, hi = [], []
    for w in range(2):
        rows = ids[q0 + 64 * w:min(q0 + 64 * w + 64, L)]
        lo.append(int(rows.min()) if len(rows) else None)
        hi.append(int(rows.max()) if len(rows) else None)
    last = min(L, q0 + BM) if causal else L
    out = []
    for kt in range(-(-last // BN)):
        keys = ids[kt * BN:min(kt * BN + BN, L)]
        live = {w for w in range(2) if lo[w] is not None
                and bool(((keys >= lo[w]) & (keys <= hi[w])).any())
                and (not causal or kt * BN <= q0 + 64 * w + 63)}
        if live:
            out.append((kt, live))
    return out


def packed_hopper_model(q, k, v, seg, causal, scale):
    """What ``packed_flash_fwd_hopper_kernel`` computes on bf16 inputs:
    each warpgroup's 64 rows take an online softmax in base 2 (scores in
    float32 times ``scale * log2(e)``) over the listed tiles live for it,
    in list order; a pair counts when the ids match and, causal, col <=
    row; P rounded to bfloat16 before P V, l the sum of the unrounded P;
    ``lse = (m + log2 l) ln 2``. Returns (out, lse, tiles listed a CTA)."""
    B, L, H, D = q.shape
    c = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    out = torch.zeros(B, H, L, D)
    lse = torch.zeros(B, H, L)
    counts = []
    for b in range(B):
        ids = seg[b]
        for q0 in range(0, L, BM):
            tiles = cta_tile_list(ids, q0, L, causal)
            counts.append(len(tiles))
            for w in range(2):
                r0, r1 = q0 + 64 * w, min(q0 + 64 * w + 64, L)
                if r0 >= L:
                    continue
                rows = torch.arange(r0, r1)
                m = torch.full((H, r1 - r0), -math.inf)
                l = torch.zeros(H, r1 - r0)
                acc = torch.zeros(H, r1 - r0, D)
                for kt, live in tiles:
                    if w not in live:
                        continue
                    cols = torch.arange(kt * BN, min(kt * BN + BN, L))
                    x = qf[b, :, r0:r1] @ kf[b, :, cols].transpose(1, 2) * c
                    ok = ids[rows][:, None] == ids[cols][None, :]
                    if causal:
                        ok = ok & (cols[None, :] <= rows[:, None])
                    x = torch.where(ok, x, torch.full((), -math.inf))
                    mn = torch.maximum(m, x.amax(-1))
                    mu = torch.where(mn == -math.inf, torch.zeros(()), mn)
                    alpha = torch.exp2(m - mu)
                    p = torch.exp2(x - mu[..., None])
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[..., None] + \
                        p.to(torch.bfloat16).float() @ vf[b, :, cols]
                    m = mn
                lsafe = torch.where(l == 0, torch.ones(()), l)
                out[b, :, r0:r1] = acc / lsafe[..., None]
                lse[b, :, r0:r1] = (m + torch.log2(lsafe)) * math.log(2.0)
    return (out.permute(0, 2, 1, 3).to(torch.bfloat16),
            lse.reshape(B * H, L), counts)


def _packed_ids(name, B, L):
    seg = np.zeros((B, L), np.int32)
    if name == "pack4":
        seg[:] = np.repeat(np.arange(4), L // 4)
    else:   # chip_smoke's uneven rows: three segments; an id in two places
        a, b = L * 100 // 512, L * 400 // 512
        seg[0, :a], seg[0, a:b], seg[0, b:] = 5, 7, 9
        seg[1, :a], seg[1, a:b], seg[1, b:] = 5, 7, 5
    return seg


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("layout,causal", [("pack4", False),
                                           ("uneven", False),
                                           ("uneven", True)],
                         ids=["pack4", "uneven", "uneven_causal"])
def test_model_of_the_packed_forward_matches_pallas_in_interpret_mode(
        layout, causal):
    B, L, H, D = 2, 512, 2, 64
    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, L, H, D))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    seg = _packed_ids(layout, B, L)
    scale = 1.0 / math.sqrt(D)

    def bhld(t):
        return jnp.swapaxes(jnp.asarray(t.float().numpy()), 1, 2) \
            .reshape(B * H, L, D).astype(jnp.bfloat16)

    prev = P._INTERPRET
    P._INTERPRET = True
    try:
        with jax.enable_x64(False):
            jseg = jnp.repeat(jnp.asarray(seg), H, axis=0)
            jout, jlse = P._pf_fwd_impl(bhld(q), bhld(k), bhld(v), jseg,
                                        scale, causal, 128, 128)
    finally:
        P._INTERPRET = prev
    jout = np.swapaxes(np.asarray(jout.astype(jnp.float32))
                       .reshape(B, H, L, D), 1, 2)
    out, lse, counts = packed_hopper_model(q, k, v, torch.from_numpy(seg),
                                           causal, scale)
    assert _rel(out.float().numpy(), jout) <= 2e-2
    assert _rel(lse.numpy(), np.asarray(jlse)[..., 0]) <= 2e-2
    rout, rlse = pf.packed_flash_fwd_ref(q, k, v, torch.from_numpy(seg),
                                         causal)
    assert _rel(out.float().numpy(), rout.float().numpy()) <= 2e-2
    assert _rel(lse.numpy(), rlse.numpy()) <= 1e-5
    if layout == "pack4":   # four segments of 128: 2 of 8 key tiles a CTA
        assert counts == [2] * (B * L // BM)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_the_tile_list_never_leaves_out_a_live_pair(seed, causal):
    """For random ids (few values, unsorted, repeated far apart) and
    lengths off the tile grid: every (row, key) pair with equal ids (and,
    causal, key <= row) lies in a tile listed live for the row's
    warpgroup."""
    rng = np.random.default_rng(seed)
    L = int(rng.integers(130, 700))
    ids = torch.from_numpy(rng.integers(0, 4, L).astype(np.int32))
    if seed % 2:   # runs, as packing makes them
        ids = torch.from_numpy(np.repeat(rng.integers(0, 5, L // 37 + 1),
                                         37)[:L].astype(np.int32))
    for q0 in range(0, L, BM):
        listed = {kt: live for kt, live in cta_tile_list(ids, q0, L, causal)}
        for r in range(q0, min(q0 + BM, L)):
            w = (r - q0) // 64
            cols = torch.nonzero(ids == ids[r]).flatten()
            if causal:
                cols = cols[cols <= r]
            for kt in set((cols // BN).tolist()):
                assert w in listed.get(kt, ()), (q0, r, kt)


# -- chip_smoke's per-call parity hook (the engine's own launches held) ------

def _launch_args(fmt, layout="mixed"):
    """Positional arguments of ``pa._launch`` over the ``layout`` case,
    its pools float32 or quantized to ``fmt`` by the port (float32 q, as
    the parity engine's)."""
    from paddle_tpu_torch.quantization.kv import quantize_per_page
    q, kf, vf, bt, kv, ql = (torch.from_numpy(a) for a in
                             _layout(layout, np.random.RandomState(31)))
    scale = q.shape[-1] ** -0.5
    if fmt == "float32":
        return q, kf, vf, bt, kv, ql, scale, None, None
    kq, ks = quantize_per_page(kf, dtype=fmt)
    vq, vs = quantize_per_page(vf, dtype=fmt)
    return q, kq, vq, bt, kv, ql, scale, ks, vs


@pytest.fixture
def plain_launch(monkeypatch):
    """``pa._launch`` standing for the kernel on the CPU: the plain
    version, counted, or the plain version plus ``planted`` on one element
    of a live row."""
    state = {"launches": 0, "planted": 0.0}

    def launch(*args):
        state["launches"] += 1
        out = pa.ragged_paged_attention_ref(*args)
        out[0, 0, 0, 0] += state["planted"]
        return out
    monkeypatch.setattr(pa, "_launch", launch)
    return state


@pytest.mark.parametrize("fmt", ["float32", "int8", "fp8"])
def test_per_call_parity_wraps_counts_and_restores_the_launch(plain_launch,
                                                              fmt):
    """Inside the block ``pa._launch`` is the hook; each call runs the
    launch and the plain version once and counts one check; after the
    block the launch is the one it wrapped."""
    fake = pa._launch
    args = _launch_args(fmt)
    with chip_smoke.per_call_parity(pa, chip_smoke.PER_CALL_TOL) as rec:
        assert pa._launch is not fake
        outs = [pa._launch(*args) for _ in range(3)]
    assert pa._launch is fake
    assert rec["calls"] == plain_launch["launches"] == 3
    assert rec["max_rel_err"] == 0.0 and rec["plain_s"] > 0
    assert torch.equal(outs[0], pa.ragged_paged_attention_ref(*args))


def test_the_ragged_entry_points_reach_the_launch_the_hook_wraps(
        monkeypatch):
    """``ragged_paged_attention`` and ``paged_decode_attention`` (the two
    names the engine binds) look ``_launch`` up in the module at each
    call, so a hook set on ``pa._launch`` sees every launch beneath the
    engine."""
    calls = []

    def launch(q, *rest):
        calls.append(tuple(q.shape))
        return torch.zeros(q.shape)
    monkeypatch.setattr(pa, "_launch", launch)
    q, kf, vf, bt, kv, ql = (torch.from_numpy(a) for a in
                             _layout("decode", np.random.RandomState(33)))
    pa.ragged_paged_attention(_fake(q), kf, vf, bt, kv, ql)
    pa.paged_decode_attention(_fake(q[:, 0]), kf, vf, bt, kv)
    assert calls == [tuple(q.shape), tuple(q.shape)]


def test_per_call_parity_raises_on_a_planted_difference(plain_launch):
    """A launch 1e-3 of max-abs off the plain version fails the hold
    (``PER_CALL_TOL``), and the launch is restored all the same; with
    ``hold=False`` the same difference is recorded, not raised."""
    args = _launch_args("fp8")
    fake = pa._launch
    ref = pa.ragged_paged_attention_ref(*args)
    plain_launch["planted"] = 1e-3 * float(ref.abs().max())
    with pytest.raises(AssertionError, match="inside the engine"):
        with chip_smoke.per_call_parity(pa, chip_smoke.PER_CALL_TOL):
            pa._launch(*args)
    assert pa._launch is fake
    with chip_smoke.per_call_parity(pa, chip_smoke.PER_CALL_TOL,
                                    hold=False) as rec:
        pa._launch(*args)
        pa._launch(*args)
    assert rec["calls"] == 2 and not rec["held"]
    assert 0.9e-3 < rec["max_rel_err"] < 1.1e-3
    plain_launch["planted"] = float("nan")
    with chip_smoke.per_call_parity(pa, chip_smoke.PER_CALL_TOL,
                                    hold=False) as rec:
        pa._launch(*args)
    assert rec["max_rel_err"] != rec["max_rel_err"]     # NaN recorded
