"""The wgmma/TMA designs of the flash forward and of dw_sharep
(``paddle_tpu_torch/kernels/csrc/flash_attention.cu``
``flash_attention_fwd_hopper_kernel``, ``csrc/fused_ce.cu``
``fused_ce_dw_sharep_hopper_kernel``), on the CPU.

- Routing: the one predicate of each wrapper (``flash_attention.hopper_fwd``,
  ``fused_ce.hopper_dw_sharep``) on every shape ``chip_smoke.py`` and the
  card tests (``tests/test_torch_cuda.py``) run: bfloat16 at D = 64 or 128
  (flash) and d a multiple of 8 (dw_sharep) take the new kernels; float32,
  other head sizes, d = 50 and tensors that are not 16-byte aligned take
  the present ones.
- The ctypes prototypes of the two new C entries.
- A CUDA tensor without the library raises on either route, and runs no
  plain version.
- The new forward's one rounding point that the plain version does not
  have: P rounded to bfloat16 before P V, on each 64-key tile of an
  online softmax (the kernel's order). A plain PyTorch model of it is held
  against the JAX ``flash_attention_pallas`` forward in interpret mode
  and against ``_sdpa_reference`` where the Pallas wrapper refuses
  (causal Lq > Lk with dead rows, an unaligned length), at the bfloat16
  forward limit the card holds the kernel to (``FA_TOL``: 2e-2 of
  max-abs, out and lse). dw_sharep adds no rounding point: its products
  are the plain version's bf16 operands summed in float32.

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
from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_ce as fc

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (B, H, Lq, Lk, D) of every flash call the card runs
FLASH_SHAPES = {**{f"smoke_{n}": c[:5]
                   for n, c in chip_smoke.FLASH_CASES.items()},
                **{f"card_{n}": c[:5] for n, c in _CARD.FA_CASES.items()},
                "bert_base": (64, 12, 128, 128, 64)}
# (T, d) of every dw_sharep call the card runs
DW_SHAPES = {**{f"smoke_{n}": (c[0], c[2])
                for n, c in chip_smoke.FCE_CASES.items()},
             **{f"card_{n}": (c[0], c[2])
                for n, c in _CARD.FCE_CASES.items()}}
BF16_FWD_TOL = _CARD.FA_TOL[torch.bfloat16][0]


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("case", list(FLASH_SHAPES))
def test_flash_forward_route_for_every_shape_the_card_runs(case):
    B, H, Lq, Lk, D = FLASH_SHAPES[case]
    for dtype, want in ((torch.bfloat16, D in (64, 128)),
                        (torch.float32, False)):
        q = _empty((B, Lq, H, D), dtype)
        kv = _empty((B, Lk, H, D), dtype)
        assert fa.hopper_fwd(q, kv, kv) is want, (case, dtype)


def test_the_card_runs_both_forward_routes_in_bf16():
    """The card's bf16 cases reach the wgmma forward and, at a head size
    it does not serve, the CUDA-core forward's bf16 instantiation."""
    routes = {D in (64, 128) for _, _, _, _, D in FLASH_SHAPES.values()}
    assert routes == {True, False}


@pytest.mark.parametrize("case", list(DW_SHAPES))
def test_dw_sharep_route_for_every_shape_the_card_runs(case):
    T, d = DW_SHAPES[case]
    assert fc.hopper_dw_sharep(_empty((T, d), torch.bfloat16)) is (d % 8 == 0)
    assert not fc.hopper_dw_sharep(_empty((T, d), torch.float32))


@pytest.mark.parametrize("D", [16, 32, 50, 96, 120])
def test_other_head_sizes_take_the_cuda_core_forward(D):
    q = _empty((1, 64, 2, D), torch.bfloat16)
    assert not fa.hopper_fwd(q, q, q)


def test_the_predicates_see_alignment():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it, so the present kernels take it."""
    q = _empty((1, 64, 2, 64), torch.bfloat16)
    off = torch.empty(q.numel() + 8, dtype=torch.bfloat16)[1:q.numel() + 1] \
        .view(q.shape)
    assert fa.hopper_fwd(q, q, q)
    assert not fa.hopper_fwd(off, q, q) and not fa.hopper_fwd(q, q, off)
    h = torch.empty(65 * 64, dtype=torch.bfloat16)
    assert fc.hopper_dw_sharep(h[:64 * 64].view(64, 64))
    assert not fc.hopper_dw_sharep(h[1:64 * 64 + 1].view(64, 64))


def test_a_define_builds_a_variant_beside_the_plain_library():
    """A test hook's -D flag keys its own library, so the variant and the
    plain build never overwrite each other."""
    src, plain = _build._target("flash_attention")
    _, hooked = _build._target("flash_attention", ("-DFLASH_FWD_STALL_WG=1",))
    _, other = _build._target("flash_attention", ("-DFLASH_FWD_STALL_WG=0",))
    assert len({plain, hooked, other}) == 3
    assert plain == _build._target("flash_attention", ())[1]
    assert "FLASH_FWD_STALL_WG" in src.read_text()


def _c_params(source, name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           source)) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("source,name,argtypes", [
    ("flash_attention.cu", "flash_attention_forward_hopper",
     fa.FWD_ARGTYPES),
    ("fused_ce.cu", "fused_ce_backward_dw_sharep_hopper",
     fc.DW_SHAREP_ARGTYPES)], ids=["flash_fwd", "dw_sharep"])
def test_ctypes_bindings_match_the_c_prototypes_of_the_new_entries(
        source, name, argtypes):
    """The new entries take their old counterparts' arguments, so the
    wrappers bind both with one argtypes list; a pointer declared as an
    int would be cut to 32 bits."""
    assert _c_params(source, name) == argtypes
    old = name.replace("_hopper", "")
    assert _c_params(source, old) == argtypes


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
    """No nvcc and no built library; the wrappers' own allocations land on
    the CPU (this torch has no CUDA); the names of the C entries asked
    for are recorded."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    asked = []
    for mod in (fa, fc):
        monkeypatch.setattr(mod, "_fns", {})
        real = mod._kernel_fn

        def spy(name, argtypes, real=real):
            asked.append(name)
            return real(name, argtypes)
        monkeypatch.setattr(mod, "_kernel_fn", spy)
    return asked


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "flash_attention_forward_hopper"),
    (torch.float32, "flash_attention_forward")], ids=["bf16", "f32"])
def test_a_cuda_tensor_raises_on_either_forward_route(no_library, monkeypatch,
                                                      dtype, entry):
    monkeypatch.setattr(fa, "flash_attention_fwd_ref", None)  # never called
    q = _fake(torch.randn(1, 64, 2, 64).to(dtype))
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        fa.flash_attention_fwd(q, q, q, True)
    assert no_library == [entry]
    assert (fa.fwd_launches, fa.fwd_hopper_launches) == (0, 0)


@pytest.mark.parametrize("dtype,d,entry", [
    (torch.bfloat16, 64, "fused_ce_backward_dw_sharep_hopper"),
    (torch.bfloat16, 50, "fused_ce_backward_dw_sharep"),
    (torch.float32, 64, "fused_ce_backward_dw_sharep")],
    ids=["bf16", "bf16_d50", "f32"])
def test_a_cuda_tensor_raises_on_either_dw_sharep_route(no_library,
                                                        monkeypatch, dtype,
                                                        d, entry):
    monkeypatch.setattr(fc, "fused_ce_bwd_dw_sharep_ref", None)
    h = _fake(torch.randn(40, d).to(dtype))
    dl = _fake(torch.zeros(40, 104, dtype=torch.bfloat16))
    fc.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        fc.fused_ce_bwd_dw_sharep(h, dl)
    assert no_library == [entry]
    assert (fc.dw_sharep_launches, fc.dw_sharep_hopper_launches) == (0, 0)


# -- the new forward's arithmetic, modelled -----------------------------------

BN = 64   # keys a tile of the wgmma forward (HopperFwd::BN)


def hopper_forward_model(q, k, v, causal, scale):
    """What ``flash_attention_fwd_hopper_kernel`` computes, in float32 on
    bf16 inputs: exact products summed in float32 (wgmma), the scores
    scaled by ``scale * log2(e)`` and the softmax in base 2 over 64-key
    tiles with a running max, P rounded to bfloat16 before ``P V``, the
    row sum of the unrounded P, and ``lse = (m + log2 l) ln 2``; the
    masking rule of the module (dead rows score 0)."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    x = s * torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    if causal:
        i = torch.arange(Lq)[:, None]
        j = torch.arange(Lk)[None, :]
        live = j <= i + (Lk - Lq)
        dead = (i + (Lk - Lq) < 0).expand(Lq, Lk)
        x = torch.where(live, x, torch.where(dead, torch.zeros(()),
                                             torch.full((), -math.inf)))
    m = torch.full((B, H, Lq), -math.inf)
    l = torch.zeros(B, H, Lq)
    acc = torch.zeros(B, H, Lq, D)
    vf = v.float().permute(0, 2, 1, 3)
    for k0 in range(0, Lk, BN):
        xt = x[..., k0:k0 + BN]
        mn = torch.maximum(m, xt.amax(-1))
        mu = torch.where(mn == -math.inf, torch.zeros(()), mn)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(xt - mu[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(torch.bfloat16).float() \
            @ vf[:, :, k0:k0 + BN]
        m = mn
    lsafe = torch.where(l == 0, torch.ones(()), l)
    out = (acc / lsafe[..., None]).permute(0, 2, 1, 3)
    lse = (m + torch.log2(lsafe)) * math.log(2.0)
    return out.to(torch.bfloat16), lse.reshape(B * H, Lq)


def _bf16_inputs(lq, lk, d, seed, b=1, h=2):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
            .to(torch.bfloat16) for n in (lq, lk, lk)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("lq,lk,d,causal", [(256, 256, 64, True),
                                            (128, 256, 64, False),
                                            (256, 256, 128, True)],
                         ids=["causal256", "cross128x256", "d128_causal256"])
def test_model_of_the_new_forward_matches_pallas_in_interpret_mode(
        lq, lk, d, causal):
    q, k, v = _bf16_inputs(lq, lk, d, seed=11)
    b, _, h, _ = q.shape
    scale = 1.0 / d ** 0.5

    def bhld(t):
        return jnp.swapaxes(jnp.asarray(t.float().numpy()), 1, 2) \
            .reshape(b * h, -1, d)

    prev = fap._INTERPRET
    fap._INTERPRET = True
    try:
        with jax.enable_x64(False):
            bq, bk = fap._pick_blocks(lq, lk)
            jout, jlse = fap._fa_fwd_impl(bhld(q), bhld(k), bhld(v), scale,
                                          causal, bq, bk)
    finally:
        fap._INTERPRET = prev
    jout = np.swapaxes(np.asarray(jout).reshape(b, h, lq, d), 1, 2)
    out, lse = hopper_forward_model(q, k, v, causal, scale)
    assert _rel(out.float().numpy(), jout) <= BF16_FWD_TOL
    assert _rel(lse.numpy(), np.asarray(jlse)[..., 0]) <= BF16_FWD_TOL
    # and the rounding point is the only one: with P kept in float32 the
    # model is the plain forward up to float32 sums
    rout, rlse = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
    assert _rel(lse.numpy(), rlse.numpy()) <= 1e-5
    assert _rel(out.float().numpy(), rout.float().numpy()) <= BF16_FWD_TOL


@pytest.mark.parametrize("lq,lk,causal", [(256, 128, True),
                                          (200, 200, True),
                                          (130, 77, False)],
                         ids=["dead_rows", "ragged200", "unaligned_cross"])
def test_model_of_the_new_forward_matches_sdpa_reference_where_pallas_refuses(
        lq, lk, causal):
    q, k, v = _bf16_inputs(lq, lk, 64, seed=12)
    scale = 1.0 / 8.0
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    jout = np.asarray(_sdpa_reference(jq, jk, jv, None, causal=causal,
                                      scale=scale))
    out, lse = hopper_forward_model(q, k, v, causal, scale)
    assert _rel(out.float().numpy(), jout) <= BF16_FWD_TOL
    _, rlse = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
    assert _rel(lse.numpy(), rlse.numpy()) <= 1e-5
    if causal and lq > lk:    # dead rows: uniform weights, lse = log Lk
        dead = lq - lk
        np.testing.assert_allclose(lse.reshape(-1, lq)[:, :dead].numpy(),
                                   math.log(lk), rtol=1e-6)
