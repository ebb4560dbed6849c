"""The wgmma/TMA design of the recomputing fused-CE dh and of the shared-dl
pair's dh pass (``paddle_tpu_torch/kernels/csrc/fused_ce.cu``
``fused_ce_dh_hopper_kernel``), on the CPU.

- Routing: ``fused_ce.hopper_recompute`` (bfloat16 h and w, d a multiple
  of 8, both 16-byte aligned) picks dh's and dh_sharep's design as it
  picks dw's, on every shape ``chip_smoke.py`` and the card tests
  (``tests/test_torch_cuda.py``) run; float32, mixed dtypes, d = 50 and
  inputs that are not 16-byte aligned keep the first design.
- The ctypes prototypes of the two new C entries, and the stall hook's
  variant.
- A CUDA tensor without the library raises on every dh and dh_sharep
  route, runs no plain version and counts no launch.
- The new kernel's arithmetic: the logits as two partial sums over the
  halves of d that its warpgroups own, added S_0 + S_1; dl in float32,
  rounded to bfloat16 before ``dl @ w``; 32-vocab-row tiles summed in
  order. A plain PyTorch model of it is held against the Pallas
  ``_bwd_dh_kernel`` and ``_bwd_dh_kernel_sharep`` in interpret mode and
  against the port's plain dh on ragged T and V, labels outside
  ``[0, V)`` and rows with g = 0, at the bfloat16 gradient limit the card
  holds the kernel to (1e-2 of max-abs), the softmax-only rows held apart
  at the same limit. The sharep model's dl (the tiles that fed its dh)
  against the dl the Pallas pair's dw pass reads.

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ctypes
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.kernels.fused_ce_pallas as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.tools.profile_train import kernel_class

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (T, V, d) of every dh and dh_sharep the card runs
DH_SHAPES = {**{f"smoke_{n}": c[:3]
                for n, c in chip_smoke.FCE_CASES.items()},
             **{f"card_{n}": c for n, c in _CARD.FCE_CASES.items()},
             **{f"card_dh_{n}": c for n, c in _CARD.FCE_DH_CASES.items()}}
GRAD_TOL = _CARD.FCE_TOL[torch.bfloat16][1]   # 1e-2 of max-abs


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(DH_SHAPES))
def test_dh_route_for_every_shape_the_card_runs(case):
    T, V, d = DH_SHAPES[case]
    h, w = _empty((T, d), torch.bfloat16), _empty((V, d), torch.bfloat16)
    assert fc.hopper_recompute(h, w) is (d % 8 == 0)
    assert not fc.hopper_recompute(h.float(), w.float())
    assert not fc.hopper_recompute(h, w.float())
    assert not fc.hopper_recompute(h.float(), w)


def test_the_card_runs_both_dh_builds_and_both_routes_in_bf16():
    """The card's bf16 cases reach the wgmma dh on the build with every
    chunk live (d > 640) and on the predicated one, and the first design's
    bf16 instantiation at d = 50; the training shape takes the wgmma one
    with every chunk live."""
    ds = [d for _, _, d in DH_SHAPES.values()]
    assert {d % 8 == 0 for d in ds} == {True, False}
    assert {d > 640 for d in ds if d % 8 == 0} == {True, False}
    assert DH_SHAPES["smoke_train"] == (16384, 50304, 768)
    ragged = [(T % 64, V % 32) for T, V, d in DH_SHAPES.values()
              if d % 8 == 0]
    assert any(t and v for t, v in ragged)


def test_the_dh_route_sees_the_alignment_of_h_and_w():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it."""
    raw = torch.empty(65 * 64, dtype=torch.bfloat16)
    ok, off = raw[:64 * 64].view(64, 64), raw[1:64 * 64 + 1].view(64, 64)
    assert fc.hopper_recompute(ok, ok)
    assert not fc.hopper_recompute(off, ok)
    assert not fc.hopper_recompute(ok, off)


def test_profile_train_classes_the_new_kernel_as_the_ce_dh():
    for name in (
            "void (anonymous namespace)::fused_ce_dh_hopper_kernel<true, "
            "true>(CUtensorMap_st, CUtensorMap_st, int const*, float const*)",
            "_ZN44_GLOBAL__N__d87d6159_11_fused_ce_cu_d501686025fused_ce_dh_"
            "hopper_kernelILb0ELb1EEEv14CUtensorMap_stS1_PKiPKfS5_P13__nv_"
            "bfloat16S7_iiii"):
        assert kernel_class(name) == "fused_ce_dh", name


# -- the C entries ------------------------------------------------------------

def _c_params(name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "fused_ce.cu")) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("entry,old,argtypes", [
    ("fused_ce_backward_dh_hopper", "fused_ce_backward_dh", "BWD_ARGTYPES"),
    ("fused_ce_backward_dh_sharep_hopper", "fused_ce_backward_dh_sharep",
     "DH_SHAREP_ARGTYPES")], ids=["dh", "dh_sharep"])
def test_ctypes_binding_matches_the_c_prototypes_of_the_new_entries(
        entry, old, argtypes):
    """A pointer declared as an int would be cut to 32 bits. Each new
    entry takes its old counterpart's arguments, so one argtypes list
    binds both."""
    assert _c_params(entry) == getattr(fc, argtypes)
    assert _c_params(old) == getattr(fc, argtypes)


def test_the_stall_hook_builds_a_variant_beside_the_plain_library():
    _, plain = _build._target("fused_ce")
    _, hooked = _build._target("fused_ce", ("-DFUSED_CE_DH_STALL_WG=1",))
    assert plain != hooked
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                            "fused_ce.cu")).read()
    assert "FUSED_CE_DH_STALL_WG" in src


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
    the CPU (this torch has no CUDA); the names of the C entries asked for
    are recorded."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fc, "_fns", {})
    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    asked = []
    real = fc._kernel_fn

    def spy(name, argtypes):
        asked.append(name)
        return real(name, argtypes)
    monkeypatch.setattr(fc, "_kernel_fn", spy)
    return asked


ROUTES = [(torch.bfloat16, 64, "_hopper"), (torch.bfloat16, 768, "_hopper"),
          (torch.bfloat16, 50, ""), (torch.float32, 64, "")]


@pytest.mark.parametrize("sharep", [False, True], ids=["dh", "dh_sharep"])
@pytest.mark.parametrize("dtype,d,suffix", ROUTES,
                         ids=["bf16", "bf16_d768", "bf16_d50", "f32"])
def test_a_cuda_tensor_raises_on_every_dh_route(no_library, monkeypatch,
                                                sharep, dtype, d, suffix):
    monkeypatch.setattr(fc, "fused_ce_bwd_dh_ref", None)          # never
    monkeypatch.setattr(fc, "fused_ce_bwd_dh_sharep_ref", None)   # called
    T, V = 40, 104
    h = _fake(torch.randn(T, d).to(dtype))
    w = _fake(torch.randn(V, d).to(dtype))
    lab = _fake(torch.zeros(T, dtype=torch.int32))
    lse = _fake(torch.zeros(T))
    fc.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        (fc.fused_ce_bwd_dh_sharep if sharep else fc.fused_ce_bwd_dh)(
            h, w, lab, lse, lse)
    kind = "dh_sharep" if sharep else "dh"
    assert no_library == [f"fused_ce_backward_{kind}{suffix}"]
    assert (fc.dh_launches, fc.dh_hopper_launches, fc.dh_sharep_launches,
            fc.dh_sharep_hopper_launches) == (0, 0, 0, 0)


# -- the new kernel's arithmetic, modelled ------------------------------------

HALF = 384   # columns of d a consumer warpgroup owns (RecomputeTile: 6 x 64)
BK = 32      # vocab rows a ring stage


def dh_hopper_model(h, w, lab, lse, g):
    """What ``fused_ce_dh_hopper_kernel`` computes, in float32 on bf16 h
    and w: each warpgroup's partial logits over its half of d (exact
    products summed in float32), the two added in the order half 0 + half
    1; dl = (exp(s - lse) - onehot) g in float32, rounded to bfloat16; dh
    = dl w summed in float32 over 32-vocab-row tiles in order, rounded to
    bfloat16. A label outside [0, V) picks no column. Returns ``(dh,
    dl)``, dl the bf16 ``[T, V]`` tiles that fed dh (what dh_sharep
    stores)."""
    hf, wf = h.float(), w.float()
    T, V = h.shape[0], w.shape[0]
    s = hf[:, :HALF] @ wf[:, :HALF].t() + hf[:, HALF:] @ wf[:, HALF:].t()
    onehot = lab.long()[:, None] == torch.arange(V)[None, :]
    dl = ((torch.exp(s - lse[:, None]) - onehot.float()) * g[:, None]) \
        .to(torch.bfloat16)
    dh = torch.zeros(T, h.shape[1])
    for v0 in range(0, V, BK):
        dh = dh + dl[:, v0:v0 + BK].float() @ wf[v0:v0 + BK]
    return dh.to(torch.bfloat16), dl


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a, np.float32)), b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _inputs(T, V, d, seed):
    """A third of the rows ignored (-100, g = 0) and every 16th label past
    the Pallas side's padded vocabulary (ROADMAP caveat 6: a label in
    [V, Vpad) would pick a padded column there) with its g kept: there dh
    is the softmax term alone."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    lab[1::16] = 1024 + 7
    lab[::3] = -100
    g = (rng.random(T) / T).astype(np.float32)
    g[::3] = 0.0
    th = torch.from_numpy(h).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    return th, tw, torch.from_numpy(lab), torch.from_numpy(g)


def _pallas_bwd(h, w, lab, lse, g, share_p, block_t=128, block_v=256):
    """``(dh, dw)`` of the Pallas backward in interpret mode
    (``_bwd_dh_kernel`` and ``_bwd_dw_kernel``, or with ``share_p`` the
    pair ``_bwd_dh_kernel_sharep`` and ``_bwd_dw_kernel_sharep``, dw from
    the stored bf16 dl), T padded to the token block with rows that weigh
    nothing (label -100, lse 0, g 0)."""
    T = h.shape[0]
    tp = -(-T // block_t) * block_t
    pad = tp - T
    hp = np.concatenate([h.float().numpy(),
                         np.zeros((pad, h.shape[1]), np.float32)])
    labp = np.concatenate([lab.numpy(), np.full(pad, -100, np.int32)])
    lsep = np.concatenate([lse.numpy(), np.zeros(pad, np.float32)])
    gp = np.concatenate([g.numpy(), np.zeros(pad, np.float32)])
    prev = K._INTERPRET, K._SHARE_P
    K._INTERPRET, K._SHARE_P = True, share_p
    try:
        jdh, jdw = K._fused_ce_bwd_impl(
            jnp.asarray(hp, jnp.bfloat16),
            jnp.asarray(w.float().numpy(), jnp.bfloat16), jnp.asarray(labp),
            jnp.asarray(lsep), jnp.asarray(gp), block_t, block_v)
    finally:
        K._INTERPRET, K._SHARE_P = prev
    return (np.asarray(jdh.astype(jnp.float32))[:T],
            np.asarray(jdw.astype(jnp.float32)))


def _softmax_rows(lab, g, V):
    """The token rows whose label picks nothing and whose g is not 0:
    there dh is the softmax term alone, many times smaller than where the
    one-hot term lands."""
    return ((lab < 0) | (lab >= V)) & (g != 0)


@pytest.mark.parametrize("share_p", [False, True], ids=["dh", "dh_sharep"])
@pytest.mark.parametrize("T,V,d", [(300, 700, 768), (200, 500, 96)],
                         ids=["d768_both_halves", "d96_one_half"])
def test_model_of_the_new_dh_matches_pallas_in_interpret_mode(T, V, d,
                                                              share_p):
    """Ragged T and V (T = 300 and 200 off the 64-token block and the
    Pallas side's 128; V off the 32-row tile, padded to 768 or 512 there),
    a third of the rows ignored and every 16th label past the padded
    vocabulary. With ``share_p`` the model's dl, the tiles that fed its
    dh, is what the Pallas pair's dw pass reads: dw from it within the
    limit of the Pallas pair's dw."""
    th, tw, tlab, tg = _inputs(T, V, d, 41)
    _, lse = fc.fused_ce_fwd_ref(th, tw, tlab)
    model, mdl = dh_hopper_model(th, tw, tlab, lse, tg)
    jdh, jdw = _pallas_bwd(th, tw, tlab, lse, tg, share_p)
    assert model.dtype == torch.bfloat16 and jdh.shape == (T, d)
    soft = _softmax_rows(tlab, tg, V)
    assert 0 < int(soft.sum()) < T
    assert _rel(jdh, model) <= GRAD_TOL
    assert _rel(jdh[soft.numpy()], model[soft]) <= GRAD_TOL
    plain, pdl = fc.fused_ce_bwd_dh_sharep_ref(th, tw, tlab, lse, tg)
    assert torch.equal(plain, fc.fused_ce_bwd_dh_ref(th, tw, tlab, lse, tg))
    assert _rel(plain.float().numpy(), model) <= GRAD_TOL
    assert _rel(plain[soft].float().numpy(), model[soft]) <= GRAD_TOL
    # g = 0 rows: no gradient and a zero dl row
    assert not model[::3].any() and not mdl[::3].any()
    # the model's dl is the plain bf16 dl up to one rounding step
    steps = chip_smoke.bf16_steps(mdl, pdl)
    assert int(steps.max()) <= 1
    if share_p:
        assert _rel(jdw, fc.fused_ce_bwd_dw_sharep_ref(th, mdl)) <= GRAD_TOL


def test_model_rounds_dl_where_the_plain_version_does_not():
    """The model's one rounding point the plain dh lacks: dl to bfloat16
    before dl @ w. With it, the model stays within the limit of the plain
    dh but is not equal to it."""
    rng = np.random.default_rng(43)
    T, V, d = 96, 300, 768
    h = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((V, d)) * 0.1)
                         .astype(np.float32)).to(torch.bfloat16)
    lab = torch.from_numpy(rng.integers(0, V, (T,)).astype(np.int32))
    g = torch.full((T,), 1.0 / T)
    _, lse = fc.fused_ce_fwd_ref(h, w, lab)
    plain = fc.fused_ce_bwd_dh_ref(h, w, lab, lse, g).float()
    model = dh_hopper_model(h, w, lab, lse, g)[0].float()
    err = float((model - plain).abs().max() / plain.abs().max())
    assert 0 < err <= GRAD_TOL
