"""The wgmma/TMA design of the recomputing fused-CE dw
(``paddle_tpu_torch/kernels/csrc/fused_ce.cu`` ``fused_ce_dw_hopper_kernel``),
on the CPU.

- Routing: ``fused_ce.hopper_recompute`` (bfloat16 h and w, d a multiple
  of 8, both 16-byte aligned) on every shape ``chip_smoke.py`` and the card
  tests (``tests/test_torch_cuda.py``) run, float32, mixed dtypes, d = 50
  and inputs that are not 16-byte aligned.
- The ctypes prototype of the new C entry, and its stall hook's variant.
- A CUDA tensor without the library raises on either dw route, runs no
  plain version and counts no launch.
- The new kernel's arithmetic: the logits as two partial sums over the
  halves of d that its warpgroups own, added in one fixed order; dl in
  float32, rounded to bfloat16 before ``dlᵀ @ h``; 32-token tiles summed
  in order. A plain PyTorch model of it is held against the Pallas
  ``_bwd_dw_kernel`` in interpret mode and against the port's plain dw on
  ragged V, labels outside ``[0, V)`` and rows with g = 0, at the bfloat16
  gradient limit the card holds the kernel to (1e-2 of max-abs), with the
  softmax-only rows held apart at the same limit.

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

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (T, V, d) of every recomputing dw the card runs
DW_SHAPES = {**{f"smoke_{n}": c[:3]
                for n, c in chip_smoke.FCE_CASES.items()},
             **{f"card_{n}": c for n, c in _CARD.FCE_CASES.items()}}
GRAD_TOL = _CARD.FCE_TOL[torch.bfloat16][1]   # 1e-2 of max-abs


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(DW_SHAPES))
def test_dw_route_for_every_shape_the_card_runs(case):
    T, V, d = DW_SHAPES[case]
    h, w = _empty((T, d), torch.bfloat16), _empty((V, d), torch.bfloat16)
    assert fc.hopper_recompute(h, w) is (d % 8 == 0)
    assert not fc.hopper_recompute(h.float(), w.float())
    assert not fc.hopper_recompute(h, w.float())
    assert not fc.hopper_recompute(h.float(), w)


def test_the_card_runs_both_dw_routes_in_bf16():
    """The card's bf16 cases reach the wgmma dw and, at d = 50, the wmma
    dw's bf16 instantiation; the training shape takes the wgmma one."""
    assert {d % 8 == 0 for _, _, d in DW_SHAPES.values()} == {True, False}
    assert DW_SHAPES["smoke_train"] == (16384, 50304, 768)


def test_the_dw_route_sees_the_alignment_of_h_and_w():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it."""
    raw = torch.empty(65 * 64, dtype=torch.bfloat16)
    ok, off = raw[:64 * 64].view(64, 64), raw[1:64 * 64 + 1].view(64, 64)
    assert fc.hopper_recompute(ok, ok)
    assert not fc.hopper_recompute(off, ok)
    assert not fc.hopper_recompute(ok, off)


# -- the C entry --------------------------------------------------------------

def _c_params(name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "fused_ce.cu")) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


def test_ctypes_binding_matches_the_c_prototype_of_the_new_entry():
    """A pointer declared as an int would be cut to 32 bits. The new entry
    takes its old counterpart's arguments, so one argtypes list binds
    both."""
    assert _c_params("fused_ce_backward_dw_hopper") == fc.BWD_ARGTYPES
    assert _c_params("fused_ce_backward_dw") == fc.BWD_ARGTYPES


def test_the_stall_hook_builds_a_variant_beside_the_plain_library():
    _, plain = _build._target("fused_ce")
    _, hooked = _build._target("fused_ce", ("-DFUSED_CE_DW_STALL_WG=1",))
    assert plain != hooked
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                            "fused_ce.cu")).read()
    assert "FUSED_CE_DW_STALL_WG" in src


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
    monkeypatch.setattr(fc, "_fns", {})
    asked = []
    real = fc._kernel_fn

    def spy(name, argtypes):
        asked.append(name)
        return real(name, argtypes)
    monkeypatch.setattr(fc, "_kernel_fn", spy)
    return asked


@pytest.mark.parametrize("dtype,d,entry", [
    (torch.bfloat16, 64, "fused_ce_backward_dw_hopper"),
    (torch.bfloat16, 768, "fused_ce_backward_dw_hopper"),
    (torch.bfloat16, 50, "fused_ce_backward_dw"),
    (torch.float32, 64, "fused_ce_backward_dw")],
    ids=["bf16", "bf16_d768", "bf16_d50", "f32"])
def test_a_cuda_tensor_raises_on_either_dw_route(no_library, monkeypatch,
                                                 dtype, d, entry):
    monkeypatch.setattr(fc, "fused_ce_bwd_dw_ref", None)   # never called
    T, V = 40, 104
    h = _fake(torch.randn(T, d).to(dtype))
    w = _fake(torch.randn(V, d).to(dtype))
    lab = _fake(torch.zeros(T, dtype=torch.int32))
    lse = _fake(torch.zeros(T))
    fc.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        fc.fused_ce_bwd_dw(h, w, lab, lse, lse)
    assert no_library == [entry]
    assert (fc.dw_launches, fc.dw_hopper_launches) == (0, 0)


# -- the new kernel's arithmetic, modelled ------------------------------------

HALF = 384   # columns of d a consumer warpgroup owns (DwRecompute: 6 x 64)
BK = 32      # tokens a ring stage


def dw_hopper_model(h, w, lab, lse, g):
    """What ``fused_ce_dw_hopper_kernel`` computes, in float32 on bf16 h
    and w: each warpgroup's partial logits over its half of d (exact
    products summed in float32), the two added in the order half 0 + half
    1; dl = (exp(s - lse) - onehot) g in float32, rounded to bfloat16;
    dw = dlᵀ h summed in float32 over 32-token tiles in order, rounded to
    bfloat16. A label outside [0, V) picks no column."""
    hf, wf = h.float(), w.float()
    T, V = h.shape[0], w.shape[0]
    s = hf[:, :HALF] @ wf[:, :HALF].t() + hf[:, HALF:] @ wf[:, HALF:].t()
    onehot = lab.long()[:, None] == torch.arange(V)[None, :]
    dl = ((torch.exp(s - lse[:, None]) - onehot.float()) * g[:, None]) \
        .to(torch.bfloat16).float()
    dw = torch.zeros(V, h.shape[1])
    for t0 in range(0, T, BK):
        dw = dw + dl[t0:t0 + BK].t() @ hf[t0:t0 + BK]
    return dw.to(torch.bfloat16)


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a, np.float32)), b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _softmax_rows(lab, V):
    """The vocab rows no label picks: there dw is the softmax term alone,
    many times smaller than where the one-hot term lands."""
    free = torch.ones(V, dtype=torch.bool)
    picks = lab[(lab >= 0) & (lab < V)].long()
    free[picks] = False
    return free


@pytest.mark.parametrize("T,V,d", [(256, 700, 768), (256, 500, 96)],
                         ids=["d768_both_halves", "d96_one_half"])
def test_model_of_the_new_dw_matches_pallas_in_interpret_mode(T, V, d):
    """Ragged V (the Pallas side pads it to 768 or 512), a third of the
    rows ignored (-100, g = 0) and every 16th label past the padded
    vocabulary (ROADMAP caveat 6: a label in [V, Vpad) would pick a padded
    column there) with its g kept."""
    rng = np.random.default_rng(31)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    lab[1::16] = 1024 + 7
    lab[::3] = -100
    g = (rng.random(T) / T).astype(np.float32)
    g[::3] = 0.0
    th = torch.from_numpy(h).to(torch.bfloat16)
    tw = torch.from_numpy(w).to(torch.bfloat16)
    tlab, tg = torch.from_numpy(lab), torch.from_numpy(g)
    _, lse = fc.fused_ce_fwd_ref(th, tw, tlab)
    model = dw_hopper_model(th, tw, tlab, lse, tg)
    prev = K._INTERPRET
    K._INTERPRET = True
    try:
        _, jdw = K._fused_ce_bwd_impl(
            jnp.asarray(th.float().numpy(), jnp.bfloat16),
            jnp.asarray(tw.float().numpy(), jnp.bfloat16), jnp.asarray(lab),
            jnp.asarray(lse.numpy()), jnp.asarray(g), 128, 256)
    finally:
        K._INTERPRET = prev
    jdw = np.asarray(jdw.astype(jnp.float32))
    assert model.dtype == torch.bfloat16 and jdw.shape == (V, d)
    free = _softmax_rows(tlab, V)
    assert 0 < int(free.sum()) < V
    assert _rel(jdw, model) <= GRAD_TOL
    assert _rel(jdw[free.numpy()], model[free]) <= GRAD_TOL
    plain = fc.fused_ce_bwd_dw_ref(th, tw, tlab, lse, tg)
    assert _rel(plain.float().numpy(), model) <= GRAD_TOL
    assert _rel(plain[free].float().numpy(), model[free]) <= GRAD_TOL


def test_model_rounds_dl_where_the_plain_version_does_not():
    """The model's one rounding point the plain dw lacks: dl to bfloat16
    before dlᵀ @ h. With it taken out, the model is the plain dw up to
    float32 summation order."""
    rng = np.random.default_rng(32)
    T, V, d = 96, 300, 768
    h = torch.from_numpy(rng.standard_normal((T, d)).astype(np.float32)) \
        .to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((V, d)) * 0.1)
                         .astype(np.float32)).to(torch.bfloat16)
    lab = torch.from_numpy(rng.integers(0, V, (T,)).astype(np.int32))
    g = torch.full((T,), 1.0 / T)
    _, lse = fc.fused_ce_fwd_ref(h, w, lab)
    plain = fc.fused_ce_bwd_dw_ref(h, w, lab, lse, g).float()
    model = dw_hopper_model(h, w, lab, lse, g).float()
    err = float((model - plain).abs().max() / plain.abs().max())
    assert 0 < err <= GRAD_TOL
