"""The shared-dl fused-CE backward of the PyTorch port
(``paddle_tpu_torch/kernels/fused_ce.py`` with ``_SHARE_P`` set) against the
JAX reference's ``_SHARE_P`` pair on the CPU.

- The plain pair through the port's autograd Function against
  ``paddle_tpu.kernels.fused_ce_pallas`` with its ``_SHARE_P`` and
  ``_INTERPRET`` set (and restored here, as ``tests/test_fused_ce.py``
  does): the Pallas ``_bwd_dh_kernel_sharep`` / ``_bwd_dw_kernel_sharep``
  run in interpret mode. Cases as ``tests/test_torch_fused_ce.py``.
- The plain functions' own contract: dh as the recomputing dh, dl bf16
  ``[T, V]`` whatever the inputs' type, dw from the bf16 dl, zero rows for
  g = 0 and nothing picked by a label outside ``[0, V)``, empty T.
- Which kernels the backward asks for: the pair only when both gradients
  are needed and the flag is set.
- A few-layer GPT with ``fused_ce=True`` and the flag set against the JAX
  ``TrainStep`` with ``fused_ce=True`` (on the CPU the reference answers
  through its XLA composition, float32 dl throughout).

Tolerances. nll and dh as ``tests/test_torch_fused_ce.py`` (dh is the
recomputing path's: float32 1e-5, bf16 2e-3). dw sums the products of a
bf16-rounded dl; the two sides round float32 dl values that differ in the
last bits, so an element of dl may land one bf16 step apart. Measured: dw
within 3.4e-7 absolute in the float32 cases (max-abs 0.019; the Pallas
pair itself is 3.6e-5 from the recompute path) and 9.5e-7 in bf16; held
to rtol 1e-4 / atol 2e-6 (float32) and the bf16 gradient tolerance 2e-3,
inside the reference's own bar against the recompute path (rtol 1e-2 /
atol 1e-4, ``tests/test_fused_ce.py:170-173``). Against the reference's
float32 dl (the GPT slice), each term of the tied embedding's head
gradient carries one bf16 rounding of dl (2^-9 of it): measured 7.4e-4 of
the gradient's max-abs, held to 2^-8; everything else is the recomputing
path's."""
import contextlib
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
import paddle_tpu.kernels.fused_ce_pallas as K
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.api import TrainStep

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {  # T, d, V, Pallas block_t, block_v, dtype, nll tol, dh tol, dw tol
    "aligned": (256, 64, 512, 128, 256, "float32", 1e-4, 1e-5,
                (1e-4, 2e-6)),
    "ragged": (300, 64, 500, 128, 256, "float32", 1e-4, 1e-5, (1e-4, 2e-6)),
    "bf16": (256, 64, 512, 128, 256, "bfloat16", 2e-2, 2e-3, (2e-3, 2e-3)),
    "labels_outside_vocab": (300, 64, 500, 128, 256, "float32", 1e-4, 1e-5,
                             (1e-4, 2e-6)),
}


@contextlib.contextmanager
def share_p():
    """The port's flag set, restored on the way out."""
    prev, fc._SHARE_P = fc._SHARE_P, True
    try:
        yield
    finally:
        fc._SHARE_P = prev


def _inputs(T, d, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    return h, w, lab


def _f32(a):
    return np.asarray(a, np.float32)


def test_the_flag_is_off_by_default_as_in_the_reference():
    assert fc._SHARE_P is False and K._SHARE_P is False


@pytest.mark.parametrize("case", list(CASES))
def test_plain_pair_matches_the_pallas_share_p_pair_in_interpret_mode(case):
    T, d, V, bt, bv, dt, tol, htol, (wrtol, watol) = CASES[case]
    h, w, lab = _inputs(T, d, V)
    if case == "labels_outside_vocab":
        # past the Pallas side's padded vocab (512), see test_torch_fused_ce
        lab[::3] = -100
        lab[1::7] = V + 100
    jh, jw = (jnp.asarray(a, dtype=dt) for a in (h, w))
    jlab = jnp.asarray(lab)
    prev = K._INTERPRET, K._SHARE_P
    K._INTERPRET, K._SHARE_P = True, True
    try:
        jnll = K.fused_softmax_ce(jh, jw, jlab, block_t=bt, block_v=bv)
        jgh, jgw = jax.grad(lambda a, b: jnp.mean(K.fused_softmax_ce(
            a, b, jlab, block_t=bt, block_v=bv)), argnums=(0, 1))(jh, jw)
    finally:
        K._INTERPRET, K._SHARE_P = prev
    tdt = getattr(torch, dt)
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    with share_p():
        nll = fc.fused_softmax_ce(th, tw, torch.from_numpy(lab).long())
        nll.mean().backward()
    assert th.grad.dtype == tdt and tw.grad.dtype == tdt
    np.testing.assert_allclose(nll.detach().numpy(), _f32(jnll), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(th.grad.float().numpy(), _f32(jgh),
                               rtol=htol, atol=htol, err_msg="dh")
    np.testing.assert_allclose(tw.grad.float().numpy(), _f32(jgw),
                               rtol=wrtol, atol=watol, err_msg="dw")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_pair_keeps_the_recomputing_dh_and_a_bf16_dl(dtype):
    h, w, lab = (torch.from_numpy(a) for a in _inputs(45, 24, 70, seed=2))
    h, w = h.to(dtype), w.to(dtype)
    lab[::4] = -100
    lab[1::9] = 70 + 3
    g = torch.from_numpy(np.random.default_rng(3).random(45)
                         .astype(np.float32) / 45)
    g[::4] = 0.0
    _, lse = fc.fused_ce_fwd_ref(h, w, lab)
    dh, dl = fc.fused_ce_bwd_dh_sharep_ref(h, w, lab, lse, g)
    assert dh.dtype == dtype and dl.dtype == torch.bfloat16
    assert dl.shape == (45, 70)
    torch.testing.assert_close(dh, fc.fused_ce_bwd_dh_ref(h, w, lab, lse, g),
                               rtol=0, atol=0)
    assert not dl[::4].any()                # g = 0: a zero dl row
    want = torch.softmax(h.float() @ w.float().t(), -1) * g[:, None]
    picks = (lab >= 0) & (lab < 70)
    want[picks, lab[picks].long()] -= g[picks]
    torch.testing.assert_close(dl, want.to(torch.bfloat16), rtol=0,
                               atol=2e-9)
    # a label outside [0, V) picks nothing: that row is the softmax alone
    assert bool((dl[1::9].float() >= 0).all())
    dw = fc.fused_ce_bwd_dw_sharep_ref(h, dl)
    assert dw.dtype == dtype and dw.shape == (70, 24)
    torch.testing.assert_close(dw, (dl.float().t() @ h.float()).to(dtype),
                               rtol=0, atol=0)


def test_plain_pair_with_no_tokens_returns_empty_and_zero():
    _, w, _ = _inputs(1, 16, 30)
    w = torch.from_numpy(w)
    h = torch.zeros(0, 16)
    lab = torch.zeros(0, dtype=torch.int32)
    e = torch.zeros(0)
    dh, dl = fc.fused_ce_bwd_dh_sharep(h, w, lab, e, e)
    assert dh.shape == (0, 16) and dl.shape == (0, 30)
    assert dl.dtype == torch.bfloat16
    dw = fc.fused_ce_bwd_dw_sharep(h, dl)
    assert dw.shape == (30, 16) and not dw.any()


@pytest.mark.parametrize("needs,flag,want", [
    ((True, True), True, {"dh_sharep", "dw_sharep"}),
    ((True, False), True, {"dh"}),
    ((False, True), True, {"dw"}),
    ((True, True), False, {"dh", "dw"}),
], ids=["both_shared", "dh_only", "dw_only", "flag_off"])
def test_backward_takes_the_pair_only_when_both_gradients_are_needed(
        monkeypatch, needs, flag, want):
    """With the flag set and both gradients needed, the pair; when only
    one is needed dl would have no reader, so that one's recomputing
    kernel; with the flag off, as before."""
    called = set()

    def spy(name):
        real = getattr(fc, name)

        def f(*a):
            called.add(name.replace("fused_ce_bwd_", ""))
            return real(*a)
        return f
    for name in ("fused_ce_bwd_dh", "fused_ce_bwd_dw",
                 "fused_ce_bwd_dh_sharep", "fused_ce_bwd_dw_sharep"):
        monkeypatch.setattr(fc, name, spy(name))
    monkeypatch.setattr(fc, "_SHARE_P", flag)
    h, w, lab = (torch.from_numpy(a) for a in _inputs(20, 16, 40, seed=4))
    h.requires_grad_(needs[0])
    w.requires_grad_(needs[1])
    fc.fused_softmax_ce(h, w, lab.long()).sum().backward()
    assert called == want
    assert (h.grad is not None) == needs[0]
    assert (w.grad is not None) == needs[1]
    # the gradients are the recomputing path's (dh exactly; dw from dl
    # rounded to bf16)
    _, lse = fc.fused_ce_fwd_ref(h.detach(), w.detach(), lab)
    g = torch.ones(20)
    if needs[0]:
        torch.testing.assert_close(h.grad, fc.fused_ce_bwd_dh_ref(
            h.detach(), w.detach(), lab, lse, g), rtol=0, atol=0)
    if needs[1]:
        torch.testing.assert_close(w.grad, fc.fused_ce_bwd_dw_ref(
            h.detach(), w.detach(), lab, lse, g), rtol=1e-2, atol=2e-3)


def test_dl_rows_for_the_kernels_are_16_byte_aligned():
    """The dw kernel reads dl rows of a stride that is a multiple of 8
    elements: the ``[:, :V]`` view of dh_sharep's buffer goes as it is,
    a contiguous dl whose V is not a multiple of 8 is copied into such
    rows first."""
    buf = fc._dl_rows(5, 45, "cpu")
    assert buf.shape == (5, 48) and buf.dtype == torch.bfloat16
    view = buf[:, :45]
    t, ldd = fc._dl_for_kernel(view)
    assert t is view and ldd == 48
    dense = torch.randn(5, 45).to(torch.bfloat16)
    t, ldd = fc._dl_for_kernel(dense)
    assert ldd == 48 and torch.equal(t[:, :45], dense)
    aligned = torch.randn(5, 40).to(torch.bfloat16)
    assert fc._dl_for_kernel(aligned) == (aligned, 40)


def test_dl_argument_checks_refuse_what_the_kernel_does_not_take():
    h = torch.zeros(6, 16)
    dl = torch.zeros(6, 9, dtype=torch.bfloat16)
    fc._check_dl(h, dl)
    fc._check_dl(h.bfloat16(), dl)
    bad = [
        (h, torch.zeros(6, 9), TypeError),
        (h.double(), dl, TypeError),
        (h, torch.zeros(5, 9, dtype=torch.bfloat16), ValueError),
        (h, torch.zeros(6, 9, 1, dtype=torch.bfloat16), ValueError),
        (h, torch.zeros(6, 0, dtype=torch.bfloat16), ValueError),
        (h, torch.zeros(9, 6, dtype=torch.bfloat16).t(), ValueError),
        (torch.zeros(16, 6).t(), dl, ValueError),
        (torch.zeros(6, fc.MAX_D + 1), dl, ValueError),
    ]
    for a, b, err in bad:
        with pytest.raises(err):
            fc._check_dl(a, b)


def test_ctypes_bindings_match_the_c_prototypes_of_the_pair():
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "fused_ce.cu")) as f:
        text = f.read()
    for name, want in (("fused_ce_backward_dh_sharep",
                        fc.DH_SHAREP_ARGTYPES),
                       ("fused_ce_backward_dw_sharep",
                        fc.DW_SHAREP_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                        re.S).group(1)
        params = [" ".join(p.split()) for p in sig.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int
                 for p in params]
        assert kinds == want, name


# -- the slice: a few-layer GPT with fused_ce=True -----------------------------

B, S, STEPS = 2, 32, 3
EMB_GRAD_TOL = 2 ** -8  # of the tied embedding's max-abs (bf16 dl)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


@pytest.fixture
def one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _models():
    kw = dict(dropout=0.0, bf16_residual=False, fused_ce=True)
    paddle.seed(0)
    ref = jax_gpt2_tiny(**kw)
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    return ref, port


def _batch(k=None, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, 128, (B, S) if k is None else (k, B, S))
    return ids.astype(np.int64), np.roll(ids, -1, axis=-1).astype(np.int64)


def _loss(m, ids, labels):
    return m.loss(ids, labels)


def test_slice_grads_match_the_reference_train_step(one_device_mesh):
    ref, port = _models()
    ids, labels = _batch()
    jstep = JaxTrainStep(ref, _loss, jopt.AdamW(parameters=ref.parameters()),
                         mesh=_mesh())
    jloss, jgrads, _ = jstep.grad_step(ids, labels)
    step = TrainStep(port, _loss, AdamW(), device="cpu")
    with share_p():
        loss, grads, _ = step.grad_step(ids, labels)
    np.testing.assert_allclose(float(loss), float(np.asarray(jloss._array)),
                               rtol=1e-5)
    emb = 0
    for name, g, jg in zip(step._param_names, grads, jgrads):
        g, jg = g.detach().numpy(), np.asarray(jg)
        if name.endswith("wte.weight"):     # the tied head: dw from dl
            emb += 1
            err = np.abs(g - jg).max() / np.abs(jg).max()
            assert err <= EMB_GRAD_TOL, err
        else:
            np.testing.assert_allclose(g, jg, rtol=1e-4, atol=1e-6,
                                       err_msg=name)
    assert emb == 1


def test_slice_trains_like_the_reference_train_step(one_device_mesh):
    """A few AdamW steps (clip 1.0): losses within 1e-5 relative, and
    every parameter within lr of the reference's. Adam divides each
    gradient element by its own magnitude, so an element of the tied
    embedding whose gradient is as small as dl's bf16 rounding may step
    the other way: at most 2 lr a step, the bound held here."""
    ref, port = _models()
    ids, labels = _batch(STEPS)
    lr = 1e-3
    jstep = JaxTrainStep(ref, _loss, jopt.AdamW(
        learning_rate=lr, weight_decay=0.1, grad_clip=JaxClip(1.0),
        parameters=ref.parameters()), mesh=_mesh())
    jl = np.asarray(jstep.multi_step(ids, labels)._array)
    step = TrainStep(port, _loss, AdamW(
        learning_rate=lr, weight_decay=0.1,
        grad_clip=ClipGradByGlobalNorm(1.0)), device="cpu")
    with share_p():
        pl = step.multi_step(torch.from_numpy(ids),
                             torch.from_numpy(labels)).detach().numpy()
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    jp = {n: np.asarray(p._array) for n, p in ref.named_parameters()}
    for name, p in port.named_parameters():
        d = np.abs(p.detach().numpy() - jp[name])
        assert d.max() <= 2 * STEPS * lr, (name, d.max())
