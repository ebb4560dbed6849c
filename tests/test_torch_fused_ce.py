"""Fused head + softmax cross entropy of the PyTorch port
(paddle_tpu_torch/kernels/fused_ce.py, nn/functional/loss.py) against the
JAX reference on the CPU.

- The plain NLL and its gradients (through the port's autograd Function)
  against ``paddle_tpu.kernels.fused_ce_pallas.fused_softmax_ce`` run in
  interpret mode (``_INTERPRET``, set and restored here as
  ``tests/test_fused_ce.py`` does) and ``jax.grad`` through its
  ``custom_vjp``. Cases: aligned (T=256, V=512), ragged (T=300, V=500, the
  Pallas side pads both), bf16, and labels outside ``[0, V)``.
- ``F.fused_linear_cross_entropy`` against the reference's, with
  ``ignore_index`` rows and an all-ignored batch (0, not NaN), with and
  without O1 autocast.
- The vocab-split combine the card's forward uses, the wrappers' routing
  and the ctypes prototypes of the three C entries.

Tolerances as in ``tests/test_fused_ce.py``: float32 NLL 1e-4, gradients
1e-5; bfloat16 2e-2 and 2e-3 (both sides round the products' inputs to
bf16 but sum in other orders). The CUDA kernels are held against these
plain versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.kernels.fused_ce_pallas as K
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.nn.functional import fused_linear_cross_entropy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CASES = {  # T, d, V, Pallas block_t, block_v, dtype, nll tol, grad tol
    "aligned": (256, 64, 512, 128, 256, "float32", 1e-4, 1e-5),
    "ragged": (300, 64, 500, 128, 256, "float32", 1e-4, 1e-5),
    "bf16": (256, 64, 512, 128, 256, "bfloat16", 2e-2, 2e-3),
    "labels_outside_vocab": (300, 64, 500, 128, 256, "float32", 1e-4,
                             1e-5),
}


def _inputs(T, d, V, seed=0):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    return h, w, lab


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_the_pallas_kernels_in_interpret_mode(case):
    T, d, V, bt, bv, dt, tol, gtol = CASES[case]
    h, w, lab = _inputs(T, d, V)
    if case == "labels_outside_vocab":
        # past the padded vocab (the Pallas side pads V to 512, and a label
        # in [V, 512) would pick a padded column's -1e30 logit there)
        lab[::3] = -100
        lab[1::7] = V + 100
    jh, jw = (jnp.asarray(a, dtype=dt) for a in (h, w))
    jlab = jnp.asarray(lab)
    prev = K._INTERPRET
    K._INTERPRET = True
    try:
        jnll = K.fused_softmax_ce(jh, jw, jlab, block_t=bt, block_v=bv)
        jgh, jgw = jax.grad(lambda a, b: jnp.mean(K.fused_softmax_ce(
            a, b, jlab, block_t=bt, block_v=bv)), argnums=(0, 1))(jh, jw)
    finally:
        K._INTERPRET = prev
    tdt = getattr(torch, dt)
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    nll = fc.fused_softmax_ce(th, tw, torch.from_numpy(lab).long())
    nll.mean().backward()
    assert nll.dtype == torch.float32 and nll.shape == (T,)
    assert th.grad.dtype == tdt and tw.grad.dtype == tdt
    np.testing.assert_allclose(nll.detach().numpy(), _f32(jnll), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(th.grad.float().numpy(), _f32(jgh),
                               rtol=gtol, atol=gtol, err_msg="dh")
    np.testing.assert_allclose(tw.grad.float().numpy(), _f32(jgw),
                               rtol=gtol, atol=gtol, err_msg="dw")


def _ref_loss(h, w, lab, **amp_kw):
    jh, jw = paddle.to_tensor(h), paddle.to_tensor(w)
    jh.stop_gradient = False
    jw.stop_gradient = False
    if amp_kw:
        with paddle.amp.auto_cast(**amp_kw):
            loss = JF.fused_linear_cross_entropy(jh, jw,
                                                 paddle.to_tensor(lab))
    else:
        loss = JF.fused_linear_cross_entropy(jh, jw, paddle.to_tensor(lab))
    loss.backward()
    return (float(np.asarray(loss.numpy())), _f32(jh.grad.numpy()),
            _f32(jw.grad.numpy()), str(loss.dtype))


def _port_loss(h, w, lab, **amp_kw):
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    if amp_kw:
        with amp.auto_cast(**amp_kw):
            loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab))
    else:
        loss = fused_linear_cross_entropy(th, tw, torch.from_numpy(lab))
    loss.backward()
    return (float(loss.detach()), th.grad.numpy(), tw.grad.numpy(),
            str(loss.dtype).replace("torch.", ""))


@pytest.mark.parametrize("ignored", ["some", "all"])
def test_functional_matches_the_reference_with_ignore_index(ignored):
    rng = np.random.default_rng(1)
    h = rng.standard_normal((2, 20, 32)).astype(np.float32)
    w = (rng.standard_normal((100, 32)) * 0.1).astype(np.float32)
    lab = rng.integers(0, 100, (2, 20)).astype(np.int64)
    if ignored == "some":
        lab[:, ::5] = -100
    else:
        lab[:] = -100
    want, wgh, wgw, _ = _ref_loss(h, w, lab)
    got, gh, gw, dt = _port_loss(h, w, lab)
    assert dt == "float32"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gh, wgh, rtol=1e-5, atol=1e-7, err_msg="dh")
    np.testing.assert_allclose(gw, wgw, rtol=1e-5, atol=1e-7, err_msg="dw")
    if ignored == "all":
        assert got == 0.0 and not np.any(gh) and not np.any(gw)


def test_functional_under_o1_casts_the_operands_to_bf16():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((48, 32)).astype(np.float32)
    w = (rng.standard_normal((80, 32)) * 0.1).astype(np.float32)
    lab = rng.integers(0, 80, (48,)).astype(np.int64)
    lab[::4] = -100
    kw = dict(level="O1", dtype="bfloat16")
    want, wgh, wgw, wdt = _ref_loss(h, w, lab, **kw)
    got, gh, gw, dt = _port_loss(h, w, lab, **kw)
    assert dt == "float32" and "float32" in wdt
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)
    np.testing.assert_allclose(gh, wgh, rtol=0, atol=2e-3, err_msg="dh")
    np.testing.assert_allclose(gw, wgw, rtol=0, atol=2e-3, err_msg="dw")
    # the operands really went through bf16: not the f32 loss
    exact, _, _, _ = _port_loss(h, w, lab)
    assert got != exact


def test_vocab_split_combine_equals_the_whole_softmax():
    """What the card's forward writes per vocab split, merged by
    ``_combine``, is the whole row's (nll, lse); an empty split holds
    (-inf, 0, 0)."""
    h, w, lab = (torch.from_numpy(a) for a in _inputs(40, 16, 300, seed=3))
    lab[::6] = -100
    s = h @ w.t()
    parts = []
    for lo, hi in ((0, 128), (128, 256), (256, 300), (300, 300)):
        blk = s[:, lo:hi]
        if hi == lo:
            parts.append((torch.full((40,), -torch.inf), torch.zeros(40),
                          torch.zeros(40)))
            continue
        m = blk.amax(1)
        pick = (lab[:, None] == torch.arange(lo, hi)[None]).float()
        parts.append((m, torch.exp(blk - m[:, None]).sum(1),
                      (blk * pick).sum(1)))
    nll, lse = fc._combine(*(torch.stack(p) for p in zip(*parts)))
    rnll, rlse = fc.fused_ce_fwd_ref(h, w, lab)
    torch.testing.assert_close(lse, rlse, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nll, rnll, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(nll[::6], lse[::6], rtol=0, atol=0)


def test_kernel_argument_checks_refuse_what_the_kernels_do_not_take():
    """What the wrappers check before a launch, on any device: types,
    shapes, contiguity and the hidden size the register accumulators
    cover."""
    h, w, lab = (torch.from_numpy(a) for a in _inputs(12, 16, 40, seed=6))
    fc._check(h, w, lab)
    fc._check(h.bfloat16(), w.bfloat16(), lab, lse=torch.zeros(12))
    bad = [
        ((h.double(), w.double(), lab), {}, TypeError),
        ((h, w.bfloat16(), lab), {}, TypeError),
        ((h, w, lab.long()), {}, TypeError),
        ((h, w[:, :8], lab), {}, ValueError),
        ((h, w, lab[:11]), {}, ValueError),
        ((h.t().contiguous().t(), w, lab), {}, ValueError),
        ((h, w, lab), {"g": torch.zeros(11)}, ValueError),
        ((h, w, lab), {"g": torch.zeros(12, dtype=torch.float64)},
         ValueError),
        ((torch.zeros(2, fc.MAX_D + 1), torch.zeros(3, fc.MAX_D + 1),
          lab[:2]), {}, ValueError),
        ((h, w[:0], lab), {}, ValueError),
    ]
    for args, rows, err in bad:
        with pytest.raises(err):
            fc._check(*args, **rows)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    h, w, lab = (torch.from_numpy(a) for a in _inputs(33, 24, 70, seed=4))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(33)
                         .astype(np.float32))
    fc.reset_launches()
    th, tw = h.clone().requires_grad_(), w.clone().requires_grad_()
    nll = fc.fused_softmax_ce(th, tw, lab.long())
    nll.backward(g)
    assert (fc.fwd_launches, fc.dh_launches, fc.dw_launches) == (0, 0, 0)
    rnll, lse = fc.fused_ce_fwd_ref(h, w, lab)
    torch.testing.assert_close(nll.detach(), rnll, rtol=0, atol=0)
    torch.testing.assert_close(th.grad, fc.fused_ce_bwd_dh_ref(
        h, w, lab, lse, g), rtol=0, atol=0)
    torch.testing.assert_close(tw.grad, fc.fused_ce_bwd_dw_ref(
        h, w, lab, lse, g), rtol=0, atol=0)
    # the backward of the plain forward by autograd agrees
    ah, aw = h.clone().requires_grad_(), w.clone().requires_grad_()
    fc.fused_ce_fwd_ref(ah, aw, lab)[0].backward(g)
    torch.testing.assert_close(th.grad, ah.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(tw.grad, aw.grad, rtol=1e-5, atol=1e-6)
    with fc.use_plain():
        assert fc._plain
    assert not fc._plain


def test_ctypes_bindings_match_the_c_prototypes():
    """Each wrapper's argtypes list the C entry's parameters in order: a
    pointer declared as an int would be cut to 32 bits."""
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "fused_ce.cu")) as f:
        text = f.read()
    for name, want in (("fused_ce_forward_splits", fc.SPLITS_ARGTYPES),
                       ("fused_ce_forward", fc.FWD_ARGTYPES),
                       ("fused_ce_backward_dh", fc.BWD_ARGTYPES),
                       ("fused_ce_backward_dw", fc.BWD_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                        re.S).group(1)
        params = [" ".join(p.split()) for p in sig.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.startswith("float") else ctypes.c_int
                 for p in params]
        assert kinds == want, name


def test_bench_entry_point_counts_the_reference_flops_and_refuses_numerics():
    """``paddle_tpu_torch.tools.bench_gpt_pretrain`` keeps the reference's
    model FLOPs a token (``tools/bench_gpt_pretrain.py:33-35``); its
    ``--numerics`` pass is not ported and raises before anything runs."""
    import importlib.util

    from paddle_tpu_torch.tools import bench_gpt_pretrain as bgp
    spec = importlib.util.spec_from_file_location(
        "reference_bench", os.path.join(ROOT, "tools", "bench_gpt_pretrain.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for args in ((12, 768, 50304, 1024), (2, 64, 128, 32)):
        assert bgp.model_flops_per_token(*args) == \
            ref.model_flops_per_token(*args)
    with pytest.raises(NotImplementedError):
        bgp.run(2, 16, numerics="stats")
