"""The ResNet slice's pieces in the PyTorch port against the JAX
reference on the CPU, with inputs from numpy seeds:

- ``nn.functional.conv2d`` (strides 1/2, paddings 0/1/3, per-side pairs
  as 2n ints and as pairs, ``"SAME"`` at stride 2 with and without
  dilation, ``"VALID"``, groups 1/2, dilation 2, with and without bias,
  NCHW and NHWC), ``max_pool2d``, ``avg_pool2d`` and
  ``adaptive_avg_pool2d`` against ``paddle_tpu.nn.functional``: outputs
  and the gradients of every input, ``err`` (largest absolute difference
  over the reference's largest absolute value) within 1e-5;
- ``batch_norm`` in train, eval and ``use_global_stats`` modes: output,
  the gradients of x, weight and bias, and both running statistics after
  one update within 1e-5, including two values a channel (where the
  unbiased variance is twice the biased one: torch's own running update
  is shown to miss there; dx, which cancels to O(eps / var) there, within
  1e-2), NHWC and a bf16 input with float32 weight, bias and statistics
  (bf16 output within 1e-2);
- ``Momentum``, plain and Nesterov, through both ``TrainStep``s
  (``multi_step`` and ``__call__``) on a small CNN: per-step losses rtol
  1e-5 and parameters and buffers ``err`` 1e-5 after K = 4 steps;
- ResNet-18 as a whole (the checks of ``tests/resnet_parity.py``, with
  the tolerances of ``test_torch_resnet_train.py``: gradients ``l2``
  1e-4, updates 5e-2);
- NHWC ResNet-18 against the NCHW model on permuted inputs (logits,
  buffers and gradients ``err`` 1e-4) and against the reference's NHWC
  forward (logits 1e-3, buffers 1e-4);
- the layers' initialisation, the device policy and what raises."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import resnet_parity as R
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu.vision.models import resnet18 as jax_resnet18
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.layers import kaiming_uniform
from paddle_tpu_torch.optimizer import AdamW, Momentum
from paddle_tpu_torch.parallel.api import TrainStep
from paddle_tpu_torch.vision.models import (load_reference_state,
                                            reference_state, resnet18,
                                            resnet50)

TOL = 1e-5
TWO_VALUES_DX_TOL = 1e-2
BF16_TOL = 1e-2
LAYOUT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(R.one_device_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jax_grads(fn, arrays, g):
    """The reference's eager output and the gradients of ``sum(out * g)``
    with respect to each of ``arrays``."""
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    (out * paddle.to_tensor(g)).sum().backward()
    return np.asarray(out._array), [np.asarray(t.grad._array) for t in ts]


def _port_grads(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _hold(fn_jax, fn_port, arrays, out_shape, tols=None):
    """Output and gradients within ``TOL``, or ``tols[i]`` for the
    gradient of ``arrays[i]``."""
    g = _rand(np.random.default_rng(9), *out_shape)
    jout, jg = _jax_grads(fn_jax, arrays, g)
    pout, pg = _port_grads(fn_port, arrays, g)
    assert pout.shape == jout.shape == tuple(out_shape)
    assert R.err(pout, jout) <= TOL
    for i, (a, b) in enumerate(zip(pg, jg)):
        tol = (tols or {}).get(i, TOL)
        assert R.err(a, b) <= tol, (i, R.err(a, b))


# (x NCHW, w, stride, padding, dilation, groups, bias, format)
CONV_CASES = {
    "s1_p0_1x1": ((2, 6, 9, 9), (8, 6, 1, 1), 1, 0, 1, 1, False, "NCHW"),
    "s1_p1_3x3_bias": ((2, 4, 9, 9), (6, 4, 3, 3), 1, 1, 1, 1, True, "NCHW"),
    "s2_p3_7x7": ((2, 3, 16, 16), (8, 3, 7, 7), 2, 3, 1, 1, False, "NCHW"),
    "s2_p1_3x3": ((2, 4, 10, 10), (6, 4, 3, 3), 2, 1, 1, 1, False, "NCHW"),
    "pairs_2n_ints": ((2, 4, 9, 8), (6, 4, 3, 3), 1, [1, 2, 0, 1], 1, 1,
                      True, "NCHW"),
    "pairs_lists": ((2, 4, 9, 8), (6, 4, 3, 2), (2, 1), [[0, 2], [1, 0]], 1,
                    1, False, "NCHW"),
    "same_s2_even": ((2, 4, 8, 8), (6, 4, 3, 3), 2, "SAME", 1, 1, True,
                     "NCHW"),
    "same_s2_odd": ((2, 4, 9, 7), (6, 4, 3, 3), 2, "same", 1, 1, False,
                    "NCHW"),
    "same_dilated": ((2, 4, 10, 9), (6, 4, 3, 3), 2, "SAME", 2, 1, False,
                     "NCHW"),
    "valid": ((2, 4, 9, 9), (6, 4, 3, 3), 1, "VALID", 1, 1, True, "NCHW"),
    "groups2": ((2, 8, 9, 9), (6, 4, 3, 3), 1, 1, 1, 2, True, "NCHW"),
    "dilation2": ((2, 4, 11, 11), (6, 4, 3, 3), 1, 2, 2, 1, False, "NCHW"),
    "nhwc_s2_p1": ((2, 4, 10, 10), (6, 4, 3, 3), 2, 1, 1, 1, True, "NHWC"),
    "nhwc_same_s2": ((2, 4, 8, 8), (6, 4, 3, 3), 2, "SAME", 1, 1, False,
                     "NHWC"),
    "nhwc_groups2_pairs": ((2, 8, 9, 8), (6, 4, 3, 3), 1, [1, 2, 0, 1], 1, 2,
                           False, "NHWC"),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_conv2d_matches_reference(case):
    xs, ws, stride, padding, dilation, groups, bias, fmt = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = _rand(rng, *xs)
    if fmt == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    arrays = [x, _rand(rng, *ws)] + ([_rand(rng, ws[0])] if bias else [])
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups, data_format=fmt)

    def jfn(*a):
        return JF.conv2d(a[0], a[1], a[2] if bias else None, **kw)

    def pfn(*a):
        return F.conv2d(a[0], a[1], a[2] if bias else None, **kw)

    shape = tuple(jfn(*[paddle.to_tensor(a) for a in arrays]).shape)
    _hold(jfn, pfn, arrays, shape)


def test_conv2d_refuses_bad_arguments():
    x, w = torch.zeros(1, 2, 5, 5), torch.zeros(3, 2, 3, 3)
    for padding in ("FULL", [1, 2, 3], [[1, 2, 3]], 1.5,
                    [[0, 0], [0, 0], [2, 1], [1, 1]]):
        with pytest.raises((ValueError, TypeError)):
            F.conv2d(x, w, padding=padding)
    with pytest.raises(ValueError):
        F.conv2d(x, w, data_format="NCDHW")


def test_conv2d_under_o1_casts_x_and_w_and_adds_the_bias_outside():
    from paddle_tpu_torch import amp
    x, w, b = torch.randn(1, 2, 5, 5), torch.randn(3, 2, 3, 3), torch.randn(3)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert F.conv2d(x, w).dtype == torch.bfloat16
        assert F.conv2d(x, w, b).dtype == torch.float32   # f32 bias promotes
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jx = paddle.to_tensor(x.numpy())
        jw, jb = paddle.to_tensor(w.numpy()), paddle.to_tensor(b.numpy())
        assert str(JF.conv2d(jx, jw).dtype) == "bfloat16"
        assert str(JF.conv2d(jx, jw, jb).dtype) == "float32"


# (x NCHW, op, kwargs)
POOL_CASES = {
    "max_3_2_1": ((2, 3, 9, 9), "max", dict(kernel_size=3, stride=2,
                                             padding=1)),
    "max_3_2_1_nhwc": ((2, 3, 10, 10), "max",
                       dict(kernel_size=3, stride=2, padding=1,
                            data_format="NHWC")),
    "max_same_s2": ((2, 3, 8, 7), "max", dict(kernel_size=3, stride=2,
                                               padding="SAME")),
    "max_pairs": ((2, 3, 8, 8), "max", dict(kernel_size=2, stride=2,
                                             padding=[0, 1, 1, 0])),
    "avg_2": ((2, 3, 8, 8), "avg", dict(kernel_size=2)),
    "avg_3_1_1_exclusive": ((2, 3, 7, 7), "avg",
                            dict(kernel_size=3, stride=1, padding=1)),
    "avg_3_2_1_inclusive": ((2, 3, 7, 7), "avg",
                            dict(kernel_size=3, stride=2, padding=1,
                                 exclusive=False)),
    "adaptive_1": ((2, 3, 7, 7), "adaptive", dict(output_size=(1, 1))),
    "adaptive_3_of_7": ((2, 3, 7, 8), "adaptive", dict(output_size=3)),
    "adaptive_3x2_nhwc": ((2, 3, 7, 5), "adaptive",
                          dict(output_size=(3, 2), data_format="NHWC")),
}


@pytest.mark.parametrize("case", list(POOL_CASES))
def test_pooling_matches_reference(case):
    xs, op, kw = POOL_CASES[case]
    x = _rand(np.random.default_rng(len(case)), *xs)
    if kw.get("data_format") == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    name = {"max": "max_pool2d", "avg": "avg_pool2d",
            "adaptive": "adaptive_avg_pool2d"}[op]
    jfn, pfn = getattr(JF, name), getattr(F, name)
    shape = tuple(jfn(paddle.to_tensor(x), **kw).shape)
    _hold(lambda t: jfn(t, **kw), lambda t: pfn(t, **kw), [x], shape)


def test_pooling_refuses_what_is_not_ported():
    x = torch.zeros(1, 2, 6, 6)
    for call in (lambda: F.max_pool2d(x, 2, ceil_mode=True),
                 lambda: F.max_pool2d(x, 2, return_mask=True),
                 lambda: F.avg_pool2d(x, 3, padding=[0, 1, 0, 1]),
                 lambda: F.avg_pool2d(x, 2, divisor_override=3)):
        with pytest.raises(NotImplementedError):
            call()


# (x shape, training, use_global_stats, data_format)
BN_CASES = {
    "train": ((4, 3, 5, 5), True, None, "NCHW"),
    "eval": ((4, 3, 5, 5), False, None, "NCHW"),
    "train_global_stats": ((4, 3, 5, 5), True, True, "NCHW"),
    "eval_batch_stats": ((4, 3, 5, 5), False, False, "NCHW"),
    "two_values_a_channel": ((2, 6), True, None, "NC"),
    "two_values_1x1_maps": ((2, 5, 1, 1), True, None, "NCHW"),
    "nhwc_train": ((3, 4, 5, 6), True, None, "NHWC"),
}


def _bn_inputs(shape, fmt, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1] if fmt == "NHWC" else shape[1]
    x = (_rand(rng, *shape) * 2.0 + 0.5).astype(np.float32)
    return (x, rng.uniform(0.5, 1.5, c).astype(np.float32),
            _rand(rng, c), _rand(rng, c) * 0.3,
            rng.uniform(0.5, 2.0, c).astype(np.float32))


@pytest.mark.parametrize("case", list(BN_CASES))
def test_batch_norm_matches_reference(case):
    shape, training, ugs, fmt = BN_CASES[case]
    x, w, b, rm, rv = _bn_inputs(shape, fmt, len(case))
    jstats = [paddle.to_tensor(rm), paddle.to_tensor(rv)]
    pstats = [torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())]
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format=fmt, use_global_stats=ugs)
    # with two values a channel x_hat is +-1 and dx cancels to O(eps/var),
    # some 1e-4 of its terms: float32 keeps three digits of it
    _hold(lambda *a: JF.batch_norm(a[0], *jstats, a[1], a[2], **kw),
          lambda *a: F.batch_norm(a[0], *pstats, a[1], a[2], **kw),
          [x, w, b], shape,
          tols={0: TWO_VALUES_DX_TOL} if case.startswith("two") else None)
    for p, j in zip(pstats, jstats):
        assert R.err(p.numpy(), np.asarray(j._array)) <= TOL
    updated = not (ugs if ugs is not None else not training)
    assert updated == (not np.allclose(pstats[1].numpy(), rv))
    if case.startswith("two_values"):
        # torch's convention (momentum on the new value, unbiased
        # variance) misses the reference here by far more than TOL
        tm, tv = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
        xt = torch.from_numpy(x)
        torch.nn.functional.batch_norm(xt, tm, tv, None, None, True, 0.1)
        assert R.err(tv.numpy(), np.asarray(jstats[1]._array)) > 100 * TOL


def test_batch_norm_bf16_input_keeps_float32_statistics():
    x, w, b, rm, rv = _bn_inputs((4, 3, 5, 5), "NCHW", 3)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    stats = [torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())]
    out = F.batch_norm(xb, *stats, torch.from_numpy(w), torch.from_numpy(b),
                       training=True)
    jstats = [paddle.to_tensor(rm), paddle.to_tensor(rv)]
    jx = paddle.to_tensor(xb.float().numpy()).astype("bfloat16")
    jout = JF.batch_norm(jx, *jstats, paddle.to_tensor(w),
                         paddle.to_tensor(b), training=True)
    assert out.dtype == torch.bfloat16 and str(jout.dtype) == "bfloat16"
    assert all(s.dtype == torch.float32 for s in stats)
    assert R.err(out.float().numpy(),
                 np.asarray(jout._array).astype(np.float32)) <= BF16_TOL
    for p, j in zip(stats, jstats):
        assert str(j.dtype) == "float32"
        assert R.err(p.numpy(), np.asarray(j._array)) <= TOL


def _small_cnns():
    """The same small CNN in both frameworks (children named as the
    reference's ``Sequential`` names them) with the reference's weights."""
    paddle.seed(3)
    ref = jnn.Sequential(
        jnn.Conv2D(3, 4, 3, padding=1), jnn.BatchNorm2D(4), jnn.ReLU(),
        jnn.MaxPool2D(2, 2),
        jnn.Conv2D(4, 6, 3, stride=2, padding="SAME"), jnn.BatchNorm2D(6),
        jnn.ReLU(), jnn.AdaptiveAvgPool2D(1), jnn.Flatten(),
        jnn.Linear(6, 5))
    kw = dict(device="cpu")
    port = nn.Sequential(
        nn.Conv2D(3, 4, 3, padding=1, **kw), nn.BatchNorm2D(4, **kw),
        nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(4, 6, 3, stride=2, padding="SAME", **kw),
        nn.BatchNorm2D(6, **kw), nn.ReLU(), nn.AdaptiveAvgPool2D(1),
        torch.nn.Flatten(), nn.Linear(6, 5, **kw))
    nn.load_named_state(port, *R.jax_state(ref))
    return ref, port


@pytest.mark.parametrize("nesterov", [False, True], ids=["plain", "nesterov"])
@pytest.mark.parametrize("call", ["multi_step", "__call__"])
def test_momentum_through_both_train_steps(nesterov, call):
    ref, port = _small_cnns()
    rng = np.random.RandomState(5)
    k = 4
    xs = rng.rand(k, 6, 3, 12, 12).astype(np.float32)
    ys = rng.randint(0, 5, (k, 6)).astype(np.int64)
    jstep = JaxTrainStep(ref, R.jax_loss, jopt.Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=nesterov,
        parameters=ref.parameters()), mesh=R.one_device_mesh())
    step = TrainStep(port, R.port_loss, Momentum(
        learning_rate=0.05, momentum=0.9, use_nesterov=nesterov),
        device="cpu")
    if call == "multi_step":
        jl = np.asarray(jstep.multi_step(xs, ys)._array)
        pl = R.to_np(step.multi_step(torch.from_numpy(xs),
                                     torch.from_numpy(ys)))
    else:
        jl = [float(np.asarray(jstep(xs[i], ys[i])._array))
              for i in range(k)]
        pl = [float(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
              for i in range(k)]
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert abs(pl[-1] - pl[0]) > 1e-3          # the steps moved the model
    (pp, pb), (jp, jb) = reference_state(port), R.jax_state(ref)
    for n in jp:
        assert R.err(pp[n], jp[n]) <= TOL, n
    for n in jb:
        assert R.err(pb[n], jb[n]) <= TOL, n


def test_train_step_refuses_what_the_reference_drops():
    m = nn.Sequential(nn.Linear(3, 2, device="cpu"))
    for opt in (Momentum(weight_decay=1e-4), Momentum(rescale_grad=0.5)):
        with pytest.raises(NotImplementedError):
            TrainStep(m, R.port_loss, opt, device="cpu")
    for opt in (Momentum(weight_decay=None), Momentum(weight_decay=0.0),
                AdamW()):
        TrainStep(m, R.port_loss, opt, device="cpu")


def test_resnet18_names_shapes_and_counts():
    R.check_names_shapes_and_counts("resnet18")


def test_resnet18_train_logits_and_running_stats():
    R.check_train_logits_and_running_stats("resnet18")


def test_resnet18_grad_step_grads_by_name_and_buffers():
    R.check_grad_step("resnet18")


def test_resnet18_multi_step_then_eval_logits():
    R.check_multi_step_then_eval("resnet18")


def test_resnet18_nesterov_calls_match_step_by_step():
    """``__call__`` K times (Nesterov) against the reference's per-call
    step, buffers included."""
    ref, port = R.models("resnet18")
    p0 = R.jax_state(ref)[0]
    xs, ys = R.batch(R.K, seed=3)
    jstep, step = R.steps(ref, port, nesterov=True)
    for i in range(R.K):
        jl = float(np.asarray(jstep(xs[i], ys[i])._array))
        pl = float(step(torch.from_numpy(xs[i]), torch.from_numpy(ys[i])))
        np.testing.assert_allclose(pl, jl, rtol=R.LOSS_RTOL)
    R.assert_state(port, ref, p0, R.ARCHS["resnet18"][6], "after __call__")


def test_nhwc_resnet18_equals_nchw_and_the_reference():
    ref, nchw = R.models("resnet18")
    params, buffers = R.jax_state(ref)
    nhwc = resnet18(num_classes=R.CLASSES, data_format="NHWC", device="cpu")
    load_reference_state(nhwc, params, buffers)
    x, y = R.batch()
    xh = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
    outs, grads = [], []
    for m, xx in ((nchw, x), (nhwc, xh)):
        loss = R.port_loss(m, torch.from_numpy(xx), torch.from_numpy(y))
        outs.append(R.to_np(m(torch.from_numpy(xx))))
        grads.append(dict(zip([n for n, _ in m.named_parameters()],
                              torch.autograd.grad(loss, list(
                                  m.parameters())))))
    assert R.err(outs[1], outs[0]) <= LAYOUT_TOL
    for n, g in grads[0].items():
        assert R.err(R.to_np(grads[1][n]), R.to_np(g)) <= LAYOUT_TOL, n
    b0, b1 = reference_state(nchw)[1], reference_state(nhwc)[1]
    for n in b0:
        assert R.err(b1[n], b0[n]) <= LAYOUT_TOL, n
    paddle.seed(0)
    jref = jax_resnet18(num_classes=R.CLASSES, data_format="NHWC")
    for n, p in jref.named_parameters():
        p._array = paddle.to_tensor(params[n])._array
    for n, b in jref.named_buffers():
        b._array = paddle.to_tensor(buffers[n])._array
    fresh = resnet18(num_classes=R.CLASSES, data_format="NHWC", device="cpu")
    load_reference_state(fresh, params, buffers)
    want = np.asarray(jref(paddle.to_tensor(xh))._array)
    assert R.err(R.to_np(fresh(torch.from_numpy(xh))), want) <= R.LOGIT_TOL
    fb, jb = reference_state(fresh)[1], R.jax_state(jref)[1]
    for n in jb:
        assert R.err(fb[n], jb[n]) <= R.BUF_TOL, n


def test_layer_initialisation_follows_the_reference():
    rng = np.random.default_rng(0)
    w = kaiming_uniform(rng, (64, 32, 3, 3), 32 * 9)
    limit = np.sqrt(6.0 / (32 * 9))
    assert w.dtype == np.float32 and np.abs(w).max() <= limit
    assert np.abs(w).max() > 0.99 * limit
    conv = nn.Conv2D(8, 6, 3, groups=2, device="cpu")
    assert tuple(conv.weight.shape) == (6, 4, 3, 3)
    assert float(conv.bias.detach().abs().max()) <= 1.0 / np.sqrt(4 * 9)
    assert nn.Conv2D(8, 6, 1, bias_attr=False, device="cpu").bias is None
    bn = nn.BatchNorm2D(5, device="cpu")
    assert [n for n, _ in bn.named_buffers()] == ["_mean_buf",
                                                  "_variance_buf"]
    assert bn._mean is bn._mean_buf and float(bn._variance.sum()) == 5.0
    assert bn.weight.tolist() == [1.0] * 5 and bn.bias.tolist() == [0.0] * 5
    assert (bn._momentum, bn._epsilon) == (0.9, 1e-5)


def test_unported_options_and_bad_state_raise():
    with pytest.raises(NotImplementedError):
        resnet18(pretrained=True, device="cpu")
    with pytest.raises(NotImplementedError):
        nn.Conv2D(2, 2, 3, padding_mode="reflect", device="cpu")
    m = resnet18(num_classes=4, device="cpu")
    params, buffers = reference_state(m)
    load_reference_state(m, params, buffers)
    with torch.no_grad():          # copies: the model moving leaves them
        m.conv1.weight.add_(1.0)
        m.bn1._mean_buf.add_(1.0)
    assert not np.allclose(reference_state(m)[0]["conv1.weight"],
                           params["conv1.weight"])
    assert np.all(buffers["bn1._mean_buf"] == 0.0)
    for bad in ({k: v for k, v in buffers.items() if k != "bn1._mean_buf"},
                dict(buffers, extra=np.zeros(3, np.float32)),
                dict(buffers, **{"bn1._mean_buf": np.zeros(3, np.float32)})):
        with pytest.raises((KeyError, ValueError)):
            load_reference_state(m, params, bad)


def test_entry_points_refuse_the_cpu_without_being_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the policy's other side")
    with pytest.raises(RuntimeError):
        resnet50()
    m = resnet18(num_classes=4, device="cpu")
    with pytest.raises(RuntimeError):
        TrainStep(m, R.port_loss, Momentum())


def test_profile_classes_for_the_resnet_step():
    from paddle_tpu_torch.tools.profile_train import kernel_class
    for name, cls in (
            ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc",
             "convolution"),
            ("sm90_xmma_wgrad_indexed_implicit_gemm_bf16bf16_bf16f32",
             "convolution"),
            ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bf",
             "convolution"),
            ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816"
             "fprop_optimized_bf16_256x64_32x4_nhwc_align8>", "convolution"),
            ("void at::native::batch_norm_backward_kernel<c10::BFloat16, "
             "float, float, int>", "batch_norm"),
            ("void at::native::batch_norm_collect_statistics_channels_last_"
             "kernel<at::native::Var, c10::BFloat16, float, 4>",
             "batch_norm"),
            ("void at::native::(anonymous namespace)::max_pool_backward_nchw"
             "<c10::BFloat16, float, int>", "pooling"),
            ("void at::native::vectorized_elementwise_kernel<8, at::native::"
             "CUDAFunctor_add<c10::BFloat16>", "elementwise"),
            ("void at::native::(anonymous namespace)::multi_tensor_apply_"
             "kernel<TensorListMetadata<3>>", "optimizer"),
            ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64",
             "matmul")):
        assert kernel_class(name) == cls, name


def test_bench_resnet_runs_bench_py_step_on_the_cpu_when_asked():
    from paddle_tpu_torch.tools import bench_resnet
    rec = bench_resnet.run(batch=2, k=2, warmup=1, reps=1, device="cpu")
    assert rec["metric"] == "resnet50_train_imgs_per_sec_per_chip"
    assert rec["unit"] == "imgs/sec/chip" and "vs_baseline" not in rec
    assert len(rec["losses"]) == 4 and np.isfinite(rec["losses"]).all()
    # ResNet-50 at 224 x 224: 4.087 G multiply-adds an image in its 53
    # convs (the published 4.09 G) and 2.048 M in the head
    assert rec["forward_flops_per_image"] == 2 * (4_087_136_256 + 2_048_000)
    assert rec["mfu"] == pytest.approx(
        rec["value"] * 3 * rec["forward_flops_per_image"] / 989e12)
    m, _ = bench_resnet.build("NHWC", "cpu")
    assert bench_resnet.forward_flops_per_image(
        m, bench_resnet.image_shape("NHWC"), "cpu") == \
        rec["forward_flops_per_image"]
