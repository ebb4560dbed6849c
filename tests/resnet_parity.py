"""Shared by ``test_torch_resnet.py`` (ResNet-18) and
``test_torch_resnet_train.py`` (ResNet-50), a helper module, not
collected: the reference and port ResNets with the same state, batches,
the two ``TrainStep``s and the whole-model checks (the error measures
are ``chip_smoke.py``'s, which holds the card against the CPU). See
``test_torch_resnet_train.py`` for the tolerances and why ResNet-50's
residual gains are scaled."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.sharding import Mesh

from chip_smoke import l2_rel as l2
from chip_smoke import max_rel as err
from chip_smoke import resnet_dtypes, update_l2
import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu.vision.models import resnet18 as jax_resnet18
from paddle_tpu.vision.models import resnet50 as jax_resnet50
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.parallel.api import TrainStep
from paddle_tpu_torch.vision.models import (load_reference_state,
                                            reference_state, resnet18,
                                            resnet50)

torch.set_num_threads(2)

B, HW, K, CLASSES, LR = 4, 64, 3, 10, 1e-4
LOGIT_TOL, BUF_TOL, EVAL_TOL, LOSS_RTOL = 1e-3, 1e-4, 1e-4, 1e-5
BF16_LOSS_ATOL = 2e-2
# arch: reference, port, residual gain, #params, #buffers, gradient and
# update tolerances (relative L2, see the docstring)
ARCHS = {"resnet50": (jax_resnet50, resnet50, 0.25, 161, 106, 5e-2, 1e-1),
         "resnet18": (jax_resnet18, resnet18, 1.0, 62, 40, 1e-4, 5e-2)}


def one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


_BUILT = {}


def reference(arch):
    """The reference model (built once a process: it takes seconds) and
    its initial state."""
    if arch not in _BUILT:
        paddle.seed(0)
        ref = ARCHS[arch][0](num_classes=CLASSES)
        _BUILT[arch] = (ref, jax_state(ref))
    return _BUILT[arch]


def jax_state(ref):
    return ({n: np.asarray(p._array) for n, p in ref.named_parameters()},
            {n: np.asarray(b._array) for n, b in ref.named_buffers()})


def models(arch, gain=None):
    """The reference (reset to its initial state, residual gains scaled by
    ``gain``, the arch's own by default) and the port carrying it."""
    ref, (params, buffers) = reference(arch)
    gain = ARCHS[arch][2] if gain is None else gain
    params = {n: a * np.float32(gain) if n.endswith("bn3.weight") else a
              for n, a in params.items()}
    for n, p in ref.named_parameters():
        p._array = jnp.asarray(params[n])
    for n, b in ref.named_buffers():
        b._array = jnp.asarray(buffers[n])
    ref.train()
    port = ARCHS[arch][1](num_classes=CLASSES, device="cpu", seed=1)
    load_reference_state(port, params, buffers)
    return ref, port


def batch(k=None, seed=0):
    rng = np.random.RandomState(seed)
    lead = (B,) if k is None else (k, B)
    return (rng.rand(*lead, 3, HW, HW).astype(np.float32),
            rng.randint(0, CLASSES, lead).astype(np.int64))


def to_np(t):
    return t.detach().float().cpu().numpy()


def jax_loss(m, x, y):
    return JF.cross_entropy(m(x), y)


def port_loss(m, x, y):
    return cross_entropy(m(x), y)


def steps(ref, port, lr=LR, nesterov=False, loss_fns=(jax_loss,
                                                       port_loss)):
    jstep = JaxTrainStep(ref, loss_fns[0], jopt.Momentum(
        learning_rate=lr, momentum=0.9, use_nesterov=nesterov,
        parameters=ref.parameters()), mesh=one_device_mesh())
    step = TrainStep(port, loss_fns[1], Momentum(
        learning_rate=lr, momentum=0.9, use_nesterov=nesterov), device="cpu")
    return jstep, step


def assert_state(port, ref, p0, tol, what):
    """Parameter updates since ``p0`` in relative L2 within ``tol``, and
    the buffers."""
    pp, pb = reference_state(port)
    jp, jb = jax_state(ref)
    assert list(pp) == list(jp) and list(pb) == list(jb)
    for n in jp:
        e = update_l2(pp[n], jp[n], p0[n])
        assert e <= tol, (what, n, e)
    for n in jb:
        assert err(pb[n], jb[n]) <= BUF_TOL, (what, n, err(pb[n], jb[n]))


def dtypes_jax(m, x, y):
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        t = m.conv1(paddle.to_tensor(x))
        out = [str(t.dtype)]
        t = m.bn1(t)
        out.append(str(t.dtype))
        t = m.maxpool(m.relu(t))
        for layer in (m.layer1, m.layer2, m.layer3, m.layer4):
            for blk in layer:
                t = blk(t)
                out.append(str(t.dtype))
        logits = m(paddle.to_tensor(x))
        out.append(str(logits.dtype))
    out.append(str(JF.cross_entropy(logits, paddle.to_tensor(y)).dtype))
    return out


def dtypes_port(m, x, y):
    return [str(t).replace("torch.", "") for t in resnet_dtypes(
        m, torch.from_numpy(x), torch.from_numpy(y))]


def check_names_shapes_and_counts(arch):
    ref, port = models(arch)
    n_params, n_buffers = ARCHS[arch][3:5]
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    assert [(n, tuple(p.shape)) for n, p in port.named_parameters()] == want
    want = [(n, tuple(b.shape)) for n, b in ref.named_buffers()]
    assert [(n, tuple(b.shape)) for n, b in port.named_buffers()] == want
    assert (len(want), len(list(port.parameters()))) == (n_buffers,
                                                          n_params)
    assert all(b.dtype == torch.float32 for b in port.buffers())


def check_train_logits_and_running_stats(arch, gain=None):
    ref, port = models(arch, gain)
    x, _ = batch()
    want = np.asarray(ref(paddle.to_tensor(x))._array)
    got = to_np(port(torch.from_numpy(x)))
    assert got.shape == (B, CLASSES)
    assert err(got, want) <= LOGIT_TOL
    pb, jb = reference_state(port)[1], jax_state(ref)[1]
    for n in jb:
        assert err(pb[n], jb[n]) <= BUF_TOL, n


def check_grad_step(arch):
    """Gradients by name, the loss, and the buffers ``grad_step`` moved."""
    ref, port = models(arch)
    x, y = batch()
    jstep, step = steps(ref, port)
    jloss, jgrads, _ = jstep.grad_step(x, y)
    loss, grads, aux = step.grad_step(torch.from_numpy(x),
                                      torch.from_numpy(y))
    assert aux is None
    assert step._param_names == jstep._param_names
    assert len(grads) == ARCHS[arch][3]
    np.testing.assert_allclose(float(loss), float(np.asarray(jloss._array)),
                               rtol=LOSS_RTOL)
    for name, g, jg in zip(step._param_names, grads, jgrads):
        e = l2(to_np(g), np.asarray(jg))
        assert e <= ARCHS[arch][5], (name, e)
    pb, jb = reference_state(port)[1], jax_state(ref)[1]
    assert not np.allclose(jb["bn1._mean_buf"], 0.0)
    for n in jb:
        assert err(pb[n], jb[n]) <= BUF_TOL, n


def check_multi_step_then_eval(arch):
    """K ``multi_step`` steps: losses, parameters and buffers by name; then
    eval-mode logits, which read the carried running statistics."""
    ref, port = models(arch)
    p0 = jax_state(ref)[0]
    xs, ys = batch(K, seed=1)
    jstep, step = steps(ref, port)
    jl = np.asarray(jstep.multi_step(xs, ys)._array)
    pl = to_np(step.multi_step(torch.from_numpy(xs), torch.from_numpy(ys)))
    assert pl.shape == (K,)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    assert_state(port, ref, p0, ARCHS[arch][6], "after multi_step")
    ref.eval()
    port.eval()
    x, _ = batch(seed=2)
    want = np.asarray(ref(paddle.to_tensor(x))._array)
    assert err(to_np(port(torch.from_numpy(x))), want) <= EVAL_TOL
