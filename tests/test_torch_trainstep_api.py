"""The hapi surface of the port's ``TrainStep`` against
``paddle_tpu.parallel.api.TrainStep`` on the CPU, on the same small MLP
with the same weights and batches (float32 on both sides, sums in other
orders: losses and outputs rtol 1e-5 / atol 1e-6, parameters after K
steps rtol 1e-5 / atol 1e-6):

- ``has_aux=True`` (the loss and the aux outputs each step),
  ``eval_step`` (with and without aux; eval mode, no update),
  ``predict_step``, ``grad_step`` + ``apply_grads`` (one optimizer state
  with the full step), ``auto_lr_step=False``, the eval-only step
  (``optimizer=None``);
- the optax mapping of SGD, RMSProp (plain and centered, with momentum),
  Adagrad and Lamb, three steps with the global-norm clip;
- ``opt_state_dict`` / ``set_opt_state_dict``: a fresh step loaded from
  the state continues as the original does, bit for bit;
- the refusals: Adamax and AdamDelta (which the reference runs as plain
  SGD, ROADMAP caveat 16) and the arguments its optax mapping drops;
- ROADMAP caveat 18: under O2 bf16 the reference's step casts optax's
  hyperparameters to bf16 (b2 = 0.999 becomes 1.0) and AdamW turns the
  parameters to NaN at the first update; the port's keeps them float32
  and its parameters finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as plr
from paddle_tpu_torch.parallel.api import TrainStep

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(AXES_ORDER)), AXES_ORDER))
    yield
    mesh_mod.set_mesh(prev)


def _nets(seed=0):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(6, 5).astype(np.float32) * 0.5,
          rng.randn(5).astype(np.float32) * 0.1,
          rng.randn(5, 3).astype(np.float32) * 0.5,
          rng.randn(3).astype(np.float32) * 0.1]
    ref = jnn.Sequential(jnn.Linear(6, 5), jnn.ReLU(), jnn.Linear(5, 3))
    port = nn.Sequential(nn.Linear(6, 5, device="cpu"), nn.ReLU(),
                         nn.Linear(5, 3, device="cpu"))
    for jp, pp, w in zip(ref.parameters(), port.parameters(), ws):
        jp._array = jnp.asarray(w)
        with torch.no_grad():
            pp.copy_(torch.from_numpy(w))
    return ref, port


def _jloss(m, x, y):
    out = m(x)
    d = out - y
    return paddle.mean(d * d), out


def _ploss(m, x, y):
    out = m(x)
    d = out - y
    return (d * d).mean(), out


def _batches(n, seed=5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(8, 6).astype(np.float32),
             rng.randn(8, 3).astype(np.float32)) for _ in range(n)]


def _params_close(ref, port, msg=""):
    for k, (jp, pp) in enumerate(zip(ref.parameters(), port.parameters())):
        np.testing.assert_allclose(pp.detach().numpy(),
                                   np.asarray(jp._array), err_msg=f"{msg}"
                                   f" param {k}", **TOL)


def test_has_aux_eval_predict_and_apply_grads_match():
    ref, port = _nets()
    jo = jopt.AdamW(0.01, parameters=ref.parameters(), weight_decay=0.02,
                    grad_clip=JClip(0.5))
    po = popt.AdamW(0.01, weight_decay=0.02,
                    grad_clip=ClipGradByGlobalNorm(0.5))
    js = JaxTrainStep(ref, _jloss, jo, has_aux=True)
    ps = TrainStep(port, _ploss, po, device="cpu", has_aux=True)
    for i, (x, y) in enumerate(_batches(3)):
        jl, jaux = js(x, y)
        pl, paux = ps(x, y)
        np.testing.assert_allclose(float(pl), float(jl._array), **TOL)
        np.testing.assert_allclose(paux.numpy(), np.asarray(jaux._array),
                                   **TOL)
        assert not paux.requires_grad
        _params_close(ref, port, f"step {i}")
    x, y = _batches(1, 9)[0]
    jl, jaux = js.eval_step(x, y)
    pl, paux = ps.eval_step(x, y)
    np.testing.assert_allclose(float(pl), float(jl._array), **TOL)
    np.testing.assert_allclose(paux.numpy(), np.asarray(jaux._array), **TOL)
    np.testing.assert_allclose(ps.predict_step(x).numpy(),
                               np.asarray(js.predict_step(x)._array), **TOL)
    assert port.training
    # gradients computed apart, applied through the same optimizer state
    jl, jg, _ = js.grad_step(x, y)
    pl, pg, paux = ps.grad_step(x, y)
    assert paux is not None
    for a, b in zip(pg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    js.apply_grads([paddle.Tensor(g) for g in jg])
    ps.apply_grads(pg)
    _params_close(ref, port, "apply_grads")
    assert ps._step_count == js._step_count == 4
    # and the full step goes on from the same state
    jl, _ = js(x, y)
    pl, _ = ps(x, y)
    np.testing.assert_allclose(float(pl), float(jl._array), **TOL)
    _params_close(ref, port, "after apply_grads")


def test_eval_only_step_and_auto_lr_step():
    ref, port = _nets(1)
    ev = TrainStep(port, _ploss, None, device="cpu", has_aux=True)
    jev = JaxTrainStep(ref, _jloss, None, has_aux=True)
    x, y = _batches(1)[0]
    np.testing.assert_allclose(float(ev.eval_step(x, y)[0]),
                               float(jev.eval_step(x, y)[0]._array), **TOL)
    with pytest.raises(RuntimeError):
        ev(x, y)
    with pytest.raises(RuntimeError):
        ev.apply_grads([None] * 4)
    assert ev.opt_state_dict() is None
    sched = plr.StepDecay(0.1, step_size=1, gamma=0.5)
    manual = TrainStep(port, lambda m, a, b: _ploss(m, a, b)[0],
                       popt.SGD(sched), device="cpu", auto_lr_step=False)
    manual(x, y)
    manual(x, y)
    assert sched.last_epoch == 0        # the caller owns the scheduler
    auto = TrainStep(port, lambda m, a, b: _ploss(m, a, b)[0],
                     popt.SGD(sched), device="cpu")
    auto(x, y)
    assert sched.last_epoch == 1
    with pytest.raises(NotImplementedError):
        TrainStep(port, _ploss, popt.SGD(0.1), device="cpu",
                  has_aux=True).multi_step(*[np.stack([b[i] for b in
                                                       _batches(2)])
                                             for i in range(2)])


def _make(name, params, pkg):
    clip = (JClip if pkg is jopt else ClipGradByGlobalNorm)(0.5)
    if name == "SGD":
        return pkg.SGD(0.05, parameters=params, grad_clip=clip)
    if name == "RMSProp":
        return pkg.RMSProp(0.01, rho=0.9, momentum=0.5, parameters=params,
                           grad_clip=clip)
    if name == "RMSProp_centered":
        return pkg.RMSProp(0.01, rho=0.9, momentum=0.0, centered=True,
                           parameters=params, grad_clip=clip)
    if name == "Adagrad":
        return pkg.Adagrad(0.05, parameters=params, grad_clip=clip)
    return pkg.Lamb(0.01, lamb_weight_decay=0.02, parameters=params,
                    grad_clip=clip)


@pytest.mark.parametrize("name", ["SGD", "RMSProp", "RMSProp_centered",
                                  "Adagrad", "Lamb"])
def test_optax_mapped_optimizers_match_the_reference(name):
    ref, port = _nets(2)
    js = JaxTrainStep(ref, lambda m, x, y: _jloss(m, x, y)[0],
                      _make(name, ref.parameters(), jopt))
    ps = TrainStep(port, lambda m, x, y: _ploss(m, x, y)[0],
                   _make(name, None, popt), device="cpu")
    for i, (x, y) in enumerate(_batches(3, 7)):
        np.testing.assert_allclose(float(ps(x, y)), float(js(x, y)._array),
                                   **TOL)
        _params_close(ref, port, f"{name} step {i}")


def test_opt_state_round_trips_into_a_fresh_step():
    _, port = _nets(3)
    twin = nn.Sequential(nn.Linear(6, 5, device="cpu"), nn.ReLU(),
                         nn.Linear(5, 3, device="cpu"))
    twin.load_state_dict(port.state_dict())
    loss = lambda m, x, y: _ploss(m, x, y)[0]  # noqa: E731
    a = TrainStep(port, loss, popt.Lamb(0.01), device="cpu")
    bs = _batches(3, 11)
    for x, y in bs[:2]:
        a(x, y)
    state = a.opt_state_dict()
    assert isinstance(state["mu"][0], np.ndarray) and state["count"] == 2
    twin.load_state_dict(port.state_dict())
    b = TrainStep(twin, loss, popt.Lamb(0.01), device="cpu")
    b.set_opt_state_dict(state)
    x, y = bs[2]
    assert torch.equal(a(x, y), b(x, y))
    for p, q in zip(port.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(ValueError):
        b.set_opt_state_dict({"count": 0, "mu": [], "nu": []})


def test_refuses_what_the_reference_drops():
    _, port = _nets()
    loss = lambda m, x, y: _ploss(m, x, y)[0]  # noqa: E731
    for opt in (popt.Adamax(0.01), popt.AdamDelta(0.01),
                popt.Lamb(exclude_from_weight_decay_fn=lambda p: True),
                popt.Adagrad(0.1, initial_accumulator_value=0.5),
                popt.SGD(0.1, weight_decay=0.01),
                popt.RMSProp(0.1, weight_decay=popt.L2Decay(0.01)),
                popt.Adagrad(0.1, weight_decay=popt.L1Decay(0.01))):
        with pytest.raises(NotImplementedError):
            TrainStep(port, loss, opt, device="cpu")
    for opt in (popt.SGD(0.1), popt.RMSProp(0.1), popt.Adagrad(0.1),
                popt.Lamb()):
        TrainStep(port, loss, opt, device="cpu")


def test_o2_bf16_adamw_the_reference_steps_to_nan_the_port_does_not():
    ref, port = _nets(4)
    jamp.decorate(ref, level="O2", dtype="bfloat16")
    amp.decorate(port, level="O2", dtype="bfloat16")

    def jl(m, x, y):
        with jamp.auto_cast(level="O2"):
            return _jloss(m, x, y)[0]

    def pl(m, x, y):
        with amp.auto_cast(level="O2"):
            return _ploss(m, x, y)[0]
    js = JaxTrainStep(ref, jl, jopt.AdamW(0.01, parameters=ref.parameters()))
    ps = TrainStep(port, pl, popt.AdamW(0.01), device="cpu")
    assert float(js._opt_state.hyperparams["b2"]) == 1.0   # 0.999 in bf16
    x, y = _batches(1)[0]
    js(x, y)
    ps(x, y)
    assert np.isnan(np.asarray(list(ref.parameters())[0]._array,
                               np.float32)).any()
    assert all(bool(torch.isfinite(p.float()).all())
               for p in port.parameters())
    assert all(p.dtype == torch.bfloat16 for p in port.parameters())
    assert all(t.dtype == torch.float32 for t in ps._opt_state["mu"])
