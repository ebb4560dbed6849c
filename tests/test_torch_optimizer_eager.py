"""The eager optimizers of the PyTorch port against the JAX reference on
the CPU: ``paddle_tpu_torch.optimizer`` (``step``, ``clear_grad``,
``state_dict``) against ``paddle_tpu.optimizer``'s ``_update_param``
rules (``optimizer.py:243-510``), on the same small MLP with the same
weights and batches.

Each of the nine optimizers runs three eager steps in three settings:

- ``l2_clip_sched``: float32, ``L2Decay`` (AdamW: its decoupled decay;
  Lamb: its own), ``ClipGradByGlobalNorm`` and a ``StepDecay`` scheduler
  stepped after each step;
- ``l1``: float32 with ``L1Decay`` (AdamW and Lamb: their own decay);
- ``o2_float16``: the parameters cast to float16 by ``amp.decorate``
  (O2), the forward under ``auto_cast(level="O2", dtype="float16")``:
  the update runs in float32 and is cast back, with no master weight.

Tolerances: float32 on both sides, sums in other orders: parameters
rtol 1e-5 / atol 1e-6; float16 parameters within 2^-9 of their magnitude
(two float16 steps: the float32 updates before the cast differ by float32
rounding, and the gradients by the forward's float16 roundings, which
the two frameworks place differently) plus 1e-4.
``state_dict`` names the reference's accumulators (``{param}_{name}``,
``@step``, ``LR_Scheduler``) and a copy loaded with ``set_state_dict``
takes the next step as the original does, bit for bit.
"""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import optimizer as jopt_mod
from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import amp, nn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import lr as plr

torch.set_num_threads(2)

NAMES = ["SGD", "Momentum", "Adam", "AdamW", "Adagrad", "RMSProp",
         "Adamax", "Lamb", "AdamDelta"]
SETTINGS = ["l2_clip_sched", "l1", "o2_float16"]
ACCUMULATORS = {"SGD": set(), "Momentum": {"velocity"},
                "Adam": {"moment1", "moment2"},
                "AdamW": {"moment1", "moment2"}, "Adagrad": {"moment"},
                "RMSProp": {"mean_square", "momentum_acc", "mean_grad"},
                "Adamax": {"moment", "inf_norm"},
                "Lamb": {"moment1", "moment2"},
                "AdamDelta": {"avg_squared_grad", "avg_squared_update"}}


def _weights(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(6, 5).astype(np.float32) * 0.5,
            rng.randn(5).astype(np.float32) * 0.1,
            rng.randn(5, 3).astype(np.float32) * 0.5,
            rng.randn(3).astype(np.float32) * 0.1]


def _nets(seed=0):
    ws = _weights(seed)
    ref = jnn.Sequential(jnn.Linear(6, 5), jnn.ReLU(), jnn.Linear(5, 3))
    port = nn.Sequential(nn.Linear(6, 5, device="cpu"), nn.ReLU(),
                         nn.Linear(5, 3, device="cpu"))
    for jp, pp, w in zip(ref.parameters(), port.parameters(), ws):
        jp._array = jnp.asarray(w)
        with torch.no_grad():
            pp.copy_(torch.from_numpy(w))
    return ref, port


def _make(pkg, name, params, setting):
    """One optimizer of ``pkg`` (the reference's module or the port's)
    in ``setting``."""
    sched = None
    lr = 0.05
    if setting == "l2_clip_sched":
        lr = sched = (jlr if pkg is jopt else plr).StepDecay(
            0.05, step_size=1, gamma=0.5)
    clip = (JClip if pkg is jopt else ClipGradByGlobalNorm)(0.5) \
        if setting == "l2_clip_sched" else None
    mod = jopt_mod if pkg is jopt else popt
    decay = None
    if setting == "l2_clip_sched":
        decay = mod.L2Decay(0.01)
    elif setting == "l1":
        decay = mod.L1Decay(0.01)
    cls = getattr(mod, name)
    if name == "AdamW":
        opt = cls(lr, parameters=params, weight_decay=0.02, grad_clip=clip)
    elif name == "Lamb":
        opt = cls(lr, lamb_weight_decay=0.02, parameters=params,
                  grad_clip=clip)
    elif name in ("Adagrad", "RMSProp"):
        opt = cls(lr, parameters=params, weight_decay=decay, grad_clip=clip)
    elif name == "Momentum":
        opt = cls(lr, momentum=0.8, parameters=params, weight_decay=decay,
                  grad_clip=clip, use_nesterov=True)
    else:
        opt = cls(lr, parameters=params, weight_decay=decay, grad_clip=clip)
    return opt, sched


def _ref_step(ref, opt, x, setting):
    with jamp.auto_cast(enable=setting == "o2_float16", level="O2",
                        dtype="float16"):
        out = ref(paddle.to_tensor(x))
        loss = paddle.mean(out * out)
    loss.backward()
    opt.step()
    opt.clear_grad()


def _port_step(port, opt, x, setting):
    with amp.auto_cast(enable=setting == "o2_float16", level="O2",
                       dtype="float16"):
        out = port(torch.from_numpy(x))
        loss = (out * out).mean()
    loss.float().backward()
    opt.step()
    opt.clear_grad()


def _close(pp, jp, setting, msg):
    got = pp.detach().float().numpy()
    want = np.asarray(jp._array).astype(np.float32)
    if setting == "o2_float16":
        assert pp.dtype == torch.float16
        assert np.all(np.abs(got - want) <= 2.0 ** -9 * np.abs(want)
                      + 1e-4), msg
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=msg)


@pytest.mark.parametrize("setting", SETTINGS)
@pytest.mark.parametrize("name", NAMES)
def test_eager_steps_match_the_reference(name, setting):
    ref, port = _nets()
    if setting == "o2_float16":
        jamp.decorate(ref, level="O2", dtype="float16")
        amp.decorate(port, level="O2", dtype="float16")
    jo, jsched = _make(jopt, name, ref.parameters(), setting)
    po, psched = _make(popt, name, list(port.parameters()), setting)
    rng = np.random.RandomState(3)
    for i in range(3):
        x = rng.randn(8, 6).astype(np.float32)
        _ref_step(ref, jo, x, setting)
        _port_step(port, po, x, setting)
        for jsd in (jsched, psched):
            if jsd is not None:
                jsd.step()
        for k, (jp, pp) in enumerate(zip(ref.parameters(),
                                         port.parameters())):
            _close(pp, jp, setting, f"step {i} param {k}")
        assert all(p.grad is None for p in port.parameters())
    assert po._step_count == jo._step_count == 3
    if setting == "l2_clip_sched":      # the clip's norm kept, no sync
        assert po._last_grad_norm is not None
        np.testing.assert_allclose(float(po._last_grad_norm), float(
            np.asarray(jo._last_grad_norm)), rtol=1e-5)


@pytest.mark.parametrize("name", NAMES)
def test_state_dict_names_and_round_trip(name):
    ref, port = _nets(1)
    jo, _ = _make(jopt, name, ref.parameters(), "l2_clip_sched")
    po, _ = _make(popt, name, list(port.parameters()), "l2_clip_sched")
    rng = np.random.RandomState(4)
    for _ in range(3):
        x = rng.randn(8, 6).astype(np.float32)
        _ref_step(ref, jo, x, "l2_clip_sched")
        _port_step(port, po, x, "l2_clip_sched")
    jsd, psd = jo.state_dict(), po.state_dict()
    jnames = {p.name: i for i, p in enumerate(ref.parameters())}

    def split(sd, names):
        out = set()
        for key in sd:
            if key in ("@step", "LR_Scheduler"):
                out.add(key)
                continue
            for pname, i in names.items():
                if key.startswith(pname + "_"):
                    out.add((i, key[len(pname) + 1:]))
        return out
    pnames = {f"param_{i}": i for i in range(4)}
    assert split(psd, pnames) == split(jsd, jnames)
    assert {k for k in split(psd, pnames) if isinstance(k, tuple)} == {
        (i, a) for i in range(4) for a in ACCUMULATORS[name]}
    assert psd["@step"] == 3
    for (i, acc) in split(psd, pnames) - {"@step", "LR_Scheduler"}:
        jkey = [k for k, v in jnames.items() if v == i][0] + "_" + acc
        np.testing.assert_allclose(
            psd[f"param_{i}_{acc}"].numpy(),
            np.asarray(jsd[jkey]._array), rtol=1e-5, atol=1e-6)
    # a copy loaded from the state steps as the original does
    twin = copy.deepcopy(port)
    po2, _ = _make(popt, name, list(twin.parameters()), "l2_clip_sched")
    po2.set_state_dict(po.state_dict())
    assert po2._step_count == 3
    x = rng.randn(8, 6).astype(np.float32)
    _port_step(port, po, x, "l2_clip_sched")
    _port_step(twin, po2, x, "l2_clip_sched")
    for a, b in zip(port.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def test_eager_refusals_and_clear_grad():
    with pytest.raises(NotImplementedError):
        popt.Adam(lazy_mode=True)
    with pytest.raises(NotImplementedError):
        popt.AdamW(multi_precision=True)
    _, port = _nets()
    opt = popt.Momentum(0.1, parameters=list(port.parameters()),
                        rescale_grad=0.5)
    port(torch.randn(2, 6)).sum().backward()
    with pytest.raises(NotImplementedError):      # ignored by the eager
        opt.step()                                # reference: refused
    sgd = popt.SGD(0.1, parameters=list(port.parameters()))
    sgd.clear_grad(set_to_zero=True)
    assert all(float(p.grad.abs().sum()) == 0 for p in port.parameters())
    sgd.clear_grad()
    assert all(p.grad is None for p in port.parameters())
    with pytest.raises(ValueError):
        popt.SGD(0.1).step()
    s = popt.SGD(plr.StepDecay(0.1, 1), parameters=[])
    with pytest.raises(RuntimeError):
        s.set_lr(0.2)
