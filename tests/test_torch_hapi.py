"""``paddle_tpu_torch.hapi`` (``Model``, the callbacks, ``summary`` and
``flops``) against ``paddle_tpu.hapi`` on the CPU, on the same networks,
weights and data (float32 on both sides, sums in other orders: losses
and outputs rtol 1e-5 / atol 1e-6, parameters rtol 1e-5 / atol 1e-6;
metrics, which count correct top-k rows, exactly):

- ``fit`` / ``evaluate`` / ``predict`` on an MLP classifier with
  ``CrossEntropyLoss``, ``Accuracy`` and AdamW: the per-step losses and
  metric logs, the eval logs, the predictions, the final parameters, and
  the order of every callback hook;
- ``train_batch(update=False)`` accumulating into ``.grad`` twice, then
  an update applying the sum through the train step's optimizer state;
- ``save`` / ``load``: a fresh model loaded from the checkpoint predicts
  and then trains as the original does, bit for bit;
- ``summary`` / ``flops`` on the MLP and on ``bert_tiny``: the printed
  table, the parameter counts and the FLOP count;
- ``ReduceLROnPlateau`` and ``EarlyStopping`` over the same eval series,
  ``VisualDL``'s JSONL records;
- the reference's own self-check of the hapi train loop
  (``tools/metrics_dump.py`` ``drive_train``, an MLP regression with
  ``NumericsCallback``, ``TelemetryCallback`` and a ``GradScaler``) on the
  port: every train series family it demands is live, except
  ``train_jit_compiles``, whose family exists without series (the port
  compiles nothing).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import io as jio
from paddle_tpu import metric as jmetric
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.hapi import callbacks as jcb
from paddle_tpu.hapi.summary import flops as jflops
from paddle_tpu.hapi.summary import summary as jsummary
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JBertForSequenceClassification
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
import paddle_tpu_torch as ptt
from paddle_tpu_torch import amp, io as pio, metric as pmetric, nn
from paddle_tpu_torch import optimizer as popt
from paddle_tpu_torch.hapi import callbacks as pcb
from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                          bert_tiny)
from paddle_tpu_torch.observability import MetricsRegistry

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(AXES_ORDER)), AXES_ORDER))
    yield
    mesh_mod.set_mesh(prev)


def _nets(seed=0, d=6, h=8, k=4):
    rng = np.random.RandomState(seed)
    ws = [rng.randn(d, h).astype(np.float32) * 0.5,
          rng.randn(h).astype(np.float32) * 0.1,
          rng.randn(h, k).astype(np.float32) * 0.5,
          rng.randn(k).astype(np.float32) * 0.1]
    ref = jnn.Sequential(jnn.Linear(d, h), jnn.ReLU(), jnn.Linear(h, k))
    port = nn.Sequential(nn.Linear(d, h, device="cpu"), nn.ReLU(),
                         nn.Linear(h, k, device="cpu"))
    for jp, pp, w in zip(ref.parameters(), port.parameters(), ws):
        jp._array = jnp.asarray(w)
        with torch.no_grad():
            pp.copy_(torch.from_numpy(w))
    return ref, port


def _data(n=40, d=6, k=4, seed=1):
    rng = np.random.RandomState(seed)
    return rng.randn(n, d).astype(np.float32), rng.randint(0, k, n)


def _dataset(pkg, x, y):
    class DS(pkg.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]
    return DS()


def _recorder(base):
    class Rec(base):
        def __init__(self):
            self.events = []
            self.losses = []

        def on_train_begin(self, logs=None):
            self.events.append("train_begin")

        def on_epoch_begin(self, epoch, logs=None):
            self.events.append(("epoch_begin", epoch))

        def on_train_batch_begin(self, step, logs=None):
            self.events.append(("batch_begin", step))

        def on_train_batch_end(self, step, logs=None):
            self.events.append(("batch_end", step, tuple(sorted(logs))))
            self.losses.append((logs["loss"][0], logs.get("acc")))

        def on_epoch_end(self, epoch, logs=None):
            self.events.append(("epoch_end", epoch))

        def on_eval_end(self, logs=None):
            self.events.append(("eval_end", tuple(sorted(logs or {}))))

        def on_train_end(self, logs=None):
            self.events.append("train_end")
    return Rec()


def _models(seed=0):
    ref, port = _nets(seed)
    jm = paddle.Model(ref)
    jm.prepare(jopt.AdamW(0.01, parameters=ref.parameters()),
               jnn.CrossEntropyLoss(), jmetric.Accuracy())
    pm = ptt.Model(port, device="cpu")
    pm.prepare(popt.AdamW(0.01), nn.CrossEntropyLoss(), pmetric.Accuracy())
    return ref, port, jm, pm


def _params_close(ref, port, msg=""):
    for k, (jp, pp) in enumerate(zip(ref.parameters(), port.parameters())):
        np.testing.assert_allclose(pp.detach().numpy(),
                                   np.asarray(jp._array),
                                   err_msg=f"{msg} param {k}", **TOL)


def test_fit_evaluate_predict_match_the_reference():
    ref, port, jm, pm = _models()
    x, y = _data()
    ex, ey = _data(12, seed=2)
    recs = [_recorder(jcb.Callback), _recorder(pcb.Callback)]
    for m, pkg, rec in ((jm, jio, recs[0]), (pm, pio, recs[1])):
        np.random.seed(3)
        m.fit(_dataset(pkg, x, y), eval_data=_dataset(pkg, ex, ey),
              batch_size=8, epochs=2, callbacks=[rec], verbose=0)
    assert recs[1].events == recs[0].events
    assert len(recs[1].losses) == 10
    for (pl, pa), (jl, ja) in zip(recs[1].losses, recs[0].losses):
        np.testing.assert_allclose(pl, jl, **TOL)
        assert pa == ja
    _params_close(ref, port, "after fit")
    jlogs = jm.evaluate(_dataset(jio, ex, ey), batch_size=5, verbose=0)
    plogs = pm.evaluate(_dataset(pio, ex, ey), batch_size=5, verbose=0)
    assert plogs.keys() == jlogs.keys()
    np.testing.assert_allclose(plogs["loss"], jlogs["loss"], **TOL)
    assert plogs["acc"] == jlogs["acc"]
    jp = jm.predict(_dataset(jio, ex, ey), batch_size=5, stack_outputs=True)
    pp = pm.predict(_dataset(pio, ex, ey), batch_size=5, stack_outputs=True)
    np.testing.assert_allclose(pp[0], jp[0], **TOL)
    assert port.training is False      # predict left it in eval mode
    _params_close(ref, port, "after evaluate and predict")


def test_update_false_accumulates_and_the_next_update_applies_it():
    ref, port, jm, pm = _models(1)
    x, y = _data(24, seed=4)
    for m in (jm, pm):      # the train step exists (and its state moves)
        m.train_batch([x[:8]], [y[:8]])
    jr = [jm.train_batch([x[8:16]], [y[8:16]], update=False)]
    pr = [pm.train_batch([x[8:16]], [y[8:16]], update=False)]
    assert all(p.grad is not None for p in port.parameters())
    jr.append(jm.train_batch([x[16:]], [y[16:]]))
    pr.append(pm.train_batch([x[16:]], [y[16:]]))
    assert all(p.grad is None for p in port.parameters())
    for a, b in zip(pr, jr):
        np.testing.assert_allclose(a[0], b[0], **TOL)
    _params_close(ref, port, "after the accumulated update")
    assert pm._train_ts()._step_count == jm._train_ts()._step_count == 2
    # before any train step exists the accumulated update is the eager
    # optimizer's
    _, fresh = _nets(5)
    fm = ptt.Model(fresh, device="cpu")
    opt = popt.SGD(0.1, parameters=list(fresh.parameters()))
    fm.prepare(opt, nn.CrossEntropyLoss())
    fm.train_batch([x[:8]], [y[:8]], update=False)
    before = [p.detach().clone() for p in fresh.parameters()]
    fm.train_batch([x[8:16]], [y[8:16]])
    assert fm._train_ts() is None and opt._step_count == 1
    assert all(not torch.equal(a, b)
               for a, b in zip(fresh.parameters(), before))


def test_save_load_round_trip(tmp_path):
    _, port, _, pm = _models(2)
    x, y = _data(32, seed=6)
    np.random.seed(0)
    pm.fit(_dataset(pio, x, y), batch_size=8, epochs=1, verbose=0,
           callbacks=[pcb.Callback()])
    path = str(tmp_path / "ckpt")
    pm.save(path)
    assert os.path.exists(path + ".pdparams")
    assert os.path.exists(path + ".pdopt")
    _, twin = _nets(9)
    tm = ptt.Model(twin, device="cpu")
    tm.prepare(popt.AdamW(0.01), nn.CrossEntropyLoss(), pmetric.Accuracy())
    tm.load(path)
    np.testing.assert_array_equal(tm.predict_batch([x[:5]])[0],
                                  pm.predict_batch([x[:5]])[0])
    a = pm.train_batch([x[:8]], [y[:8]])
    b = tm.train_batch([x[:8]], [y[:8]])
    assert a == b
    for p, q in zip(port.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    with pytest.raises(NotImplementedError):
        pm.prepare(popt.AdamW(), nn.CrossEntropyLoss(), amp_configs={})


def test_summary_and_flops_match_the_reference(capsys):
    ref, port = _nets()
    jinfo = jsummary(ref, (2, 6))
    want = capsys.readouterr().out
    pinfo = ptt.summary(port, (2, 6))
    got = capsys.readouterr().out
    assert got == want and pinfo == jinfo
    assert ptt.flops(port, (2, 6)) == jflops(ref, (2, 6))
    paddle.seed(0)
    jb = JBertForSequenceClassification(jax_bert_tiny(dropout=0.0))
    pb = BertForSequenceClassification(bert_tiny(dropout=0.0), device="cpu")
    jinfo = jsummary(jb, (2, 16), dtypes="int64")
    want = capsys.readouterr().out
    pinfo = ptt.summary(pb, (2, 16), dtypes="int64")
    got = capsys.readouterr().out
    assert got == want and pinfo == jinfo
    ids = np.zeros((2, 16), np.int64)
    assert ptt.flops(pb, inputs=torch.from_numpy(ids)) == \
        jflops(jb, inputs=paddle.to_tensor(ids)) > 0
    _, port, _, pm = _models()
    assert pm.summary()["total_params"] == sum(
        p.numel() for p in port.parameters())


def test_plateau_early_stopping_and_visualdl(tmp_path):
    series = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.7, 0.8]
    lrs = []
    for pkg, opt in ((jcb, jopt.SGD(0.1, parameters=[])),
                     (pcb, popt.SGD(0.1, parameters=[]))):
        plateau = pkg.ReduceLROnPlateau(patience=2, factor=0.5, verbose=0,
                                        cooldown=1)
        stop = pkg.EarlyStopping(patience=3)

        class M:
            _optimizer = opt
            stop_training = False
        for cb in (plateau, stop):
            cb.set_model(M)
        got = []
        for v in series:
            for cb in (plateau, stop):
                cb.on_eval_end({"loss": v})
            got.append((opt.get_lr(), M.stop_training))
        lrs.append(got)
    assert lrs[0] == lrs[1]
    recs = []
    for pkg in (jcb, pcb):
        d = tmp_path / pkg.__name__
        vdl = pkg.VisualDL(str(d))
        vdl.on_train_begin()
        for s in range(3):
            vdl.on_train_batch_end(s, {"loss": [0.5 + s], "batch_size": 4,
                                       "acc": 0.25 * s})
        vdl.on_eval_end({"loss": 0.1})
        vdl.on_train_end()
        with open(d / "vdlrecords.jsonl") as f:
            recs.append([(r["tag"], r["step"], r["value"])
                         for r in map(json.loads, f)])
    assert recs[1] == recs[0] and len(recs[0]) == 7


def test_drive_train_series_are_live_on_the_port():
    """The reference's ``drive_train`` on the port: 1 epoch x 4 batches of
    an MLP regression with NumericsCallback (stats) + TelemetryCallback +
    a GradScaler on one registry."""
    reg = MetricsRegistry()

    class DS(pio.Dataset):
        def __init__(self, n=32, d=8):
            rng = np.random.RandomState(0)
            self.x = rng.randn(n, d).astype(np.float32)
            self.y = rng.randn(n, 4).astype(np.float32)

        def __len__(self):
            return len(self.x)

        def __getitem__(self, i):
            return self.x[i], self.y[i]

    net = nn.Sequential(nn.Linear(8, 16, device="cpu"), nn.ReLU(),
                        nn.Linear(16, 4, device="cpu"))
    model = ptt.Model(net, device="cpu")
    model.prepare(popt.SGD(1e-2, parameters=list(model.parameters())),
                  nn.MSELoss())
    scaler = amp.GradScaler(init_loss_scaling=1024.0, registry=reg)
    tel = pcb.TelemetryCallback(registry=reg, tracing=False)
    num = pcb.NumericsCallback(registry=reg, scaler=scaler, telemetry=tel)
    model.fit(DS(), batch_size=8, epochs=1, verbose=0, callbacks=[num, tel])
    snap = reg.snapshot()
    for name in ("train_grad_norm", "train_steps_total", "train_loss",
                 "amp_loss_scale", "amp_found_inf_total"):
        assert snap[name]["series"], name
    # registered, no series: the port's train step compiles nothing
    assert snap["train_jit_compiles"]["series"] == []
    gn = next(s["value"] for s in snap["train_grad_norm"]["series"]
              if s["labels"].get("layer") == "__global__")
    assert gn > 0
    assert [s["value"] for s in snap["amp_loss_scale"]["series"]] == \
        [1024.0]
    assert snap["train_steps_total"]["series"][0]["value"] == 4
    assert model._train_ts()._numerics == "stats"
