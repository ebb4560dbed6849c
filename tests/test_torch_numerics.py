"""Training numerics of the PyTorch port (``paddle_tpu_torch/observability/
numerics.py``, the plain version of ``kernels/tensor_health.py``,
``TrainStep(numerics=..., skip_nonfinite=...)``) against the JAX
reference's on the CPU.

- ``tensor_stats``/``stats_tree`` against the reference's on arrays
  holding NaN, +-Inf, exact zeros, bfloat16 values and odd sizes: counts
  and ``absmax`` exact (NaN where the tensor holds a NaN), ``sq_sum``
  within 1e-6 relative (float32 sums in another order), ``zero_frac``
  within 1e-7 relative (the port divides the exact count in float64, the
  reference takes a float32 mean). Empty tensors: the reference's
  ``jnp.max`` refuses them; the port gives 0 counts, ``absmax`` 0,
  ``sq_sum`` 0 (``jnp.sum``'s answer) and ``zero_frac`` NaN
  (``jnp.mean``'s).
- ``TrainStep(numerics=...)`` against the reference's ``TrainStep`` on a
  small MLP (one step, ``watch``: grads, params and updates) and on a
  tiny GPT (``multi_step`` of K = 4 with a loss made NaN at step 2 and
  ``skip_nonfinite``): every kind's per-tensor stats (counts exact, the
  floats within 1e-5 relative and 1e-7 absolute: float32 gradients of
  two frameworks; the qkv biases' counts only, see ``_held``),
  ``found_inf``, ``grad_norm`` (1e-5), the window's
  reduction (counts summed, abs-max NaN, the last step's sums), the
  poisoned window visible, ``first_nonfinite()`` naming the same tensor,
  and the parameters after the window (every element within 2 x K x lr,
  all but max(2, 1e-3 x numel) within 1e-4 relative / 1e-6 absolute:
  Adam may step a rounding-noise gradient the other way).
- ``skip_nonfinite``: a rejected step leaves parameters and AdamW's
  state (moments and step count) bit-identical, and a run with a
  poisoned step in it ends bit-identical to the run without it;
  ``numerics="stats"`` and ``"watch"`` leave losses and parameters
  bit-identical to numerics off.
- The ``AnomalyWatchdog`` policies (loss spike, nonfinite ``halt``,
  loss-scale collapse with a stub scaler) against the reference's on the
  same health sequence: the actions, the anomaly log, the EMA and the
  bundle; the reference's ``tools/numerics_check.validate_bundle``
  accepts the port's bundles, and the port's self-drive passes.
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.observability import numerics as jnum
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm, Linear, ReLU
from paddle_tpu_torch.nn import load_named_state
from paddle_tpu_torch.observability import numerics as num
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.parallel.api import TrainStep
from paddle_tpu_torch.tools import numerics_check as port_check

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAT_RTOL = dict(rtol=1e-5, atol=1e-7)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    """The reference's step runs under a one-device mesh (as in
    tests/test_torch_train.py), restored after."""
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _arrays():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(7, 13)).astype(np.float32)
    a[0, :3] = 0.0
    a[2, 5], a[4, 1], a[6, 12] = np.nan, np.inf, -np.inf
    b = rng.normal(size=4097).astype(np.float32) * 1e3
    b[::5] = 0.0
    c = rng.normal(size=(3, 1)).astype(np.float32)
    c[1, 0] = -np.inf
    d = np.zeros(9, np.float32)
    e = (rng.normal(size=(5, 3)) * 1e-3).astype(np.float32)
    e[0, 0] = np.nan
    return [a, b, c, d, e]


def _torch(x, bf16=False):
    t = torch.from_numpy(np.array(x))
    return t.bfloat16() if bf16 else t


def _jnp(x, bf16=False):
    return jnp.asarray(x, jnp.bfloat16 if bf16 else jnp.float32)


def _assert_stats(got, want, exact_floats=False):
    for s in ("nan", "inf"):
        np.testing.assert_array_equal(np.asarray(got[s]),
                                      np.asarray(want[s]), err_msg=s)
    np.testing.assert_array_equal(np.asarray(got["absmax"]),
                                  np.asarray(want["absmax"]))
    if exact_floats:
        np.testing.assert_array_equal(np.asarray(got["sq_sum"]),
                                      np.asarray(want["sq_sum"]))
    else:
        np.testing.assert_allclose(np.asarray(got["sq_sum"]),
                                   np.asarray(want["sq_sum"]), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(got["zero_frac"]),
                               np.asarray(want["zero_frac"]), rtol=1e-7)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_stats_tree_matches_the_reference(bf16):
    xs = _arrays()
    got = num.stats_tree([_torch(x, bf16) for x in xs])
    want = jnum.stats_tree([_jnp(x, bf16) for x in xs])
    _assert_stats({k: v.numpy() for k, v in got.items()}, want)
    assert np.isnan(float(got["absmax"][0]))
    assert np.isnan(float(got["absmax"][4]))
    for x in xs:
        one = num.tensor_stats(_torch(x, bf16))
        ref = jnum.tensor_stats(_jnp(x, bf16))
        _assert_stats({k: v.numpy()[None] for k, v in one.items()},
                      {k: np.asarray(v)[None] for k, v in ref.items()})
        assert one["nan"].dtype == torch.int32


def test_stats_tree_reuses_given_sums_and_takes_empty_tensors():
    xs = [torch.ones(3), torch.zeros(0, 4), torch.full((2,), 2.0)]
    sq = [torch.tensor(5.0), torch.tensor(6.0), torch.tensor(7.0)]
    got = num.stats_tree(xs, sq_sums=sq)
    assert got["sq_sum"].tolist() == [5.0, 6.0, 7.0]
    empty = num.stats_tree(xs)
    e = jnp.zeros((0, 4), jnp.float32)
    with pytest.raises(ValueError):
        jnum.tensor_stats(e)            # jnp.max of nothing
    assert [int(empty["nan"][1]), int(empty["inf"][1])] == [0, 0]
    assert float(empty["absmax"][1]) == 0.0
    assert float(empty["sq_sum"][1]) == float(jnp.sum(jnp.square(e))) == 0.0
    assert np.isnan(float(empty["zero_frac"][1]))
    assert np.isnan(float(jnp.mean((e == 0).astype(jnp.float32))))
    assert num.stats_tree([])["nan"].shape == (0,)


def _mlp_pair():
    paddle.seed(0)
    ref = jnn.Sequential(jnn.Linear(8, 16), jnn.ReLU(), jnn.Linear(16, 4))
    port = torch.nn.Sequential(Linear(8, 16, device="cpu"), ReLU(),
                               Linear(16, 4, device="cpu"))
    load_named_state(port, {n: np.asarray(p._array)
                            for n, p in ref.named_parameters()})
    return ref, port


def _mlp_jax_loss(m, x, y):
    d = m(x) - y
    return paddle.mean(d * d)


def _mlp_port_loss(m, x, y):
    d = m(x) - y
    return (d * d).mean()


def _held(names):
    """The tensors whose float stats are held. Not the attention qkv
    biases: the key third's exact gradient is zero, both sides hold
    rounding noise there, and Adam scales it to steps of about lr that
    may go either way (the caveat of tests/test_torch_train.py), so
    their gradients' zeros and their parameters' and updates' values
    differ between the frameworks; only their counts are held."""
    return np.array([not n.endswith("attn.qkv.bias") for n in names])


def _assert_floats(names, g, w, kind, stats=("absmax", "sq_sum",
                                             "zero_frac")):
    keep = _held(names)
    for s in stats:
        np.testing.assert_allclose(g[s][keep], w[s][keep],
                                   err_msg=f"{kind} {s}", **STAT_RTOL)


def _assert_health(got, want, kinds):
    assert got.names == want.names
    assert got.kinds() == want.kinds() == tuple(kinds)
    for kind in kinds:
        g, w = got.stats[kind], want.stats[kind]
        for s in ("nan", "inf"):
            np.testing.assert_array_equal(g[s], w[s], err_msg=f"{kind} {s}")
        _assert_floats(got.names, g, w, kind)
    assert got.found_inf == want.found_inf
    np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=1e-5)
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-6)
    assert got.first_nonfinite() == want.first_nonfinite()


@pytest.mark.parametrize("mode", ["stats", "watch"])
def test_mlp_step_numerics_match_the_reference(mode):
    ref, port = _mlp_pair()
    rng = np.random.RandomState(0)
    x = rng.rand(16, 8).astype(np.float32)
    y = rng.rand(16, 4).astype(np.float32)
    jstep = JaxTrainStep(ref, _mlp_jax_loss, jopt.AdamW(
        learning_rate=1e-2, grad_clip=JaxClip(0.5),
        parameters=ref.parameters()), mesh=_mesh(), numerics=mode)
    step = TrainStep(port, _mlp_port_loss, AdamW(
        1e-2, grad_clip=ClipGradByGlobalNorm(0.5)), device="cpu",
        numerics=mode)
    for _ in range(2):
        jstep(x, y)
        step(torch.from_numpy(x), torch.from_numpy(y))
    want, got = jstep.numerics_view(step=1), step.numerics_view(step=1)
    kinds = ("grad", "param", "update") if mode == "watch" else ("grad",)
    _assert_health(got, want, kinds)
    assert (got.grad_arrays is not None) == (mode == "watch")
    if mode == "watch":
        for g, w in zip(got.grad_arrays, want.grad_arrays):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **STAT_RTOL)
    # the view's dict is the reference's, key for key
    assert set(got.to_dict()) == set(want.to_dict())


def _gpt_pair():
    paddle.seed(0)
    ref = jax_gpt2_tiny(dropout=0.0, bf16_residual=False)
    port = GPTForCausalLM(gpt2_tiny(dropout=0.0, bf16_residual=False),
                          device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    return ref, port


def _scaled_jax_loss(m, ids, labels, s):
    return m.loss(ids, labels) * s


def _scaled_port_loss(m, ids, labels, s):
    return m.loss(ids, labels) * s


def _gpt_batch(k, poison=None):
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (k, 2, 32)).astype(np.int64)
    s = np.ones((k, 1), np.float32)    # rank 2: the reference's stacking
    if poison is not None:
        s[poison] = np.nan
    return ids, np.roll(ids, -1, axis=-1), s


@pytest.mark.parametrize("poison", [None, 2], ids=["clean", "poisoned"])
def test_gpt_multi_step_window_matches_the_reference(poison):
    K = 4
    ref, port = _gpt_pair()
    ids, labels, s = _gpt_batch(K, poison)
    jstep = JaxTrainStep(ref, _scaled_jax_loss, jopt.AdamW(
        learning_rate=3e-3, weight_decay=0.1, grad_clip=JaxClip(1.0),
        parameters=ref.parameters()), mesh=_mesh(), numerics="watch",
        skip_nonfinite=True)
    jl = np.asarray(jstep.multi_step(ids, labels, s)._array)
    step = TrainStep(port, _scaled_port_loss, AdamW(
        3e-3, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)),
        device="cpu", numerics="watch", skip_nonfinite=True)
    pl = step.multi_step(*(torch.from_numpy(a) for a in (ids, labels, s)))
    np.testing.assert_allclose(pl.numpy(), jl, rtol=1e-5)
    want, got = jstep.numerics_view(), step.numerics_view()
    assert got.grad_arrays is None and want.grad_arrays is None
    if poison is None:
        _assert_health(got, want, ("grad", "param", "update"))
        assert got.first_nonfinite() is None
    else:
        # the window stays poisoned though steps 3.. were clean: counts
        # summed, abs-max NaN, found_inf or-ed; the sums are step 3's
        assert got.found_inf and want.found_inf
        for kind in ("grad", "update"):
            g, w = got.stats[kind], want.stats[kind]
            np.testing.assert_array_equal(g["nan"], w["nan"])
            np.testing.assert_array_equal(g["inf"], w["inf"])
            assert np.isnan(g["absmax"]).all() and np.isnan(w["absmax"]).all()
            _assert_floats(got.names, g, w, kind, ("sq_sum", "zero_frac"))
        np.testing.assert_array_equal(got.stats["param"]["nan"], 0)
        assert got.first_nonfinite() == want.first_nonfinite() == (
            got.names[0], "grad")
        np.testing.assert_allclose(got.grad_norm, want.grad_norm, rtol=1e-5)
    jp = {n: np.asarray(p._array) for n, p in ref.named_parameters()}
    lr = 3e-3
    for name, p in port.named_parameters():
        g, w = p.detach().numpy().ravel(), jp[name].ravel()
        # Adam normalises each element's gradient, so an element whose
        # gradient is rounding noise (the key bias's exact gradient is
        # zero) may step the other way: every element within 2 x K x lr,
        # and all but max(2, 1e-3 x numel) within PARAM_TOL (the rule of
        # chip_smoke.py's train_parity)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * K * lr,
                                   err_msg=name)
        if name.endswith("attn.qkv.bias"):
            continue
        off = ~np.isclose(g, w, **PARAM_TOL)
        assert off.sum() <= max(2, 1e-3 * g.size), (name, off.sum())


def _state_copy(step):
    st = step._opt_state
    return ([p.detach().clone() for p in step._params],
            {k: ([t.clone() for t in v] if isinstance(v, list) else
                 v.clone()) for k, v in st.items()})


def _assert_state_equal(a, b):
    pa, sa = a
    pb, sb = b
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert sa.keys() == sb.keys()
    for k in sa:
        va, vb = sa[k], sb[k]
        if isinstance(va, list):
            assert all(torch.equal(x, y) for x, y in zip(va, vb)), k
        else:
            assert torch.equal(va, vb), k


def test_skip_nonfinite_leaves_params_and_adamw_state_bit_identical():
    _, port = _gpt_pair()
    ids, labels, s = _gpt_batch(3, poison=1)
    b = [torch.from_numpy(a) for a in (ids, labels, s)]
    step = TrainStep(port, _scaled_port_loss, AdamW(
        3e-3, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)),
        device="cpu", numerics="stats", skip_nonfinite=True)
    step(*(a[0] for a in b))
    before = _state_copy(step)
    assert int(step._opt_state["count"]) == 1
    loss = step(*(a[1] for a in b))
    assert torch.isnan(loss)
    _assert_state_equal(_state_copy(step), before)
    view = step.numerics_view()
    assert view.found_inf and view.first_nonfinite()[1] == "grad"
    step(*(a[2] for a in b))
    # the same run without the poisoned batch ends bit for bit the same
    _, fresh = _gpt_pair()
    clean = TrainStep(fresh, _scaled_port_loss, AdamW(
        3e-3, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)),
        device="cpu", numerics="stats", skip_nonfinite=True)
    clean(*(a[0] for a in b))
    clean(*(a[2] for a in b))
    _assert_state_equal(_state_copy(step), _state_copy(clean))
    # without the pass nothing is masked, as in the reference
    plain = TrainStep(_gpt_pair()[1], _scaled_port_loss, AdamW(3e-3),
                      device="cpu", skip_nonfinite=True)
    plain(*(a[1] for a in b))
    assert plain.numerics_view() is None
    assert any(torch.isnan(p).any() for p in plain._params)


def test_numerics_modes_leave_losses_and_params_bit_identical():
    ids, labels, s = _gpt_batch(3)
    runs = []
    for mode in (None, "stats", "watch"):
        _, port = _gpt_pair()
        step = TrainStep(port, _scaled_port_loss, AdamW(
            3e-3, weight_decay=0.1, grad_clip=ClipGradByGlobalNorm(1.0)),
            device="cpu", numerics=mode, skip_nonfinite=True)
        losses = step.multi_step(*(torch.from_numpy(a)
                                   for a in (ids, labels, s)))
        runs.append((losses, [p.detach().clone() for p in step._params]))
        assert (step.last_numerics is None) == (mode is None)
    for losses, params in runs[1:]:
        assert torch.equal(losses, runs[0][0])
        assert all(torch.equal(a, b) for a, b in zip(params, runs[0][1]))


class _Scaler:
    def __init__(self, scale):
        self._scale = scale

    def state_dict(self):
        return {"scale": self._scale}


def _views(names, rows):
    """The same health sequence in both packages: rows of (loss, nan count
    in tensor 1 or 0)."""
    out = []
    for i, (loss, nan) in enumerate(rows):
        st = {"grad": {
            "nan": np.array([0, nan], np.int32),
            "inf": np.zeros(2, np.int32),
            "absmax": np.array([1.0 + i, np.nan if nan else 2.0],
                               np.float32),
            "sq_sum": np.array([3.0, 4.0], np.float32),
            "zero_frac": np.array([0.0, 0.5], np.float32)}}
        out.append([mod.TensorHealth(names, {k: dict(v) for k, v in
                                             st.items()},
                                     loss=loss, grad_norm=1.0,
                                     found_inf=bool(nan), step=i)
                    for mod in (jnum, num)])
    return out


def _bundle(d):
    doc = json.load(open(os.path.join(d, "bundle.json")))
    doc.pop("ts")
    doc["policy"].pop("dump_dir")
    return doc


def _reference_checker():
    spec = importlib.util.spec_from_file_location(
        "reference_numerics_check",
        os.path.join(ROOT, "tools", "numerics_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("action", ["continue", "skip_step", "halt"])
def test_anomaly_watchdog_policies_match_the_reference(action, tmp_path):
    names = ["a.weight", "b.weight"]
    rows = [(2.0, 0), (2.1, 0), (1.9, 0), (2.0, 0), (2.05, 0), (2.0, 0),
            (40.0, 0), (2.0, 0), (2.1, 0), (float("nan"), 3), (2.0, 0)]
    scales = [1024.0] * 7 + [2.0, 2.0, 2.0, 1024.0]
    dogs = [mod.watch(mod.WatchPolicy(
        action=action, warmup_steps=3, dump_dir=str(tmp_path / tag),
        max_dumps=3)) for mod, tag in ((jnum, "ref"), (num, "port"))]
    acts = [[], []]
    for i, pair in enumerate(_views(names, rows)):
        for j, (dog, view) in enumerate(zip(dogs, pair)):
            try:
                acts[j].append(dog.check(view, step=i,
                                         scaler=_Scaler(scales[i])))
            except (jnum.NumericsAnomalyError,
                    num.NumericsAnomalyError) as e:
                acts[j].append(("halt", os.path.basename(e.bundle)))
    assert acts[1] == acts[0]
    assert list(dogs[1].anomalies) == list(dogs[0].anomalies)
    assert dogs[1].ema_loss == dogs[0].ema_loss
    assert [os.path.basename(d) for d in dogs[1].dumps] == \
        [os.path.basename(d) for d in dogs[0].dumps]
    checker = _reference_checker()
    for dr, dp in zip(dogs[0].dumps, dogs[1].dumps):
        assert _bundle(dp) == _bundle(dr)
        assert checker.validate_bundle(dp) == []
        assert port_check.validate_bundle(dp) == []


def test_port_bundle_passes_the_reference_checker_and_the_self_drive(
        tmp_path):
    bundle, poisoned = port_check.self_drive(str(tmp_path), device="cpu")
    assert _reference_checker().validate_bundle(bundle) == []
    doc = json.load(open(os.path.join(bundle, "bundle.json")))
    assert doc["reason"] == "nonfinite"
    assert doc["health"]["first_nonfinite"] == {"tensor": poisoned,
                                                "kind": "param"}
    assert doc["tensor_dumps"] and doc["flight_dumps"]
    assert port_check.main(["--bundle", bundle, "--quiet"]) == 0
    assert port_check.main(["--bundle", str(tmp_path), "--quiet"]) == 1
