"""Mixed precision of the PyTorch port against the JAX reference on the
CPU: ``paddle_tpu_torch.amp`` (the O1/O2 cast rule, ``decorate``,
``GradScaler``) against ``paddle_tpu.amp``.

- The cast rule at the ops of GPT-2's and BERT's paths: on ``gpt2_tiny``
  (``bf16_residual`` on and off, the plain and the fused head + CE) and
  ``bert_tiny``, under O1 and O2 (O2 with ``decorate``) in bfloat16 and
  float16, the dtype of each block's output, of the logits and of the
  loss equals the reference's; then the loss and every gradient. The two
  packages round at different places (the reference's XLA CPU fuses
  bf16/f16 ops and rounds less often), so losses agree within 2e-2
  (bfloat16) and 5e-3 (float16) and each gradient's max-abs error over
  its max-abs within 5e-2 and 1.5e-2 (readings: 2.3e-2 and 8e-3 at
  most; the attention key bias, whose exact gradient is zero, against
  the largest gradient's max-abs); an O2 loss the reference computes in
  the low dtype is equal.
- ``GradScaler``: both packages' scalers drive an eager SGD step of the
  same tiny linear model through a scripted run of finite and found-inf
  steps (``minimize`` on a loss multiplied by inf), with
  ``incr_every_n_steps=3`` and ``decr_every_n_nan_or_inf=2``: the scale,
  ``good_steps``/``bad_steps``, ``scale_history``, ``state_dict``, the
  ``amp_loss_scale`` gauge and ``amp_found_inf_total`` counter on each
  package's own registry are equal after every step, and the parameters
  within 1e-6 (float32 on both sides). A found-inf step leaves the
  parameters bit-identical.
- C20 on the CPU: the plain flash, fused-CE (and its shared-dl pair) and
  packed-flash versions take float16 as the reference's Pallas kernels
  in interpret mode do (limits in the test).
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import amp as jamp
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.models.bert import \
    BertForSequenceClassification as JBertForSequenceClassification
from paddle_tpu.models.bert import bert_tiny as jax_bert_tiny
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.observability import MetricsRegistry as JRegistry
from paddle_tpu_torch import amp
from paddle_tpu_torch import nn
from paddle_tpu_torch.models.bert import (BertForSequenceClassification,
                                          bert_tiny)
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.observability import MetricsRegistry
from paddle_tpu_torch.optimizer import SGD

torch.set_num_threads(2)

LOSS_ATOL = {"bfloat16": 2e-2, "float16": 5e-3}
GRAD_TOL = {"bfloat16": 5e-2, "float16": 1.5e-2}
CASES = [(lv, dt) for lv in ("O1", "O2") for dt in ("bfloat16", "float16")]


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(Mesh(np.array(jax.devices()[:1]).reshape(
        (1,) * len(AXES_ORDER)), AXES_ORDER))
    yield
    mesh_mod.set_mesh(prev)


def _named(ref):
    return {n: np.asarray(p._array) for n, p in ref.named_parameters()}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _dt(t):
    return str(t.dtype).replace("torch.", "")


def _decorate(ref, port, level, dtype):
    if level == "O2":
        jamp.decorate(ref, level="O2", dtype=dtype)
        amp.decorate(port, level="O2", dtype=dtype)


def _check_grads(ref, port, dtype):
    """Each gradient within the tolerance of its max-abs; the attention
    key bias, whose exact gradient is zero (softmax ignores a shift of
    every key's score), holds rounding noise on both sides and is held
    to the tolerance of the largest gradient's max-abs."""
    pg = dict(port.named_parameters())
    want = {n: np.asarray(jp.grad._array).astype(np.float32)
            for n, jp in ref.named_parameters()}
    top = max(np.abs(w).max() for w in want.values())
    for n, w in want.items():
        g = pg[n].grad
        assert g.dtype == pg[n].dtype, n
        got = g.float().numpy()
        if n.endswith("k_proj.bias"):
            assert np.abs(got - w).max() <= GRAD_TOL[dtype] * top, n
        else:
            assert _rel(got, w) <= GRAD_TOL[dtype], n


@pytest.mark.parametrize("level,dtype", CASES)
@pytest.mark.parametrize("bf16_residual,fused_ce", [
    (True, False), (False, False), (True, True)],
    ids=["bf16_residual", "f32_residual", "fused_ce"])
def test_gpt_dtypes_losses_and_grads_match(level, dtype, bf16_residual,
                                           fused_ce):
    kw = dict(dropout=0.0, bf16_residual=bf16_residual, fused_ce=fused_ce)
    paddle.seed(0)
    ref = jax_gpt2_tiny(**kw)
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state(_named(ref))
    _decorate(ref, port, level, dtype)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (2, 32))
    lab = np.roll(ids, -1, -1)
    t, tt = paddle.to_tensor(ids), torch.from_numpy(ids)
    want, got = [], []
    with jamp.auto_cast(level=level, dtype=dtype):
        x = paddle.add(ref.gpt.wte(t), ref.gpt.wpe(paddle.arange(
            0, ids.shape[1], dtype="int64")))
        for blk in ref.gpt.blocks:
            x = blk(x)
            want.append(str(x.dtype))
        want.append(str(ref(t).dtype))
        jl = ref.loss(t, paddle.to_tensor(lab))
        want.append(str(jl.dtype))
    with amp.auto_cast(level=level, dtype=dtype):
        x = PF.add(port.gpt.wte(tt), port.gpt.wpe(torch.arange(
            ids.shape[1])))
        for blk in port.gpt.blocks:
            x = blk(x)
            got.append(_dt(x))
        got.append(_dt(port(tt)))
        pl = port.loss(tt, torch.from_numpy(lab))
        got.append(_dt(pl))
    assert got == want
    # O2 rounds the bf16 residual stream to float16 at every add
    if level == "O2":
        assert want[:-1] == [dtype] * (len(want) - 1)
    jv = float(np.asarray(jl._array).astype(np.float32))
    if want[-1] != "float32":      # computed in the low dtype on both sides
        assert float(pl.detach().float()) == jv
    np.testing.assert_allclose(float(pl.detach().float()), jv,
                               atol=LOSS_ATOL[dtype], rtol=0)
    pl.float().backward()
    jl.backward()
    _check_grads(ref, port, dtype)


@pytest.mark.parametrize("level,dtype", CASES)
def test_bert_dtypes_losses_and_grads_match(level, dtype):
    paddle.seed(0)
    ref = JBertForSequenceClassification(jax_bert_tiny(dropout=0.0))
    port = BertForSequenceClassification(bert_tiny(dropout=0.0),
                                         device="cpu", seed=1)
    port.load_reference_state(_named(ref))
    _decorate(ref, port, level, dtype)
    rng = np.random.RandomState(1)
    ids = rng.randint(0, 256, (4, 24))
    tok = rng.randint(0, 2, (4, 24))
    lab = rng.randint(0, 2, (4,))
    want, got = [], []
    jce, pce = jnn.CrossEntropyLoss(), nn.CrossEntropyLoss()
    with jamp.auto_cast(level=level, dtype=dtype):
        t, tk = paddle.to_tensor(ids), paddle.to_tensor(tok)
        x = ref.bert.embeddings(t, tk)
        want.append(str(x.dtype))
        for layer in ref.bert.encoder.layers:
            x = layer(x)
            want.append(str(x.dtype))
        logits = ref(t, tk)
        want.append(str(logits.dtype))
        jl = jce(logits, paddle.to_tensor(lab))
        want.append(str(jl.dtype))
    with amp.auto_cast(level=level, dtype=dtype):
        t, tk = torch.from_numpy(ids), torch.from_numpy(tok)
        x = port.bert.embeddings(t, tk)
        got.append(_dt(x))
        for layer in port.bert.encoder.layers:
            x = layer(x)
            got.append(_dt(x))
        logits = port(t, tk)
        got.append(_dt(logits))
        pl = pce(logits, torch.from_numpy(lab))
        got.append(_dt(pl))
    assert got == want
    jv = float(np.asarray(jl._array).astype(np.float32))
    np.testing.assert_allclose(float(pl.detach().float()), jv,
                               atol=LOSS_ATOL[dtype], rtol=0)
    pl.float().backward()
    jl.backward()
    _check_grads(ref, port, dtype)


def test_cast_rule_follows_the_reference_registry():
    """Each op's floating inputs under the rule of
    ``ops/registry.py:89-114``: O1 white low / black float32 / else
    kept; O2 everything low but the black list; cast and assign exempt."""
    x = torch.randn(3)
    for level, op, want in (("O1", "linear_op", torch.float16),
                            ("O1", "elementwise_add", torch.float32),
                            ("O1", "softmax_with_cross_entropy",
                             torch.float32),
                            ("O2", "elementwise_add", torch.float16),
                            ("O2", "layer_norm_op", torch.float16),
                            ("O2", "reduce_sum", torch.float32),
                            ("O2", "cast", torch.float32),
                            ("O2", "assign", torch.float32)):
        with amp.auto_cast(level=level, dtype="float16"):
            assert amp.cast_inputs(op, x)[0].dtype == want, (level, op)
    with amp.auto_cast(level="O2", custom_black_list={"elementwise_add"}):
        assert amp.cast_inputs("elementwise_add",
                               x.half())[0].dtype == torch.float32
    with amp.auto_cast(level="O2"):
        assert amp.cast_inputs("gelu_op", x)[0].dtype == torch.bfloat16
        assert amp.cast_inputs("embedding_op", torch.arange(3))[0].dtype \
            == torch.int64
    assert amp.cast_inputs("elementwise_add", x)[0].dtype == torch.float32
    with pytest.raises(ValueError):
        with amp.auto_cast(level="O3"):
            pass


def test_decorate_casts_parameters_once_and_refuses_ignored_args():
    m = nn.Sequential(nn.Linear(4, 3, device="cpu"), nn.LayerNorm(
        3, device="cpu"))
    ps = list(m.parameters())
    opt = SGD(0.1, parameters=ps)
    out = amp.decorate(m, opt, level="O2", dtype="float16")
    assert out == (m, opt)
    assert all(p.dtype == torch.float16 for p in m.parameters())
    assert all(a is b for a, b in zip(ps, m.parameters()))
    assert amp.decorate(m, level="O1") is m
    for kw in (dict(master_weight=True), dict(save_dtype="float32")):
        with pytest.raises(NotImplementedError):
            amp.decorate(m, level="O2", **kw)


def _scaler_models(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(4, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    paddle.seed(0)
    ref = jnn.Linear(4, 3)
    ref.weight._array = jax.numpy.asarray(w)
    ref.bias._array = jax.numpy.asarray(b)
    port = nn.Linear(4, 3, device="cpu")
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(w))
        port.bias.copy_(torch.from_numpy(b))
    return ref, port


# finite (1.0) and found-inf (inf) steps: two good steps, two bad (the
# scale halves at update 4), three good (doubles at 7), one bad, one good,
# three bad (halves at 11, one bad step left over), three good (doubles
# at 15)
SCRIPT = [1, 1, np.inf, np.inf, 1, 1, 1, np.inf, 1, np.inf, np.inf,
          np.inf, 1, 1, 1]


def test_grad_scaler_state_machine_matches_the_reference():
    jref, port = _scaler_models()
    jreg, preg = JRegistry(), MetricsRegistry()
    kw = dict(init_loss_scaling=1024.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=2)
    js = jamp.GradScaler(registry=jreg, **kw)
    ps = amp.GradScaler(registry=preg, **kw)
    jo = jopt.SGD(0.05, parameters=jref.parameters())
    po = SGD(0.05, parameters=list(port.parameters()))
    x = np.random.RandomState(1).randn(5, 4).astype(np.float32)
    for i, mult in enumerate(SCRIPT):
        before = [p.detach().clone() for p in port.parameters()]
        jl = paddle.mean(jref(paddle.to_tensor(x))) * float(mult)
        js.minimize(jo, js.scale(jl))
        jo.clear_grad()
        pl = port(torch.from_numpy(x)).mean() * float(mult)
        ps.minimize(po, ps.scale(pl))
        po.clear_grad()
        assert ps.state_dict() == js.state_dict(), i
        assert ps._scale == js._scale
        if mult == np.inf:     # a found-inf step moves nothing
            for a, b in zip(port.parameters(), before):
                assert torch.equal(a, b)
        for (n, jp), pp in zip(jref.named_parameters(), port.parameters()):
            np.testing.assert_allclose(pp.detach().numpy(),
                                       np.asarray(jp._array), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{i} {n}")
        for name in ("amp_loss_scale", "amp_found_inf_total"):
            j = [s["value"] for s in jreg.snapshot()[name]["series"]]
            p = [s["value"] for s in preg.snapshot()[name]["series"]]
            assert p == j, (i, name)
    assert ps.state_dict()["scale_history"] == [
        [0, 1024.0], [4, 512.0], [7, 1024.0], [11, 512.0], [15, 1024.0]]
    assert preg.snapshot()["amp_found_inf_total"]["series"][0]["value"] \
        == SCRIPT.count(np.inf)
    ps.close()
    assert preg.snapshot()["amp_loss_scale"]["series"] == []


def test_grad_scaler_unscales_once_per_step_and_round_trips():
    _, port = _scaler_models()
    s = amp.GradScaler(init_loss_scaling=8.0, registry=False)
    po = SGD(0.1, parameters=list(port.parameters()))
    x = torch.randn(5, 4)
    s.scale(port(x).mean()).backward()
    raw = [p.grad.clone() for p in port.parameters()]
    s.unscale_(po)
    s.unscale_(po)             # a second call in the step does nothing
    for p, g in zip(port.parameters(), raw):
        torch.testing.assert_close(p.grad, g / 8.0, rtol=0, atol=0)
    s.step(po)
    s.update()
    assert s._found_inf is False and s._good_steps == 1
    s.notify_found_inf()
    s.update()
    assert (s._good_steps, s._bad_steps) == (0, 1)
    fresh = amp.GradScaler(registry=False)
    fresh.load_state_dict(s.state_dict())
    assert fresh.state_dict() == s.state_dict()
    off = amp.GradScaler(enable=False)
    y = torch.ones(2)
    assert off.scale(y) is y
    with amp.auto_cast(level="O2", dtype="float16"):
        assert s.scale(torch.ones(2)).dtype == torch.float16


def _rel16(got, want):
    """max-abs error over max-abs, both taken in float32."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    return _rel(got, np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("share_p", [False, True], ids=["recompute",
                                                        "shared_dl"])
def test_plain_kernels_take_float16_as_the_pallas_kernels_do(share_p):
    """C20 on the CPU: the port's plain flash, fused-CE (with and without
    the shared-dl pair: float16 h with the bf16 dl) and packed-flash
    versions at float16 against the reference's Pallas kernels in
    interpret mode at float16 (``_INTERPRET``, and ``_SHARE_P``, set and
    restored here). Both sides compute in float32 and round their outputs
    to float16 (the reference's ``preferred_element_type``), so they
    agree within 4e-3 of max-abs (two float16 steps; the shared-dl pair's
    bf16 dl within 1e-2, a bf16 step); outputs and gradients are float16
    on both sides."""
    from paddle_tpu.kernels import flash_attention_pallas as fap
    from paddle_tpu.kernels import fused_ce_pallas as fcp
    from paddle_tpu.kernels import packed_flash_pallas as pfp
    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import fused_ce as fc
    from paddle_tpu_torch.kernels import packed_flash as pf
    rng = np.random.RandomState(0)
    B, L, H, D = 1, 256, 2, 64
    q, k, v, do = (rng.randn(B, L, H, D).astype(np.float16)
                   for _ in range(4))
    T, d, V = 128, 64, 500
    h = rng.randn(T, d).astype(np.float16)
    w = (rng.randn(V, d) * 0.1).astype(np.float16)
    lab = rng.randint(0, V, T)
    seg = np.repeat(np.arange(4), L // 4)[None].astype(np.int32)
    prev = (fap._INTERPRET, fcp._INTERPRET, pfp._INTERPRET, fcp._SHARE_P,
            fc._SHARE_P)
    fap._INTERPRET = fcp._INTERPRET = pfp._INTERPRET = True
    fcp._SHARE_P = fc._SHARE_P = share_p
    try:
        with jax.enable_x64(False):     # Mosaic's int32 index arithmetic
            jq, jk, jv, jdo = map(jax.numpy.asarray, (q, k, v, do))
            jout, jvjp = jax.vjp(lambda a, b, c: fap.flash_attention(
                a, b, c, causal=True), jq, jk, jv)
            jflash = (jout, *jvjp(jdo))
            jpout, pvjp = jax.vjp(lambda a, b, c: pfp.packed_flash_attention(
                a, b, c, jax.numpy.asarray(seg)), jq, jk, jv)
            jpacked = (jpout, *pvjp(jdo))
            jh, jw = jax.numpy.asarray(h), jax.numpy.asarray(w)
            jnll, cvjp = jax.vjp(lambda a, b: fcp.fused_softmax_ce(
                a, b, jax.numpy.asarray(lab)), jh, jw)
            jce = (jnll, *cvjp(jax.numpy.full((T,), 1.0 / T,
                                              jax.numpy.float32)))
        tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        out = fa.flash_attention(tq, tk, tv, causal=True)
        out.backward(torch.from_numpy(do))
        flash = (out, tq.grad, tk.grad, tv.grad)
        pq, pk, pv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        pout = pf.packed_flash_attention(pq, pk, pv, torch.from_numpy(seg))
        pout.backward(torch.from_numpy(do))
        packed = (pout, pq.grad, pk.grad, pv.grad)
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        nll = fc.fused_softmax_ce(th, tw, torch.from_numpy(lab))
        nll.mean().backward()
        ce = (nll, th.grad, tw.grad)
    finally:
        (fap._INTERPRET, fcp._INTERPRET, pfp._INTERPRET, fcp._SHARE_P,
         fc._SHARE_P) = prev
    for name, got, want in (("flash", flash, jflash),
                            ("packed", packed, jpacked)):
        for key, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            assert a.dtype == torch.float16 and str(b.dtype) == "float16"
            assert _rel16(a, b) <= 4e-3, (name, key, _rel16(a, b))
    assert ce[0].dtype == torch.float32 and str(jce[0].dtype) == "float32"
    assert _rel16(ce[0], jce[0]) <= 1e-5
    gtol = 1e-2 if share_p else 4e-3
    for key, a, b in zip(("dh", "dw"), ce[1:], jce[1:]):
        assert a.dtype == torch.float16 and str(b.dtype) == "float16", key
        assert _rel16(a, b) <= gtol, (key, _rel16(a, b))
