"""The GPT-2 training step of the PyTorch port against the JAX reference
on the CPU: ``paddle_tpu_torch.parallel.api.TrainStep`` over
``paddle_tpu_torch.models.gpt.GPTForCausalLM`` versus
``paddle_tpu.parallel.api.TrainStep`` over the reference's
``GPTForCausalLM``, on ``gpt2_tiny`` built after ``paddle.seed(0)``, its
weights carried across by name with ``load_reference_state``.

Tolerances (float32 on both sides; sums run in another order in the two
frameworks, and the reference's attention is its XLA path with autodiff
where the port's is the plain flash forward with the lse backward):
logits rtol 1e-5 / atol 1e-5 (logits are O(1)); gradients rtol 1e-4 / atol 1e-6; per-step
losses rtol 1e-5; parameters after K steps rtol 1e-4 / atol 1e-6. Under
O1 bf16 the two round at different places, so losses agree within 2e-2
and the dtypes at block, logits and loss boundaries must be equal. With
``fused_ce=True`` the reference answers through its XLA composition on
the CPU and the port through the plain fused-CE functions."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu as paddle
from paddle_tpu import optimizer as jopt
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu.distributed.mesh import AXES_ORDER
from paddle_tpu.models.gpt import gpt2_tiny as jax_gpt2_tiny
from paddle_tpu.nn import ClipGradByGlobalNorm as JaxClip
from paddle_tpu.optimizer.lr import LinearWarmup as JaxLinearWarmup
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch import amp
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gen_params, gpt2_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.nn.functional import cross_entropy
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer.lr import LinearWarmup
from paddle_tpu_torch.parallel.api import TrainStep

torch.set_num_threads(2)

B, S, K = 2, 32, 4
LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOSS_RTOL = 1e-5
BF16_LOSS_ATOL = 2e-2


def _mesh():
    """A one-device mesh with the reference's axes."""
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    """The reference's layers constrain activations to the global mesh;
    a mesh left by another test file in this process would not match
    the one-device step, so each test runs under the one-device mesh
    and restores what it found."""
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _models(**kw):
    kw.setdefault("dropout", 0.0)
    kw.setdefault("bf16_residual", False)
    paddle.seed(0)
    ref = jax_gpt2_tiny(**kw)
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    return ref, port


def _batch(k=None, seed=0):
    rng = np.random.RandomState(seed)
    shape = (B, S) if k is None else (k, B, S)
    ids = rng.randint(0, 128, shape).astype(np.int64)
    return ids, np.roll(ids, -1, axis=-1)


def _jax_loss(m, ids, labels):
    return m.loss(ids, labels)


def _port_loss(m, ids, labels):
    return m.loss(ids, labels)


def _np(t):
    return t.detach().float().cpu().numpy()


def test_parameter_names_and_shapes_match_the_reference():
    ref, port = _models()
    want = [(n, tuple(p.shape)) for n, p in ref.named_parameters()]
    got = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    assert got == want


def test_forward_logits_match():
    ref, port = _models()
    ids, _ = _batch()
    want = np.asarray(ref(paddle.to_tensor(ids))._array)
    got = _np(port(torch.from_numpy(ids)))
    np.testing.assert_allclose(got, want, **LOGIT_TOL)


def test_grad_step_grads_match_by_name():
    ref, port = _models()
    ids, labels = _batch()
    jstep = JaxTrainStep(ref, _jax_loss, jopt.AdamW(
        parameters=ref.parameters()), mesh=_mesh())
    jloss, jgrads, _ = jstep.grad_step(ids, labels)
    step = TrainStep(port, _port_loss, AdamW(), device="cpu")
    loss, grads, aux = step.grad_step(ids, labels)
    assert aux is None
    assert step._param_names == jstep._param_names
    np.testing.assert_allclose(float(loss), float(np.asarray(jloss._array)),
                               rtol=LOSS_RTOL)
    for name, g, jg in zip(step._param_names, grads, jgrads):
        np.testing.assert_allclose(_np(g), np.asarray(jg), err_msg=name,
                                   **GRAD_TOL)


def _run_multi(ref, port, loss_fns=(_jax_loss, _port_loss)):
    """K steps of AdamW + global-norm clip + LinearWarmup on both
    sides; returns ((losses, params) reference, (losses, params) port)."""
    ids, labels = _batch(K)

    def sched(cls):
        return cls(learning_rate=3e-3, warmup_steps=3, start_lr=1e-3,
                   end_lr=3e-3)

    jstep = JaxTrainStep(ref, loss_fns[0], jopt.AdamW(
        learning_rate=sched(JaxLinearWarmup), weight_decay=0.1,
        grad_clip=JaxClip(1.0), parameters=ref.parameters()), mesh=_mesh())
    jl = np.asarray(jstep.multi_step(ids, labels)._array)
    step = TrainStep(port, loss_fns[1], AdamW(
        learning_rate=sched(LinearWarmup), weight_decay=0.1,
        grad_clip=ClipGradByGlobalNorm(1.0)), device="cpu")
    pl = _np(step.multi_step(torch.from_numpy(ids), torch.from_numpy(labels)))
    jp = {n: np.asarray(p._array) for n, p in ref.named_parameters()}
    pp = {n: _np(p) for n, p in port.named_parameters()}
    return (jl, jp), (pl, pp)


@pytest.mark.parametrize("kw", [dict(), dict(recompute=True),
                                dict(ce_chunk=16), dict(fused_ce=True)],
                         ids=["plain", "recompute", "ce_chunk", "fused_ce"])
def test_multi_step_matches_losses_and_params(kw):
    ref, port = _models(**kw)
    (jl, jp), (pl, pp) = _run_multi(ref, port)
    assert pl.shape == (K,)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    H = 64
    for name in jp:
        got, want = pp[name], jp[name]
        if name.endswith("attn.qkv.bias"):
            # the key bias adds one constant to each query's scores, which
            # softmax ignores: its exact gradient is zero and both sides
            # hold rounding noise that Adam scales to steps of about lr,
            # so it may differ by up to 2 * K * max lr; the rest as usual
            np.testing.assert_allclose(got[H:2 * H], want[H:2 * H],
                                       rtol=0, atol=2 * K * 3e-3)
            got = np.concatenate([got[:H], got[2 * H:]])
            want = np.concatenate([want[:H], want[2 * H:]])
        np.testing.assert_allclose(got, want, err_msg=name, **PARAM_TOL)


def _block_dtypes_jax(m, ids):
    out = []
    t = paddle.to_tensor(ids)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        x = paddle.add(m.gpt.wte(t), m.gpt.wpe(paddle.arange(
            0, ids.shape[1], dtype="int64")))
        for blk in m.gpt.blocks:
            x = blk(x)
            out.append(str(x.dtype))
        out.append(str(m(t).dtype))
        out.append(str(m.loss(t, paddle.to_tensor(np.roll(ids, -1, -1)))
                       .dtype))
    return out


def _block_dtypes_port(m, ids):
    out = []
    t = torch.from_numpy(ids)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        x = m.gpt.wte(t) + m.gpt.wpe(torch.arange(ids.shape[1]))
        for blk in m.gpt.blocks:
            x = blk(x)
            out.append(str(x.dtype).replace("torch.", ""))
        out.append(str(m(t).dtype).replace("torch.", ""))
        out.append(str(m.loss(t, torch.from_numpy(np.roll(ids, -1, -1)))
                       .dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("bf16_residual,fused_ce", [
    pytest.param(True, False, id="True"),
    pytest.param(False, False, id="False"),
    pytest.param(True, True, id="fused_ce")])
def test_o1_bf16_dtypes_and_losses_match(bf16_residual, fused_ce):
    ref, port = _models(bf16_residual=bf16_residual, fused_ce=fused_ce)
    ids, _ = _batch()
    want = _block_dtypes_jax(ref, ids)
    assert _block_dtypes_port(port, ids) == want
    assert want[-2:] == ["bfloat16", "float32"]   # bf16 logits, f32 CE

    def jloss(m, i, y):
        with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(i, y)

    def ploss(m, i, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            return m.loss(i, y)

    (jl, _), (pl, _) = _run_multi(ref, port, (jloss, ploss))
    np.testing.assert_allclose(pl, jl, atol=BF16_LOSS_ATOL, rtol=0)


def test_autocast_follows_the_reference_lists():
    from paddle_tpu_torch.nn import functional as F
    x = torch.randn(3, 4)
    w, b = torch.randn(4, 5), torch.randn(5)
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        assert F.linear(x, w, b).dtype == torch.bfloat16   # bias cast too
        assert (F.matmul(x, w) + b).dtype == torch.float32  # add promotes
        xb = x.to(torch.bfloat16)
        assert F.layer_norm(xb, torch.ones(4), torch.zeros(4)).dtype == \
            torch.bfloat16
        assert F.gelu(xb, approximate=True).dtype == torch.bfloat16
        assert cross_entropy(xb, torch.tensor([0, 1, 2])).dtype == \
            torch.float32
        with amp.auto_cast(enable=False):
            assert F.linear(x, w, b).dtype == torch.bfloat16
        with amp.auto_cast(custom_black_list={"linear_op"}):
            assert F.linear(xb, w, b).dtype == torch.float32
    assert F.linear(x, w, b).dtype == torch.float32


def test_cross_entropy_mean_ignores_and_never_divides_by_zero():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 7).astype(np.float32)
    labels = np.array([1, -100, 3, 6, -100, 0], np.int64)
    from paddle_tpu.nn.functional import cross_entropy as jce
    for lab in (labels, np.full(6, -100, np.int64)):
        want = float(np.asarray(jce(paddle.to_tensor(logits),
                                    paddle.to_tensor(lab))._array))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(lab)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got == 0.0


def test_recompute_replays_dropout_masks_and_autocast():
    """With dropout on, the MLP half recomputed in the backward must draw
    the masks its forward drew, under the autocast state its forward
    saw: gradients equal those of the run without recompute."""
    ids, labels = _batch()
    grads = {}
    for rc in (False, True):
        m = GPTForCausalLM(gpt2_tiny(dropout=0.2, recompute=rc), device="cpu",
                           seed=7)
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            loss = m.loss(torch.from_numpy(ids), torch.from_numpy(labels))
        loss.backward()
        grads[rc] = {n: p.grad.clone() for n, p in m.named_parameters()}
    for n, g in grads[False].items():
        torch.testing.assert_close(grads[True][n], g, rtol=0, atol=0,
                                   msg=n)


def test_gen_params_serves_the_model_it_was_read_from():
    cfg = gpt2_tiny(dropout=0.0, bf16_residual=False)
    m = GPTForCausalLM(cfg, device="cpu", seed=5)
    prompt = np.random.RandomState(4).randint(0, 128, 21)
    eng = ServingEngine(cfg, gen_params(m), device="cpu", num_slots=1,
                        page_size=8, prefill_chunk=8, max_seq_len=128,
                        record_logits=True)
    uid = eng.add_request(prompt, 1)
    eng.run(max_steps=100)
    with torch.no_grad():
        want = m(torch.from_numpy(prompt[None]))[0, -1]
    torch.testing.assert_close(eng.logit_log[uid][0].float(), want,
                               rtol=1e-5, atol=1e-5)


def test_unported_options_raise():
    assert gpt2_tiny(fused_ce=True).fused_ce     # ported: no longer raises
    with pytest.raises(ValueError):
        gpt2_tiny(fused_ce=True, ce_chunk=16)
    with pytest.raises(NotImplementedError):
        gpt2_tiny(num_experts=4)
    m = GPTForCausalLM(gpt2_tiny(), device="cpu")
    for kw in (dict(mesh=object()), dict(fsdp_params=True),
               dict(shard_opt="dp"), dict(extra_state=[]),
               dict(has_aux=True)):
        with pytest.raises(NotImplementedError):
            TrainStep(m, _port_loss, AdamW(), device="cpu", **kw)
    # ported: the numerics pass and skip_nonfinite construct; a mode the
    # reference does not know raises its ValueError
    TrainStep(m, _port_loss, AdamW(), device="cpu", numerics="stats",
              skip_nonfinite=True)
    with pytest.raises(ValueError):
        TrainStep(m, _port_loss, AdamW(), device="cpu", numerics="all")
    for opt in (AdamW(apply_decay_param_fun=lambda n: True),
                AdamW(lr_ratio=lambda p: 1.0), None):
        with pytest.raises(NotImplementedError):
            TrainStep(m, _port_loss, opt, device="cpu")
    for attr, val in (("_grad_merge_k", 4), ("_asp_masks_by_param", {1: 1})):
        opt = AdamW()
        setattr(opt, attr, val)
        with pytest.raises(NotImplementedError):
            TrainStep(m, _port_loss, opt, device="cpu")
