"""``Adam`` of the PyTorch port (``paddle_tpu_torch/optimizer``) through
its ``TrainStep`` against ``paddle_tpu.parallel.api.TrainStep`` with the
reference's ``Adam`` (which that step runs as ``optax.adam``), on
``gpt2_tiny`` with dropout 0 built after ``paddle.seed(0)``, its weights
carried across by name.

Tolerances as tests/test_torch_train.py (float32 on both sides): per-step
losses rtol 1e-5, parameters after K = 5 steps rtol 1e-4 / atol 1e-6,
under the AdamW caveat (ROADMAP): an element whose gradient is rounding
noise steps by about lr either way, so it may differ by up to 2 * K * lr.
That is the whole attention key bias (its exact gradient is zero) and, in
other tensors, at most one element in a thousand (with the clip, whose
global norm sums in another order, one weight of 16384 reads 9.5e-6
apart)."""
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
from paddle_tpu.parallel.api import TrainStep as JaxTrainStep
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt2_tiny
from paddle_tpu_torch.nn import ClipGradByGlobalNorm
from paddle_tpu_torch.optimizer import Adam, AdamW
from paddle_tpu_torch.parallel.api import TrainStep

torch.set_num_threads(2)

B, S, K, LR, H = 2, 32, 5, 3e-3, 64
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape((1,) * len(AXES_ORDER)),
                AXES_ORDER)


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(_mesh())
    yield
    mesh_mod.set_mesh(prev)


def _models():
    kw = dict(dropout=0.0, bf16_residual=False)
    paddle.seed(0)
    ref = jax_gpt2_tiny(**kw)
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    return ref, port


def _loss(m, ids, labels):
    return m.loss(ids, labels)


@pytest.mark.parametrize("clip", [False, True], ids=["plain", "clip"])
def test_adam_steps_match_the_reference(clip):
    ref, port = _models()
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 128, (K, B, S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    jstep = JaxTrainStep(ref, _loss, jopt.Adam(
        learning_rate=LR, grad_clip=JaxClip(1.0) if clip else None,
        parameters=ref.parameters()), mesh=_mesh())
    jl = np.asarray(jstep.multi_step(ids, labels)._array)
    step = TrainStep(port, _loss, Adam(
        learning_rate=LR, grad_clip=ClipGradByGlobalNorm(1.0) if clip
        else None), device="cpu")
    pl = np.stack([float(step(ids[i], labels[i])) for i in range(K)])
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL)
    for name, p in port.named_parameters():
        got = p.detach().numpy()
        want = np.asarray(dict(ref.named_parameters())[name]._array)
        if name.endswith("attn.qkv.bias"):
            np.testing.assert_allclose(got[H:2 * H], want[H:2 * H], rtol=0,
                                       atol=2 * K * LR)
            got = np.concatenate([got[:H], got[2 * H:]])
            want = np.concatenate([want[:H], want[2 * H:]])
        noise = ~np.isclose(got, want, **PARAM_TOL)
        assert noise.mean() <= 1e-3, (name, int(noise.sum()))
        np.testing.assert_allclose(got[noise], want[noise], rtol=0,
                                   atol=2 * K * LR, err_msg=name)
    assert step._opt_state["count"] == K


def test_adam_is_adamw_without_decay():
    _, port_a = _models()
    _, port_w = _models()
    ids = np.random.RandomState(1).randint(0, 128, (B, S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    sa = TrainStep(port_a, _loss, Adam(learning_rate=LR), device="cpu")
    sw = TrainStep(port_w, _loss, AdamW(learning_rate=LR, weight_decay=0.0),
                   device="cpu")
    for _ in range(2):
        sa(ids, labels)
        sw(ids, labels)
    for (n, a), (_, w) in zip(port_a.named_parameters(),
                              port_w.named_parameters()):
        assert torch.equal(a, w), n
    assert issubclass(AdamW, Adam)


def test_adam_weight_decay_is_refused():
    """``optax.adam`` takes no decay, so the reference's step drops
    ``Adam(weight_decay=...)`` silently; the port's refuses it."""
    _, port = _models()
    with pytest.raises(NotImplementedError, match="weight_decay"):
        TrainStep(port, _loss, Adam(weight_decay=0.01), device="cpu")
    TrainStep(port, _loss, Adam(weight_decay=None), device="cpu")
    TrainStep(port, _loss, AdamW(weight_decay=0.01), device="cpu")


def test_bf16_residual_without_autocast_trains_as_the_reference():
    """ROADMAP C19: with ``bf16_residual=True`` (the default) and no
    autocast, the bf16 stream meets float32 weights; the reference's
    ``jnp.matmul`` promotes to float32 and so does the port's (it raised
    before). This is how ``bench_serving --spec-train-steps`` trains.
    The step-1 loss within 1e-5 (the same forward); the K steps' losses
    within 2e-2, tests/test_torch_train.py's bf16 limit: the stream
    rounds to bf16 at other places once the weights have moved (readings
    up to 1.1e-3)."""
    kw = dict(dropout=0.0)
    paddle.seed(0)
    ref = jax_gpt2_tiny(**kw)
    port = GPTForCausalLM(gpt2_tiny(**kw), device="cpu", seed=1)
    port.load_reference_state({n: np.asarray(p._array)
                               for n, p in ref.named_parameters()})
    assert port.gpt.cfg.bf16_residual
    rng = np.random.RandomState(2)
    ids = rng.randint(0, 128, (K, B, S)).astype(np.int64)
    labels = np.roll(ids, -1, axis=-1)
    jstep = JaxTrainStep(ref, _loss, jopt.Adam(
        learning_rate=LR, parameters=ref.parameters()), mesh=_mesh())
    jl = np.asarray(jstep.multi_step(ids, labels)._array)
    step = TrainStep(port, _loss, Adam(learning_rate=LR), device="cpu")
    pl = np.stack([float(step(ids[i], labels[i])) for i in range(K)])
    assert port(torch.from_numpy(ids[0])).dtype == torch.float32
    np.testing.assert_allclose(pl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(pl, jl, rtol=0, atol=2e-2)
