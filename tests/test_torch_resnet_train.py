"""ResNet-50 training in the PyTorch port against the JAX reference on
the CPU: ``paddle_tpu_torch.vision.models.resnet50`` through
``paddle_tpu_torch.parallel.api.TrainStep`` with ``Momentum`` versus
``paddle_tpu.vision.models.resnet50`` through
``paddle_tpu.parallel.api.TrainStep``, built after ``paddle.seed(0)``
with ``num_classes=10``, parameters and batch-norm buffers carried
across by name (``load_reference_state``), batches of 4 images of 64 x
64 drawn from numpy seeds (helpers in ``tests/resnet_parity.py``;
``test_torch_resnet.py`` runs the same checks on ResNet-18).

Every comparison is float32 on both sides. ``err`` reads the largest
absolute difference of a tensor over the largest absolute value of the
reference's tensor, ``l2`` the L2 norm of the difference over the
reference's. Tolerances: train-mode logits ``err`` 1e-3; batch-norm
buffers after a forward, a ``grad_step`` or K steps ``err`` 1e-4;
gradients by name (all 161 of ResNet-50, 62 of ResNet-18) ``l2`` 5e-2
for ResNet-50 and 1e-4 for ResNet-18; per-step losses of K = 3 Momentum
steps at lr 1e-4 rtol 1e-5; the K steps' parameter updates
(``update_l2``: ``|p - p_ref| / |p_ref - p_0|``, an update below 1e-6 of
the tensor's norm counted as that much) 1e-1 for ResNet-50 and 5e-2 for
ResNet-18 (a flip in steps 2-3 moves a few: 2.0e-2 read on the card
against the CPU); eval-mode logits afterwards ``err`` 1e-4. Under O1 bf16 the
per-step losses agree within 2e-2 and the dtypes at the conv, BN,
block, logits and loss boundaries are equal.

Why ResNet-50's residual gains are scaled. At the reference's
initialisation (every batch-norm gain 1) a random ResNet-50 at batch 4
is chaotic in float32: the drift of a float32 forward from a float64 one
grows stage by stage (1.6e-6 after layer1, 1.4e-4 after layer4, the port
against itself in float64), enough that a few ReLU gates in layers 2-4
flip under rounding, and each flip moves some gradients by up to 20% of
their largest entry (3% in L2): the port in float32 and in float64
differ that much, as the reference and the port do, and K steps at lr
1e-4 end 10% apart in loss. So ResNet-50's gradient and K-step checks
run with the last batch-norm gain of each residual branch
(``bn3.weight``) at 0.25 on both sides, as zero-gain recipes start the
branches small (the drift after layer4 falls to 9e-6, the K-step losses
agree within 1e-6); the unscaled model is held on its train-mode logits
and buffers. Flips remain (a few ReLU gates in layers 1-2 at batch 4),
so ResNet-50's gradients and updates are held in L2 and loosely
(readings: 2.5e-2 and 4e-2); ResNet-18, which covers the same ops
(7x7 / 3x3 / 1x1 convs at strides 1 and 2, batch norm, both pools, the
head), holds its gradients at 1e-4 (reading 9e-6)."""
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
import resnet_parity as R
from paddle_tpu.distributed import mesh as mesh_mod
from paddle_tpu_torch import amp
from paddle_tpu_torch.nn.functional import cross_entropy


@pytest.fixture(autouse=True)
def _one_device_mesh():
    prev = mesh_mod._global_mesh
    mesh_mod.set_mesh(R.one_device_mesh())
    yield
    mesh_mod.set_mesh(prev)


def test_names_shapes_and_counts_match_the_reference():
    R.check_names_shapes_and_counts("resnet50")


@pytest.mark.parametrize("gain", [1.0, None], ids=["unit_gains", "scaled"])
def test_train_logits_and_running_stats_after_one_forward(gain):
    R.check_train_logits_and_running_stats("resnet50", gain)


def test_grad_step_grads_by_name_and_buffers():
    R.check_grad_step("resnet50")


def test_multi_step_losses_params_buffers_then_eval_logits():
    R.check_multi_step_then_eval("resnet50")


def test_o1_bf16_dtypes_and_losses_match():
    ref, port = R.models("resnet50")
    x, y = R.batch()
    want = R.dtypes_jax(ref, x, y)
    assert R.dtypes_port(port, x, y) == want
    assert want[:2] == ["bfloat16", "bfloat16"]       # conv, BN stay low
    # logits bf16, and so is the CE taken outside the autocast, as bench.py
    assert want[-2:] == ["bfloat16", "bfloat16"]
    ref, port = R.models("resnet50")

    def jloss(m, x, y):
        with R.paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(x)
        return JF.cross_entropy(logits, y)

    def ploss(m, x, y):
        with amp.auto_cast(level="O1", dtype="bfloat16"):
            logits = m(x)
        return cross_entropy(logits, y)

    xs, ys = R.batch(R.K, seed=4)
    jstep, step = R.steps(ref, port, loss_fns=(jloss, ploss))
    jl = np.asarray(jstep.multi_step(xs, ys)._array)
    pl = R.to_np(step.multi_step(torch.from_numpy(xs), torch.from_numpy(ys)))
    np.testing.assert_allclose(pl, jl, atol=R.BF16_LOSS_ATOL, rtol=0)
    assert all(b.dtype == torch.float32 for b in port.buffers())
