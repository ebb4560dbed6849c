"""``paddle_tpu_torch/tools/bench_longctx.py`` on the CPU at small
lengths: the reference's lines and keys, and the plain flash version's
gradients of ``sum(out ** 2)`` against naive softmax attention's and
against the JAX reference's naive attention, float32, within 1e-5 of
each gradient's max-abs (the same function summed in another order: the
flash backward goes through the saved lse, the naive one through
softmax's autodiff; readings 0.8e-6 to 1.3e-6 of gradients up to 18)."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.tools import bench_longctx as bl

torch.set_num_threads(2)


def test_lines_carry_the_reference_keys():
    lines = []
    bl.run(lengths=(128, 256), device="cpu", iters=1, emit=lines.append)
    recs = [json.loads(x) for x in lines]
    assert [(r["metric"], r["seq_len"]) for r in recs] == [
        ("attention_fwd_bwd_flash", 128), ("attention_fwd_bwd_naive", 128),
        ("flash_speedup_vs_naive", 128), ("attention_fwd_bwd_flash", 256),
        ("attention_fwd_bwd_naive", 256), ("flash_speedup_vs_naive", 256)]
    for r in recs:
        assert r["value"] > 0 and r["dtype"] == "float32"
        if r["metric"].startswith("attention"):
            assert r["unit"] == "ms/step" and r["tflops"] > 0
            assert r["device"] == "cpu"
        else:
            assert r["unit"] == "x"


def _jax_naive_grads(q, k, v):
    D = q.shape[-1]

    def naive(q, k, v):   # tools/bench_longctx.py's naive
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(D)
        mask = jnp.tril(jnp.ones((q.shape[1], q.shape[1]), bool))
        s = jnp.where(mask[None, None], s, -1e30)
        p = jax.nn.softmax(s, axis=-1)
        return jnp.einsum("bhqk,bkhd->bqhd", p, v)

    return jax.grad(lambda q, k, v: jnp.sum(naive(q, k, v) ** 2),
                    argnums=(0, 1, 2))(q, k, v)


@pytest.mark.parametrize("T", [128, 256])
def test_flash_gradients_equal_naive(T):
    q, k, v = bl.inputs(T, torch.float32, torch.device("cpu"),
                        np.random.RandomState(T))
    flash = bl.grads(bl.flash, q, k, v)
    naive = bl.grads(bl.naive, q, k, v)
    ref = _jax_naive_grads(*(t.detach().numpy() for t in (q, k, v)))
    for f, n, r in zip(flash, naive, ref):
        tol = 1e-5 * float(np.abs(np.asarray(r)).max())
        np.testing.assert_allclose(f.numpy(), n.numpy(), rtol=0, atol=tol)
        np.testing.assert_allclose(f.numpy(), np.asarray(r), rtol=0,
                                   atol=tol)


def test_cpu_does_not_stand_in_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError):
        bl.run(lengths=(128,), iters=1, emit=lambda _: None)
