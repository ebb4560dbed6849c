"""Flash attention of the PyTorch port (paddle_tpu_torch/kernels/
flash_attention.py) against the JAX reference on the CPU.

- The plain forward (``out``, ``lse``) and the plain backward against
  the Pallas kernels of ``paddle_tpu/kernels/flash_attention_pallas.py``
  run in interpret mode (``_INTERPRET``, set and restored here as
  ``tests/test_kernels.py`` does): ``lse`` against ``_fa_fwd_impl``'s,
  the gradients against ``jax.grad`` through the Pallas ``custom_vjp``.
  Cases: causal 256, cross 128/256, streamed 256/4096 (Lk > 2048).
- Against ``_sdpa_reference`` (``nn/functional/attention.py:24``) for
  what the Pallas wrapper refuses: an unaligned length (1030) and
  causal ``Lq != Lk`` in both directions (128/256, and 256/128 whose
  first rows see no column).
- The lse backward against torch autograd through the plain forward.
- The wrappers' routing: CPU tensors run the plain versions and launch
  nothing.

Tolerances, float32: forward and lse 1e-5, gradients 1e-4 (absolute
and relative; sums run in other orders in the three implementations).
The CUDA kernels themselves are held against these plain versions on
the card (tests/test_torch_cuda.py, chip_smoke.py)."""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.nn.functional import scaled_dot_product_attention
from paddle_tpu_torch.nn.functional.attention import \
    _sdpa_reference as port_sdpa_reference

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(lq, lk, b=1, h=2, d=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, lq, h, d).astype(np.float32),
            rng.randn(b, lk, h, d).astype(np.float32),
            rng.randn(b, lk, h, d).astype(np.float32),
            rng.randn(b, lq, h, d).astype(np.float32))


def _port(q, k, v, do, causal):
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    scale = 1.0 / q.shape[-1] ** 0.5
    out, lse = fa.flash_attention_fwd_ref(tq, tk, tv, causal, scale)
    grads = fa.flash_attention_bwd_ref(tq, tk, tv, out, lse, tdo, causal,
                                       scale)
    return out.numpy(), lse.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("lq,lk,causal", [(256, 256, True),
                                          (128, 256, False),
                                          (256, 4096, False)],
                         ids=["causal256", "cross128x256",
                              "streamed256x4096"])
def test_plain_matches_the_pallas_kernels_in_interpret_mode(lq, lk, causal):
    q, k, v, do = _inputs(lq, lk)
    b, _, h, d = q.shape
    scale = 1.0 / d ** 0.5

    def bhld(t):
        return jnp.swapaxes(jnp.asarray(t), 1, 2).reshape(b * h, -1, d)

    def loss(q_, k_, v_):
        return jnp.sum(fap.flash_attention(q_, k_, v_, causal=causal)
                       * jnp.asarray(do))

    prev = fap._INTERPRET
    fap._INTERPRET = True
    try:
        with jax.enable_x64(False):
            bq, bk = fap._pick_blocks(lq, lk)
            jout, jlse = fap._fa_fwd_impl(bhld(q), bhld(k), bhld(v), scale,
                                          causal, bq, bk)
            jgrads = jax.grad(loss, argnums=(0, 1, 2))(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    finally:
        fap._INTERPRET = prev
    out, lse, grads = _port(q, k, v, do, causal)
    jout = np.swapaxes(np.asarray(jout).reshape(b, h, lq, d), 1, 2)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    np.testing.assert_allclose(lse, np.asarray(jlse)[..., 0], **FWD_TOL)
    for g, jg, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(jg), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("lq,lk,causal", [(1030, 1030, True),
                                          (1030, 77, False),
                                          (128, 256, True),
                                          (256, 128, True)],
                         ids=["unaligned_causal", "unaligned_cross",
                              "causal_q_shorter", "causal_q_longer"])
def test_plain_matches_sdpa_reference_where_pallas_refuses(lq, lk, causal):
    q, k, v, do = _inputs(lq, lk, seed=1)
    scale = 1.0 / q.shape[-1] ** 0.5

    def ref(q_, k_, v_):
        return _sdpa_reference(q_, k_, v_, None, causal=causal, scale=scale)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    jout = ref(jq, jk, jv)
    jgrads = jax.grad(lambda a, b_, c: jnp.sum(ref(a, b_, c) * do),
                      argnums=(0, 1, 2))(jq, jk, jv)
    out, _, grads = _port(q, k, v, do, causal)
    np.testing.assert_allclose(out, np.asarray(jout), **FWD_TOL)
    for g, jg, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(jg), err_msg=name,
                                   **GRAD_TOL)
    # the port's own copy of the oracle agrees with the reference's
    pout = port_sdpa_reference(*map(torch.from_numpy, (q, k, v)),
                               causal=causal, scale=scale)
    np.testing.assert_allclose(pout.numpy(), np.asarray(jout), **FWD_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(96, 96), (40, 72), (72, 40)])
def test_lse_backward_matches_autograd_of_the_plain_forward(lq, lk, causal):
    q, k, v, do = _inputs(lq, lk, b=2, h=3, d=16, seed=2)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out, lse = fa.flash_attention_fwd_ref(tq, tk, tv, causal)
    out.backward(torch.from_numpy(do))
    dq, dk, dv = fa.flash_attention_bwd_ref(
        tq.detach(), tk.detach(), tv.detach(), out.detach(), lse.detach(),
        torch.from_numpy(do), causal)
    for g, t, name in ((dq, tq, "dq"), (dk, tk, "dk"), (dv, tv, "dv")):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), err_msg=name,
                                   **GRAD_TOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(64, 80, seed=3))
    fa.reset_launches()
    tq = q.clone().requires_grad_()
    out = fa.flash_attention(tq, k, v, causal=True)
    out.backward(do)
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (0, 0, 0)
    ref, lse = fa.flash_attention_fwd_ref(q, k, v, True)
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    dq, _, _ = fa.flash_attention_bwd_ref(q, k, v, ref, lse, do, True)
    torch.testing.assert_close(tq.grad, dq, rtol=0, atol=0)
    with fa.use_plain():
        assert fa._plain
    assert not fa._plain


def test_sdpa_casts_as_the_white_listed_op_and_refuses_masks():
    q, k, v, _ = (torch.from_numpy(t) for t in _inputs(32, 32, seed=4))
    assert scaled_dot_product_attention(q, k, v).dtype == torch.float32
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
    assert out.dtype == torch.bfloat16
    want = port_sdpa_reference(q, k, v, causal=True, scale=1 / 8.0)
    torch.testing.assert_close(out.float(), want, rtol=0, atol=2e-2)
    # masks are ported now (the BERT slice): a dense additive mask no
    # longer raises; it goes to _sdpa_reference, as in the reference
    mask = torch.zeros(32, 32)
    mask[:, 5:9] = -1e30
    got = scaled_dot_product_attention(q, k, v, attn_mask=mask)
    torch.testing.assert_close(
        got, port_sdpa_reference(q, k, v, mask, causal=False, scale=1 / 8.0),
        rtol=0, atol=0)


def test_ctypes_bindings_match_the_c_prototypes():
    """Each wrapper's argtypes list the C entry's parameters in order: a
    pointer declared as an int would be cut to 32 bits."""
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "flash_attention.cu")) as f:
        text = f.read()
    for name, want in (("flash_attention_forward", fa.FWD_ARGTYPES),
                       ("flash_attention_backward_dq", fa.DQ_ARGTYPES),
                       ("flash_attention_backward_dkv", fa.DKV_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                        re.S).group(1)
        params = [" ".join(p.split()) for p in sig.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.startswith("float") else ctypes.c_int
                 for p in params]
        assert kinds == want, name
