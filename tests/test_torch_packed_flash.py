"""Packed (segment-id) flash attention of the PyTorch port
(paddle_tpu_torch/kernels/packed_flash.py) against the JAX reference on
the CPU.

- The plain forward (``out``, ``lse``) against ``_pf_fwd_impl`` and the
  gradients of ``PackedFlashAttention`` against ``jax.vjp`` through the
  Pallas ``custom_vjp``, both run in interpret mode (``_INTERPRET``, set
  and restored here as ``tests/test_packed_flash.py`` does), at that
  file's sizes (B=2, H=2, D=32, L=256) over per-row segment layouts,
  causal and not.
- ``segment_relative_positions`` against the reference's.
- ``F.scaled_dot_product_attention``'s routing: a ``SegmentIds`` with
  ``dense=False`` to the packed kernels' wrapper, with ``dense=True`` and
  a dense additive mask to ``_sdpa_reference``, each against the
  reference's answer (on the CPU the reference answers through its dense
  route), and the O1 dtypes.
- A CUDA tensor on a machine without a card raises: the wrapper goes for
  the kernel, never for the plain version.

Tolerance, float32: max-abs error within 1e-5 of max-abs (sums run in
other orders in the two frameworks). The CUDA kernels themselves are
held against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ctypes
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.kernels.packed_flash_pallas as P
import paddle_tpu.nn.functional as JF
from paddle_tpu_torch import amp
from paddle_tpu_torch.kernels import packed_flash as pf
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention as port_attention

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-5
B, H, D, L = 2, 2, 32, 256


def _close(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= REL_TOL * float(np.abs(want).max()), (what, err)


def _layout(name):
    """Per-row segment ids ``[B, L]`` int32."""
    seg = np.zeros((B, L), np.int32)
    if name == "halves_third":     # tests/test_packed_flash.py's layout
        seg[0] = np.repeat(np.arange(2), L // 2)
        seg[1, L // 3:] = 1
    elif name == "uneven":         # not contiguous, not sorted; one segment
        seg[0] = [5] * 50 + [7] * 150 + [5] * 31 + [9] * 25
        seg[1] = 3
    elif name == "pack4":
        seg[:] = np.repeat(np.arange(4), L // 4)
    return seg


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
@pytest.mark.parametrize("layout", ["halves_third", "uneven", "pack4"])
def test_plain_matches_the_pallas_kernels_in_interpret_mode(layout, causal):
    q, k, v, do = _inputs()
    seg = _layout(layout)
    scale = 1.0 / np.sqrt(D)

    def bhld(t):
        return jnp.swapaxes(jnp.asarray(t), 1, 2).reshape(B * H, L, D)

    prev = P._INTERPRET
    P._INTERPRET = True
    try:
        with jax.enable_x64(False):
            jseg = jnp.repeat(jnp.asarray(seg), H, axis=0)
            jout, jlse = P._pf_fwd_impl(bhld(q), bhld(k), bhld(v), jseg,
                                        scale, causal, 256, 256)
            _, vjp = jax.vjp(
                lambda a, b_, c: P.packed_flash_attention(
                    a, b_, c, jnp.asarray(seg), causal=causal),
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
            jgrads = vjp(jnp.asarray(do))
    finally:
        P._INTERPRET = prev
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tseg = torch.from_numpy(seg)
    out, lse = pf.packed_flash_fwd_ref(tq.detach(), tk.detach(),
                                       tv.detach(), tseg, causal)
    _close(out.numpy(), np.swapaxes(np.asarray(jout).reshape(B, H, L, D),
                                    1, 2), "out")
    _close(lse.numpy(), np.asarray(jlse)[..., 0], "lse")
    pf.reset_launches()
    got = pf.packed_flash_attention(tq, tk, tv, tseg, causal=causal)
    got.backward(torch.from_numpy(do))
    assert (pf.fwd_launches, pf.dq_launches, pf.dkv_launches) == (0, 0, 0)
    torch.testing.assert_close(got.detach(), out, rtol=0, atol=0)
    for t, jg, name in zip((tq, tk, tv), jgrads, ("dq", "dk", "dv")):
        _close(t.grad.numpy(), np.asarray(jg), name)


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_lse_backward_matches_autograd_of_the_plain_forward(causal):
    """The dq and dk/dv formulas given (lse, delta) against torch autograd
    through the plain forward, at a length no Pallas block divides."""
    rng = np.random.default_rng(3)
    Lr = 100
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, Lr, 3, 16)).astype(np.float32)) for _ in range(4))
    seg = torch.from_numpy(np.array([[1] * 30 + [2] * 70,
                                     [4] * 61 + [1] * 39], np.int32))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = pf.packed_flash_fwd_ref(tq, tk, tv, seg, causal)
    out.backward(do)
    delta = pf.attention_delta(out.detach(), do)
    dq = pf.packed_flash_bwd_dq_ref(q, k, v, seg, do, lse.detach(), delta,
                                    causal)
    dk, dv = pf.packed_flash_bwd_dkv_ref(q, k, v, seg, do, lse.detach(),
                                         delta, causal)
    for g, t, name in ((dq, tq, "dq"), (dk, tk, "dk"), (dv, tv, "dv")):
        _close(g.numpy(), t.grad.numpy(), name)


def test_segment_relative_positions_match_the_reference():
    rng = np.random.default_rng(4)
    rows = []
    for _ in range(5):
        cuts = np.sort(rng.choice(np.arange(1, 64), rng.integers(0, 6),
                                  replace=False))
        ids = np.zeros(64, np.int32)
        for i, c in enumerate(cuts):
            ids[c:] = rng.integers(0, 100) if i % 2 else i + 1
        rows.append(ids)
    seg = np.stack(rows)
    want = np.asarray(P.segment_relative_positions(jnp.asarray(seg)))
    got = pf.segment_relative_positions(torch.from_numpy(seg))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _sdpa_case(seed=5):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
               for _ in range(3))
    seg = np.array([[0] * 10 + [1] * 14, [2] * 5 + [3] * 19], np.int32)
    return q, k, v, seg


def _jax_sdpa(q, k, v, mask):
    return np.asarray(JF.scaled_dot_product_attention(
        paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
        attn_mask=mask)._array)


def test_sdpa_routes_segment_ids_to_the_packed_kernels(monkeypatch):
    q, k, v, seg = _sdpa_case()
    want = _jax_sdpa(q, k, v, P.SegmentIds(paddle.to_tensor(seg)))
    calls = []
    real = port_attention.packed_flash_attention

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(port_attention, "packed_flash_attention", spy)
    monkeypatch.setattr(port_attention, "_sdpa_reference", None)
    got = F.scaled_dot_product_attention(
        *map(torch.from_numpy, (q, k, v)),
        attn_mask=pf.SegmentIds(torch.from_numpy(seg)), dropout_p=0.3,
        training=True)
    assert calls == [1]
    _close(got.numpy(), want, "packed")


@pytest.mark.parametrize("route", ["segment_ids_dense", "additive_mask"])
def test_sdpa_routes_dense_masks_to_the_reference_route(route, monkeypatch):
    q, k, v, seg = _sdpa_case(6)
    if route == "segment_ids_dense":
        jmask = P.SegmentIds(paddle.to_tensor(seg), dense=True)
        mask = pf.SegmentIds(torch.from_numpy(seg), dense=True)
    else:
        keep = seg[:, None, :, None] == seg[:, None, None, :]
        dense = np.where(keep, 0.0, -1e30).astype(np.float32)
        jmask, mask = paddle.to_tensor(dense), torch.from_numpy(dense)
    want = _jax_sdpa(q, k, v, jmask)

    def refuse(*a, **kw):
        raise AssertionError("a dense mask reached a kernel wrapper")
    monkeypatch.setattr(port_attention, "packed_flash_attention", refuse)
    monkeypatch.setattr(port_attention, "flash_attention", refuse)
    got = F.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)),
                                         attn_mask=mask)
    _close(got.numpy(), want, route)


@pytest.mark.parametrize("dense", [False, True])
def test_sdpa_casts_packed_attention_as_the_white_listed_op(dense):
    q, k, v, seg = _sdpa_case(7)
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        want = JF.scaled_dot_product_attention(
            paddle.to_tensor(q), paddle.to_tensor(k), paddle.to_tensor(v),
            attn_mask=P.SegmentIds(paddle.to_tensor(seg), dense=dense))
    with amp.auto_cast(level="O1", dtype="bfloat16"):
        got = F.scaled_dot_product_attention(
            *map(torch.from_numpy, (q, k, v)),
            attn_mask=pf.SegmentIds(torch.from_numpy(seg), dense=dense))
    assert str(want.dtype) == "bfloat16" and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want._array, np.float32),
                               rtol=0, atol=3e-2)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrapper sees of a
    CUDA tensor, on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_a_cuda_tensor_raises_without_a_card_and_never_runs_plain(
        tmp_path, monkeypatch):
    import torch.utils.cpp_extension as ext
    from paddle_tpu_torch.kernels import _build
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pf, "_fns", {})
    for name in ("packed_flash_fwd_ref", "packed_flash_bwd_dq_ref",
                 "packed_flash_bwd_dkv_ref"):
        monkeypatch.setattr(pf, name, None)      # calling one would fail
    q, k, v, do = (torch.Tensor._make_subclass(_FakeCuda,
                                               torch.from_numpy(t))
                   for t in _inputs(8))
    seg = torch.Tensor._make_subclass(_FakeCuda,
                                      torch.from_numpy(_layout("uneven")))
    lse = torch.Tensor._make_subclass(_FakeCuda, torch.zeros(B * H, L))
    pf.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        pf.packed_flash_fwd(q, k, v, seg)
    with pytest.raises(RuntimeError, match="nvcc"):
        pf.packed_flash_bwd_dq(q, k, v, seg, do, lse, lse)
    with pytest.raises(RuntimeError, match="nvcc"):
        pf.packed_flash_bwd_dkv(q, k, v, seg, do, lse, lse)
    assert (pf.fwd_launches, pf.dq_launches, pf.dkv_launches) == (0, 0, 0)


def test_wrappers_check_what_the_kernels_take():
    q = torch.zeros(1, 8, 2, 16)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        pf._check(q, q, q, seg.long())
    with pytest.raises(ValueError):
        pf._check(q, q, q, seg[:, :4])
    with pytest.raises(ValueError):
        big = torch.zeros(1, 8, 2, 160)
        pf._check(big, big, big, seg)
    with pytest.raises(ValueError):
        pf._check(q, q[:, :4], q, seg)
    pf._check(q, q, q, seg)


def test_ctypes_bindings_match_the_c_prototypes():
    """Each wrapper's argtypes list the C entry's parameters in order: a
    pointer declared as an int would be cut to 32 bits."""
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "packed_flash.cu")) as f:
        text = f.read()
    for name, want in (("packed_flash_forward", pf.FWD_ARGTYPES),
                       ("packed_flash_backward_dq", pf.DQ_ARGTYPES),
                       ("packed_flash_backward_dkv", pf.DKV_ARGTYPES)):
        sig = re.search(rf'extern "C" int {name}\((.*?)\)', text,
                        re.S).group(1)
        params = [" ".join(p.split()) for p in sig.split(",")]
        kinds = [ctypes.c_void_p if "*" in p else
                 ctypes.c_float if p.startswith("float") else ctypes.c_int
                 for p in params]
        assert kinds == want, name
