"""The wgmma/TMA design of the flash backward, dq and dk/dv
(``paddle_tpu_torch/kernels/csrc/flash_attention.cu``
``flash_attention_dq_hopper_kernel``, ``flash_attention_dkv_hopper_kernel``),
on the CPU.

- Routing: ``flash_attention.hopper_bwd`` on every shape ``chip_smoke.py``
  and the card tests (``tests/test_torch_cuda.py``) run: bfloat16 at D = 64
  takes the new kernels; float32, other head sizes (128 included) and
  tensors that are not 16-byte aligned take the CUDA-core ones.
- The ctypes prototypes of the two new C entries, and the build flag
  ``FLASH_BWD_STALL_WG`` keying a variant of its own.
- A CUDA tensor without the library raises on either backward route, and
  runs no plain version.
- The new backward's rounding points that the plain version does not
  have: P (for dV) and dS rounded to bfloat16 before their products, P
  taken as ``2^(S scale log2(e) - lse log2(e))``, and the sums over 64-key
  (dq) and 64-row (dk/dv) tiles in the kernels' order. A plain PyTorch
  model of it is held against the JAX ``flash_attention_pallas`` backward
  in interpret mode, and against ``_sdpa_reference``'s gradient where the
  Pallas wrapper refuses (causal Lq != Lk, dead rows, unaligned lengths),
  at the bfloat16 gradient limit the card holds the kernels to
  (``BF16_GRAD_TOL``: 3e-2 of max-abs).

The kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ctypes
import importlib.util
import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from paddle_tpu.kernels import flash_attention_pallas as fap
from paddle_tpu.nn.functional.attention import _sdpa_reference
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as fa

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (B, H, Lq, Lk, D) of every flash backward the card runs
FLASH_SHAPES = {**{f"smoke_{n}": c[:5]
                   for n, c in chip_smoke.FLASH_CASES.items()},
                **{f"card_{n}": c[:5] for n, c in _CARD.FA_CASES.items()},
                "bert_base": (64, 12, 128, 128, 64)}
GRAD_TOL = chip_smoke.BF16_GRAD_TOL
assert GRAD_TOL == _CARD.FA_TOL[torch.bfloat16][1]


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


@pytest.mark.parametrize("case", list(FLASH_SHAPES))
def test_flash_backward_route_for_every_shape_the_card_runs(case):
    B, H, Lq, Lk, D = FLASH_SHAPES[case]
    for dtype, want in ((torch.bfloat16, D == 64), (torch.float32, False)):
        q, do = _empty((B, Lq, H, D), dtype), _empty((B, Lq, H, D), dtype)
        kv = _empty((B, Lk, H, D), dtype)
        assert fa.hopper_bwd(q, kv, kv, do) is want, (case, dtype)


def test_the_card_runs_both_backward_routes_in_bf16():
    """The card's bf16 cases reach the wgmma backward and, at head sizes
    it does not serve (128, 32), the CUDA-core kernels' bf16 build; the
    dead-row case runs through both designs."""
    assert {D == 64 for *_, D in FLASH_SHAPES.values()} == {True, False}
    dead = [n for n, (_, _, lq, lk, D) in FLASH_SHAPES.items()
            if lq > lk and D == 64 and n.startswith("smoke_")]
    assert dead and chip_smoke.FLASH_CASES["causal256x128"][5]


@pytest.mark.parametrize("D", [16, 32, 50, 96, 128])
def test_other_head_sizes_take_the_cuda_core_backward(D):
    q = _empty((1, 64, 2, D), torch.bfloat16)
    assert not fa.hopper_bwd(q, q, q, q)


def test_hopper_bwd_sees_the_alignment_of_every_input():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it, so the CUDA-core kernels take it, whichever input it is."""
    q = _empty((1, 64, 2, 64), torch.bfloat16)
    off = torch.empty(q.numel() + 8, dtype=torch.bfloat16)[1:q.numel() + 1] \
        .view(q.shape)
    assert fa.hopper_bwd(q, q, q, q)
    for i in range(4):
        args = [q] * 4
        args[i] = off
        assert not fa.hopper_bwd(*args), i


def test_the_stall_hook_builds_a_variant_beside_the_plain_library():
    src, plain = _build._target("flash_attention")
    _, wg0 = _build._target("flash_attention", ("-DFLASH_BWD_STALL_WG=0",))
    _, wg1 = _build._target("flash_attention", ("-DFLASH_BWD_STALL_WG=1",))
    assert len({plain, wg0, wg1}) == 3
    # the hook sits in both consumer loops, dq's and dk/dv's, of the bodies
    # the flash and the packed backward share
    text = (src.parent / "flash_bwd_hopper.cuh").read_text()
    assert text.count("#ifdef FLASH_BWD_STALL_WG") == 2


def _c_params(name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "flash_attention.cu")) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("name,argtypes", [
    ("flash_attention_backward_dq_hopper", fa.DQ_ARGTYPES),
    ("flash_attention_backward_dkv_hopper", fa.DKV_ARGTYPES)],
    ids=["dq", "dkv"])
def test_ctypes_bindings_match_the_c_prototypes_of_the_new_entries(
        name, argtypes):
    """The new entries take their old counterparts' arguments, so the
    wrappers bind both with one argtypes list; a pointer declared as an
    int would be cut to 32 bits."""
    assert _c_params(name) == argtypes
    assert _c_params(name.replace("_hopper", "")) == argtypes


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what the wrapper sees of a
    CUDA tensor, on a machine without a card."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _fake(t):
    return torch.Tensor._make_subclass(_FakeCuda, t)


@pytest.fixture
def no_library(tmp_path, monkeypatch):
    """No nvcc and no built library; the wrapper's own allocations land on
    the CPU (this torch has no CUDA); the names of the C entries asked
    for are recorded."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fa, "_fns", {})
    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    asked = []
    real = fa._kernel_fn

    def spy(name, argtypes):
        asked.append(name)
        return real(name, argtypes)
    monkeypatch.setattr(fa, "_kernel_fn", spy)
    # never called: a CUDA tensor runs no plain version
    monkeypatch.setattr(fa, "flash_attention_bwd_dq_ref", None)
    monkeypatch.setattr(fa, "flash_attention_bwd_dkv_ref", None)
    return asked


@pytest.mark.parametrize("dtype,D,hopper", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, False),
    (torch.float32, 64, False)], ids=["bf16", "bf16_d128", "f32"])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_a_cuda_tensor_raises_on_either_backward_route(no_library, kernel,
                                                       dtype, D, hopper):
    q = _fake(torch.randn(1, 64, 2, D).to(dtype))
    lse = _fake(torch.zeros(2, 64))
    fn = {"dq": fa.flash_attention_bwd_dq,
          "dkv": fa.flash_attention_bwd_dkv}[kernel]
    fa.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(q, q, q, q, lse, lse, True)
    entry = f"flash_attention_backward_{kernel}"
    assert no_library == [entry + "_hopper" if hopper else entry]
    assert (fa.dq_launches, fa.dq_hopper_launches, fa.dkv_launches,
            fa.dkv_hopper_launches) == (0, 0, 0, 0)


# -- the new backward's arithmetic, modelled ----------------------------------

TILE = 64   # keys a dq tile, q rows a dk/dv tile (HopperBwd::BN)


def hopper_backward_model(q, k, v, do, lse, delta, causal, scale,
                          rounded=True):
    """What ``flash_attention_dq_hopper_kernel`` and
    ``flash_attention_dkv_hopper_kernel`` compute, in float32 on bf16
    inputs: exact products summed in float32 (wgmma); P = 2^(S scale
    log2(e) - lse log2(e)) with the scale and lse prescaled in float32;
    dS = P (dP - delta) scale; dead rows weigh every key by 2^(-lse
    log2(e)) in dV and pass no dS; P and dS rounded to bfloat16 before
    dV += P^T dO, dq += dS K and dK += dS^T Q (``rounded``), each summed
    over 64-key (dq) or 64-row (dk/dv) tiles in order. Returns (dq, dk,
    dv) in bfloat16."""
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    sl2 = torch.tensor(scale, dtype=torch.float32) * log2e
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    lse2 = (lse.reshape(B, H, Lq) * log2e)[..., None]
    dl = delta.reshape(B, H, Lq)[..., None]
    p = torch.exp2(qf @ kf.transpose(-1, -2) * sl2 - lse2)
    ds = p * (dof @ vf.transpose(-1, -2) - dl) * scale
    if causal:
        i = torch.arange(Lq)[:, None]
        j = torch.arange(Lk)[None, :]
        live = j <= i + (Lk - Lq)
        dead = (i + (Lk - Lq) < 0).expand(Lq, Lk)
        p = torch.where(live, p, torch.where(dead, torch.exp2(-lse2)
                                             .expand_as(p), torch.zeros(())))
        ds = torch.where(live, ds, torch.zeros(()))

    def rnd(t):
        return t.to(torch.bfloat16).float() if rounded else t
    pb, dsb = rnd(p), rnd(ds)
    dq = torch.zeros(B, H, Lq, D)
    for k0 in range(0, Lk, TILE):
        dq += dsb[..., k0:k0 + TILE] @ kf[:, :, k0:k0 + TILE]
    dk, dv = torch.zeros(B, H, Lk, D), torch.zeros(B, H, Lk, D)
    for q0 in range(0, Lq, TILE):
        rows = slice(q0, q0 + TILE)
        dv += pb[:, :, rows].transpose(-1, -2) @ dof[:, :, rows]
        dk += dsb[:, :, rows].transpose(-1, -2) @ qf[:, :, rows]
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for t in (dq, dk, dv))


def _bf16_inputs(lq, lk, d, seed, b=1, h=2):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, n, h, d).astype(np.float32))
            .to(torch.bfloat16) for n in (lq, lk, lk, lq)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _model_grads(q, k, v, do, causal, scale, rounded=True):
    """The model on the forward the kernels are handed: lse from the
    plain forward, delta from its bf16 output, as the autograd Function
    does on the card."""
    out, lse = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
    delta = fa.attention_delta(out, do)
    return hopper_backward_model(q, k, v, do, lse, delta, causal, scale,
                                 rounded)


def _check_model(q, k, v, do, causal, scale, ref_grads):
    grads = _model_grads(q, k, v, do, causal, scale)
    for g, jg, name in zip(grads, ref_grads, ("dq", "dk", "dv")):
        assert _rel(g.float().numpy(), jg) <= GRAD_TOL, name
    # without the bf16 rounding the model is the plain backward up to
    # float32 sums: the rounding is the only point where they part
    exact = _model_grads(q, k, v, do, causal, scale, rounded=False)
    out, lse = fa.flash_attention_fwd_ref(q, k, v, causal, scale)
    plain = fa.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       out.float(), lse, do.float(), causal,
                                       scale)
    for g, pg, name in zip(exact, plain, ("dq", "dk", "dv")):
        assert _rel(g.float().numpy(), pg.to(torch.bfloat16).float()
                    .numpy()) <= 2 ** -7, name


@pytest.mark.parametrize("lq,lk,causal", [(256, 256, True),
                                          (128, 256, False),
                                          (192, 320, False)],
                         ids=["causal256", "cross128x256", "cross192x320"])
def test_model_of_the_new_backward_matches_pallas_in_interpret_mode(
        lq, lk, causal):
    q, k, v, do = _bf16_inputs(lq, lk, 64, seed=21)
    scale = 1.0 / 8.0
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    jdo = jnp.asarray(do.float().numpy())

    def loss(q_, k_, v_):
        return jnp.sum(fap.flash_attention(q_, k_, v_, causal=causal,
                                           scale=scale) * jdo)

    prev = fap._INTERPRET
    fap._INTERPRET = True
    try:
        jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    finally:
        fap._INTERPRET = prev
    _check_model(q, k, v, do, causal, scale,
                 [np.asarray(g) for g in jgrads])


@pytest.mark.parametrize("lq,lk,causal", [(256, 128, True),
                                          (128, 256, True),
                                          (200, 200, True),
                                          (130, 77, False)],
                         ids=["dead_rows", "causal_q_shorter", "ragged200",
                              "unaligned_cross"])
def test_model_of_the_new_backward_matches_sdpa_reference_where_pallas_refuses(
        lq, lk, causal):
    q, k, v, do = _bf16_inputs(lq, lk, 64, seed=22)
    scale = 1.0 / 8.0
    jq, jk, jv = (jnp.asarray(t.float().numpy()) for t in (q, k, v))
    jdo = jnp.asarray(do.float().numpy())

    def loss(q_, k_, v_):
        return jnp.sum(_sdpa_reference(q_, k_, v_, None, causal=causal,
                                       scale=scale) * jdo)

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    _check_model(q, k, v, do, causal, scale,
                 [np.asarray(g) for g in jgrads])
    if causal and lq > lk:    # dead rows pass no gradient to q
        dq, _, _ = _model_grads(q, k, v, do, causal, scale)
        assert not dq[:, :lq - lk].float().abs().max()


@pytest.mark.parametrize("kernel,cls", [
    ("flash_attention_dq_hopper_kernel", "flash_attention_dq"),
    ("flash_attention_dkv_hopper_kernel", "flash_attention_dkv")])
def test_the_profiler_counts_the_new_kernels_with_their_class(kernel, cls):
    """``profile_train`` sorts device time by substrings of the kernel
    names; the wgmma kernels' mangled names land in the old classes."""
    from paddle_tpu_torch.tools.profile_train import kernel_class
    mangled = (f"void (anonymous namespace)::{kernel}<64>(CUtensorMap_st, "
               "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
               "float const*, __nv_bfloat16*, (anonymous namespace)::Shape, "
               "float)")
    assert kernel_class(mangled) == cls
    assert f"{kernel}(" in (_build.CSRC / "flash_attention.cu").read_text()
