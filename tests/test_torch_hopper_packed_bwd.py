"""The wgmma/TMA design of the packed (segment-id) flash backward, dq and
dk/dv (``paddle_tpu_torch/kernels/csrc/packed_flash.cu``
``packed_flash_dq_hopper_kernel``, ``packed_flash_dkv_hopper_kernel``: the
bodies of ``csrc/flash_bwd_hopper.cuh`` with segment ids), on the CPU.

- Routing: ``packed_flash.hopper_bwd`` on every shape ``chip_smoke.py``
  and the card tests (``tests/test_torch_cuda.py``) run: bfloat16 at
  D = 64 and L <= 16384 with 16-byte aligned q, k, v, do takes the new
  kernels; float32, other head sizes (128 included), longer rows and
  unaligned inputs take the CUDA-core ones.
- The ctypes prototypes of the two new C entries; the build flag
  ``PACKED_BWD_STALL_WG`` keying a variant of its own and sitting in both
  bodies of the shared header, which both sources include.
- A CUDA tensor without the library raises on either route, runs no plain
  version and counts no launch.
- The profiler's classes for the new kernel names.
- The tile lists: a model of ``list_tiles`` (key tiles for dq, q tiles
  for dk/dv) agrees with the packed forward's model of its key list, never leaves out a live pair on random ids (non-contiguous, an
  id in two places, L off the tile grid, causal and not), and lists 2 of 8
  tiles a CTA, all flagged "one id", at pack 4.
- The new backward's schedule (each warpgroup's 64 rows or keys over the
  listed tiles live for it, P = 2^(S scale log2(e) - lse log2(e)), P and
  dS rounded to bfloat16 before their products, float32 sums over 64-row
  tiles in list order), modelled in PyTorch, against the Pallas
  ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel`` gradients in interpret mode on
  pack 4, uneven ids, an id in two places and causal, and against the
  plain backward at a length the Pallas wrapper refuses; within the
  bfloat16 gradient limit the card holds the kernels to (``BF16_GRAD_TOL``:
  3e-2 of max-abs).

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
import paddle_tpu.kernels.packed_flash_pallas as P
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import packed_flash as pf

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_cases", os.path.join(ROOT, "tests", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _load("test_torch_cuda")
_FWD = _load("test_torch_hopper_paged_packed")
# (B, H, L, D) of every packed backward the card runs
PACKED_SHAPES = {
    **{f"smoke_{n}": c[:4] for n, c in chip_smoke.PACKED_CASES.items()},
    **{f"card_{n}": c[:4] for n, c in _CARD.PF_CASES.items()},
    "bert_pack4": (16, 12, 512, 64),
}
GRAD_TOL = chip_smoke.BF16_GRAD_TOL
assert GRAD_TOL == _CARD.FA_TOL[torch.bfloat16][1]


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


def _read(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PACKED_SHAPES))
def test_packed_backward_route_for_every_shape_the_card_runs(case):
    B, H, L, D = PACKED_SHAPES[case]
    seg = _empty((B, L), torch.int32)
    for dtype, want in ((torch.bfloat16, D == 64), (torch.float32, False)):
        q = _empty((B, L, H, D), dtype)
        assert pf.hopper_bwd(q, q, q, q, seg) is want, (case, dtype)


def test_the_card_runs_both_packed_backward_routes_in_bf16():
    """The card's bf16 cases reach the wgmma backward and, at head sizes
    it does not serve (128, 40), the CUDA-core kernels' bf16 build."""
    assert {D == 64 for *_, D in PACKED_SHAPES.values()} == {True, False}
    assert chip_smoke.PACKED_CASES["d128"][3] == 128


@pytest.mark.parametrize("D", [16, 32, 40, 96, 128])
def test_other_head_sizes_take_the_cuda_core_backward(D):
    q = _empty((1, 128, 2, D), torch.bfloat16)
    assert not pf.hopper_bwd(q, q, q, q, _empty((1, 128), torch.int32))


def test_packed_backward_route_sees_every_alignment_and_the_length():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it, so the CUDA-core kernels take it, whichever of q, k, v, do
    it is. The ids are read with plain loads (any alignment); the lists of
    live tiles hold 256 tiles (L <= 16384)."""
    q = _empty((1, 128, 2, 64), torch.bfloat16)
    seg = _empty((1, 128), torch.int32)
    off = torch.empty(q.numel() + 8, dtype=torch.bfloat16)[1:q.numel() + 1] \
        .view(q.shape)
    assert pf.hopper_bwd(q, q, q, q, seg)
    for i in range(4):
        args = [q] * 4
        args[i] = off
        assert not pf.hopper_bwd(*args, seg), i
    seg_off = torch.empty(129, dtype=torch.int32)[1:].view(1, 128)
    assert pf.hopper_bwd(q, q, q, q, seg_off)
    for L, want in ((16384, True), (16385, False)):
        big = torch.empty((1, L, 1, 64), dtype=torch.bfloat16)
        assert pf.hopper_bwd(big, big, big, big,
                             _empty((1, L), torch.int32)) is want


# -- the C entries and the shared header --------------------------------------

def _c_params(name):
    sig = re.search(rf'extern "C" int {name}\((.*?)\)',
                    _read("packed_flash.cu"), re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("name,argtypes", [
    ("packed_flash_backward_dq_hopper", pf.DQ_ARGTYPES),
    ("packed_flash_backward_dkv_hopper", pf.DKV_ARGTYPES)],
    ids=["dq", "dkv"])
def test_ctypes_bindings_match_the_c_prototypes_of_the_new_entries(
        name, argtypes):
    """The new entries take their old counterparts' arguments, so the
    wrappers bind both with one argtypes list; a pointer declared as an
    int would be cut to 32 bits."""
    assert _c_params(name) == argtypes
    assert _c_params(name.replace("_hopper", "")) == argtypes


def test_the_stall_hook_keys_a_variant_and_sits_in_both_shared_bodies():
    _, plain = _build._target("packed_flash")
    _, wg0 = _build._target("packed_flash", ("-DPACKED_BWD_STALL_WG=0",))
    _, wg1 = _build._target("packed_flash", ("-DPACKED_BWD_STALL_WG=1",))
    assert len({plain, wg0, wg1}) == 3
    body = _read("flash_bwd_hopper.cuh")
    # dq's consumer loop and dk/dv's, beside the flash backward's hooks
    assert body.count("#ifdef PACKED_BWD_STALL_WG") == 2
    assert body.count("#ifdef FLASH_BWD_STALL_WG") == 2
    for src in ("flash_attention.cu", "packed_flash.cu"):
        assert '#include "flash_bwd_hopper.cuh"' in _read(src), src
    # a change of the header rebuilds both libraries
    assert "flash_bwd_hopper.cuh" in {p.name for p in
                                      _build.CSRC.glob("*.cuh")}


def test_both_backwards_run_one_body_each():
    """The flash and the packed kernels instantiate the same two bodies,
    without and with segment ids."""
    for src, seg in (("flash_attention.cu", "false"),
                     ("packed_flash.cu", "true")):
        text = _read(src)
        assert f"dq_hopper_body<D, {seg}>(" in text, src
        assert f"dkv_hopper_body<D, {seg}>(" in text, src
    assert "__global__" not in _read("flash_bwd_hopper.cuh")


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
    """No nvcc and no built library; the names of the C entries asked for
    are recorded; the plain versions are gone (a CUDA tensor runs none)."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(pf, "_fns", {})
    asked = []
    real = pf._kernel_fn

    def spy(name, argtypes):
        asked.append(name)
        return real(name, argtypes)
    monkeypatch.setattr(pf, "_kernel_fn", spy)
    monkeypatch.setattr(pf, "packed_flash_bwd_dq_ref", None)
    monkeypatch.setattr(pf, "packed_flash_bwd_dkv_ref", None)
    return asked


@pytest.mark.parametrize("dtype,D,hopper", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, False),
    (torch.float32, 64, False)], ids=["bf16", "bf16_d128", "f32"])
@pytest.mark.parametrize("kernel", ["dq", "dkv"])
def test_a_cuda_tensor_raises_on_either_packed_backward_route(
        no_library, kernel, dtype, D, hopper):
    q = _fake(torch.randn(1, 64, 2, D).to(dtype))
    seg = _fake(torch.zeros(1, 64, dtype=torch.int32))
    lse = _fake(torch.zeros(2, 64))
    fn = {"dq": pf.packed_flash_bwd_dq, "dkv": pf.packed_flash_bwd_dkv}[kernel]
    pf.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        fn(q, q, q, seg, q, lse, lse)
    entry = f"packed_flash_backward_{kernel}"
    assert no_library == [entry + "_hopper" if hopper else entry]
    assert (pf.dq_launches, pf.dq_hopper_launches, pf.dkv_launches,
            pf.dkv_hopper_launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("kernel,cls", [
    ("packed_flash_dq_hopper_kernel", "packed_flash_dq"),
    ("packed_flash_dkv_hopper_kernel", "packed_flash_dkv")])
def test_the_profiler_counts_the_new_kernels_with_their_class(kernel, cls):
    """``profile_train`` sorts device time by substrings of the kernel
    names, demangled or not."""
    from paddle_tpu_torch.tools.profile_train import kernel_class
    demangled = (f"void (anonymous namespace)::{kernel}<64>(CUtensorMap_st, "
                 "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, float const*, "
                 "float const*, __nv_bfloat16*, (anonymous namespace)::Shape, "
                 "float, int const*)")
    mangled = (f"_ZN48_GLOBAL__N__2c884570_15_packed_flash_cu_53b4e2ca"
               f"{len(kernel)}{kernel}ILi64EEEv14CUtensorMap_stS1_S1_S1_PKfS3_"
               "P13__nv_bfloat16NS_5ShapeEfPKi")
    for name in (demangled, mangled):
        assert kernel_class(name) == cls, name
    assert f"{kernel}(" in _read("packed_flash.cu")


# -- the tile lists, modelled --------------------------------------------------

BM, BN = 128, 64   # HopperBwd: rows a CTA owns, rows a tile streams


def tile_list(ids, r0, L, causal, own_keys):
    """``list_tiles`` of one CTA owning rows [r0, r0 + 128) of a row of
    ``ids`` (q rows for dq, ``own_keys`` False; keys for dk/dv, True):
    ``(tile, live warpgroups, "one id" warpgroups)`` for every streamed
    64-row tile that can hold a live pair for one of its two warpgroups."""
    ids = [int(x) for x in ids]
    lo, hi, whole = [], [], []
    for w in range(2):
        own = ids[r0 + 64 * w:min(r0 + 64 * w + 64, L)]
        lo.append(min(own) if own else None)
        hi.append(max(own) if own else None)
        whole.append(len(own) == 64)
    first, last = 0, L
    if causal:
        if own_keys:
            first = r0 // BN
        else:
            last = min(L, r0 + BM)
    out = []
    for kt in range(first, -(-last // BN)):
        tile = ids[kt * BN:min(kt * BN + BN, L)]
        live, one = set(), set()
        for w in range(2):
            hit = lo[w] is not None and any(lo[w] <= x <= hi[w] for x in tile)
            meet = not causal or (kt * BN + BN - 1 >= r0 + 64 * w if own_keys
                                  else kt * BN <= r0 + 64 * w + 63)
            if hit and meet:
                live.add(w)
            if (len(tile) == BN and min(tile) == max(tile) and whole[w]
                    and lo[w] == hi[w] == tile[0]):
                one.add(w)
        if live:
            out.append((kt, live, one))
    return out


def _random_ids(seed, L):
    """Few values, unsorted, an id in several places; odd seeds in runs,
    as packing makes them."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        return np.repeat(rng.integers(0, 5, L // 37 + 1), 37)[:L] \
            .astype(np.int32)
    return rng.integers(0, 4, L).astype(np.int32)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_the_key_list_is_the_packed_forwards(seed, causal):
    """``list_tiles`` with q rows owned is the packed forward's list (its
    model in tests/test_torch_hopper_paged_packed.py), tile for tile."""
    L = int(np.random.default_rng(seed + 10).integers(130, 700))
    ids = torch.from_numpy(_random_ids(seed, L))
    for q0 in range(0, L, BM):
        got = [(kt, live) for kt, live, _ in
               tile_list(ids, q0, L, causal, own_keys=False)]
        assert got == _FWD.cta_tile_list(ids, q0, L, causal), q0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_the_q_list_never_leaves_out_a_live_pair(seed, causal):
    """For random ids and lengths off the tile grid: every (row, key) pair
    with equal ids (and, causal, key <= row) lies in a q tile listed live
    for the key's warpgroup; and a tile flagged "one id" for a warpgroup
    holds only pairs of one id."""
    L = int(np.random.default_rng(seed + 20).integers(130, 700))
    ids = _random_ids(seed, L)
    for k0 in range(0, L, BM):
        listed = {qt: (live, one) for qt, live, one in
                  tile_list(ids, k0, L, causal, own_keys=True)}
        for c in range(k0, min(k0 + BM, L)):
            w = (c - k0) // 64
            rows = np.nonzero(ids == ids[c])[0]
            if causal:
                rows = rows[rows >= c]
            for qt in set((rows // BN).tolist()):
                assert w in listed.get(qt, ((), ()))[0], (k0, c, qt)
        for qt, (live, one) in listed.items():
            for w in one:
                keys = ids[k0 + 64 * w:k0 + 64 * w + 64]
                assert len(set(keys) | set(ids[qt * BN:qt * BN + BN])) == 1


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_at_pack4_both_lists_hold_2_of_8_tiles_of_one_id(causal):
    """BERT's pack 4 (four 128-token sequences in a 512 row): every CTA
    covers one segment, so dq lists 2 of its 8 key tiles and dk/dv 2 of 8
    q tiles, each flagged "one id" for the warpgroups it is live for (no
    per-element segment test; causal adds the diagonal's)."""
    ids = np.repeat(np.arange(4), 128).astype(np.int32)
    for r0 in range(0, 512, BM):
        for own_keys in (False, True):
            tiles = tile_list(ids, r0, 512, causal, own_keys)
            assert [kt for kt, _, _ in tiles] == [r0 // BN, r0 // BN + 1]
            for _, live, one in tiles:
                assert live <= one


# -- the new backward's arithmetic, modelled -----------------------------------

def packed_backward_model(q, k, v, do, seg, lse, delta, causal, scale,
                          rounded=True):
    """What ``packed_flash_dq_hopper_kernel`` and
    ``packed_flash_dkv_hopper_kernel`` compute on bf16 inputs: exact
    products summed in float32 (wgmma); P = 2^(S scale log2(e) - lse
    log2(e)) with the scale and lse prescaled in float32; dS = P (dP -
    delta) scale; a pair counts when the ids match and, causal, col <= row;
    P and dS rounded to bfloat16 before dV += P^T dO, dq += dS K and dK +=
    dS^T Q (``rounded``). dq: each warpgroup's 64 q rows over the key
    tiles listed live for them, in list order; dk/dv: each warpgroup's 64
    keys over the q tiles listed live for them. Returns (dq, dk, dv) in
    bfloat16 and the lengths of the two lists, a CTA each."""
    B, L, H, D = q.shape
    log2e = torch.tensor(math.log2(math.e), dtype=torch.float32)
    sl2 = torch.tensor(scale, dtype=torch.float32) * log2e
    qf, kf, vf, dof = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, do))
    lse2 = lse.reshape(B, H, L) * log2e
    dl = delta.reshape(B, H, L)

    def rnd(t):
        return t.to(torch.bfloat16).float() if rounded else t

    def p_ds(b, rows, cols):
        """P and dS of q rows x keys, [H, rows, cols], masked and
        rounded."""
        s = qf[b][:, rows] @ kf[b][:, cols].transpose(1, 2)
        p = torch.exp2(s * sl2 - lse2[b][:, rows, None])
        dp = dof[b][:, rows] @ vf[b][:, cols].transpose(1, 2)
        ds = p * (dp - dl[b][:, rows, None]) * scale
        ok = seg[b][rows][:, None] == seg[b][cols][None, :]
        if causal:
            ok = ok & (cols[None, :] <= rows[:, None])
        zero = torch.zeros(())
        return rnd(torch.where(ok, p, zero)), rnd(torch.where(ok, ds, zero))

    dq, dk, dv = (torch.zeros(B, H, L, D) for _ in range(3))
    counts = {"dq": [], "dkv": []}
    for b in range(B):
        for own_keys, kn in ((False, "dq"), (True, "dkv")):
            for r0 in range(0, L, BM):
                tiles = tile_list(seg[b], r0, L, causal, own_keys)
                counts[kn].append(len(tiles))
                for w in range(2):
                    if r0 + 64 * w >= L:
                        continue
                    own = torch.arange(r0 + 64 * w, min(r0 + 64 * w + 64, L))
                    for t, live, _ in tiles:
                        if w not in live:
                            continue
                        other = torch.arange(t * BN, min(t * BN + BN, L))
                        if kn == "dq":
                            _, ds = p_ds(b, own, other)
                            dq[b][:, own] += ds @ kf[b][:, other]
                        else:
                            p, ds = p_ds(b, other, own)
                            dv[b][:, own] += p.transpose(1, 2) @ \
                                dof[b][:, other]
                            dk[b][:, own] += ds.transpose(1, 2) @ \
                                qf[b][:, other]
    grads = tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16)
                  for t in (dq, dk, dv))
    return grads, counts


def _packed_ids(name, B, L):
    seg = np.zeros((B, L), np.int32)
    if name == "pack4":
        seg[:] = np.repeat(np.arange(4), L // 4)
    else:   # chip_smoke's uneven rows: three segments; an id in two places
        a, b = L * 100 // 512, L * 400 // 512
        seg[0, :a], seg[0, a:b], seg[0, b:] = 5, 7, 9
        seg[1, :a], seg[1, a:b], seg[1, b:] = 5, 7, 5
    return seg


def _bf16_inputs(B, L, H, D, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((B, L, H, D))
                             .astype(np.float32)).to(torch.bfloat16)
            for _ in range(4)]


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _model_grads(q, k, v, do, seg, causal, scale, rounded=True):
    """The model on the forward the kernels are handed: lse from the plain
    forward, delta from its bf16 output, as the autograd Function does on
    the card."""
    out, lse = pf.packed_flash_fwd_ref(q, k, v, seg, causal, scale)
    delta = pf.attention_delta(out, do)
    return packed_backward_model(q, k, v, do, seg, lse, delta, causal, scale,
                                 rounded)


def _check_against_plain(q, k, v, do, seg, causal, scale):
    """Without the bf16 rounding the model is the plain backward up to
    float32 sums: the rounding is the only point where they part."""
    (dq, dk, dv), _ = _model_grads(q, k, v, do, seg, causal, scale,
                                   rounded=False)
    out, lse = pf.packed_flash_fwd_ref(q, k, v, seg, causal, scale)
    delta = pf.attention_delta(out, do)
    f = [t.float() for t in (q, k, v, do)]
    want = (pf.packed_flash_bwd_dq_ref(*f[:3], seg, f[3], lse, delta, causal,
                                       scale),
            *pf.packed_flash_bwd_dkv_ref(*f[:3], seg, f[3], lse, delta,
                                         causal, scale))
    for g, pg, name in zip((dq, dk, dv), want, ("dq", "dk", "dv")):
        assert _rel(g.float().numpy(), pg.to(torch.bfloat16).float()
                    .numpy()) <= 2 ** -7, name


@pytest.mark.parametrize("layout,causal", [("pack4", False),
                                           ("pack4", True),
                                           ("uneven", False),
                                           ("uneven", True)],
                         ids=["pack4", "pack4_causal", "uneven",
                              "uneven_causal"])
def test_model_of_the_new_backward_matches_pallas_in_interpret_mode(
        layout, causal):
    """Against the gradients of the Pallas ``custom_vjp`` (its
    ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``) in interpret mode, on the
    same bf16 values in float32; the uneven layout's second row holds one
    id in two places."""
    B, L, H, D = 2, 512, 2, 64
    q, k, v, do = _bf16_inputs(B, L, H, D, 41)
    seg = _packed_ids(layout, B, L)
    scale = 1.0 / math.sqrt(D)
    prev = P._INTERPRET
    P._INTERPRET = True
    try:
        with jax.enable_x64(False):
            _, vjp = jax.vjp(
                lambda a, b_, c: P.packed_flash_attention(
                    a, b_, c, jnp.asarray(seg), causal=causal, scale=scale),
                *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
            jgrads = vjp(jnp.asarray(do.float().numpy()))
    finally:
        P._INTERPRET = prev
    tseg = torch.from_numpy(seg)
    grads, counts = _model_grads(q, k, v, do, tseg, causal, scale)
    for g, jg, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        assert _rel(g.float().numpy(), np.asarray(jg)) <= GRAD_TOL, name
    _check_against_plain(q, k, v, do, tseg, causal, scale)
    if layout == "pack4":   # 2 of 8 tiles a CTA, in both lists
        assert counts == {"dq": [2] * (B * L // BM),
                          "dkv": [2] * (B * L // BM)}


@pytest.mark.parametrize("causal", [False, True], ids=["bidir", "causal"])
def test_model_of_the_new_backward_matches_plain_off_the_tile_grid(causal):
    """At L = 300 (rows and keys past L in the last CTA, which the Pallas
    wrapper refuses) with random unsorted ids: the model against the plain
    backward at the bf16 limit, and unrounded within one bf16 step."""
    B, L, H, D = 2, 300, 2, 64
    q, k, v, do = _bf16_inputs(B, L, H, D, 42)
    seg = torch.from_numpy(np.stack([_random_ids(s, L) for s in (5, 6)]))
    scale = 1.0 / math.sqrt(D)
    grads, _ = _model_grads(q, k, v, do, seg, causal, scale)
    out, lse = pf.packed_flash_fwd_ref(q, k, v, seg, causal, scale)
    delta = pf.attention_delta(out, do)
    f = [t.float() for t in (q, k, v, do)]
    want = (pf.packed_flash_bwd_dq_ref(*f[:3], seg, f[3], lse, delta, causal,
                                       scale),
            *pf.packed_flash_bwd_dkv_ref(*f[:3], seg, f[3], lse, delta,
                                         causal, scale))
    for g, pg, name in zip(grads, want, ("dq", "dk", "dv")):
        assert _rel(g.float().numpy(), pg.numpy()) <= GRAD_TOL, name
    _check_against_plain(q, k, v, do, seg, causal, scale)
