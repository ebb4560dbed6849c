"""The wgmma/TMA design of the fused-CE forward
(``paddle_tpu_torch/kernels/csrc/fused_ce.cu``
``fused_ce_fwd_hopper_kernel``), on the CPU.

- Routing: ``fused_ce.hopper_recompute`` (bfloat16 h and w, d a multiple
  of 8, both 16-byte aligned) picks the forward's design as it picks the
  backward's, on every shape ``chip_smoke.py`` and the card tests
  (``tests/test_torch_cuda.py``) run; float32, mixed dtypes, d = 50 and
  inputs that are not 16-byte aligned keep the first design.
- The ctypes prototypes of the two new C entries (the forward and its
  split count), and the stall hook's variant.
- A CUDA tensor without the library raises on either forward route, runs
  no plain version and counts no launch.
- ``profile_train`` classes the new kernel as the CE forward.
- The new kernel's arithmetic: each vocab split's 128-vocab tiles dealt
  alternately to two running states (the two consumer warpgroups), each
  an online max and sum of exp(s - m) in float32 over bf16 h and w, the
  label's logit taken from the tile that holds it; the two states merged
  in one order (warpgroup 0's, then 1's) into the split's (m, l, target),
  which ``_combine`` merges across splits. A plain PyTorch model of it is
  held against the Pallas ``_fwd_kernel`` in interpret mode and against
  the port's plain forward on ragged T and V (V off the 128-row tile),
  labels outside ``[0, V)`` and a split with no column, at the limit the
  card holds the kernel to (nll and lse within 2e-6 of max-abs).

The kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import ctypes
import importlib.util
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import paddle_tpu.kernels.fused_ce_pallas as K
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import fused_ce as fc
from paddle_tpu_torch.tools.profile_train import kernel_class

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _card_tests():
    spec = importlib.util.spec_from_file_location(
        "torch_cuda_cases", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CARD = _card_tests()
# (T, V, d) of every forward the card runs
FWD_SHAPES = {**{f"smoke_{n}": c[:3]
                 for n, c in chip_smoke.FCE_CASES.items()},
              **{f"card_{n}": c for n, c in _CARD.FCE_CASES.items()},
              **{f"card_dh_{n}": c for n, c in _CARD.FCE_DH_CASES.items()},
              **{f"card_fwd_{n}": c for n, c in _CARD.FCE_FWD_CASES.items()}}
FWD_TOL = _CARD.FCE_TOL[torch.bfloat16][0]   # 2e-6 of max-abs
assert FWD_TOL == chip_smoke.FCE_LSE_TOL


def _empty(shape, dtype):
    return torch.empty(shape, dtype=dtype)


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("case", list(FWD_SHAPES))
def test_fwd_route_for_every_shape_the_card_runs(case):
    T, V, d = FWD_SHAPES[case]
    h, w = _empty((T, d), torch.bfloat16), _empty((V, d), torch.bfloat16)
    assert fc.hopper_recompute(h, w) is (d % 8 == 0)
    assert not fc.hopper_recompute(h.float(), w.float())
    assert not fc.hopper_recompute(h, w.float())
    assert not fc.hopper_recompute(h.float(), w)


def test_the_card_runs_both_fwd_builds_and_both_routes_in_bf16():
    """The card's bf16 cases reach the wgmma forward on the build with
    every 64-column box of d live (d > 704) and on the one that loops over
    the boxes holding d, and the first design's bf16 instantiation at
    d = 50; the training shape takes the build with every box live; some
    wgmma case is ragged in both T (64-token blocks) and V (128-vocab
    tiles), and one has two tiles only, the second of one column."""
    ds = [d for _, _, d in FWD_SHAPES.values()]
    assert {d % 8 == 0 for d in ds} == {True, False}
    assert {d > 704 for d in ds if d % 8 == 0} == {True, False}
    assert 704 in ds and 712 in ds
    assert FWD_SHAPES["smoke_train"] == (16384, 50304, 768)
    ragged = [(T % 64, V % 128) for T, V, d in FWD_SHAPES.values()
              if d % 8 == 0]
    assert any(t and v for t, v in ragged)
    assert FWD_SHAPES["card_fwd_one_tile_and_a_row"][1] == 129


def test_the_fwd_route_sees_the_alignment_of_h_and_w():
    """A view 2 bytes into its storage is not 16-byte aligned: TMA cannot
    address it."""
    raw = torch.empty(65 * 64, dtype=torch.bfloat16)
    ok, off = raw[:64 * 64].view(64, 64), raw[1:64 * 64 + 1].view(64, 64)
    assert fc.hopper_recompute(ok, ok)
    assert not fc.hopper_recompute(off, ok)
    assert not fc.hopper_recompute(ok, off)


def test_profile_train_classes_the_new_kernel_as_the_ce_fwd():
    for name in (
            "void (anonymous namespace)::fused_ce_fwd_hopper_kernel<true>"
            "(CUtensorMap_st, CUtensorMap_st, int const*, float*)",
            "_ZN44_GLOBAL__N__d87d6159_11_fused_ce_cu_d501686026fused_ce_fwd_"
            "hopper_kernelILb1EEEv14CUtensorMap_stS1_PKiPfS4_S4_iiii",
            "void (anonymous namespace)::fused_ce_fwd_kernel<__nv_bfloat16>"
            "(__nv_bfloat16 const*)"):
        assert kernel_class(name) == "fused_ce_fwd", name


# -- the C entries ------------------------------------------------------------

def _c_params(name):
    with open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                           "fused_ce.cu")) as f:
        text = f.read()
    sig = re.search(rf'extern "C" int {name}\((.*?)\)', text, re.S).group(1)
    params = [" ".join(p.split()) for p in sig.split(",")]
    return [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else ctypes.c_int
            for p in params]


@pytest.mark.parametrize("entry,old,argtypes", [
    ("fused_ce_forward_hopper", "fused_ce_forward", "FWD_ARGTYPES"),
    ("fused_ce_forward_hopper_splits", "fused_ce_forward_splits",
     "SPLITS_ARGTYPES")], ids=["forward", "splits"])
def test_ctypes_binding_matches_the_c_prototypes_of_the_new_entries(
        entry, old, argtypes):
    """A pointer declared as an int would be cut to 32 bits. Each new
    entry takes its old counterpart's arguments, so one argtypes list
    binds both."""
    assert _c_params(entry) == getattr(fc, argtypes)
    assert _c_params(old) == getattr(fc, argtypes)


def test_the_stall_hook_builds_a_variant_beside_the_plain_library():
    _, plain = _build._target("fused_ce")
    _, hooked = _build._target("fused_ce", ("-DFUSED_CE_FWD_STALL_WG=1",))
    assert plain != hooked
    src = open(os.path.join(ROOT, "paddle_tpu_torch", "kernels", "csrc",
                            "fused_ce.cu")).read()
    assert "FUSED_CE_FWD_STALL_WG" in src


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
    """No nvcc and no built library; the wrappers' own allocations land on
    the CPU (this torch has no CUDA); the names of the C entries asked for
    are recorded."""
    import torch.utils.cpp_extension as ext
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(fc, "_fns", {})
    real_empty = torch.empty

    def empty(*shape, device=None, **kw):
        return real_empty(*shape, **kw)
    monkeypatch.setattr(torch, "empty", empty)
    asked = []
    real = fc._kernel_fn

    def spy(name, argtypes):
        asked.append(name)
        return real(name, argtypes)
    monkeypatch.setattr(fc, "_kernel_fn", spy)
    return asked


ROUTES = [(torch.bfloat16, 64, "_hopper"), (torch.bfloat16, 768, "_hopper"),
          (torch.bfloat16, 50, ""), (torch.float32, 64, "")]


@pytest.mark.parametrize("nsplit", [None, 2], ids=["split_count", "forced"])
@pytest.mark.parametrize("dtype,d,suffix", ROUTES,
                         ids=["bf16", "bf16_d768", "bf16_d50", "f32"])
def test_a_cuda_tensor_raises_on_either_fwd_route(no_library, monkeypatch,
                                                  nsplit, dtype, d, suffix):
    """The first C entry the route asks for: its split count, or with the
    count forced the forward itself."""
    monkeypatch.setattr(fc, "fused_ce_fwd_ref", None)     # never called
    T, V = 40, 300
    h = _fake(torch.randn(T, d).to(dtype))
    w = _fake(torch.randn(V, d).to(dtype))
    lab = _fake(torch.zeros(T, dtype=torch.int32))
    fc.reset_launches()
    with pytest.raises(RuntimeError, match="nvcc"):
        if nsplit is None:
            fc.fused_ce_fwd(h, w, lab)
        else:
            fc._launch_fwd(h, w, lab, nsplit=nsplit)
    want = f"fused_ce_forward{suffix}" + ("_splits" if nsplit is None else "")
    assert no_library == [want]
    assert (fc.fwd_launches, fc.fwd_hopper_launches) == (0, 0)


# -- the new kernel's arithmetic, modelled ------------------------------------

BV = 128   # FwdHopper::BV: vocab rows a tile


def fwd_hopper_model(h, w, lab, nsplit):
    """What ``fused_ce_fwd_hopper_kernel`` computes, in float32 on bf16 h
    and w, as the ``[3, nsplit, T]`` parts (m, l, target) that
    ``_combine`` merges: split y owns tiles [y tps, (y + 1) tps) of the
    ceil(V / 128) vocab tiles (tps = ceil(tiles / nsplit)); its local tile
    j goes to state j % 2 (the two consumer warpgroups), each keeping per
    row the running max m, l = sum exp(s - m) (rescaled as m grows) and
    the label's logit (a label outside [0, V) picks nothing; vocab columns
    >= V are not columns); the split's part is state 0 merged with state
    1: M = max(m0, m1), L = l0 exp(m0 - M) + l1 exp(m1 - M), target t0 + t1.
    A split or state with no tile holds (-inf, 0, 0). Also returns how
    many tiles each state took, per split."""
    hf, wf = h.float(), w.float()
    T, V = h.shape[0], w.shape[0]
    s = hf @ wf.t()          # bf16 products are exact in float32
    lab = lab.long()
    tiles = -(-V // BV)
    tps = -(-tiles // nsplit)
    parts = torch.zeros(3, nsplit, T)
    taken = []
    ninf = torch.full((T,), -torch.inf)

    def rescale(l, m, mu):
        return l * torch.exp(m - mu)   # m = -inf: 0

    for y in range(nsplit):
        st = [[ninf.clone(), torch.zeros(T), torch.zeros(T)] for _ in (0, 1)]
        count = [0, 0]
        for j, vt in enumerate(range(y * tps, min(tiles, (y + 1) * tps))):
            m, l, t = st[j % 2]
            count[j % 2] += 1
            lo, hi = vt * BV, min(V, vt * BV + BV)
            blk = s[:, lo:hi]
            mn = torch.maximum(m, blk.amax(1))
            l = rescale(l, m, mn) + torch.exp(blk - mn[:, None]).sum(1)
            t = t + torch.where(lab[:, None] == torch.arange(lo, hi)[None],
                                blk, torch.zeros(())).sum(1)
            st[j % 2] = [mn, l, t]
        (m0, l0, t0), (m1, l1, t1) = st
        M = torch.maximum(m0, m1)
        mu = torch.where(M == -torch.inf, torch.zeros(()), M)
        parts[0, y] = M
        parts[1, y] = rescale(l0, m0, mu) + rescale(l1, m1, mu)
        parts[2, y] = t0 + t1
        taken.append(count)
    return parts, taken


def _rel(a, b):
    a, b = torch.as_tensor(np.array(a, np.float32)), b.float()
    return float((a.float() - b).abs().max() / b.abs().max().clamp(min=1e-30))


def _inputs(T, V, d, seed):
    """Every 16th label (from row 1) past the Pallas side's padded
    vocabulary (ROADMAP caveat 6: a label in [V, Vpad) would pick a padded
    column there) and every 5th -100: rows whose nll is their lse."""
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, d)).astype(np.float32)
    w = (rng.standard_normal((V, d)) * 0.1).astype(np.float32)
    lab = rng.integers(0, V, (T,)).astype(np.int32)
    lab[1::16] = 1024 + 7
    lab[::5] = -100
    return (torch.from_numpy(h).to(torch.bfloat16),
            torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(lab))


def _pallas_nll(h, w, lab, block_t=128, block_v=256):
    """The Pallas forward's nll in interpret mode (``_fwd_kernel`` through
    ``fused_softmax_ce``, which pads T and V to its blocks)."""
    prev = K._INTERPRET
    K._INTERPRET = True
    try:
        nll = K.fused_softmax_ce(jnp.asarray(h.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(w.float().numpy(), jnp.bfloat16),
                                 jnp.asarray(lab.numpy()), block_t=block_t,
                                 block_v=block_v)
    finally:
        K._INTERPRET = prev
    return np.asarray(nll, np.float32)


@pytest.mark.parametrize("nsplit", [1, 3, 7],
                         ids=["one_split", "two_tiles_a_split",
                              "an_empty_split"])
@pytest.mark.parametrize("T,V,d", [(300, 700, 768), (200, 500, 96)],
                         ids=["d768", "d96"])
def test_model_of_the_new_fwd_matches_pallas_in_interpret_mode(T, V, d,
                                                               nsplit):
    """Ragged T (off the 64-token block and the Pallas side's 128) and V
    (off the 128-vocab tile: 700 is six tiles, the last of 60 columns; 500
    is four, the last of 116), labels outside [0, V); one split, splits
    of two tiles (one per state) and, with seven splits over six or four
    tiles, splits with no column. nll and lse within 2e-6 of max-abs of
    the plain forward, nll within the same limit of the Pallas forward's,
    rows whose label picks nothing with their nll equal to their lse."""
    th, tw, tlab = _inputs(T, V, d, 51)
    parts, taken = fwd_hopper_model(th, tw, tlab, nsplit)
    nll, lse = fc._combine(*parts)
    rnll, rlse = fc.fused_ce_fwd_ref(th, tw, tlab)
    assert _rel(nll.numpy(), rnll) <= FWD_TOL
    assert _rel(lse.numpy(), rlse) <= FWD_TOL
    assert _rel(_pallas_nll(th, tw, tlab), nll) <= FWD_TOL
    none = (tlab < 0) | (tlab >= V)
    assert 0 < int(none.sum()) < T
    assert torch.equal(nll[none], lse[none])
    tiles = -(-V // BV)
    assert sum(a + b for a, b in taken) == tiles
    if nsplit == 7:       # the splits past the tiles hold (-inf, 0, 0)
        empty = [y for y, (a, b) in enumerate(taken) if a + b == 0]
        assert empty
        for y in empty:
            assert bool((parts[0, y] == -torch.inf).all())
            assert not parts[1, y].any() and not parts[2, y].any()
    else:                 # state 0 takes the even tiles, state 1 the odd
        assert all(a - b in (0, 1) for a, b in taken)


def test_model_merges_two_states_into_the_one_state_answer():
    """Dealing a split's tiles to two states and merging them gives the
    split's single online pass (one state over every tile in order)
    within float32 rounding, and equal when the second state is empty."""
    th, tw, tlab = _inputs(130, 1000, 64, 53)
    two, taken = fwd_hopper_model(th, tw, tlab, 1)
    assert taken == [[4, 4]]
    s = th.float() @ tw.float().t()
    m = s.amax(1)
    l = torch.exp(s - m[:, None]).sum(1)
    assert torch.equal(two[0, 0], m)
    torch.testing.assert_close(two[1, 0], l, rtol=2e-6, atol=0)
    one_tile, taken = fwd_hopper_model(th, tw[:100].contiguous(), tlab, 1)
    assert taken == [[1, 0]]
    s1 = s[:, :100]
    m1 = s1.amax(1)
    assert torch.equal(one_tile[0, 0], m1)
    assert torch.equal(one_tile[1, 0], torch.exp(s1 - m1[:, None]).sum(1))
